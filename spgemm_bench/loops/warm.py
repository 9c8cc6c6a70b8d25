"""Repeated products on one structure with a reused plan: a closed loop
with one caller, as AMG re-setup and iterative graph kernels run it.

Two operands share the configuration's structure and differ in their
values (the second drawn from the seed): two systems on one mesh.  Set-up
routes once (``choose_engine``), prepares the engine's state for each,
makes each one's first call and ``warmup_calls`` warm ones.  In the
window the calls alternate between the two, each the chosen engine's
entry with that operand's reused state, and each ends when C is on the
card and the card is idle.  Outputs of both are kept, so a call that
returns an earlier C is caught.  A traced run profiles ``trace_calls``
calls at the start of the window."""

from __future__ import annotations

import time

from spgemm_bench import gen, profile


def setup(run) -> None:
    from spgemm_bench.harness import engine, load_program
    _, pipeline = load_program()
    cfg = run.program_config()
    run.inputs = [run.A, gen.revalued(run.A, run.seed, 1)]
    csr = {id(M): run.program_csr(M) for M in run.inputs}
    A = csr[id(run.A)]
    with run.span("route"):
        run.engine = pipeline.choose_engine(A, A, cfg, device=run.device)
    prepare, call = engine(run.engine)
    states = {}
    for M in run.inputs:
        X = csr[id(M)]
        with run.span("plan"):
            state = prepare(X, X, cfg, device=run.device)
        with run.span("first_call"):
            _, states[id(M)] = call(X, X, cfg, state=state)
            run.sync()
    run.state = states
    run.counters["plan"] = states[id(run.A)].plan.stats()

    def entry(M):
        X = csr[id(M)]
        return call(X, X, cfg, state=states[id(M)])[0]

    run.entry = entry
    n = run.traffic["warmup_calls"]
    t0 = time.perf_counter()
    for k in range(n):
        run.entry(run.inputs[k % 2])
        run.sync()
    run.t_call = (time.perf_counter() - t0) / n


def tail_slots(run) -> dict:
    """The tail's slots by route, summed over both plans' runs so far
    (a bucketed plan's counter; empty for another engine)."""
    out: dict = {}
    for state in run.state.values():
        for route, n in getattr(state.plan, "tail_slots", {}).items():
            out[route] = out.get(route, 0) + n
    return out


def window(run) -> None:
    sample = run.sample(run.traffic["sampled_calls"])
    last = {}

    def one() -> None:
        k = len(run.calls) + run.failed
        M = run.inputs[k % 2]
        C = run.timed_call(M)
        if C is not None:
            if k in sample:
                run.kept.append((M, C))
            last[id(M)] = (M, C)

    t_end = run.start_window()
    before = tail_slots(run)
    if run.trace:
        n = run.traffic["trace_calls"]

        def step() -> int:
            for _ in range(n):
                one()
            return n

        run.profile = profile.record(step, warm=one)
    while time.perf_counter() < t_end and not run.failed:
        one()
    run.counters["tail_slots"] = {k: n - before.get(k, 0)
                                  for k, n in tail_slots(run).items()}
    for M, C in last.values():
        if not any(M is KM and C is KC for KM, KC in run.kept):
            run.kept.append((M, C))
