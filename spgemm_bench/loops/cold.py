"""The first product on a structure the process has never multiplied: the
paper's protocol (symbolic and numeric in one call), as one-shot users of
``spgemm_host`` and of the command line pay it.

Call k multiplies A_k = P_k A P_k^T, P_k a permutation of A's whole
``permute_block``-row blocks drawn from (seed, k) and applied outside the
timed call, so every call does the same work (intprod, nnz(C), block
pairs) on a structure that never repeats.  Each call is
``spgemm_host(A_k, None, config)``, host CSR in, host CSR out.  Set-up
makes one such call on a structure outside the window.

A traced run makes each call as the public steps that ``spgemm_host``'s
body consists of, each a span: ``route`` (``choose_engine``), ``plan``
(``prepare_*_state``), ``run`` (the engine's first call), ``readback``
(``C.host()``); it profiles the window's first call."""

from __future__ import annotations

import time

import torch

from spgemm_bench import gen, profile


def setup(run) -> None:
    from spgemm_bench.harness import engine, load_program
    _, pipeline = load_program()
    cfg = run.program_config()
    bs = run.traffic["permute_block"]

    def host_call(Ak):
        return pipeline.spgemm_host(run.program_csr(Ak), None, cfg,
                                    device=run.device)

    def traced_call(Ak):
        A = run.program_csr(Ak)
        with run.span("route"):
            run.engine = pipeline.choose_engine(A, A, cfg,
                                                device=run.device)
        prepare, call = engine(run.engine)
        with run.span("plan"):
            state = prepare(A, A, cfg, device=run.device)
        with run.span("run"):
            C, _ = call(A, A, cfg, state=state, device=run.device)
        with run.span("readback"):
            return C.host()

    run.permuted = lambda k: gen.block_permuted(run.A, bs, run.rng(2, k))
    run.entry = traced_call if run.trace else host_call
    A_w = gen.block_permuted(run.A, bs, run.rng(3))
    t0 = time.perf_counter()
    for _ in range(run.traffic["warmup_calls"]):
        run.entry(A_w)
        run.sync()
    run.t_call = (time.perf_counter() - t0) / run.traffic["warmup_calls"]


def window(run) -> None:
    sample = run.sample(run.traffic["sampled_calls"])
    last = None
    made = {0: run.permuted(0)}

    def one() -> None:
        nonlocal last
        k = len(run.calls) + run.failed
        Ak = made.pop(k) if k in made else run.permuted(k)   # untimed
        C = run.timed_call(Ak)
        if C is not None:
            if k in sample:
                run.kept.append((Ak, C))
            last = (Ak, C)

    t_end = run.start_window()
    if run.trace:
        def step() -> int:
            one()
            return 1

        run.profile = profile.record(
            step, warm=lambda: torch.ones(1, device=run.device).add_(1),
            whole=False)
    while time.perf_counter() < t_end and not run.failed:
        one()
    if last is not None and not any(last[0] is KA and last[1] is KC
                                    for KA, KC in run.kept):
        run.kept.append(last)
