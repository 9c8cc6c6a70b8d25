"""Reads the program's own spans from a profiler record: the ``mh::``
ranges that ``mh_spgemm_torch.timing.span`` opens while a profiler
records (the span tree: ``bucketed``, ``plan``, ``plan.first``,
``plan.replan``, ``upload``, ``main``, ``front.*``, ``tail.*``,
``learn``, ``extract.*``, ``readback``, ``route``, ``spgemm_host`` and
the reference's phase names).

:func:`summarize` gives the harness's reading (``profile.summarize``) of
the record without the program's ranges, so every number the benchmark
reads stays what it is without them, and beside it:

* ``spans``: ``{span: [count, host_s, device_s]}``; ``device_s`` is the
  device time launched inside the span, the innermost span winning.  A
  device operation belongs to the innermost program span open on the
  host when its launch (the runtime call with its correlation id) ran;
  where no launch is linked, to the innermost device-side range of a
  span around it; else, or where no span was open, to ``(outside)``.
  ``linked`` counts the operations whose launch was found, those placed
  by a device-side range, and those placed by neither.
* ``idle_by_span``: each idle gap of the device, cut at the edges of the
  program's and the benchmark's host ranges, piece by piece under the
  innermost of them open at the piece's middle (``(none)`` where none
  is).

:data:`READERS` reads each stage metric of the traced stretch from that;
every reader returns None where the record holds no program span.

    python3 -m spgemm_bench.spans --workload <cell> --seed <n> \\
        --seconds <s> [--out FILE]

runs the cell once traced, as ``spgemm_bench.run --trace 1`` does, and
prints one JSON line: the result line, the stage readings, the top spans
and idle pieces, and the balance of the span attribution against the
harness's busy time.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
from typing import Optional

# run.py sets one host thread for the numerical libraries on import: it
# comes first, before torch and numpy load, as in a run of the cell
from . import run as _run  # noqa: F401
from . import profile

PREFIX = "mh::"
OUTSIDE = "(outside)"
NONE = "(none)"


@dataclasses.dataclass
class SpanProfile:
    """One measured step read by the program's spans."""

    profile: profile.Profile      # the harness's reading, ranges left out
    spans: dict                   # span -> [count, host_s, device_s]
    idle_by_span: dict            # innermost host range -> idle seconds
    linked: dict                  # attribution -> device operations
    ranges: list                  # (start, end, span) host ranges, us

    @property
    def calls(self) -> int:
        return self.profile.calls

    def has_spans(self) -> bool:
        return bool(self.ranges)


def _host(e) -> bool:
    return not str(getattr(e, "device_type", "")).endswith("CUDA")


def _launch(e) -> bool:
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return _host(e) and e.name.startswith("cu")


def innermost(ranges: list, times: list) -> list:
    """The innermost of ``ranges`` ((start, end, name), properly nested)
    open at each of ``times``, or None: one sweep over both, sorted."""
    order = sorted(range(len(times)), key=times.__getitem__)
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: list = [None] * len(times)
    stack: list = []
    i = 0
    for k in order:
        t = times[k]
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def _window(events: list, busy: list):
    step = [e for e in events if e.name.startswith("ProfilerStep")
            and not profile._is_device(e)]
    if step:
        return (min(e.time_range.start for e in step),
                max(e.time_range.end for e in step))
    if busy:
        return busy[0][0], busy[-1][1]
    return 0.0, 0.0


def summarize(events: list, calls: int, window_s: float) -> SpanProfile:
    """A :class:`SpanProfile` from the measured step's profiler events."""
    mine = [e for e in events if e.name.startswith(PREFIX)]
    rest = [e for e in events if not e.name.startswith(PREFIX)]
    base = profile.summarize(rest, calls, window_s)
    dev = [e for e in rest if profile._is_device(e)]
    busy = profile._union([(e.time_range.start, e.time_range.end)
                           for e in dev])
    t0, t1 = _window(rest, busy)
    host = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
            for e in mine if _host(e)]
    annot = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
             for e in mine if not _host(e)]
    launch_at = {e.id: e.time_range.start for e in rest
                 if _launch(e) and getattr(e, "id", None) is not None}

    spans: dict = {}
    for s, e, name in host:
        rec = spans.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e6
    # each device operation: by its launch, else by a device-side range
    linked = {"launch": 0, "annotation": 0, "none": 0}
    at = [launch_at.get(getattr(e, "id", None)) for e in dev]
    by_launch = innermost(host, [t for t in at if t is not None])
    by_annot = innermost(annot, [(e.time_range.start + e.time_range.end)
                                 / 2 for e in dev])
    it = iter(by_launch)
    for e, t, a in zip(dev, at, by_annot):
        if t is not None:
            owner = next(it)
            linked["launch"] += 1
        else:
            owner = a
            linked["annotation" if a is not None else "none"] += 1
        dur = (min(e.time_range.end, t1) - max(e.time_range.start, t0))
        if dur <= 0:
            continue
        name = owner[2] if owner else OUTSIDE
        spans.setdefault(name, [0, 0.0, 0.0])[2] += dur / 1e6

    # idle pieces, cut at every host range's edges
    clipped = [(max(s, t0), min(e, t1)) for s, e in busy
               if e > t0 and s < t1]
    edges = [t0] + [x for iv in clipped for x in iv] + [t1]
    bench = [(e.time_range.start, e.time_range.end, e.name) for e in rest
             if e.name.startswith(profile.SPAN_PREFIX) and _host(e)]
    named = [(s, e, PREFIX + n) for s, e, n in host] + bench
    cuts = sorted({t for s, e, _ in named for t in (s, e)})
    pieces = []
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        lo, hi = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        cut = [a] + cuts[lo:hi] + [b]
        pieces += [(x, y) for x, y in zip(cut[:-1], cut[1:]) if y > x]
    idle: dict = {}
    for (a, b), r in zip(pieces, innermost(named, [(a + b) / 2
                                                   for a, b in pieces])):
        label = r[2] if r else NONE
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return SpanProfile(profile=base, spans=spans, idle_by_span=idle,
                       linked=linked, ranges=host)


# -- the stage readings ---------------------------------------------------

def _device_ms(sp: SpanProfile, match) -> float:
    return 1e3 * sum(v[2] for k, v in sp.spans.items() if match(k)) \
        / sp.calls


def _host_ms(sp: SpanProfile, name: str) -> float:
    return 1e3 * sp.spans.get(name, [0, 0.0, 0.0])[1] / sp.calls


def discarded_plan_ms(sp: SpanProfile) -> float:
    """Host time of ``plan.first`` in the ``plan`` ranges that also ran
    ``plan.replan`` (the plan thrown away), per call; 0 where none did."""
    plans = [r for r in sp.ranges if r[2] == "plan"]
    total = 0.0
    for s, e, _ in plans:
        inside = [r for r in sp.ranges if s <= r[0] and r[1] <= e]
        if any(r[2] == "plan.replan" for r in inside):
            total += sum(r[1] - r[0] for r in inside
                         if r[2] == "plan.first")
    return total / 1e3 / sp.calls


READERS = {
    "frontend_ms.warm": lambda sp: _device_ms(
        sp, lambda k: k.startswith("front.")),
    "esc_tail.sort_ms.warm": lambda sp: _device_ms(
        sp, lambda k: k == "tail.sort"),
    "esc_tail.kernel_ms.warm": lambda sp: _device_ms(
        sp, lambda k: k == "tail.kernel"),
    "extract_ms.warm": lambda sp: _device_ms(
        sp, lambda k: k.startswith("extract.")),
    "plan.discarded_ms.cold": discarded_plan_ms,
    "learn_ms.cold": lambda sp: _host_ms(sp, "learn"),
}


def read(sp, name: str):
    """The stage metric ``name`` of a :class:`SpanProfile`, or None where
    there is none or it holds no program span."""
    if sp is None or not sp.has_spans() or sp.calls <= 0:
        return None
    return READERS[name](sp)


# -- one traced run -------------------------------------------------------

def traced_run(workload: str, seed: int, seconds: float,
               bench: Optional[dict] = None, device="cuda:0") -> dict:
    """One ``--trace 1`` run of ``workload`` (of ``BENCHMARK.json`` unless
    ``bench`` is given) on the card, as ``spgemm_bench.run`` makes it,
    with the traced step read both ways."""
    import torch

    from . import harness

    kept: list = []
    plain = profile.summarize

    def keeping(events, calls, window_s):
        kept[:] = [(events, calls, window_s)]
        return plain(events, calls, window_s)

    if bench is None:
        bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    profile.summarize = keeping
    try:
        out = harness.run_cell(bench, workload, seed, seconds, True,
                               device=device)
    finally:
        profile.summarize = plain
    res = {"result": out, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if not kept:
        return res
    events, calls, window_s = kept[0]
    sp = summarize(events, calls, window_s)
    p = sp.profile
    mine = [e for e in events if e.name.startswith(PREFIX)]
    top = sorted(sp.spans.items(), key=lambda kv: -kv[1][2])
    res.update(
        calls=calls,
        stages={k: read(sp, k) for k in READERS},
        spans={k: v for k, v in sorted(sp.spans.items())},
        top_device_spans=[[k, v[2]] for k, v in top[:12]],
        idle_by_span=sorted(sp.idle_by_span.items(),
                            key=lambda kv: -kv[1])[:10],
        linked=sp.linked,
        # the harness's reading without the program's ranges
        without_ranges={"busy_s": p.busy_s, "window_s": p.window_s,
                        "launches_per_call": p.launches_per_call(),
                        "partial": p.partial,
                        "idle_gaps": sorted(p.idle.items(),
                                            key=lambda kv: -kv[1])[:10]},
        balance={"span_device_s_per_call":
                 sum(v[2] for v in sp.spans.values()) / calls,
                 "busy_s_per_call": p.busy_s / calls},
        device_ranges={
            "events": sum(not _host(e) for e in mine),
            "flagged_user_annotation": sum(
                bool(getattr(e, "is_user_annotation", False))
                for e in mine if not _host(e)),
            "counted_by_harness": sum(profile._is_device(e)
                                      for e in mine)})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    res = traced_run(args.workload, args.seed, args.seconds)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
