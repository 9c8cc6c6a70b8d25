"""Reads a stretch of the run under ``torch.profiler``: device time by
kernel name, the device's busy time and the idle gaps named by what the
host was doing.  A frozen copy of the program's chip-run profiler reader
(``chip_smoke.device_profile`` and ``kernel_name``): a warm-up step that
the profiler discards, since it misses launches while its device tracing
starts, then the measured step; a record with no device time, or with a
kernel launched a number of times that is not a multiple of the calls,
is taken again.

The benchmark's own spans are ``torch.profiler.record_function`` ranges
named ``bench::<span>``; an idle gap, cut at the edges of those spans,
is named piece by piece by the innermost span and the innermost other
host operation open at the piece's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable

import torch

ATTEMPTS = 4
SPAN_PREFIX = "bench::"
NAMED_GAPS = 256          # the longest gaps that are named one by one


def kernel_name(event_name: str) -> str:
    """A device event's name without its return type, namespace and
    parameter list: ``void (anonymous namespace)::tail_warp<double,
    8>(...)`` reads ``tail_warp<double, 8>``."""
    name = event_name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].strip()


@dataclasses.dataclass
class Profile:
    """One measured step of ``calls`` calls."""

    calls: int
    window_s: float               # the step's length
    busy_s: float                 # union of the device operations
    by_name: dict                 # kernel -> [launches, device seconds]
    idle: dict                    # gap label -> idle seconds
    partial: dict = dataclasses.field(default_factory=dict)

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds per call of the kernels whose name matches."""
        return sum(s for k, (_, s) in self.by_name.items()
                   if match(k)) / self.calls

    def launches_per_call(self) -> float:
        return sum(n for n, _ in self.by_name.values()) / self.calls


def _is_device(e) -> bool:
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")
            and not e.name.startswith(SPAN_PREFIX))


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(events: list, t: float):
    best = None
    for s, e, name in events:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(events: list, calls: int, window_s: float) -> Profile:
    """A :class:`Profile` from the measured step's profiler events."""
    step = [e for e in events if e.name.startswith("ProfilerStep")
            and not _is_device(e)]
    dev = [e for e in events if _is_device(e)]
    by_name: dict = {}
    for e in dev:
        n, s = by_name.get(kernel_name(e.name), (0, 0.0))
        dur = (e.time_range.end - e.time_range.start) / 1e6
        by_name[kernel_name(e.name)] = [n + 1, s + dur]
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    if step:
        t0 = min(e.time_range.start for e in step)
        t1 = max(e.time_range.end for e in step)
        window_s = (t1 - t0) / 1e6
    elif busy:
        t0, t1 = busy[0][0], busy[-1][1]
    else:
        t0 = t1 = 0.0
    clipped = [(max(s, t0), min(e, t1)) for s, e in busy if e > t0
               and s < t1]
    busy_s = sum(e - s for s, e in clipped) / 1e6
    edges = [t0] + [x for iv in clipped for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _is_device(e) and not e.name.startswith("ProfilerStep")
            and not str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    ops = [h for h in host if not h[2].startswith(SPAN_PREFIX)]
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    idle: dict = {}
    for i, (dur, s, e) in enumerate(gaps):
        if i >= NAMED_GAPS:
            idle["shorter gaps"] = idle.get("shorter gaps", 0.0) + dur / 1e6
            continue
        # a gap across several spans is cut at their edges
        lo, hi = bisect.bisect_right(cuts, s), bisect.bisect_left(cuts, e)
        edges = [s] + cuts[lo:hi] + [e]
        for a, b in zip(edges[:-1], edges[1:]):
            mid = (a + b) / 2
            span = _innermost(spans, mid)
            span = span[len(SPAN_PREFIX):] if span else "between spans"
            op = _innermost(ops, mid)
            label = f"{span}/{op}" if op else span
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    partial = {k: n for k, (n, _) in by_name.items() if n % calls}
    return Profile(calls=calls, window_s=window_s, busy_s=busy_s,
                   by_name=by_name, idle=idle, partial=partial)


def record(step: Callable[[], int], warm: Callable[[], None],
           whole: bool = True) -> Profile:
    """``warm()`` as the profiler's warm-up step, then ``step()``, which
    makes its calls and returns how many, as the measured step; each
    ends with a synchronize.  Taken again, up to ATTEMPTS times, while
    the record holds no device time or, with ``whole``, a partial call.
    Raises RuntimeError if no record is whole."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            calls = step()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            prof.step()
        out = summarize(list(prof.events()), calls, window_s)
        if out.busy_s > 0 and not (whole and out.partial):
            return out
    raise RuntimeError(
        f"the profiler kept no whole record in {ATTEMPTS} attempts "
        f"(busy {out.busy_s} s, partial launches {out.partial})")
