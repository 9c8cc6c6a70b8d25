"""One run of one cell: find its files by name, make the input from the
seed, let the traffic mix's loop set the program up and drive the
measured window, then compare the kept outputs with the plain reference
and read the cell's metrics.

The loop (``loops/<traffic["loop"]>.py``) gives two functions:
``setup(run)``, everything before the first timed call, which leaves the
timed call in ``run.entry`` (input matrix -> the program's C), and
``window(run)``, the measured window, which calls
:meth:`Run.start_window` just before its first timed call, records each
call with :meth:`Run.timed_call` and keeps the outputs to compare in
``run.kept``.  A metric (``metrics/<name>.py``) gives ``read(run)``, a
number or None where the run holds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import check, gen, reference

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "mh_spgemm_tpu")
_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (Linux: from its start time in
    ``/proc``, interpreter start included); elsewhere since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_IMPORT


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_part(kind: str, name: str):
    """``spgemm_bench/<kind>/<name>.py`` as a module (names may hold
    dots, so it is loaded from its path)."""
    path = os.path.join(PKG, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"spgemm_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_program():
    """The system under test."""
    import mh_spgemm_torch
    from mh_spgemm_torch import pipeline
    return mh_spgemm_torch, pipeline


def engine(name: str) -> tuple:
    """(``prepare_*_state``, the engine's entry) of the engine that
    ``choose_engine`` names."""
    _, pipeline = load_program()
    return {"bucketed": (pipeline.prepare_bucketed_state,
                         pipeline.spgemm_bucketed),
            "blockdense": (pipeline.prepare_blockdense_state,
                           pipeline.spgemm_blockdense)}[name]


class Run:
    """What one run knows: the cell's files, the input, the program's
    state while the window lasts, and what the window recorded."""

    def __init__(self, cell: str, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.A: Optional[gen.Matrix] = None
        self.entry: Optional[Callable] = None
        self.state = None
        self.engine: Optional[str] = None
        self.t_call: Optional[float] = None   # a set-up call's seconds
        self.setup_s: Optional[float] = None
        self.calls: list = []      # {"start", "end", "events"} a call
        self.spans: dict = {}      # span -> seconds of each
        self.kept: list = []       # (input, output) to compare
        self.failed = 0
        self.counters: dict = {}
        self.work: dict = {}
        self.profile = None
        self.card: dict = {}

    # -- the program ---------------------------------------------------

    def program_config(self):
        pkg, _ = load_program()
        return pkg.SpGEMMConfig(value_dtype=self.config["value_dtype"],
                                mode=self.config["mode"])

    @staticmethod
    def program_csr(M: gen.Matrix):
        pkg, _ = load_program()
        return pkg.CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- seeds -----------------------------------------------------------

    def rng(self, *tags) -> np.random.Generator:
        """A generator drawn from the run's seed and ``tags``."""
        return np.random.default_rng([self.seed % 2**64, *tags])

    def sample(self, k: int) -> set:
        """``k`` call indices drawn from the seed among the calls that
        half the window holds at the set-up call's pace."""
        n = max(1, int(0.5 * self.seconds / max(self.t_call, 1e-6)))
        return set(self.rng(1).choice(n, size=min(k, n),
                                      replace=False).tolist())

    # -- the window ------------------------------------------------------

    def start_window(self) -> float:
        """Marks the end of set-up; returns the window's end (host
        clock)."""
        self.setup_s = process_age_s() - build_seconds()
        self.spans = {}
        return time.perf_counter() + self.seconds

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of a step, kept under ``name``; in a traced run also
        a ``bench::<name>`` range in the profile."""
        rf = (torch.profiler.record_function(f"bench::{name}")
              if self.trace else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def timed_call(self, A: gen.Matrix):
        """One timed call of ``run.entry`` that ends when its output is
        on its device and the device is idle.  Records its host interval
        and, on the card, its length on the device's clock (CUDA events
        recorded before the call and after its synchronize).  A call
        that raises is counted failed; returns None then."""
        cuda = self.device.type == "cuda"
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            ev0.record()
        try:
            with self.span("call"):
                C = self.entry(A)
                self.sync()
        except Exception as exc:     # a failed call fails the run
            self.failed += 1
            print(f"call {len(self.calls)} raised "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr,
                  flush=True)
            return None
        if cuda:
            ev1.record()
        t1 = time.perf_counter()
        self.calls.append({"start": t0, "end": t1,
                           "events": (ev0, ev1) if cuda else None})
        return C

    def call_ms(self) -> list:
        """Each window call's milliseconds: on the card by its CUDA
        events, elsewhere by the host clock."""
        self.sync()
        return [c["events"][0].elapsed_time(c["events"][1])
                if c["events"] else (c["end"] - c["start"]) * 1e3
                for c in self.calls]

    def release(self) -> None:
        """Drops the program's state once the window has closed."""
        self.state = self.entry = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare_kept(run: Run, dtype=torch.float64) -> dict:
    """The kept outputs against the reference, one reference pass per
    distinct input."""
    groups: dict = {}
    for A, C in run.kept:
        groups.setdefault(id(A), (A, []))[1].append(C)
    total = {"shape_wrong": 0, "rows_wrong": 0, "entries_wrong": 0,
             "val_gap": 0.0}
    for A, outs in groups.values():
        r = check.compare(A, A, outs, run.device, dtype)
        for k in ("shape_wrong", "rows_wrong", "entries_wrong"):
            total[k] += r[k]
        total["val_gap"] = max(total["val_gap"], r["val_gap"])
    return total


def control_entry(run: Run) -> Callable:
    """The control: the plain reference in float32, the precision below
    the configuration's float64, in the program's place."""
    def entry(A):
        return reference.as_csr(A, A, run.device, torch.float32)
    return entry


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return {"nvidia_smi": out.stdout.strip().splitlines()[0]}
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": "not read"}


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device="cuda",
             hook: Optional[Callable[[Run], None]] = None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``hook``
    may replace ``run.entry`` after set-up (the control and the tests'
    planted faults)."""
    wl = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == wl["config"])
    config = load_json(ROOT, cfg_entry["file"])
    traffic = load_json(PKG, "traffic", f"{wl['traffic']}.json")
    loop = load_part("loops", traffic["loop"])
    metrics = [(m, load_part("metrics", m["name"]))
               for m in cell_metrics(bench, cell, trace)]
    run = Run(cell, config, traffic, seed, seconds, trace, device)
    run.A = gen.make(config["generator"], seed)
    run.work["intprod"] = gen.intprod(run.A, run.A)
    loop.setup(run)
    if hook is not None:
        hook(run)
    loop.window(run)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    run.release()
    readings = {"shape_wrong": 0, "rows_wrong": 0, "entries_wrong": 0,
                "val_gap": math.inf}
    t_check = time.perf_counter()
    try:
        if run.kept:
            readings = compare_kept(run)
    except Exception as exc:         # the comparison could not be made
        print(f"comparison raised {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        readings["shape_wrong"] = max(1, len(run.kept))
    readings["calls_failed"] = run.failed
    readings["outputs_missing"] = 0 if run.kept else 1
    run.kept = []
    check_s = time.perf_counter() - t_check
    limits = dict(config["check"])
    limits.update({k: 0 for k in check.EXACT})
    correct, rows = check.judge(readings, limits)
    if cuda:
        run.card = {"kind": torch.cuda.get_device_name(run.device),
                    **card_info()}
    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if cuda
           else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": len(run.calls) + run.failed,
           "failed": run.failed, "metrics": values, "device": dev}
    if trace and run.profile is not None:
        p = run.profile
        dev.update(busy_s=p.busy_s, window_s=p.window_s)
        top = sorted(p.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        idle = sorted(p.idle.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, s] for k, (_, s) in top],
                            "idle_gaps": [[k, s] for k, s in idle]}
    out.update(engine=run.engine, card=run.card, nvcc_s=build_seconds(),
               check_s=check_s, seed=seed, host=host_info())
    if len(run.calls) <= 64:
        out["calls_ms"] = run.call_ms()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    return out


def host_info() -> dict:
    """What the host gave this run: the cores it may use and torch's
    host threads."""
    return {"cpus": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads()}


def build_seconds() -> float:
    """Seconds this process spent in nvcc building the program's
    kernels: above 0 only in the first run of a checkout.  ``setup_s``
    leaves them out; the result line gives them as ``nvcc_s``."""
    build = sys.modules.get("mh_spgemm_torch._build")
    return float(sum(build.build_seconds.values())) if build else 0.0
