#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch version.
2. Builds the six CUDA sources (``mh_spgemm_torch/csrc/esc_tail.cu``,
   ``pair_matmul.cu``, ``ragged_fill.cu``, ``planned.cu``,
   ``remote_fetch.cu`` and ``gather_front.cu``) with nvcc for sm_90a
   into ``build/``, one nvcc per source, started together; prints the
   build times and, for each kernel, the registers, static shared
   memory, stack and spills ptxas reports (also in each kernel's
   ``ptxas`` entry of the kernels line).
   Then ``cuobjdump -sass`` of the built ``pair_matmul`` library: per
   pair kernel the count of DMMA, HMMA ... TF32, LDGSTS and UTMALDG
   instructions, beside the registers, dynamic shared memory, local
   bytes and resident blocks per SM the runtime reports; the f64 kernel
   must have DMMA and keep two blocks per SM, the f32 kernel TF32 HMMA,
   both LDGSTS or UTMALDG (in each one's ``sass`` entry).  The ESC
   tail's warp-path and tile-path kernels (``tail_warp``, ``tail_tile``,
   every width and value type) must use no local memory and spill
   nothing.
3. Kernel phase: ``esc_tail_flat`` against its plain PyTorch version on
   the card for w2 in {2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
   4096, 8192, 32768, 65536} (the warp path up to 256, the tile path from
   512, the wide path above 8192; each line prints the path), f64 and
   f32, on duplicate-heavy, empty and all-same-key segments (keys and
   counts exact, values within 1e-9 (f64) / 1e-4 (f32)
   absolute-or-relative; whether they are bit for bit equal is
   printed); the slab form ``esc_tail`` the same way over
   the same widths, the padded widths W of ``PADDED_WS`` (rows of W
   slots sorted in segments of the next power of two) and the wide path's
   widths of ``WIDE_WS`` (not powers of two, up to 786432), with row counts
   under W (NaN values and random keys past them), empty rows and full
   rows; both tails also against a
   reference by ``torch.sort`` and ``index_add_`` that shares nothing of
   their algorithm (keys and counts exact, values within 1e-9 (f64) /
   1e-4 (f32) of the summed magnitudes); ``ragged_fill`` against its
   plain version for 1, 2 and 3 planes at window rows 16 and 128 (the
   largest), on runs that cross the half-window grid, full-window runs
   and a zero-length run, compared exactly on the words the runs cover;
   ``pgather`` against its plain version on every output word and
   against ``tab[src[perm]]`` from the host schedule, for 1, 2 and 3
   planes read in place with a word stride of 2, planes 0-1 or 1-2 the
   two words of one f64 array (the 8-byte load) and no such pair;
   ``proute`` against its plain version on every word for 1, 2 and 3
   planes at the main path's widths and holds (``PROUTE_CASES``: m from
   1024 to 131072, holds 1 to 32768, among them m = 16384 with 2048 and
   m = 65536 with 64 and 1024), on planned routes and on random mask
   bits, and without the hold against ``out[dest] = in`` (all exact);
   ``pair_matmul_f64`` and ``pair_matmul_f32`` against their plain
   versions on a synthetic stream (segments of 1 to 64 pairs, dead
   pairs, C blocks with no pair), on the boundary streams of
   ``ops/pair_matmul.boundary_streams`` (segments of 1, 2, 3 and
   37 pairs with dead pairs at their starts and ends, an all-dead C
   block, empty C blocks, and ncb = 1) and on pdb1HYS's own pair stream
   (f64 within 1e-9 absolute-or-relative; f32 within 1e-4 of the
   magnitude of the summed terms, the same pair product over |a| and
   |b|: two f32 summation orders of up to 8192 random-sign terms differ
   by more than 1e-4 absolute where the sum cancels to near zero); the
   f32 kernel ``torch.equal`` to its plain version on 0/1 blocks (the
   boundary streams and pdb1HYS's patterns), and its max abs error
   against the f64 product of the same f32 inputs at most 4 times that
   of ``torch.bmm`` in full f32; ``block_gather``
   against ``index_select`` for f64, f32 and int32 (exact);
   ``halo_exchange`` against its plain version and against
   ``torch.stack(sends).transpose(0, 1)`` for D in {1, 2, 4, 8} and vr in
   {1, 3, 336, 5376}, every shard in its own allocation (exact), at D=8
   also into each receiving range of ``HALO_SUBSETS`` alone (a
   process's own shards; given buffers) against the plain version's
   subset and the whole exchange's slice (exact), and
   ``exchange_planes`` round-tripping 3 planes of cap 300.
   Then the gather frontend's phase: the gather classes of the
   benchmark's two configurations as the pipeline plans them on the card
   (``GATHER_RUNS``: er_s17_ef16's W = 192, 256, 384, 512 and 768,
   g500_s15_ef16's W = 393216 and 786432), ``gather_front`` against
   ``front_gather_plain`` (keys, the products' bits and the row counts
   equal), each class timed beside the plain version, one
   ``index_select`` of B's columns and values at the covered slots'
   sources and the byte bound (the ``gather_front`` lines and kernel
   entry: the phase's own launches, nonzero, are its ``timed_launches``;
   its ``launches`` are those of the bucketed, masked, distributed and
   multi-process phases below, each counted from 0 around its runs).
4. Bucketed phase: ``spgemm_host`` and ``spgemm_bucketed`` (one cold
   call, then warm calls reusing the state) under the default config
   (``planned="auto"``: the planned frontend on the card) on the
   full-size stand-ins scircuit, cage12 and webbase-1M; every C must
   equal the scipy oracle within 1e-9; scircuit and webbase-1M must run
   planned classes, cage12 must be replanned (the legacy-replan rule);
   the launch counts, set to 0 before this phase, must have grown for
   ``esc_tail_flat``, ``ragged_fill`` (cage12's windowed extraction),
   ``pgather``, ``proute`` and ``gather_front`` (cage12's replanned gather
   class).  Prints per matrix the engine
   ``choose_engine`` picks, the warm ms per SpGEMM (CUDA events), GFLOPS
   = 2 * intprod / ms, nnz(C), the class widths and frontends, the
   planning seconds, whether the plan was replanned, which extraction the
   warm call runs (windowed, planned or gather) and the slots each tail
   took; then each stage of a warm call timed alone, the extraction by
   the gather and by the copy the plan has (windowed or planned), and
   each class's tail alone (the ``tail_classes`` line: W, the route
   taken (the kernel's warp, tile or wide path, the direct W = 1 path
   or the sort tail; the kernel's path as ``esc_tail.path_for`` names
   it), rows,
   slots, ms and the byte bound), and the same under ``planned="off"``.
   Then the planned-versus-off phase: on each stand-in, cold calls (host
   wall clock, planning included) and warm calls (CUDA events) under the
   default config and under ``planned="off"``, in turns (default, off,
   off, default), every C against the oracle; then one warm call of each
   under ``torch.profiler``: its kernels by name, their device time and
   the card's idle share against the faster warm time.
   DeviceCSR-engine phase (after the planned-versus-off phase, on the
   same three stand-ins at full size): ``spgemm_host(mode="esc")``, then
   ``spgemm`` on padded device operands (``CSR.device(pad=True)``) under
   ``mode="esc"`` on all three and ``mode="masked"`` (the
   product-granularity pipeline) on scircuit and webbase-1M, cold (host
   wall clock) and warm through a reused ``SpGEMMPlan`` (the seven
   phases of one fenced warm call, and the mean of 10 calls queued under
   ``no_fence`` between CUDA events); ``spgemm(dA, dA)`` under
   ``DEFAULT_CONFIG`` (ESC) on scircuit; on cage12 (29,246,941 products)
   the masked pipeline must raise its ``masked_max_products`` budget
   ``SpGEMMError``.  Every C must equal the oracle within 1e-9.  Then
   ESC against the bucketed engine's warm call in turns (esc, bucketed,
   bucketed, esc, both queued under ``no_fence``), one warm ESC call on
   cage12 under ``torch.profiler`` (kernels, busy ms, idle share), and
   ``spgemm_dist(engine="esc")`` on eight shards of the card: scircuit
   under ``replicate``, ``allgather`` and ``ragged``, cage12 under
   ``ragged``, each cold, warm through its state and its shard program
   alone, against the oracle.  These engines are torch ops, so the
   phase launches none of the nine kernels (their counts are printed).
5. Forced-fill phase on cage12 (``dma_fill="on"``): its W=256 class must
   run the fill frontend, C must equal the oracle, and the
   ``ragged_fill`` and ``esc_tail`` launch counts, set to 0 before, must
   have grown; prints its warm ms beside the default path's, in turns.
6. Block-dense phase on the full-size stand-ins pdb1HYS and pwtk:
   ``spgemm_blockdense`` cold, warm calls reusing the state, and
   ``spgemm_host`` under ``mode="auto"``; every C must equal the oracle
   within 1e-9, and the pair kernels' and ``ragged_fill``'s launch
   counts (the windowed extraction), set to 0 before this phase, must
   have grown.  Prints the engine ``choose_engine`` picks, warm ms,
   GFLOPS, nnz(C), pairs, C blocks, peak memory, and each stage timed
   alone (densify, value pair matmul, pattern pair matmul, strips, and
   the extraction windowed and by the gather).
7. Masked phase: ``spgemm_masked`` cold, then warm, on scircuit and
   cage12 at full size; C must equal the oracle within 1e-9, and
   ``ragged_fill``, set to 0 before each matrix, must have run for both
   (scircuit's tile fill, cage12's windowed extraction);
   ``gather_front``'s launches, set to 0 before each matrix, are read
   after it.  Prints warm ms, GFLOPS, cold ms, the classes by frontend
   and their tile widths.
8. Distributed phase (after the masked phase): ``spgemm_dist`` on D=8
   shards of the one card (``make_row_mesh(8)``; grid2d on 4 x 2) on
   the full-size stand-ins: scircuit under ``replicate``, ``allgather``,
   ``ragged`` ("xla" and "pallas"), ``ragged_overlap`` as its model
   decides and forced, and ``grid2d``; cage12 under ``ragged`` (both
   backends), once with ``dma_fill="on"``, and under ``allgather``.  Each cold (host wall
   clock), then warm through its state (CUDA events: a whole call, and
   the shard program alone), every C against the oracle within 1e-9;
   prints per call D, the shard classes (W, rb, nchunks, fill), plan_s,
   cold, warm and program ms and the words exchanged.  The launch counts,
   set to 0 before the phase, must have grown for ``halo_exchange`` and
   ``esc_tail``, and ``ragged_fill``'s, set to 0 before the forced-fill
   call, in that call.  Then each stand-in's two backends' warm calls in
   turns (pallas, xla, xla, pallas), and ``halo_exchange`` timed at both
   stand-ins' D=8 exchange shapes beside its plain version, the stack
   yardstick and its byte bound.  Then the multi-process phase: the runs
   of ``MP_RUNS`` spawn ranks of ``python -m
   mh_spgemm_torch.parallel.worker`` on the one card (gloo rendezvous on
   localhost, the device payload by CUDA IPC), D=8 in each: 2 ranks x 4
   shards on scircuit (the bucketed engine under every strategy and both
   backends, ragged_overlap forced, grid2d on 4 x 2; ESC under
   replicate, allgather and ragged) and on cage12 (bucketed ragged under
   both backends, allgather), and 8 ranks x 1 shard on scircuit (bucketed
   ragged, "pallas").  Every rank must exit 0 within ``MP_TIMEOUT_S``
   (a failed rank kills the rest) and print its OK line, every C must
   equal the oracle (in the rank) and, bit for bit, the single-process
   D=8 C of the same call (digests of the distributed phases' cold Cs);
   the ESC tails (``esc_tail``, ``esc_tail_flat``) must have launched in
   every rank of each bucketed call, ``halo_exchange`` in every rank of
   each bucketed ragged "pallas" call and in none of the
   ``ragged_overlap`` or ESC calls; each rank's counts are its call's own
   runs (not the turns' single-process calls).  Prints per rank and call the cold, warm and shard-program ms,
   the barriers a call and their ms, and the ms of the gather of C's host
   pieces over gloo (the ``multiprocess`` lines), and
   cage12's ragged "pallas" call in turns against the single-process D=8
   call (``multiprocess_turns``; ranks time-slice the card).  Then
   ``python -m
   mh_spgemm_torch.bench.dist_bench scircuit --max-devices 8`` in a
   subprocess, with ``--engine bucketed`` and with ``--engine esc``, must
   exit 0, pass every check and print nothing of JAX.
9. Kernel timing (CUDA events, warm, many launches), each kernel beside
   its plain version, one PyTorch call computing the same function and
   its bound: ``esc_tail_flat`` on cage12's W=256 class under
   ``planned="off"`` (``torch.sort``),
   ``esc_tail`` on cage12's forced-fill W=256 class (``torch.sort``),
   ``ragged_fill`` at cage12's windowed-extraction shapes (one
   ``index_select`` over the same word indices), ``pgather`` and
   ``proute`` at scircuit's widest planned class (its B route) and at its
   planned extraction's shapes (one ``index_select`` over the same word
   indices; one ``index_copy_`` by the host-simulated destinations), each
   as a wrapper call, as its C entry alone and by device time
   (``torch.profiler``, after a discarded warm-up step, every launch of
   every timed call recorded), ``pgather`` also with its 8-byte f64 load
   off and by host time, ``proute`` also with the hold at scircuit's
   widest A route (m = 16384, hold 2048), and
   the pair matmuls at pwtk's and pdb1HYS's shapes, each in turns with
   ``torch.bmm`` of the pre-gathered pairs (kernel, bmm, bmm, kernel),
   with TFLOP/s (f64 bound: DMMA at 67 TFLOP/s; f32: three TF32 passes
   at 495 TFLOP/s, and the FFMA bound beside it), and ``block_gather`` at
   pwtk's (``torch.index_select``).  Then, after the distributed phase
   and its ``halo_exchange`` timing (the last profiled timings), the
   tile-path phase: the two
   suite members whose classes take the ESC tail's tile path (512 <= w2
   <= 8192), cage15 under ``planned="off"`` (its W=512 pre class; its
   default plan is replanned to a W=384 gather class, which the tile
   path takes padded to 512) and cop20k_A under the default config (its
   W=512 gather class), each cold and warm (5 calls; both Cs against the oracle's
   digest in ``data/oracle_digest.json``, the tails' launch counts set to
   0 before each and read after its warm calls, which must have launched
   them), with their ``tail_classes`` lines; then both tails at cage15's
   W=512 class (256,114,688 slots): ``esc_tail_flat`` on its frontend's
   output and ``esc_tail`` on the same planes as ``[rows, 512]`` slabs
   with every row full, each equal to its plain version (and the two to
   each other) bit for bit, timed beside the plain version,
   ``torch.sort`` of the slots with the segment folded into the key, and
   the byte bound (the ``tile`` entry of kernel rows 1-2).
10. CLI phase: ``python -m mh_spgemm_torch pdb1HYS --check --stats --json
   --iters 3`` in a subprocess must exit 0, pass its check on the
   block-dense engine, and print nothing of JAX; ``python -m
   mh_spgemm_torch scircuit --mode masked --check --iters 2`` and
   ``python -m mh_spgemm_torch scircuit --mode esc --check --iters 3``
   must exit 0 and pass.
11. Soak phase: the structured catalog's 400 cases (``bench/soak.py``)
   through ``spgemm_host`` under ``mode`` bucketed, blockdense, masked,
   esc and auto with the CUDA defaults, in f64, one subprocess per
   family (four at a time: a device-side assert poisons only its own
   family's process), each C against the scipy oracle within 1e-9; and
   ``mode="masked"`` on ``rect_tall(0)``, ``planned="on"`` on
   ``diag_full_row(6)`` and ``rect_tall(9)``, cold and warm.  No run may
   fail, and the soak's launches of ``esc_tail_flat``, ``pgather``,
   ``proute`` and ``pair_matmul_f64`` (counted in the subprocesses) must
   be nonzero.  Prints the ``soak`` line: cases, runs per engine,
   failures, the repaired runs, the launches of kernels 1-7 and seconds
   (also in each kernel's ``soak_launches``).
12. Suite phase: ``python -m mh_spgemm_torch.bench.suite`` in a
   subprocess over the 16 stand-ins under ``mode="auto"``, f64, its plan
   and oracle caches under ``build/``: exit 0, every member's digest
   check against ``data/oracle_digest.json`` passes, the summary is not
   partial, the masked contract members (cant, pdb1HYS) ran without
   error, and nothing of JAX is printed.  Prints a ``suite member`` line
   per member (engine, GFLOPS, warm ms) and the ``suite`` line (the
   summary's headline fields).  Then the runner again in a new process
   on cage12 (bucketed) and pdb1HYS (block-dense): each plan must warm
   from the plan-cache record the first run saved (``plan_cache: hit``)
   and pass its check (the ``suite plan_cache`` line).
13. Prints ``{"kernels": [...]}`` (all ten kernels), the card's name and
   power limit, and,
   as the last line, ``{"ok": true, "device": {...}}``.

Each phase prints its seconds.  Any failed check raises, so the script
exits non-zero and prints no result line.  It exits non-zero at once
where CUDA is not available.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, 700 W
FP64_FLOPS = 34e12              # H100 SXM data sheet, FP64 (non-tensor)
FP64_TC_FLOPS = 67e12           # H100 SXM data sheet, FP64 tensor core
FP32_FLOPS = 67e12              # H100 SXM data sheet, FP32 (non-tensor)
TF32_TC_FLOPS = 495e12          # H100 SXM data sheet, TF32 tensor core, dense
F32_ERR_RATIO = 4.0             # f32 kernel's error against f64: <= 4x bmm's
# records of a device_profile taken before it gives up (its docstring)
PROFILE_ATTEMPTS = 8
# the pair kernels' mangled names hold these (template on the value type)
PAIR_KERNELS = {"pair_matmul_f64": "pair_matmul_kernelIdE",
                "pair_matmul_f32": "pair_matmul_kernelIfE"}
W2S = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 32768,
       65536)
# slab widths off the powers of two (the 1.5x grid's, and two that are
# not multiples of 4), each sorted in segments of the next power of two
PADDED_WS = (3, 6, 12, 100, 192, 384, 768, 1536, 3072, 6144, 8191)
# slab widths past 8192 off the powers of two, on the wide path: rows of
# 2 to 96 pieces of 8192 slots and 1 to 7 merge rounds, among them
# g500_s15_ef16's W = 12288, 98304, 393216 and 786432 classes and one
# whose last piece is short
WIDE_WS = (12288, 40000, 98304, 393216, 786432)
MATRICES = ("scircuit", "cage12", "webbase-1M")
# the gather frontend's phase: the benchmark's configurations (name,
# scale, R-MAT a / b / c, permuted and symmetric); their replanned plans
# hold gather classes of W = 192, 256, 384, 512, 768 (er_s17_ef16) and
# 393216, 786432 (g500_s15_ef16)
GATHER_RUNS = (("er_s17_ef16", 17, (0.25, 0.25, 0.25), False),
               ("g500_s15_ef16", 15, (0.57, 0.19, 0.19), True))
GATHER_SEED = 1234567890123
BD_MATRICES = ("pdb1HYS", "pwtk")
SOURCES = ("esc_tail", "pair_matmul", "ragged_fill", "planned",
           "remote_fetch", "gather_front")
PLANNED_MATRICES = ("scircuit", "webbase-1M")   # must run planned classes
REPLANNED_MATRIX = "cage12"                     # must be replanned
PLANNED_TIMING = "scircuit"
MASKED_MATRICES = ("scircuit", "cage12")
FILL_MATRIX = "cage12"
WARM_CALLS = 20
# the suite members whose classes take the tail's tile path, the config
# whose plan has them, and the tail form timed at their W=512 class:
# kernel row 1's tile entry at cage15's pre class, row 2's at cop20k_A's
# gather class
TILE_RUNS = (("cage15", "planned_off", "flat"),
             ("cop20k_A", "default", "slab"))
TILE_WARM_CALLS = 5
BD_WARM_CALLS = 10
DIST_WARM_CALLS = 5
# the DeviceCSR-level engines: masked stand-ins (cage12's 29,246,941
# products exceed masked_max_products and must raise), warm calls per
# timing, and the spgemm_dist(engine="esc") calls on DIST_SHARDS shards
DEVICE_MASKED = ("scircuit", "webbase-1M")
DEVICE_BUDGET_MATRIX = "cage12"
DEVICE_WARM_CALLS = 10
DEVICE_DIST_CALLS = (("scircuit", "replicate"), ("scircuit", "allgather"),
                     ("scircuit", "ragged"), ("cage12", "ragged"))
DIST_SHARDS = 8
HALO_DS = (1, 2, 4, 8)
HALO_VRS = (1, 3, 336, 5376)
# (matrix, strategy, comm_backend, dma_fill, overlap forced); on D=8
# shards of the one card, grid2d on 4 x 2
DIST_CALLS = (
    ("scircuit", "replicate", "xla", "auto", False),
    ("scircuit", "allgather", "xla", "auto", False),
    ("scircuit", "ragged", "xla", "auto", False),
    ("scircuit", "ragged", "pallas", "auto", False),
    ("scircuit", "ragged_overlap", "xla", "auto", False),
    ("scircuit", "ragged_overlap", "xla", "auto", True),
    ("scircuit", "grid2d", "xla", "auto", False),
    ("cage12", "ragged", "xla", "auto", False),
    ("cage12", "ragged", "pallas", "auto", False),
    ("cage12", "ragged", "pallas", "on", False),
    ("cage12", "allgather", "xla", "auto", False),
)
# the multi-process phase: (processes, shards per process, matrix, calls
# of parallel/worker.py) on the one card, D = 8 in every run
MP_RUNS = (
    (2, 4, "scircuit",
     tuple(f"bucketed:{s}:{b}" + (":force" if s == "ragged_overlap" else "")
           for s in ("replicate", "allgather", "ragged", "ragged_overlap",
                     "grid2d") for b in ("pallas", "xla"))
     + ("esc:replicate:xla", "esc:allgather:xla", "esc:ragged:xla")),
    (2, 4, "cage12", ("bucketed:ragged:pallas:turns", "bucketed:ragged:xla",
                      "bucketed:allgather:xla")),
    (8, 1, "scircuit", ("bucketed:ragged:pallas",)),
)
MP_WARM = 3                 # warm calls a call, and a turn's calls
MP_TIMEOUT_S = 240          # a run's ranks, start to end
HALO_SUBSETS = ((0, 4), (4, 4), (7, 1), (2, 3))    # (dst_first, count), D=8
# kernels the soak must reach (ragged_fill's count is printed: the cost
# model may not pick the fill on such small cases)
SOAK_MUST_LAUNCH = ("esc_tail_flat", "pgather", "proute", "pair_matmul_f64")
SUITE_DEADLINE_S = 600
SUITE_REWARM = ("cage12", "pdb1HYS")     # rerun warm from the plan cache
# proute's checks: (m, hold widths); the main path's networks run m from
# 1024 to 131072, scircuit's A routes m_a = 16384 with hold 2048 and
# 65536 with holds 64 and 1024
PROUTE_CASES = ((1024, (1, 8)), (16384, (1, 2048)),
                (32768, (1, 8, 2048, 32768)), (65536, (1, 64, 1024)),
                (131072, (1, 8, 2048, 32768)))
I32_MAX = 2**31 - 1
BS = 128


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tail_inputs(w2: int, nseg: int, seed: int):
    """Duplicate-heavy keys, one empty and one all-same-key segment,
    random valid lengths; invalid slots carry 2^31-1 and value 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 4), (nseg, w2)).astype(np.int32)
    n = rng.integers(0, w2 + 1, nseg)
    n[0] = 0
    keys[1] = 7
    n[1] = w2
    keys[np.arange(w2)[None, :] >= n[:, None]] = I32_MAX
    vals = rng.standard_normal((nseg, w2))
    vals[keys == I32_MAX] = 0.0
    return keys.reshape(-1), vals.reshape(-1)


def sorted_tail(torch, K, V):
    """The tail on ``[S, w2]`` by ``torch.sort`` and ``index_add_``,
    independent of the bitonic network and the scan that the kernel and
    its plain version share.  Returns (packed keys, packed sums in f64,
    the summed magnitudes of each packed key's terms, counts)."""
    S, w2 = K.shape
    sk, order = torch.sort(K, dim=1)
    sv = torch.gather(V, 1, order).double()
    valid = sk < I32_MAX
    head = valid.clone()
    head[:, 1:] &= sk[:, 1:] != sk[:, :-1]
    pos = (torch.arange(S, device=K.device)[:, None] * w2
           + torch.cumsum(head, dim=1) - 1)
    out_k = torch.full((S * w2,), I32_MAX, dtype=torch.int32,
                       device=K.device)
    out_k[pos[head]] = sk[head]
    out_v = torch.zeros(S * w2, dtype=torch.float64, device=K.device)
    mag = torch.zeros_like(out_v)
    out_v.index_add_(0, pos[valid], sv[valid])
    mag.index_add_(0, pos[valid], sv[valid].abs())
    return out_k, out_v, mag, head.sum(dim=1, dtype=torch.int32)


def check_sorted(torch, oK, oV, cnt, K, V, tol: float, label: str) -> float:
    """Kernel output against :func:`sorted_tail` on the masked inputs:
    keys and counts exact, values within ``tol`` of the summed
    magnitudes (at least 1).  Returns the max abs error."""
    rK, rV, mag, rc = sorted_tail(torch, K, V)
    check(torch.equal(oK.reshape(-1), rK), f"{label}: keys differ from "
          "the sort reference")
    check(torch.equal(cnt, rc), f"{label}: counts differ from the sort "
          "reference")
    err = (oV.reshape(-1).double() - rV).abs()
    check(bool((err <= tol * torch.clamp(mag, min=1.0)).all()),
          f"{label}: values differ from the sort reference: max abs err "
          f"{float(err.max())}")
    return float(err.max())


def kernel_phase(torch, et, dev) -> dict:
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    tols = {torch.float64: 1e-9, torch.float32: 1e-4}
    for dtype in (torch.float64, torch.float32):
        for w2 in W2S:
            nseg = max(4, (1 << 20) // w2)
            k, v = tail_inputs(w2, nseg, seed=w2)
            keys = torch.from_numpy(k).to(dev)
            vals = torch.from_numpy(v).to(dtype).to(dev)
            oK, oV, cnt = et.esc_tail_flat(keys, vals, w2=w2)
            torch.cuda.synchronize()
            pK, pV, pc = et.esc_tail_flat_plain(keys, vals, w2=w2)
            check(torch.equal(oK, pK), f"keys differ at w2={w2} {dtype}")
            check(torch.equal(cnt, pc), f"counts differ at w2={w2} {dtype}")
            err = (oV - pV).abs()
            check(torch.equal(oV, pV), f"values differ at w2={w2} {dtype}: "
                  f"max abs err {float(err.max())}")
            serr = check_sorted(torch, oK, oV, cnt, keys.view(nseg, w2),
                                vals.view(nseg, w2), tols[dtype],
                                f"esc_tail_flat w2={w2} {dtype}")
            errs[dtype] = max(errs[dtype], float(err.max()))
            print(f"kernel w2={w2:6d} {str(dtype):14s} slots={k.size:8d} "
                  f"path={et.path_for(w2)} "
                  f"max_abs_err={float(err.max()):.3e} "
                  f"sort_ref_err={serr:.3e} exact=True ok", flush=True)
    return errs


def slab_tail_phase(torch, et, dev) -> dict:
    """The slab form against its plain version: rows of W slots with
    counts under W (NaN values and random keys past them), an empty and a
    full row; W each power of two of ``W2S``, each padded width of
    ``PADDED_WS`` (sorted in segments of the next power of two) and each
    wide width of ``WIDE_WS`` (pieces of 8192 slots, the last one short
    where 8192 does not divide W, then merge rounds).  Keys, counts and
    values bit for bit against the plain version; keys and counts exact
    and values within the flat tail's tolerances against the sort
    reference."""
    errs = {torch.float64: 0.0, torch.float32: 0.0}
    tols = {torch.float64: 1e-9, torch.float32: 1e-4}
    for dtype in (torch.float64, torch.float32):
        for W in W2S + PADDED_WS + WIDE_WS:
            w2 = et.pad_w2(W)
            rows = max(4, (1 << 20) // w2)
            rng = np.random.default_rng(W + 1)
            keys = rng.integers(0, max(2, W // 4), (rows, W)).astype(
                np.int32)
            row_len = rng.integers(0, W, rows).astype(np.int32)
            row_len[0], row_len[1] = 0, W
            keys[1] = 7
            vals = rng.standard_normal((rows, W))
            vals[np.arange(W)[None, :] >= row_len[:, None]] = np.nan
            k, rl = (torch.from_numpy(x).to(dev) for x in (keys, row_len))
            v = torch.from_numpy(vals).to(dtype).to(dev)
            oK, oV, cnt = et.esc_tail(k, v, rl, w2=w2)
            torch.cuda.synchronize()
            pK, pV, pc = et.esc_tail_plain(k, v, rl, w2=w2)
            check(torch.equal(oK, pK), f"esc_tail keys differ at W={W}")
            check(torch.equal(cnt, pc), f"esc_tail counts differ at W={W}")
            err = (oV - pV).abs()
            check(torch.equal(oV, pV), f"esc_tail values differ at W={W} "
                  f"{dtype}: max abs err {float(err.max())}")
            live = (torch.arange(W, device=dev)[None, :]
                    < rl.long()[:, None])
            serr = check_sorted(torch, oK, oV, cnt,
                                torch.where(live, k, I32_MAX),
                                torch.where(live, v, 0.0), tols[dtype],
                                f"esc_tail W={W} {dtype}")
            errs[dtype] = max(errs[dtype], float(err.max()))
            print(f"kernel esc_tail W={W:6d} w2={w2:6d} {str(dtype):14s} "
                  f"rows={rows:7d} path={et.path_for(w2)} "
                  f"max_abs_err={float(err.max()):.3e} "
                  f"sort_ref_err={serr:.3e} exact=True ok", flush=True)
    return errs


def fill_kernel_phase(torch, rf, bk, dev) -> int:
    """ragged_fill against its plain version for 1, 2 and 3 planes at
    window rows 16 and 128, exact on the covered words (the rest are
    undefined).  Runs come from the planner's own grouping: full-window
    runs, runs crossing the half-window grid, and one zero-length run
    among the live ones."""
    rng = np.random.default_rng(3)
    err = 0
    for nplanes in (1, 2, 3):
        for wrows in (16, 128):
            SW = wrows * 64
            n = 4000
            ln = rng.integers(0, SW // 4 + 1, n)
            ln[:3] = [0, SW, SW - 1]
            dst = np.cumsum(rng.integers(0, 50, n) + ln) - ln
            out_slots = -(-int(dst[-1] + ln[-1]) // 128) * 128
            src = rng.integers(0, 40 * SW, n)
            live = ln > 0
            wr, rn = bk._group_runs(src[live], dst[live], ln[live], wrows,
                                    bk._FILL_EPG)
            rn[0, 0, 2] = 0
            rel = rn[:, :, 0].astype(np.int64) - 128
            crossing = int(((rel // SW) != ((rel + rn[:, :, 2] - 1) // SW))
                           [rn[:, :, 2] > 0].sum())
            check(crossing > 0, "no run crosses the half-window grid")
            pitch = (-(-(bk._FILL_BIAS_WORDS + 42 * SW) // 128) + wrows
                     + rf.PAD_ROWS)
            pairs = torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (nplanes * pitch, 128),
                dtype=np.int64).astype(np.int32)).to(dev)
            w, r = (torch.from_numpy(x[None]).to(dev) for x in (wr, rn))
            kw = dict(out_rows=nplanes * out_slots // 128, nplanes=nplanes,
                      src_stride_rows=pitch, dst_stride=out_slots)
            got = rf.ragged_fill(w, r, pairs, **kw)
            torch.cuda.synchronize()
            want = rf.ragged_fill_plain(w, r, pairs, **kw)
            cov = rf.ragged_fill_plain(w, r, torch.ones_like(pairs),
                                       **kw) != 0
            diff = int((got[cov].long() - want[cov].long()).abs().max())
            check(diff == 0,
                  f"ragged_fill differs: {nplanes} planes, wrows {wrows}")
            err = max(err, diff)
            print(f"kernel ragged_fill planes={nplanes} wrows={wrows:3d} "
                  f"steps={wr.shape[0]} runs={int(wr[:, 1].sum())} "
                  f"crossing={crossing} words={int(cov.sum())} "
                  f"max_abs_err={diff} ok", flush=True)
    return err


def planned_kernel_phase(torch, pn, dev) -> dict:
    """pgather and proute against their plain versions on every output
    word, and against the host's truth: the table read at each scheduled
    source, and out[dest] = in.  All exact.  pgather runs with planes 0-1
    and with planes 1-2 the two words of one f64 array (the 8-byte load)
    and with no such pair; proute at the main path's widths and holds
    (PROUTE_CASES), 1 to 3 planes, on planned routes and random mask bits.
    Returns the max abs errors (0 when the run gets here)."""
    rng = np.random.default_rng(4)
    for S, T in ((30000, 2000), (100000, 600000)):
        src = rng.integers(0, T, S).astype(np.int64)
        wblk, rowsel, lane, perm = pn.plan_pgather(src, T)
        sched = [torch.from_numpy(x).to(dev) for x in (wblk, rowsel, lane)]
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, (T, 2), dtype=np.int64).astype(
                np.int32)).to(dev)
        w0, w1, other = words[:, 0], words[:, 1], words[:, 0].contiguous() ^ 5
        live = np.flatnonzero(perm >= 0)
        at = torch.from_numpy(src[perm[live]]).to(dev)
        lv = torch.from_numpy(live).to(dev)
        for label, tabs, pair in (
                ("1 plane", [w0], -1), ("pair 0-1", [w0, w1], 0),
                ("pair 0-1 of 3", [w0, w1, other], 0),
                ("pair 1-2", [other, w0, w1], 1),
                ("no pair", [w1, w0, other], -1)):
            check(pn._f64_pair(tabs) == pair,
                  f"pgather planes {label}: pair {pn._f64_pair(tabs)}")
            out = pn.pgather(tabs, *sched)
            torch.cuda.synchronize()
            check(torch.equal(out, pn.pgather_plain(tabs, *sched)),
                  f"pgather differs from its plain version ({S}, {T}, "
                  f"{label})")
            check(all(torch.equal(out[p][lv], t[at])
                      for p, t in enumerate(tabs)),
                  "pgather differs from the table at its sources")
            print(f"kernel pgather {label} sources={S} table={T} "
                  f"blocks={wblk.size} exact ok", flush=True)
    for m, holds in PROUTE_CASES:
        nb = 3
        dest = np.stack([rng.permutation(m) for _ in range(nb)])
        srcs = rng.integers(0, 4 * m, (nb, m // 4))
        routes = []
        for b in range(nb):          # a planned route: schedule -> slots
            sch = pn.plan_pgather(srcs[b], 0)
            if sch[3].size <= m:
                routes.append(pn.route_dest(sch[3], m, rng.permutation(m)))
        dest = np.concatenate([dest, np.stack(routes)]) if routes else dest
        nb = dest.shape[0]
        masks, nst = pn.plan_routes(dest)
        mk = torch.from_numpy(masks).to(dev)
        rand = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, masks.shape, dtype=np.int64).astype(
                np.int32)).to(dev)
        d = torch.from_numpy(dest).to(dev)
        for nplanes in (1, 2, 3):
            x = torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (nplanes, nb, m), dtype=np.int64).astype(
                    np.int32)).to(dev)
            fl = torch.from_numpy((rng.random((nb, m)) < 0.1).astype(
                np.int32)).to(dev)
            fl[:, ::8] = 1
            fl[0, : m // 2] = 0      # long unflagged runs, whole segments
            for hold in holds:
                for masks_ in (mk, rand):
                    out = pn.proute(x, masks_, nst, hold_w2=hold, flags=fl)
                    torch.cuda.synchronize()
                    check(torch.equal(out, pn.proute_plain(
                        x, masks_, nst, hold_w2=hold, flags=fl)),
                        f"proute differs from its plain version (m={m}, "
                        f"hold {hold}, {nplanes} planes)")
                if hold == 1:
                    want = torch.empty_like(x)
                    for b in range(nb):
                        want[:, b, d[b]] = x[:, b]
                    check(torch.equal(pn.proute(x, mk, nst), want),
                          f"proute differs from out[dest] = in (m={m})")
                print(f"kernel proute m={m} networks={nb} planes={nplanes} "
                      f"hold={hold} exact ok", flush=True)
    return {"pgather": 0.0, "proute": 0.0}


def extraction_kind(plan) -> str:
    """Which extraction a warm call of ``plan`` runs (the order of
    ``extract_warm``)."""
    if plan.ext is not None:
        return "windowed"
    return "planned" if plan.ext_pf is not None else "gather"


def gather_front_phase(torch, mt, bk, gf, dev) -> dict:
    """The gather frontend's kernel against its plain version on the
    gather classes of the benchmark's two configurations (``GATHER_RUNS``:
    the generator and seed of ``spgemm_bench``, planned by the pipeline
    with the card's modes, so replanned onto the 1.5x grid): K, the
    products' bits and the row counts equal; then each class timed
    (CUDA events) beside its plain version, one ``index_select`` of B's
    columns and values at the covered slots' sources (the same words
    read) and its byte bound (:func:`gather_bound_ms`).  Returns, per
    configuration, the sums and the classes' rows; ``timed_launches``,
    this phase's own launches; and ``max_abs_err``, the largest
    difference of the compared products."""
    from spgemm_bench import gen as sg
    gf.gather_front.launches = 0
    out, err = {}, 0.0
    for name, scale, abc, sym in GATHER_RUNS:
        M = sg.rmat(scale, 16, *abc, permute=sym, symmetric=sym,
                    rng=np.random.default_rng([GATHER_SEED, 0]))
        A = mt.CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
        st = mt.pipeline.prepare_bucketed_state(A, A, mt.SpGEMMConfig(),
                                                device=dev)
        plan = st.plan
        bk.upload_plan(plan, dev)
        cls = [(c, d) for c, d in zip(plan.classes, plan.dev)
               if c.frontend == "gather"]
        check(bool(cls), f"{name}'s plan has no gather class")
        a_val = torch.from_numpy(A.val).to(dev)
        b_val = a_val
        b_col = torch.from_numpy(A.col.astype(np.int32)).to(dev)
        rows, tot = [], dict.fromkeys(("ms", "plain_ms", "library_ms"),
                                      0.0)
        for c, d in cls:
            args = (d, a_val, b_col, b_val)
            kw = dict(W=c.W, rb=c.rb)
            K, prod, rl = bk.front_gather(*args, **kw)
            pK, pP, valid = bk.front_gather_plain(*args, **kw)
            check(torch.equal(K, pK)
                  and torch.equal(prod.view(torch.int64),
                                  pP.view(torch.int64))
                  and torch.equal(rl, valid.sum(dim=1, dtype=torch.int32)),
                  f"gather_front differs from its plain version on "
                  f"{name}'s W={c.W} class")
            err = max(err, float((prod - pP).abs().max()))
            del K, prod, rl, pK, pP, valid
            live = c.ent_len.astype(np.int64).ravel()
            start = c.ent_src.astype(np.int64).ravel()[live > 0]
            live = live[live > 0]
            src = (np.repeat(start - np.concatenate([[0], np.cumsum(
                live)[:-1]]), live) + np.arange(int(live.sum())))
            idx = torch.from_numpy(src).to(dev)
            slots = c.nchunks * c.rb * c.W
            row = {"W": c.W, "rows": int((c.rows_g >= 0).sum()),
                   "slots": slots, "live": int(live.sum()),
                   "ms": cuda_ms(lambda: bk.front_gather(*args, **kw), 20),
                   "plain_ms": cuda_ms(
                       lambda: bk.front_gather_plain(*args, **kw), 3,
                       warmup=1),
                   "library_ms": cuda_ms(
                       lambda: (b_col.index_select(0, idx),
                                b_val.index_select(0, idx)), 20),
                   "bound_ms": gather_bound_ms(slots, int(live.sum()),
                                               A.nnz)}
            del idx
            for k in tot:
                tot[k] += row[k]
            rows.append(row)
            print(f"gather_front {name} W={c.W} rows={row['rows']} "
                  f"slots={slots} live={row['live']}: {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, index_select "
                  f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                  f" ms, exact=True", flush=True)
        tot["bound_ms"] = gather_bound_ms(
            sum(r["slots"] for r in rows), sum(r["live"] for r in rows),
            A.nnz)
        out[name] = dict(tot, classes=rows)
        print(f"gather_front {name} all {len(rows)} classes: "
              f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"index_select {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms", flush=True)
    out["timed_launches"] = gf.gather_front.launches
    out["max_abs_err"] = err
    check(out["timed_launches"] > 0, "gather_front never launched")
    return out


def gather_bound_ms(slots: int, live: int, nnz_b: int) -> float:
    """The gather frontend's byte bound in f64, as
    ``front.gather_roofline_pct`` counts it: 12 B written a slot, and 12 B
    read for each of B's nonzeros that the ``live`` covered slots read, at
    most ``nnz_b`` (B's repeated reads can come from L2)."""
    return 12 * (slots + min(live, nnz_b)) / HBM_BYTES_PER_S * 1e3


def main_path_phase(torch, mt, et, rf, pn, gf, dev):
    """Drive the main path on every stand-in; the tail kernels',
    ragged_fill's and gather_front's launch counts are set to 0 just
    before and read just after.  Returns (states, oracles, matrices,
    launches)."""
    from mh_spgemm_torch.io.suites import load_matrix
    from mh_spgemm_torch.pipeline import spgemm_bucketed
    kept, refs, mats = {}, {}, {}
    counted = (et.esc_tail_flat, et.esc_tail, rf.ragged_fill, pn.pgather,
               pn.proute, gf.gather_front)
    for fn in counted:
        fn.launches = 0
    for name in MATRICES:
        t0 = time.perf_counter()
        A = mats[name] = load_matrix(name)
        ref = refs[name] = mt.oracle_spgemm(A, A)
        setup_s = time.perf_counter() - t0
        intprod = A.intprod(A)
        engine = mt.choose_engine(A, A, mt.SpGEMMConfig(mode="auto"))
        torch.cuda.reset_peak_memory_stats()
        C = mt.spgemm_host(A, device=dev)
        check(C.equals(ref, tol=1e-9), f"{name}: spgemm_host != oracle")
        tm = mt.Timing()
        t0 = time.perf_counter()
        Cd, state = spgemm_bucketed(A, A, timing=tm, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(Cd.host().equals(ref, tol=1e-9), f"{name}: cold != oracle")
        plan = state.plan
        per_call = dict(plan.tail_slots)      # this plan ran once (cold)
        out = {}

        def warm():
            out["C"], _ = spgemm_bucketed(A, A, state=state)

        ms = cuda_ms(warm, WARM_CALLS, warmup=1)
        check(out["C"].host().equals(ref, tol=1e-9),
              f"{name}: warm != oracle")
        row = {
            "matrix": name, "auto_engine": engine, "rows": A.M,
            "nnz_a": A.nnz, "intprod": intprod, "nnz_c": ref.nnz,
            "warm_ms": ms, "gflops": mt.gflops(intprod, ms),
            "cold_ms": cold_ms, "setup_s": setup_s,
            "plan_s": tm.symbolic_binning / 1e3,
            "cold_readback_ms": tm.malloc_c_col_val,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "planned": state.planned, "replanned": state.replanned,
            "widths": [c.W for c in plan.classes],
            "chunks": [c.nchunks for c in plan.classes],
            "frontends": [c.frontend for c in plan.classes],
            "networks": [c.pf_spec[:4] for c in plan.classes if c.pf],
            "extraction": extraction_kind(plan),
            "windowed_extraction": plan.ext is not None,
            "slots_per_call": per_call,
        }
        print("main " + json.dumps(row), flush=True)
        kept[name] = state
        del Cd, C, out
    launches = {fn.__name__: fn.launches for fn in counted}
    print("main launches " + json.dumps(launches), flush=True)
    for name in PLANNED_MATRICES:
        check(any(c.pf for c in kept[name].plan.classes),
              f"{name} runs no planned class")
    kind = extraction_kind(kept[PLANNED_TIMING].plan)
    check(kind in ("planned", "windowed"),
          f"{PLANNED_TIMING}'s warm call extracts by the {kind}")
    print(f"{PLANNED_TIMING}'s warm call extracts by the {kind} copy"
          + (" (dma_fill='auto' picked the windowed copy, which takes "
             "precedence as in the JAX package)" if kind == "windowed"
             else ""), flush=True)
    check(kept[REPLANNED_MATRIX].replanned,
          f"{REPLANNED_MATRIX} was not replanned")
    print(f"{REPLANNED_MATRIX}: replanned by the legacy-replan rule "
          f"(classes {[(c.W, c.frontend) for c in kept[REPLANNED_MATRIX].plan.classes]})",
          flush=True)
    check(kept[FILL_MATRIX].plan.ext is not None,
          f"{FILL_MATRIX}'s extraction is not windowed")
    for fn in ("esc_tail_flat", "ragged_fill", "pgather", "proute",
               "gather_front"):
        check(launches[fn] > 0, f"{fn} was not launched on the main path")
    return kept, refs, mats, launches


def planned_vs_off_phase(torch, mt, mats: dict, refs: dict, states: dict,
                         dev) -> dict:
    """Each stand-in under the default config (planned "auto", on on the
    card) against planned="off": cold calls (host wall clock, planning
    and the first readback included) and warm calls (CUDA events), in
    turns (default, off, off, default).  Every C against the oracle.
    Returns the planned="off" states."""
    from mh_spgemm_torch.pipeline import spgemm_bucketed
    off_cfg = mt.SpGEMMConfig(planned="off")
    off_states = {}
    for name in MATRICES:
        A, ref = mats[name], refs[name]
        cfgs = {"default": mt.SpGEMMConfig(), "off": off_cfg}
        cold = {"default": [], "off": []}
        warm = {"default": [], "off": []}
        st = {"default": states[name]}
        for which in ("default", "off", "off", "default"):
            t0 = time.perf_counter()
            C, s_ = spgemm_bucketed(A, A, config=cfgs[which], device=dev)
            cold[which].append((time.perf_counter() - t0) * 1e3)
            check(C.host().equals(ref, tol=1e-9),
                  f"{name} ({which}): cold != oracle")
            st.setdefault(which, s_)
            del C, s_
        for which in ("default", "off", "off", "default"):
            out = {}

            def warm_call():
                out["C"], _ = spgemm_bucketed(A, A, config=cfgs[which],
                                              state=st[which])

            warm[which].append(cuda_ms(warm_call, WARM_CALLS, warmup=1))
            check(out["C"].host().equals(ref, tol=1e-9),
                  f"{name} ({which}): warm != oracle")
            del out
        off_states[name] = st["off"]
        for which in ("default", "off"):    # where a warm call's time goes
            prof = device_profile(torch, lambda: spgemm_bucketed(
                A, A, config=cfgs[which], state=st[which]), reps=3,
                whole=False)
            wm = min(warm[which])
            top = dict(list(prof["by_name"].items())[:8])
            print("warm_profile " + json.dumps({
                "matrix": name, "config": which, "warm_ms": wm,
                "busy_ms": prof["busy_ms"], "kernels": prof["kernels"],
                "idle_share": 1.0 - prof["busy_ms"] / wm, "top": top,
                "partial": prof["partial"],
                "profile_attempts": prof["attempts"]}), flush=True)
        row = {"matrix": name, "warm_ms": warm, "cold_ms": cold,
               "frontends": {k: [(c.W, c.frontend) for c in v.plan.classes]
                             for k, v in st.items()},
               "extraction": {k: extraction_kind(v.plan)
                              for k, v in st.items()}}
        print("planned_vs_off " + json.dumps(row), flush=True)
    return off_states


def tail_classes(et, bk, state) -> list:
    """Each class's tail of ``state``'s plan timed alone (CUDA events over
    10 calls on its frontend's output): W, the route (the kernel's path
    as ``esc_tail.path_for`` names ``csrc/esc_tail.cu``'s dispatch:
    ``warp`` / ``tile`` / ``wide``; ``direct`` for W = 1; ``sort``),
    rows, slots, ms and the
    byte bound (each slot's key and value read once and written once)."""
    plan = state.plan
    ops = (state.a_val, state.b_col, state.b_val, state.pairs)
    out = []
    for c, d in zip(plan.classes, plan.dev):
        front = bk.class_front(c, d, *ops)
        counts = {"direct": 0, "kernel": 0, "sort": 0}

        def tail():
            return bk.class_tail(c, front, route=state.route, counts=counts)

        tail()
        route = max(counts, key=counts.get)
        rows = c.nchunks * c.rb
        slots = rows * c.W
        nbytes = slots * (4 + front[1].element_size()) * 2
        out.append({"W": c.W, "route": (et.path_for(et.pad_w2(c.W))
                                         if route == "kernel" else route),
                    "rows": rows, "slots": slots, "ms": cuda_ms(tail, 10),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        del front
    return out


def breakdown_phase(et, bk, states: dict, label: str = "stages") -> dict:
    """Device time of a warm call's three stages, each timed alone over
    all classes: the frontends, the tails (the kernels, plus the direct
    W = 1 path and the wide-sort tail) and the extraction, by the static
    gather and, where the plan has it, by the windowed copy; then each
    class's tail alone with its route (``tail_classes``).  Returns the
    extraction times per matrix."""
    ext_ms = {}
    for name, state in states.items():
        plan = state.plan
        ops = (state.a_val, state.b_col, state.b_val, state.pairs)
        counts = {"direct": 0, "kernel": 0, "sort": 0}

        def front():
            return [bk.class_front(c, d, *ops)
                    for c, d in zip(plan.classes, plan.dev)]

        fronts = front()

        def tails():
            return [bk.class_tail(c, f, route=state.route, counts=counts)
                    for c, f in zip(plan.classes, fronts)]

        slabs = tails()
        ext_src = bk.static_dev(plan)[0]
        row = {"matrix": name,
               "frontend_ms": cuda_ms(front, 10),
               "tail_ms": cuda_ms(tails, 10),
               "extract_gather_ms": cuda_ms(
                   lambda: bk.bucketed_extract_static(
                       slabs, ext_src, nnz_c=plan.nnz_c), 10)}
        if plan.ext is not None:
            row["extract_windowed_ms"] = cuda_ms(
                lambda: bk.bucketed_extract_windowed(
                    slabs, plan.ext, nnz_cap=plan.nnz_cap,
                    nnz_c=plan.nnz_c), 10)
        elif plan.ext_pf is not None:
            row["extract_planned_ms"] = cuda_ms(
                lambda: bk.extract_warm(plan, slabs), 10)
        ext_ms[name] = row
        print(f"{label} " + json.dumps(row), flush=True)
        del fronts, slabs
        print("tail_classes " + json.dumps({
            "matrix": name, "config": label,
            "classes": tail_classes(et, bk, state)}), flush=True)
    return ext_ms


def folded_sort_ms(torch, K, w2: int) -> float:
    """``torch.sort`` of a tail's slots with the segment folded into the
    key (segment << 32 | key, one flat int64 sort)."""
    seg = torch.arange(K.numel() // w2, device=K.device,
                       dtype=torch.int64).repeat_interleave(w2) << 32
    folded = seg | K.reshape(-1).to(torch.int64)
    del seg
    return cuda_ms(lambda: torch.sort(folded), 5)


def widest_pre(bk, state):
    """The frontend's output (keys, products) of the widest pre class of
    ``state``, and its width."""
    plan = state.plan
    i = max((j for j, c in enumerate(plan.classes) if c.pre and c.W > 1),
            key=lambda j: plan.classes[j].W * plan.classes[j].rb
            * plan.classes[j].nchunks)
    d = plan.dev[i]
    K, prod, _ = bk.expand_pre(d["slot_src"], d["slot_aidx"], state.a_val,
                               state.b_col, state.b_val)
    return K, prod, plan.classes[i].W


def time_tail(torch, et, K, prod, w2: int, label: str, rl=None) -> dict:
    """One tail on a class's frontend output, which must equal its plain
    version bit for bit, timed beside the plain version, ``torch.sort``
    by segment and with the segment folded into the key, and its bound.
    With ``rl`` None, ``esc_tail_flat`` on the flat planes of a pre class;
    else ``esc_tail`` on ``[rows, w2]`` slabs with row counts ``rl``.  The
    bound's bytes: each key the function reads (every key of the flat
    form; those under the row counts of the slab form, and the counts),
    the value of each live slot among them (an empty slot's value is
    never used), every output slot's key and value written and the
    counts written."""
    name = "esc_tail_flat" if rl is None else "esc_tail"
    fn, plain = getattr(et, name), getattr(et, name + "_plain")
    args = (K, prod) if rl is None else (K, prod, rl)
    got = fn(*args, w2=w2)
    want = plain(*args, w2=w2)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name} differs from its plain version on {label} W={w2}")
    cnt = want[2]
    del got, want
    ms = cuda_ms(lambda: fn(*args, w2=w2), 20)
    plain_ms = cuda_ms(lambda: plain(*args, w2=w2), 3, warmup=1)
    Kr = K.view(-1, w2)
    lib_ms = cuda_ms(lambda: torch.sort(Kr, dim=1), 20)
    sort_ms = folded_sort_ms(torch, K, w2)
    rows, slots = Kr.shape[0], K.numel()
    live = Kr < I32_MAX
    if rl is None:
        keys_read, extra = slots, cnt.numel() * 4
    else:
        under = torch.arange(w2, device=K.device)[None, :] < rl[:, None]
        live &= under
        keys_read, extra = int(under.sum()), rows * 8
        del under
    nlive = int(live.sum())
    del live
    adds = nlive - int(cnt.sum())             # additions the tail must do
    esize = prod.element_size()
    nbytes = keys_read * 4 + nlive * esize + slots * (4 + esize) + extra
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP64_FLOPS * 1e3
    print(f"timing {name} on {label} W={w2} ({rows} rows, {slots} slots, "
          f"{nlive} live) path={et.path_for(w2)}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (equal bit for bit), torch.sort by segment "
          f"{lib_ms:.4f} ms, folded {sort_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes} B, {adds} adds)",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "sort_folded_ms": sort_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "w2": w2, "slots": slots, "live_slots": nlive,
            "path": et.path_for(w2), "exact": True}


def widest_front(bk, state, want):
    """The frontend's output of the widest class of ``state`` (by slots)
    with W > 1 that ``want`` picks, and its width."""
    plan = state.plan
    i = max((j for j, c in enumerate(plan.classes) if want(c) and c.W > 1),
            key=lambda j: plan.classes[j].W * plan.classes[j].rb
            * plan.classes[j].nchunks)
    c, d = plan.classes[i], plan.dev[i]
    return bk.class_front(c, d, state.a_val, state.b_col, state.b_val,
                          state.pairs), c.W


def tile_phase(torch, mt, et, bk, dev) -> tuple:
    """The suite members of ``TILE_RUNS`` under the config whose plan
    sends their classes through the tail's tile path: each cold and warm
    (``TILE_WARM_CALLS``), both Cs against the oracle's digest in
    ``data/oracle_digest.json``; the tails' launch counts set to 0 before
    each and read after its warm calls; its ``tail_classes`` line; then
    its named tail form timed at its widest class of that form on the
    tile path, on the frontend's own output.  Returns (flat timing, slab
    timing, launches)."""
    from mh_spgemm_torch.baseline import digest_check, digest_device
    from mh_spgemm_torch.bench.suite import oracle_entry
    from mh_spgemm_torch.io.suites import load_matrix
    from mh_spgemm_torch.pipeline import spgemm_bucketed
    tails = (et.esc_tail_flat, et.esc_tail)
    launches = {fn.__name__: 0 for fn in tails}
    timed = {}
    for name, which, form in TILE_RUNS:
        A = load_matrix(name)
        cfg = (mt.SpGEMMConfig(planned="off") if which == "planned_off"
               else mt.SpGEMMConfig())
        want = oracle_entry(name, A, A)["digest"]
        for fn in tails:
            fn.launches = 0
        t0 = time.perf_counter()
        C, state = spgemm_bucketed(A, A, config=cfg, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        ok, why = digest_check(digest_device(C), want)
        check(ok, f"{name} ({which}) cold: {why}")
        del C
        out = {}

        def warm():
            out["C"], _ = spgemm_bucketed(A, A, config=cfg, state=state)

        ms = cuda_ms(warm, TILE_WARM_CALLS, warmup=1)
        ok, why = digest_check(digest_device(out["C"]), want)
        check(ok, f"{name} ({which}) warm: {why}")
        del out
        ran = {fn.__name__: fn.launches for fn in tails}
        check(sum(ran.values()) > 0, f"{name} ({which}) launched no tail")
        for k, v in ran.items():
            launches[k] += v
        print("tile_matrix " + json.dumps({
            "matrix": name, "config": which, "cold_ms": cold_ms,
            "warm_ms": ms, "launches": ran, "check": "pass",
            "classes": [(c.W, c.frontend, c.nchunks * c.rb)
                        for c in state.plan.classes]}), flush=True)
        print("tail_classes " + json.dumps({
            "matrix": name, "config": which,
            "classes": tail_classes(et, bk, state)}), flush=True)
        label = f"{name} ({which})"
        if form == "flat":
            K, prod, w2 = widest_pre(bk, state)
            rl = None
        else:
            (K, prod, rl), w2 = widest_front(bk, state,
                                             lambda c: not c.pre)
        check(et.path_for(w2) == "tile",
              f"{label}'s widest {form} class W={w2} is not on the tile path")
        timed[form] = time_tail(torch, et, K, prod, w2, label, rl=rl)
        del K, prod, rl, state, A
        torch.cuda.empty_cache()
    check(all(v > 0 for v in launches.values()),
          f"the tile phase launched a tail no time: {launches}")
    return timed["flat"], timed["slab"], launches


def time_slab_tail(torch, et, bk, state) -> dict:
    """The slab form on the forced-fill plan's widest fill class, on the
    fill frontend's own output (raw slab, the plan's row counts)."""
    (K, prod, rl), w2 = widest_front(bk, state, lambda c: c.fill)
    return time_tail(torch, et, K, prod, w2,
                     f"{FILL_MATRIX}'s forced-fill class", rl=rl)


def time_fill(torch, rf, bk, state) -> dict:
    """ragged_fill at the shapes of cage12's windowed extraction, on the
    stream of its own warm slabs; checked against the plain version on
    the covered words first."""
    plan, ext = state.plan, state.plan.ext
    slabs = bk.bucketed_main(plan, state.a_val, state.b_col, state.b_val,
                             state.pairs, route=state.route)
    stream = bk.extract_stream(slabs, ext)
    del slabs
    win_row, runs = bk._ext_dev(ext, stream.device)
    kw = dict(out_rows=ext.nplanes * ext.cap_slots // 128,
              nplanes=ext.nplanes, src_stride_rows=ext.area_pad // 128,
              dst_stride=ext.cap_slots)
    got = rf.ragged_fill(win_row, runs, stream, **kw)
    want = rf.ragged_fill_plain(win_row, runs, stream, **kw)
    cov = rf.ragged_fill_plain(win_row, runs, torch.ones_like(stream),
                               **kw) != 0
    check(torch.equal(got[cov], want[cov]),
          "ragged_fill differs from its plain version on the extraction")
    words = int(cov.sum())
    check(words == plan.nnz_c * ext.nplanes,
          f"the extraction runs cover {words} words, not nnz(C) x planes")
    del got, want, cov
    ms = cuda_ms(lambda: rf.ragged_fill(win_row, runs, stream, **kw), 20)
    plain_ms = cuda_ms(lambda: rf.ragged_fill_plain(win_row, runs, stream,
                                                    **kw), 3, warmup=1)
    src = torch.as_tensor(plan.ext_src_h[: plan.nnz_c]).to(
        stream.device).long()
    idx = torch.cat([src + bk._FILL_BIAS_WORDS + p * ext.area_pad
                     for p in range(ext.nplanes)])
    flat = stream.view(-1)
    lib_ms = cuda_ms(lambda: torch.index_select(flat, 0, idx), 20)
    nbytes = words * 8                  # each copied word read and written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"timing ragged_fill on {FILL_MATRIX}'s windowed extraction "
          f"({ext.nchunks} chunks, {int(ext.win_row[:, :, 1].sum())} runs, "
          f"{words} words in {ext.nplanes} planes): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes} B)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "words": words}


def schedule_words(torch, wblk, rowsel, lane):
    """The table word each output position of a pgather schedule reads
    (the kernel's index arithmetic), flat int64."""
    ln = lane.reshape(-1, 8, 128).long() & 127
    rs = rowsel.reshape(-1, 8, 128).long()
    return ((wblk.reshape(-1).long()[:, None, None] * 64
             + torch.gather(rs, 2, ln)) * 128 + ln).reshape(-1)


def time_pgather(torch, pn, tabs, sched, label: str) -> dict:
    """pgather on a schedule beside its plain version, one index_select of
    the stacked planes by the same word indices, and its bound: each
    lane and rowsel word and each wblk entry read once, each table word
    the schedule names read once per plane, each output word written
    once.  ``ms`` is a wrapper call; ``launch_ms`` the C entry alone on
    prebuilt arguments (no checks, no allocation); ``host_us`` the host
    time of each (the wall clock of 200 back-to-back calls, none of which
    waits for the card).  Where two planes are one f64 array's words, the
    C entry also runs with the 8-byte load off (``apart``), on the same
    planes."""
    wblk, rowsel, lane = sched
    ms = cuda_ms(lambda: pn.pgather(tabs, *sched), 100)
    out = pn.pgather(tabs, *sched)
    lib = pn._lib()
    P = len(tabs)
    pair = pn._f64_pair(tabs)
    args = []
    for t in list(tabs) + [tabs[0]] * (3 - P):
        args += [t.data_ptr(), t.stride(0), t.numel()]
    tail = [wblk.data_ptr(), rowsel.data_ptr(), lane.data_ptr(),
            wblk.numel(), out.data_ptr(), out[0].numel(),
            torch.cuda.current_stream().cuda_stream]
    runs = {"pair": args + [P, pair] + tail}
    if pair >= 0:
        runs["apart"] = args + [P, -1] + tail
    launch_ms, device_ms, attempts = {}, {}, {}
    for key, a in runs.items():
        launch_ms[key] = cuda_ms(lambda: lib.pgather(*a), 100)
        check(torch.equal(out, pn.pgather(tabs, *sched)),
              f"pgather's launch alone ({key}) differs on {label}")
        prof = device_profile(torch, lambda: lib.pgather(*a))
        device_ms[key], attempts[key] = prof["busy_ms"], prof["attempts"]
    host_us = {}
    for key, fn in (("call", lambda: pn.pgather(tabs, *sched)),
                    ("launch", lambda: lib.pgather(*runs["pair"]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[key] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: pn.pgather_plain(tabs, *sched), 5)
    idx = schedule_words(torch, wblk, rowsel, lane)
    n = tabs[0].numel()
    idx = idx.clamp(0, n - 1)
    stacked = torch.stack([t.contiguous() for t in tabs])
    check(torch.equal(pn.pgather(tabs, *sched).reshape(len(tabs), -1),
                      torch.index_select(stacked, 1, idx)),
          f"pgather differs from index_select on {label}")
    lib_ms = cuda_ms(lambda: torch.index_select(stacked, 1, idx), 100)
    pos = idx.numel()
    distinct = int(torch.unique(idx).numel())
    nbytes = pos * 8 + wblk.numel() * 4 + distinct * 4 * P + pos * 4 * P
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    apart = (f"; 8-byte load off: the launch alone {launch_ms['apart']:.4f}"
             f" ms, device time {device_ms['apart']:.4f} ms"
             if pair >= 0 else "")
    print(f"timing pgather on {label} ({P} planes, f64 pair {pair}, "
          f"{wblk.numel()} blocks, {pos} positions, {distinct} distinct "
          f"words): {ms:.4f} ms (the launch alone {launch_ms['pair']:.4f} "
          f"ms, device time {device_ms['pair']:.4f} ms{apart}), host "
          f"{host_us['call']:.2f} us a call, {host_us['launch']:.2f} us a "
          f"launch alone, plain {plain_ms:.4f} ms, index_select "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B)",
          flush=True)
    return {"ms": ms, "launch_ms": launch_ms["pair"],
            "device_ms": device_ms["pair"],
            "apart_launch_ms": launch_ms.get("apart"),
            "apart_device_ms": device_ms.get("apart"),
            "host_us": host_us, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "positions": pos, "profile_attempts": attempts}


def time_proute(torch, pn, x, masks, nst, dest, label: str, hold: int = 1,
                flags=None) -> dict:
    """proute beside its plain version and its bound: the mask words read
    once, each plane read and written once, the flags read once.  Without
    the hold also one index_copy_ by the host-simulated destinations
    (``dest``), which must agree with it; with the hold there is no one
    PyTorch call for the function (library_ms None).  ``ms`` is a wrapper
    call; ``launch_ms`` the C entry alone on prebuilt arguments."""
    kw = {"hold_w2": hold, "flags": flags} if hold > 1 else {}
    ms = cuda_ms(lambda: pn.proute(x, masks, nst, **kw), 100)
    lib = pn._lib()
    P, nb, m = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty(lib.proute_scratch_words(P, nb, m, hold),
                          dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    fptr = flags.data_ptr() if hold > 1 else None
    launch_ms = cuda_ms(lambda: lib.proute(
        x.data_ptr(), nb * m, out.data_ptr(), scratch.data_ptr(), nb * m, P,
        masks.data_ptr(), fptr, nb, m, nst, hold, stream), 100)
    check(torch.equal(out, pn.proute(x, masks, nst, **kw)),
          f"proute's launch alone differs from a call on {label}")
    prof = device_profile(torch, lambda: lib.proute(
        x.data_ptr(), nb * m, out.data_ptr(), scratch.data_ptr(), nb * m, P,
        masks.data_ptr(), fptr, nb, m, nst, hold, stream))
    device_ms = prof["busy_ms"]
    tile = 1 << lib.proute_tile_log(m.bit_length() - 1, nb * m)
    plain_ms = cuda_ms(lambda: pn.proute_plain(x, masks, nst, **kw), 3,
                       warmup=1)
    check(torch.equal(out, pn.proute_plain(x, masks, nst, **kw)),
          f"proute differs from its plain version on {label}")
    lib_ms = None
    if hold == 1:
        flat_dest = (dest + torch.arange(nb, device=x.device)[:, None] * m
                     ).reshape(-1)
        flat_x = x.reshape(P, -1)
        ref = torch.empty_like(flat_x)
        ref.index_copy_(1, flat_dest, flat_x)
        check(torch.equal(out.reshape(P, -1), ref),
              f"proute differs from index_copy_ on {label}")
        lib_ms = cuda_ms(lambda: ref.index_copy_(1, flat_dest, flat_x), 100)
    nbytes = (masks.numel() * 4 + 2 * x.numel() * 4
              + (flags.numel() * 4 if hold > 1 else 0))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lib_txt = f"index_copy_ {lib_ms:.4f} ms" if lib_ms is not None else \
        "no library call"
    print(f"timing proute on {label} ({P} planes, {nb} networks of {m}, "
          f"{nst} stages, hold {hold}, tile {tile}): {ms:.4f} ms (the "
          f"launch alone {launch_ms:.4f} ms, device time {device_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, {lib_txt}, bound {bound_ms:.4f} "
          f"ms ({nbytes} B); kernels "
          + json.dumps({k: [v["launches"], round(v["ms"], 5)]
                        for k, v in prof["by_name"].items()}), flush=True)
    return {"ms": ms, "launch_ms": launch_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "m": m, "networks": nb, "hold": hold,
            "tile": tile, "profile_attempts": prof["attempts"]}


def time_planned(torch, pn, bk, state) -> dict:
    """pgather and proute at the shapes of scircuit's widest planned class
    (its B route: column and value words of B) and of its planned
    extraction (the warm slabs' words), each on the main path's own
    schedules.  The destinations for the index_copy_ yardstick come from
    the host schedules, independent of the masks."""
    plan = state.plan
    i = max((j for j, c in enumerate(plan.classes) if c.pf),
            key=lambda j: plan.classes[j].pf_spec[0]
            * plan.classes[j].nchunks)
    c, d = plan.classes[i], plan.dev[i]
    m_b, nst_b = c.pf_spec[:2]
    label = (f"{PLANNED_TIMING}'s W={c.W} class ({c.nchunks} chunks, "
             f"m={m_b})")
    tabs = [state.b_col] + bk._words(state.b_val)
    sched = (d["bg_wblk"], d["bg_rowsel"], d["bg_lane"])
    res = {"class": time_pgather(torch, pn, tabs, sched, label)}
    dest = []
    for k in range(c.nchunks):
        pos = np.flatnonzero(c.slot_src[k] >= 0)
        sch = pn.plan_pgather(c.slot_src[k][pos].astype(np.int64), 0)
        dest.append(pn.route_dest(sch[3], m_b, pos))
    dest = torch.from_numpy(np.stack(dest)).to(state.b_col.device)
    g = pn.pgather(tabs, *sched)
    res["route"] = time_proute(torch, pn, g, d["bt_masks"], nst_b, dest,
                               label)
    # the hold: the A route of the widest planned class that has one
    ia = max((j for j, c_ in enumerate(plan.classes)
              if c_.pf and c_.pf_spec[4]), key=lambda j: plan.classes[j].W)
    ca, da = plan.classes[ia], plan.dev[ia]
    ga = pn.pgather(bk._words(state.a_val), da["ag_wblk"], da["ag_rowsel"],
                    da["ag_lane"])
    res["hold"] = time_proute(
        torch, pn, ga, da["at_masks"], ca.pf_spec[3], None,
        f"{PLANNED_TIMING}'s W={ca.W} A route ({ca.nchunks} chunks, "
        f"m={ca.pf_spec[2]})", hold=ca.W, flags=da["flags"])
    if plan.ext_pf is not None:
        slabs = bk.bucketed_main(plan, state.a_val, state.b_col,
                                 state.b_val, state.pairs, route=state.route)
        vals = bk._flat([s_[1] for s_ in slabs])
        etabs = [bk._flat([s_[0] for s_ in slabs])] + bk._words(vals)
        wblk, rowsel, lane, masks = bk.planned_extract_dev(plan)
        m_e, nst_e, nch, CH = plan.ext_pf_spec
        elabel = f"{PLANNED_TIMING}'s planned extraction ({nch} chunks)"
        res["ext_gather"] = time_pgather(torch, pn, etabs,
                                         (wblk, rowsel, lane), elabel)
        dest = []
        for k in range(nch):
            lo, hi = k * CH, min(plan.nnz_c, (k + 1) * CH)
            sch = pn.plan_pgather(plan.ext_src_h[lo:hi].astype(np.int64), 0)
            dest.append(pn.route_dest(sch[3], m_e))
        dest = torch.from_numpy(np.stack(dest)).to(vals.device)
        g = pn.pgather(etabs, wblk, rowsel, lane)
        res["ext_route"] = time_proute(torch, pn, g, masks, nst_e, dest,
                                       elabel)
        res["ext_ms"] = cuda_ms(lambda: bk.extract_warm(plan, slabs), 10)
        res["ext_gather_ms"] = cuda_ms(
            lambda: bk.bucketed_extract_static(
                slabs, bk.static_dev(plan)[0], nnz_c=plan.nnz_c), 10)
        print(f"timing {PLANNED_TIMING}'s extraction: planned "
              f"{res['ext_ms']:.4f} ms, static gather "
              f"{res['ext_gather_ms']:.4f} ms", flush=True)
        del slabs
    return res


def fill_phase(torch, mt, et, rf, A, ref, default_state, dev) -> tuple:
    """cage12 under dma_fill="on": its W=256 class takes the fill
    frontend; C equals the oracle; ragged_fill and esc_tail, set to 0
    before, both ran.  Its warm ms beside the default path's, timed in
    turns (fill, default, fill, default)."""
    from mh_spgemm_torch.pipeline import spgemm_bucketed
    cfg = mt.SpGEMMConfig(dma_fill="on")
    for fn in (et.esc_tail_flat, et.esc_tail, rf.ragged_fill):
        fn.launches = 0
    t0 = time.perf_counter()
    Cd, state = spgemm_bucketed(A, A, config=cfg, device=dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    check(Cd.host().equals(ref, tol=1e-9), "forced fill: cold != oracle")
    plan = state.plan
    check(any(c.W == 256 and c.fill for c in plan.classes),
          f"forced fill: no W=256 fill class in {FILL_MATRIX}'s plan")
    out = {}

    def fill():
        out["C"], _ = spgemm_bucketed(A, A, config=cfg, state=state)

    def default():
        spgemm_bucketed(A, A, state=default_state)

    ms = [cuda_ms(fill, WARM_CALLS, warmup=1)]
    check(out["C"].host().equals(ref, tol=1e-9),
          "forced fill: warm != oracle")
    launches = {fn.__name__: fn.launches
                for fn in (et.esc_tail_flat, et.esc_tail, rf.ragged_fill)}
    check(launches["esc_tail"] > 0 and launches["ragged_fill"] > 0,
          f"forced fill did not launch esc_tail and ragged_fill: "
          f"{launches}")
    dms = [cuda_ms(default, WARM_CALLS, warmup=1)]
    ms.append(cuda_ms(fill, WARM_CALLS, warmup=1))
    dms.append(cuda_ms(default, WARM_CALLS, warmup=1))
    row = {"matrix": FILL_MATRIX, "frontends": [(c.W, c.frontend)
                                                for c in plan.classes],
           "windowed_extraction": plan.ext is not None,
           "fill_warm_ms": ms, "default_warm_ms": dms,
           "fill_gflops": mt.gflops(A.intprod(A), float(np.mean(ms))),
           "cold_ms": cold_ms, "launches": launches}
    print("fill " + json.dumps(row), flush=True)
    del Cd, out
    return state, launches


def masked_phase(torch, mt, rf, gf, mats: dict, refs: dict, dev) -> dict:
    """spgemm_masked cold, then warm, on each stand-in; ragged_fill and
    gather_front are set to 0 before each and read after it, and
    ragged_fill must have run for each.  Returns each kernel's launches
    by stand-in."""
    from mh_spgemm_torch.pipeline import spgemm_masked
    launches = {"ragged_fill": {}, "gather_front": {}}
    for name in MASKED_MATRICES:
        A, ref = mats[name], refs[name]
        rf.ragged_fill.launches = gf.gather_front.launches = 0
        t0 = time.perf_counter()
        Cd, state = spgemm_masked(A, A, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(Cd.host().equals(ref, tol=1e-9), f"masked {name}: cold != "
              "oracle")
        out = {}

        def warm():
            out["C"], _ = spgemm_masked(A, A, state=state)

        ms = cuda_ms(warm, WARM_CALLS, warmup=1)
        check(out["C"].host().equals(ref, tol=1e-9),
              f"masked {name}: warm != oracle")
        for fn in (rf.ragged_fill, gf.gather_front):
            launches[fn.__name__][name] = fn.launches
        check(launches["ragged_fill"][name] > 0,
              f"masked {name}: ragged_fill did not run")
        plan = state.plan
        intprod = A.intprod(A)
        row = {"matrix": name, "warm_ms": ms,
               "gflops": mt.gflops(intprod, ms), "cold_ms": cold_ms,
               "classes": [{"W": c.W, "frontend": c.frontend, "Wt": e["Wt"],
                            "tile_frontend": ("fill" if e["t_fill"]
                                              else "gather")}
                           for c, e in zip(plan.classes, state.extras)],
               "windowed_extraction": plan.ext is not None,
               "slots": sum(c.W * c.rb * c.nchunks for c in plan.classes),
               "ragged_fill_launches": launches["ragged_fill"][name],
               "gather_front_launches": launches["gather_front"][name]}
        print("masked " + json.dumps(row), flush=True)
        del Cd, out, state
    return launches


def device_engine_phase(torch, mt, et, rf, pn, rfx, pm, mats: dict,
                        refs: dict, states: dict, dev) -> dict:
    """The DeviceCSR-level engines on the full-size stand-ins: per
    matrix, spgemm_host(mode="esc"), then spgemm on padded device
    operands under mode="esc" (and "masked" on DEVICE_MASKED), cold (host
    wall clock, readbacks included) and warm through the plan (the seven
    phases of one fenced warm call; the mean of DEVICE_WARM_CALLS calls
    queued under no_fence between CUDA events); spgemm(dA, dA) under
    DEFAULT_CONFIG on scircuit; the masked budget SpGEMMError on
    DEVICE_BUDGET_MATRIX.  Every C against the oracle.  Then ESC against
    the bucketed engine's warm call (the main path's states), in turns
    (esc, bucketed, bucketed, esc), and one profiled warm ESC call on
    cage12.  These engines are torch ops: the nine kernels' counts are
    set to 0 before each matrix's engine calls and read before its turns
    (which launch the bucketed engine's kernels), and their sum is
    printed."""
    from mh_spgemm_torch.pipeline import no_fence, spgemm_bucketed
    counted = (et.esc_tail_flat, et.esc_tail, rf.ragged_fill, pn.pgather,
               pn.proute, rfx.halo_exchange, pm.pair_matmul_f64,
               pm.pair_matmul_f32, pm.block_gather)
    launches = dict.fromkeys((fn.__name__ for fn in counted), 0)
    rows = {}
    for name in MATRICES:
        for fn in counted:
            fn.launches = 0
        A, ref = mats[name], refs[name]
        intprod = A.intprod(A)
        t0 = time.perf_counter()
        C = mt.spgemm_host(A, config=mt.SpGEMMConfig(mode="esc"),
                           device=dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        check(C.equals(ref, tol=1e-9), f"{name}: spgemm_host(esc) != "
              "oracle")
        del C
        dA = A.device(torch.float64, pad=True, device=dev)
        modes = ("esc", "masked") if name in DEVICE_MASKED else ("esc",)
        row = {"matrix": name, "intprod": intprod, "nnz_c": ref.nnz,
               "m_pad": dA.m_pad, "nnz_pad": dA.nnz_pad,
               "host_esc_ms": host_ms}
        for mode in modes:
            cfg = mt.SpGEMMConfig(mode=mode)
            plan = mt.make_plan(dA, dA)
            torch.cuda.reset_peak_memory_stats()
            cold_t = mt.Timing()
            t0 = time.perf_counter()
            Cd = mt.spgemm(dA, dA, config=cfg, timing=cold_t, plan=plan)
            cold_ms = (time.perf_counter() - t0) * 1e3
            check(Cd.host().equals(ref, tol=1e-9), f"{name} {mode}: cold "
                  "!= oracle")
            warm_t = mt.Timing()
            Cd = mt.spgemm(dA, dA, config=cfg, timing=warm_t, plan=plan)
            check(Cd.host().equals(ref, tol=1e-9), f"{name} {mode}: warm "
                  "!= oracle")
            out = {}

            def warm():
                out["C"] = mt.spgemm(dA, dA, config=cfg, plan=plan)

            with no_fence():
                ms = cuda_ms(warm, DEVICE_WARM_CALLS, warmup=1)
            check(out["C"].host().equals(ref, tol=1e-9),
                  f"{name} {mode}: queued warm != oracle")
            row[mode] = {
                "cold_ms": cold_ms, "warm_ms": ms,
                "gflops": mt.gflops(intprod, ms),
                "cold_phases_ms": cold_t.as_dict(),
                "warm_phases_ms": warm_t.as_dict(),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                "plan": dataclasses.asdict(plan)}
            del Cd, out
        if name == "scircuit":
            Cd = mt.spgemm(dA, dA)                   # DEFAULT_CONFIG: ESC
            check(Cd.host().equals(ref, tol=1e-9), "scircuit: spgemm "
                  "under DEFAULT_CONFIG != oracle")
            del Cd
        if name == DEVICE_BUDGET_MATRIX:
            try:
                mt.spgemm(dA, dA, config=mt.SpGEMMConfig(mode="masked"))
                raised = None
            except mt.SpGEMMError as exc:
                raised = str(exc)
            check(raised is not None and "budget" in raised,
                  f"{name}: the masked pipeline did not raise its budget "
                  f"error ({raised})")
            row["masked"] = {"raised": raised}
        for fn in counted:
            launches[fn.__name__] += fn.launches
        # ESC against the bucketed engine's warm call, in turns
        cfg = mt.SpGEMMConfig(mode="esc")
        plan = mt.make_plan(dA, dA)
        mt.spgemm(dA, dA, config=cfg, plan=plan)
        st = states[name]
        calls = {"esc": lambda: mt.spgemm(dA, dA, config=cfg, plan=plan),
                 "bucketed": lambda: spgemm_bucketed(A, A, state=st)}
        turns = {"esc": [], "bucketed": []}
        with no_fence():
            for which in ("esc", "bucketed", "bucketed", "esc"):
                turns[which].append(cuda_ms(calls[which],
                                            DEVICE_WARM_CALLS, warmup=1))
        row["turns_warm_ms"] = turns
        if name == "cage12":
            esc_ms = min(turns["esc"])
            try:
                prof = device_profile(torch, calls["esc"], reps=3,
                                      whole=False)
                row["esc_profile"] = {
                    "warm_ms": esc_ms, "busy_ms": prof["busy_ms"],
                    "kernels": prof["kernels"],
                    "idle_share": 1.0 - prof["busy_ms"] / esc_ms,
                    "top": dict(list(prof["by_name"].items())[:10]),
                    "partial": prof["partial"],
                    "profile_attempts": prof["attempts"]}
            except Exception as exc:   # the measurement only, not a check
                row["esc_profile"] = (f"not measured ({type(exc).__name__}"
                                      f": {exc})")
        print("device_engines " + json.dumps(row), flush=True)
        rows[name] = row
        del dA
    print("device_engines launches " + json.dumps(launches), flush=True)
    return rows


def device_dist_phase(torch, mt, mats: dict, refs: dict,
                      digests: dict) -> list:
    """spgemm_dist(engine="esc") on DIST_SHARDS shards of the card for
    each of DEVICE_DIST_CALLS: cold (host wall clock), then warm through
    the state (CUDA events: a whole call, host assembly included, and the
    shard program alone); every C against the oracle, its digest in
    ``digests``."""
    from mh_spgemm_torch.parallel.mesh import make_row_mesh
    from mh_spgemm_torch.parallel.spgemm_dist import spgemm_dist
    from mh_spgemm_torch.parallel.worker import csr_sha
    mesh = make_row_mesh(DIST_SHARDS)
    rows = []
    for name, strategy in DEVICE_DIST_CALLS:
        A, ref = mats[name], refs[name]
        st = {}
        t0 = time.perf_counter()
        C = spgemm_dist(A, None, mesh, b_strategy=strategy, state=st,
                        engine="esc")
        cold_ms = (time.perf_counter() - t0) * 1e3
        label = f"{name} esc {strategy}"
        check(C.equals(ref, tol=1e-9), f"dist {label}: cold != oracle")
        digests[mp_key(name, "esc", strategy, "xla", False)] = csr_sha(C)
        out = {}

        def warm():
            out["C"] = spgemm_dist(A, None, mesh, b_strategy=strategy,
                                   state=st, engine="esc")

        warm_ms = cuda_ms(warm, DIST_WARM_CALLS, warmup=1)
        check(out["C"].equals(ref, tol=1e-9), f"dist {label}: warm != "
              "oracle")
        device_ms = cuda_ms(lambda: st["fn"](*st["args"]), DIST_WARM_CALLS,
                            warmup=1)
        row = {"matrix": name, "D": mesh.size, "engine": "esc",
               "strategy": strategy, "per_shard_products": st["total"],
               "plan_s": st["plan_s"], "cold_ms": cold_ms,
               "warm_ms": warm_ms, "device_ms": device_ms,
               "exchanged_words": st["exchanged_words"], "nnz_c": ref.nnz}
        print("dist_esc " + json.dumps(row), flush=True)
        rows.append(row)
        del C, out, st
    return rows


def halo_kernel_phase(torch, rfx, dev) -> int:
    """halo_exchange against its plain version and against the yardstick
    ``torch.stack(sends).transpose(0, 1)`` for D in HALO_DS and vr in
    HALO_VRS, the shards in separate allocations, exact on every word;
    at D = 8 the exchange into each receiving range of HALO_SUBSETS
    alone (into given buffers), against the plain version's subset and
    the whole exchange's slice; then exchange_planes round-trips 3 planes
    of cap 300.  Returns the
    max abs error (0 when the run gets here)."""
    rng = np.random.default_rng(6)
    for D in HALO_DS:
        for vr in HALO_VRS:
            sends = [torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, (D, vr, 128), dtype=np.int64).astype(
                    np.int32)).to(dev) for _ in range(D)]
            got = rfx.halo_exchange(sends, n_devices=D)
            torch.cuda.synchronize()
            want = rfx.halo_exchange_plain(sends, n_devices=D)
            lib = torch.stack(sends).transpose(0, 1).contiguous()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"halo_exchange differs from its plain version (D={D}, "
                  f"vr={vr})")
            check(all(torch.equal(g, lib[s]) for s, g in enumerate(got)),
                  f"halo_exchange differs from the stack yardstick (D={D}, "
                  f"vr={vr})")
            print(f"kernel halo_exchange D={D} vr={vr:5d} "
                  f"words={D * D * vr * 128} exact ok", flush=True)
            if D == 8:
                # a process's own shards: the receiving range alone, into
                # buffers it keeps
                for first, count in HALO_SUBSETS:
                    out = [torch.empty_like(sends[0]) for _ in range(count)]
                    sub = rfx.halo_exchange(sends, n_devices=D,
                                            dst_first=first,
                                            dst_count=count, out=out)
                    torch.cuda.synchronize()
                    plain = rfx.halo_exchange_plain(
                        sends, n_devices=D, dst_first=first,
                        dst_count=count)
                    check(all(torch.equal(g, w) and torch.equal(g, want[
                        first + j]) for j, (g, w) in enumerate(zip(
                            sub, plain))),
                          f"halo_exchange into shards {first}.."
                          f"{first + count - 1} differs from its plain "
                          f"version (vr={vr})")
                    print(f"kernel halo_exchange D={D} vr={vr:5d} "
                          f"dst_first={first} dst_count={count} exact ok",
                          flush=True)
                    del out, sub, plain
            del sends, got, want, lib
    D, cap = 4, 300
    planes = [[torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (D, cap),
                                             dtype=np.int64).astype(
                                                 np.int32)).to(dev)
               for _ in range(3)] for _ in range(D)]
    got = rfx.exchange_planes(planes, n_devices=D)
    check(all(torch.equal(got[s][i][d], planes[d][i][s])
              for s in range(D) for i in range(3) for d in range(D)),
          "exchange_planes does not round-trip 3 planes of cap 300")
    print("kernel exchange_planes D=4 cap=300 planes=3 exact ok",
          flush=True)
    return 0


def dist_classes(st) -> list:
    """(W, rb, nchunks, fill) of every class of shard 0's plan(s)."""
    plans = st["plans"]
    groups = plans if isinstance(plans, tuple) else (plans,)
    return [[(c.W, c.rb, c.nchunks, c.fill) for c in g[0].classes]
            for g in groups]


def kernel_name(event_name: str) -> str:
    """A device event's kernel name without its return type, namespace
    and parameter list: ``void (anonymous namespace)::gather_blocks<3,
    1>(...)`` reads ``gather_blocks<3, 1>``."""
    name = event_name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].strip()


def device_profile(torch, fn, reps: int = 5, whole: bool = True) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``, after a warm-up
    step of as many calls that the profiler discards (it misses launches
    while its device tracing starts): the CUDA kernels they launched, by
    name, with their summed device time, per call.  Raises where the
    profiler records no device time, or, with ``whole``, a kernel a
    number of times that is not a multiple of ``reps`` (a call whose
    launches were not all recorded); without it, ``partial`` names such
    kernels.  The profiler now and then records nothing or part of a
    step, at times several records in a row, so a record with no device
    time or a partial count is taken again, up to PROFILE_ATTEMPTS
    times, a pause of 0.2 s before each retry."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name = {}
        for e in prof.events():
            if (not str(getattr(e, "device_type", "")).endswith("CUDA")
                    or e.name.startswith("ProfilerStep")):  # the step's span
                continue
            us = (getattr(e, "device_time", None)
                  or getattr(e, "cuda_time", 0.0))
            name = kernel_name(e.name)
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + us)
        busy_us = sum(t for _, t in by_name.values())
        partial = {k: n for k, (n, _) in by_name.items() if n % reps}
        if busy_us > 0 and not partial:
            break
        print(f"device_profile: record {attempt + 1} incomplete "
              f"({busy_us:.1f} us, partial {partial}), taken again",
              flush=True)
    check(busy_us > 0, "the profiler recorded no device time")
    check(not (whole and partial),
          f"the profiler recorded part of a call's launches over {reps} "
          f"calls: {partial}")
    return {"busy_ms": busy_us / 1e3 / reps, "partial": partial,
            "attempts": attempt + 1,
            "kernels": sum(n for n, _ in by_name.values()) / reps,
            "by_name": {k: {"launches": n / reps, "ms": t / 1e3 / reps}
                        for k, (n, t) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][1])}}


def profile_program(torch, st, program_ms: float, label: str) -> dict:
    """One run of a distributed state's shard program under
    ``torch.profiler`` (:func:`device_profile`): the CUDA kernels it
    launched and their summed device time, and the device's idle share
    against ``program_ms`` (the program's CUDA-event time without the
    profiler).  Where the profiler fails or records no device time (no
    CUPTI tracing), the row says "not measured"."""
    row = {"label": label, "program_ms": program_ms}
    try:
        prof = device_profile(torch, lambda: st["fn"](*st["args"]), reps=1)
        row.update(kernels=prof["kernels"], busy_ms=prof["busy_ms"],
                   idle_share=1.0 - prof["busy_ms"] / program_ms,
                   profile_attempts=prof["attempts"])
    except Exception as exc:            # the measurement only, not a check
        row["profile"] = f"not measured ({type(exc).__name__}: {exc})"
    print("dist_profile " + json.dumps(row), flush=True)
    return row


def mp_key(matrix: str, engine: str, strategy: str, backend: str,
           force: bool) -> tuple:
    """The key of a distributed call's C: the backend only where it
    changes the path (the bucketed engine's ragged exchange)."""
    if engine != "bucketed" or strategy != "ragged":
        backend = "-"
    return (matrix, engine, strategy, backend, force)


def dist_phase(torch, mt, rfx, et, rf, gf, mats: dict, refs: dict,
               digests: dict):
    """spgemm_dist on D=8 shards of the one card (grid2d on 4 x 2) for
    each of DIST_CALLS: cold (host wall clock, planning included), then
    warm through the state (CUDA events: a whole call, host assembly
    included, and the shard program alone); every C against the oracle.
    The launch counts are set to 0 before the phase; ragged_fill's again
    before the forced-fill call.  Then the two backends' warm calls in
    turns (pallas, xla, xla, pallas) on scircuit and cage12.  Records
    each cold C's digest in ``digests`` (by :func:`mp_key`).  Returns
    (rows, launches, pallas states)."""
    from mh_spgemm_torch.parallel.mesh import make_grid_mesh, make_row_mesh
    from mh_spgemm_torch.parallel.spgemm_dist import spgemm_dist
    from mh_spgemm_torch.parallel.worker import csr_sha
    counted = (rfx.halo_exchange, et.esc_tail, et.esc_tail_flat,
               rf.ragged_fill, gf.gather_front)
    for fn in counted:
        fn.launches = 0
    mesh = make_row_mesh(DIST_SHARDS)
    grid = make_grid_mesh(DIST_SHARDS // 2, 2)
    check(mesh.size == DIST_SHARDS and len(set(mesh.devices)) == 1,
          f"the mesh is not {DIST_SHARDS} shards on one card")
    rows, states, fill_launches = [], {}, None
    for name, strategy, backend, fill, force in DIST_CALLS:
        A, ref = mats[name], refs[name]
        cfg = mt.SpGEMMConfig(comm_backend=backend, dma_fill=fill)
        m = grid if strategy == "grid2d" else mesh
        if fill == "on":
            rf.ragged_fill.launches = 0
        if force:
            os.environ["MHSPGEMM_FORCE_OVERLAP"] = "1"
        st = {}
        try:
            t0 = time.perf_counter()
            C = spgemm_dist(A, None, m, config=cfg, b_strategy=strategy,
                            state=st)
            cold_ms = (time.perf_counter() - t0) * 1e3
        finally:
            os.environ.pop("MHSPGEMM_FORCE_OVERLAP", None)
        label = f"{name} {strategy} {backend} dma_fill={fill}"
        check(C.equals(ref, tol=1e-9), f"dist {label}: cold != oracle")
        if fill == "auto":
            digests[mp_key(name, "bucketed", strategy, backend,
                           force)] = csr_sha(C)
        out = {}

        def warm():
            out["C"] = spgemm_dist(A, None, m, config=cfg,
                                   b_strategy=strategy, state=st)

        warm_ms = cuda_ms(warm, DIST_WARM_CALLS, warmup=1)
        check(out["C"].equals(ref, tol=1e-9), f"dist {label}: warm != "
              "oracle")
        device_ms = cuda_ms(lambda: st["fn"](*st["args"]), DIST_WARM_CALLS,
                            warmup=1)
        overlap = isinstance(st["plans"], tuple)
        if strategy == "ragged_overlap":
            check(overlap or not force, f"dist {label}: forced overlap "
                  "fell back to ragged")
        if fill == "on":
            fill_launches = rf.ragged_fill.launches
            check(fill_launches > 0 and any(
                c[3] for c in dist_classes(st)[0]),
                f"dist {label}: no fill class ran ragged_fill")
        row = {"matrix": name, "D": m.size,
               "grid": st.get("grid"), "strategy": strategy,
               "backend": backend, "dma_fill": fill,
               "overlap_forced": force, "overlap_ran": overlap,
               "classes": dist_classes(st), "plan_s": st["plan_s"],
               "cold_ms": cold_ms, "warm_ms": warm_ms,
               "device_ms": device_ms,
               "exchanged_words": st["exchanged_words"],
               "nnz_c": ref.nnz}
        print("dist " + json.dumps(row), flush=True)
        rows.append(row)
        if strategy == "ragged" and fill == "auto":
            states[(name, backend)] = st
            if backend == "pallas":
                row["profile"] = profile_program(torch, st, device_ms, label)
        del C, out
    launches = {fn.__name__: fn.launches for fn in counted}
    launches["ragged_fill_forced_fill_call"] = fill_launches
    print("dist launches " + json.dumps(launches), flush=True)
    check(launches["halo_exchange"] > 0, "halo_exchange was not launched "
          "on the distributed path")
    check(launches["esc_tail"] > 0, "esc_tail was not launched on the "
          "distributed path")
    for name in ("scircuit", "cage12"):
        A = mats[name]
        turns = {"pallas": [], "xla": []}
        for backend in ("pallas", "xla", "xla", "pallas"):
            st = states[(name, backend)]
            cfg = mt.SpGEMMConfig(comm_backend=backend)
            turns[backend].append(cuda_ms(
                lambda: spgemm_dist(A, None, mesh, config=cfg,
                                    b_strategy="ragged", state=st),
                DIST_WARM_CALLS, warmup=1))
        print("dist_turns " + json.dumps({"matrix": name, "warm_ms": turns}),
              flush=True)
    return rows, launches, states


def time_halo(torch, rfx, states: dict) -> dict:
    """halo_exchange at the D=8 ragged exchange shapes of scircuit and
    cage12 (the pallas states' packed [D, 3 * vr1, 128] blocks, random
    words), beside its plain version, the stack yardstick and its bound:
    each word read once and written once."""
    res = {}
    rng = np.random.default_rng(7)
    for name in ("scircuit", "cage12"):
        st = states[(name, "pallas")]
        D = DIST_SHARDS
        words = st["exchanged_words"]
        rows = words // (D * D * 128)
        dev = st["args"][0][0].device
        sends = [torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, (D, rows, 128), dtype=np.int64).astype(
                np.int32)).to(dev) for _ in range(D)]
        ms = cuda_ms(lambda: rfx.halo_exchange(sends, n_devices=D), 20)
        # the launch alone: the C entry on prebuilt pointer tables, no
        # wrapper (checks, allocation, tables)
        recvs = rfx.halo_exchange(sends, n_devices=D)
        fn, _ = rfx._kernel_fns()
        vp = ctypes.c_void_p * D
        sp, rp = (vp(*[t.data_ptr() for t in x]) for x in (sends, recvs))
        stream = torch.cuda.current_stream().cuda_stream
        launch_ms = cuda_ms(lambda: fn(sp, rp, D, rows * 128, 0, D, stream),
                            20)
        plain_ms = cuda_ms(lambda: rfx.halo_exchange_plain(
            sends, n_devices=D), 5)
        lib_ms = cuda_ms(
            lambda: torch.stack(sends).transpose(0, 1).contiguous(), 20)
        nbytes = words * 4 * 2
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "words": words, "block_rows": rows}
        print(f"timing halo_exchange at {name}'s D={D} ragged exchange "
              f"({D}x{D} blocks of {rows} rows, {words} words): {ms:.4f} ms "
              f"(the launch alone {launch_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, stack+transpose {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes} B)", flush=True)
        del sends, recvs
    return res


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(nproc: int, spp: int, matrix: str, calls, out: str) -> list:
    """``nproc`` ranks of ``python -m mh_spgemm_torch.parallel.worker`` on
    the card, ``spp`` shards each; each must exit 0 and print its OK line
    within MP_TIMEOUT_S.  A rank that fails or a run past the limit kills
    every rank still running.  Returns every rank's records."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out, exist_ok=True)
    port = free_port()
    logs = [os.path.join(out, f"rank{r}.log") for r in range(nproc)]
    procs = []
    try:
        for r in range(nproc):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mh_spgemm_torch.parallel.worker",
                     str(port), str(r), str(nproc), str(spp), "--device",
                     "cuda", "--matrix", matrix, "--calls", ",".join(calls),
                     "--out", out, "--warm", str(MP_WARM),
                     "--timeout", str(MP_TIMEOUT_S // 2)],
                    cwd=root, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + MP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                       # a rank failed: stop the rest
            if time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for r, path in enumerate(logs):
        with open(path) as f:
            texts.append(f.read())
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0 and
              f"rank {r}: multiprocess dist OK" in text,
              f"multiprocess {matrix} {nproc}x{spp}: rank {r} exited "
              f"{p.returncode}:\n{text[-3000:]}")
    records = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            records.extend(json.load(f))
    return records


def multiprocess_phase(digests: dict) -> dict:
    """spgemm_dist across processes on the one card: each run of MP_RUNS
    spawns its ranks of ``parallel.worker`` (gloo rendezvous on
    localhost, payload by CUDA IPC), which check every C against the
    oracle and time it (cold; MP_WARM warm calls: the whole call, the
    shard program and the exchanges' barriers); here every rank's C must
    equal, bit for bit (:func:`csr_sha`), the single-process D=8 C of the
    same call from the distributed phases, the ESC tails must have
    launched in every rank of each bucketed call, ``halo_exchange`` in
    every rank of each bucketed ragged pallas call and in no
    ``ragged_overlap`` or ESC call (those exchange by copies).  A rank's
    counts are its call's cold, warm and program runs: the worker reads
    them before the turns.  cage12's
    ragged pallas call is timed in turns against the single-process D=8
    call on the card (single, multi, multi, single): processes time-slice
    the card without MPS, so this is overhead, not scaling.  Returns the
    launches summed over ranks and calls, the rows and the turns."""
    out_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "multiprocess")
    shutil.rmtree(out_root, ignore_errors=True)
    launches, rows, turns = {}, [], None
    for nproc, spp, matrix, calls in MP_RUNS:
        t0 = time.perf_counter()
        recs = spawn_ranks(nproc, spp, matrix, calls,
                           os.path.join(out_root, f"{matrix}_{nproc}x{spp}"))
        seconds = time.perf_counter() - t0
        check(len(recs) == nproc * len(calls),
              f"multiprocess {matrix} {nproc}x{spp}: {len(recs)} records")
        for rec in recs:
            spec = rec["call"].split(":")
            engine, strategy, backend = spec[:3]
            key = mp_key(matrix, engine, strategy, backend, "force" in spec)
            label = f"{matrix} {nproc}x{spp} rank {rec['rank']} {rec['call']}"
            check(key in digests, f"multiprocess {label}: no single-process "
                  f"C to compare with ({key})")
            check(rec["digest"] == digests[key], f"multiprocess {label}: C "
                  "differs from the single-process D=8 C")
            halo = rec["launches"]["halo_exchange"]
            if engine == "bucketed":
                check(rec["launches"]["esc_tail"]
                      + rec["launches"]["esc_tail_flat"] > 0,
                      f"multiprocess {label}: no ESC tail launched")
            if engine == "bucketed" and strategy == "ragged" and \
                    backend == "pallas":
                check(halo > 0, f"multiprocess {label}: halo_exchange did "
                      "not launch")
            elif strategy == "ragged_overlap" or engine == "esc":
                check(halo == 0, f"multiprocess {label}: halo_exchange "
                      "launched on a path that exchanges by copies")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
            row = {"matrix": matrix, "processes": nproc,
                   "shards_per_process": spp, **{k: rec.get(k) for k in (
                       "rank", "call", "D", "grid", "cold_ms", "warm_ms",
                       "program_ms", "barriers_per_call", "barrier_ms",
                       "sync_ms", "gather_ms", "launches", "nnz")},
                   "same_as_single_process": True}
            print("multiprocess " + json.dumps(row), flush=True)
            rows.append(row)
            if "turns" in rec and rec["rank"] == 0:
                turns = {"matrix": matrix, "call": rec["call"],
                         "processes": nproc, "shards_per_process": spp,
                         "warm_ms": rec["turns"], "calls_a_turn": MP_WARM}
                print("multiprocess_turns " + json.dumps(turns), flush=True)
        print(f"multiprocess run {matrix} {nproc}x{spp}: {len(calls)} calls, "
              f"{seconds:.1f} s", flush=True)
    check(turns is not None, "multiprocess: no call was timed in turns")
    print("multiprocess launches " + json.dumps(launches), flush=True)
    return {"launches": launches, "rows": rows, "turns": turns}


def dist_bench_phase(engine: str = "bucketed") -> dict:
    """dist_bench on scircuit with --max-devices 8 and ``engine`` in a
    subprocess: exit 0, every check passes, nothing of JAX in its
    output."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mh_spgemm_torch.bench.dist_bench",
           "scircuit", "--strategy", "ragged", "--max-devices",
           str(DIST_SHARDS), "--iters", "2", "--engine", engine]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        print(f"dist_bench engine={engine}", line)
    check(proc.returncode == 0, f"dist_bench exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    check(len(res["devices"]) == 4 and all(
        r["check"] == "pass" for r in res["devices"].values()),
        f"dist_bench checks: {res['devices']}")
    check(res["shards_share_devices"], "dist_bench did not report that the "
          "shards share the card")
    text = (proc.stdout + proc.stderr).lower()
    check("jax" not in text and "mh_spgemm_tpu" not in text,
          "dist_bench's output mentions JAX")
    return res


def build_phase(_build) -> dict:
    """One nvcc per source, all started together.  Returns each source's
    kernels as ptxas reports them (``_build.ptxas_kernels``)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(_build.build, SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(SOURCES)} "
          "sources in parallel", flush=True)
    info = {}
    for src in SOURCES:
        print(f"build {src}.cu: nvcc {_build.build_seconds[src]:.2f} s")
        info[src] = _build.ptxas_kernels(_build.build_log.get(src, ""))
        for k in info[src]:
            print(f"ptxas {src}.cu {k['kernel']}: {k['registers']} "
                  f"registers, {k['smem_bytes']} B static shared memory, "
                  f"{k['stack_bytes']} B stack, {k['spill_bytes']} B "
                  "spilled", flush=True)
    return info


def pair_stream(rng, nab: int, nbb: int, ncb: int):
    """Segments of 1 to 64 pairs in C-block order, about 10 % dead
    pairs, one C block whose pairs are all dead, and C blocks with no
    pair."""
    lens = rng.integers(1, 65, ncb)
    lens[rng.random(ncb) < 0.15] = 0
    lens[0] = 0
    lens[1] = 64
    cb = np.repeat(np.arange(ncb), lens).astype(np.int32)
    live = (rng.random(cb.size) > 0.1).astype(np.int32)
    live[cb == 2] = 0
    return (rng.integers(0, nab, cb.size).astype(np.int32),
            rng.integers(0, nbb, cb.size).astype(np.int32), cb, live)


def check_pair_kernel(torch, pm, a, b, stream, ncb: int, label: str):
    """Kernel against its plain version on the same card tensors; C
    blocks without a live pair must be zero.  Returns the max abs
    error."""
    f64 = a.dtype == torch.float64
    fn = pm.pair_matmul_f64 if f64 else pm.pair_matmul_f32
    out = fn(a, b, *stream, ncb=ncb)
    torch.cuda.synchronize()
    ref = pm.pair_matmul_plain(a, b, *stream, ncb=ncb)
    err = (out - ref).abs()
    if f64:
        bound = 1e-9 * torch.clamp(ref.abs(), min=1.0)
    else:
        scale = pm.pair_matmul_plain(a.abs(), b.abs(), *stream, ncb=ncb)
        bound = 1e-4 * torch.clamp(scale, min=1.0)
    check(bool((err <= bound).all()),
          f"{fn.__name__} differs on {label}: max abs err "
          f"{float(err.max())}")
    cb, live = stream[2], stream[3]
    dead = torch.ones(ncb, dtype=torch.bool, device=a.device)
    dead[cb[live != 0].long()] = False
    check(not bool(out[dead].any()), f"{fn.__name__}: empty C blocks "
          f"are not zero on {label}")
    e = float(err.max()) if err.numel() else 0.0
    print(f"kernel {fn.__name__} {label}: pairs={stream[0].numel()} "
          f"ncb={ncb} max_abs_err={e:.3e} ok", flush=True)
    return e


def matrix_inputs(torch, tbd, A, dev) -> dict:
    """The block-dense engine's dense blocks and pair stream for A·A (a
    CSR matrix)."""
    plan = tbd.plan_blockdense(A.ptr, A.col, A.ptr, A.col, A.M, A.N, A.N,
                               max_pairs=1 << 18)
    tbd.upload_blockplan(plan, dev)
    d = plan.dev
    val = torch.from_numpy(A.val).to(dev)
    ad, ap = tbd.densify(d["a_blk"], d["a_pos"], val, nblk=plan.nab)
    bd, bp = tbd.densify(d["b_blk"], d["b_pos"], val, nblk=plan.nbb)
    return {"stream": (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"]),
            "ncb": plan.ncb, "values": (ad, bd), "patterns": (ap, bp)}


def pair_kernel_phase(torch, pm, tbd, pdb, dev) -> dict:
    """Both pair matmuls on a synthetic stream, on the boundary streams
    (segments of 1, 2, 3 and 37 pairs, dead pairs at their ends, an
    all-dead C block, ncb = 1) and on pdb1HYS's own pair stream; the f32
    kernel exactly on 0/1 patterns and, on random normal blocks, within
    F32_ERR_RATIO times torch.bmm's error against the f64 product;
    block_gather against index_select.  Returns the max abs errors and
    the f32 accuracy figures."""
    errs = {"pair_matmul_f64": 0.0, "pair_matmul_f32": 0.0}
    rng = np.random.default_rng(2)
    ncb = 200
    stream = [torch.from_numpy(x).to(dev)
              for x in pair_stream(rng, 300, 250, ncb)]
    for dtype in (torch.float64, torch.float32):
        a = torch.from_numpy(rng.standard_normal((300, BS, BS))).to(
            dtype).to(dev)
        b = torch.from_numpy(rng.standard_normal((250, BS, BS))).to(
            dtype).to(dev)
        name = "pair_matmul_f64" if dtype == torch.float64 \
            else "pair_matmul_f32"
        errs[name] = max(errs[name], check_pair_kernel(
            torch, pm, a, b, stream, ncb, "synthetic"))
    a = torch.from_numpy(rng.standard_normal((60, BS, BS))).to(dev)
    b = torch.from_numpy(rng.standard_normal((50, BS, BS))).to(dev)
    for k, (st, nb) in enumerate(pm.boundary_streams(rng, 60, 50)):
        st = [torch.from_numpy(x).to(dev) for x in st]
        label = f"boundary stream {k} (ncb={nb})"
        errs["pair_matmul_f64"] = max(errs["pair_matmul_f64"],
                                      check_pair_kernel(torch, pm, a, b, st,
                                                        nb, label))
        errs["pair_matmul_f32"] = max(errs["pair_matmul_f32"],
                                      check_pair_kernel(torch, pm, a.float(),
                                                        b.float(), st, nb,
                                                        label))
        check_pattern_exact(torch, pm, (a > 0.3).float(), (b > 0.3).float(),
                            st, nb, label + " 0/1")
    st = [torch.from_numpy(x).to(dev)
          for x in pm.boundary_streams(rng, 60, 50)[0][0]]
    k_err, bmm_err = pm.f32_errors(pm.pair_matmul_f32, a.float(), b.float(),
                                    st, 11)
    check(k_err <= F32_ERR_RATIO * bmm_err,
          f"pair_matmul_f32's error against f64 ({k_err:.3e}) is more than "
          f"{F32_ERR_RATIO} times torch.bmm's ({bmm_err:.3e})")
    print(f"kernel pair_matmul_f32 accuracy: max abs err against the f64 "
          f"product {k_err:.4e}, torch.bmm in f32 {bmm_err:.4e}, ratio "
          f"{k_err / bmm_err:.3f} (limit {F32_ERR_RATIO}) ok", flush=True)
    m = matrix_inputs(torch, tbd, pdb, dev)
    stream, nb = m["stream"], m["ncb"]
    errs["pair_matmul_f64"] = max(errs["pair_matmul_f64"], check_pair_kernel(
        torch, pm, *m["values"], stream, nb, "pdb1HYS values"))
    errs["pair_matmul_f32"] = max(errs["pair_matmul_f32"], check_pair_kernel(
        torch, pm, *m["patterns"], stream, nb, "pdb1HYS patterns"))
    check_pattern_exact(torch, pm, *m["patterns"], stream, nb,
                        "pdb1HYS patterns")
    del m
    for dtype in (torch.float64, torch.float32, torch.int32):
        table = torch.from_numpy(rng.integers(-2**20, 2**20, (64, BS, BS))
                                 ).to(dtype).to(dev)
        idx = torch.from_numpy(rng.integers(0, 64, 500).astype(np.int32)
                               ).to(dev)
        out = pm.block_gather(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, table.index_select(0, idx.long())),
              f"block_gather differs from index_select ({dtype})")
        print(f"kernel block_gather {str(dtype):14s} blocks=500 exact ok",
              flush=True)
    errs["block_gather"] = 0.0
    errs["f32_accuracy"] = {"kernel_err_vs_f64": k_err,
                            "bmm_err_vs_f64": bmm_err,
                            "ratio": k_err / bmm_err,
                            "limit": F32_ERR_RATIO}
    return errs


def check_pattern_exact(torch, pm, a, b, stream, ncb: int, label: str):
    """The f32 kernel on 0/1 blocks must equal its plain version bit for
    bit: every partial sum is an integer below 2^24."""
    out = pm.pair_matmul_f32(a, b, *stream, ncb=ncb)
    torch.cuda.synchronize()
    check(torch.equal(out, pm.pair_matmul_plain(a, b, *stream, ncb=ncb)),
          f"pair_matmul_f32 is not exact on {label}")
    print(f"kernel pair_matmul_f32 {label}: exact ok", flush=True)


def sass_phase(torch, _build, pm) -> dict:
    """``cuobjdump -sass`` of the built pair_matmul library: per pair
    kernel the count of DMMA (f64), HMMA ... TF32 (f32), LDGSTS
    (cp.async) and UTMALDG (TMA) instructions; the f64 kernel must have
    DMMA, the f32 kernel TF32 HMMA, both LDGSTS or UTMALDG.  Also what
    the runtime reports of each (registers, dynamic shared memory, local
    bytes, resident blocks per SM): the f64 kernel must keep two blocks
    per SM."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.build("pair_matmul")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True)
    counts, cur = {}, None
    for line in proc.stdout.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            cur = next((n for n, tag in PAIR_KERNELS.items()
                        if tag in hit.group(1)), None)
            if cur:
                counts[cur] = {"DMMA": 0, "HMMA_TF32": 0, "LDGSTS": 0,
                               "UTMALDG": 0}
            continue
        if cur is None:
            continue
        c = counts[cur]
        c["DMMA"] += "DMMA" in line
        c["HMMA_TF32"] += "HMMA" in line and "TF32" in line
        c["LDGSTS"] += "LDGSTS" in line
        c["UTMALDG"] += "UTMALDG" in line
    for name, dtype in (("pair_matmul_f64", torch.float64),
                        ("pair_matmul_f32", torch.float32)):
        check(name in counts, f"{name}'s kernel is not in {lib}")
        counts[name]["runtime"] = pm.kernel_info(dtype)
        print(f"sass {name}: " + json.dumps(counts[name]), flush=True)
    f64, f32 = counts["pair_matmul_f64"], counts["pair_matmul_f32"]
    check(f64["DMMA"] > 0, "pair_matmul_f64 has no DMMA")
    check(f32["HMMA_TF32"] > 0, "pair_matmul_f32 has no TF32 HMMA")
    check(all(c["LDGSTS"] + c["UTMALDG"] > 0 for c in (f64, f32)),
          "a pair kernel has no LDGSTS or UTMALDG")
    check(f64["runtime"]["blocks_per_sm"] >= 2,
          f"pair_matmul_f64 keeps {f64['runtime']['blocks_per_sm']} blocks "
          "per SM")
    return counts


def blockdense_phase(torch, mt, pm, rf, mats: dict, dev):
    """Drive the block-dense engine on every stand-in; the pair kernels'
    and ragged_fill's launch counts are set to 0 just before and read
    just after.  Returns (states, launches)."""
    from mh_spgemm_torch.pipeline import spgemm_blockdense
    kept, refs = {}, {}
    for name, A in mats.items():
        t0 = time.perf_counter()
        refs[name] = mt.oracle_spgemm(A, A)
        print(f"oracle {name}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    for fn in (pm.pair_matmul_f64, pm.pair_matmul_f32, pm.block_gather,
               rf.ragged_fill):
        fn.launches = 0
    for name, A in mats.items():
        ref = refs[name]
        intprod = A.intprod(A)
        t0 = time.perf_counter()
        engine = mt.choose_engine(A, A, mt.SpGEMMConfig(mode="auto"))
        choose_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Cd, state = spgemm_blockdense(A, A, device=dev)
        cold_ms = (time.perf_counter() - t0) * 1e3
        check(Cd.host().equals(ref, tol=1e-9), f"{name}: cold != oracle")
        out = {}

        def warm():
            out["C"], _ = spgemm_blockdense(A, A, state=state)

        ms = cuda_ms(warm, BD_WARM_CALLS, warmup=1)
        check(out["C"].host().equals(ref, tol=1e-9),
              f"{name}: warm != oracle")
        peak = torch.cuda.max_memory_allocated() / 2**30
        del Cd, out
        C = mt.spgemm_host(A, config=mt.SpGEMMConfig(mode="auto"),
                           device=dev)
        check(C.equals(ref, tol=1e-9), f"{name}: auto != oracle")
        plan = state.plan
        row = {"matrix": name, "auto_engine": engine,
               "choose_engine_s": choose_s, "rows": A.M, "nnz_a": A.nnz,
               "intprod": intprod, "nnz_c": ref.nnz, "pairs": plan.npairs,
               "a_blocks": plan.nab, "c_blocks": plan.ncb,
               "strip_classes": [(s.nj, s.nrows_blk) for s in plan.strips],
               "windowed_extraction": plan.ext is not None,
               "warm_ms": ms, "gflops": mt.gflops(intprod, ms),
               "cold_ms": cold_ms, "peak_mem_gb": peak}
        print("blockdense " + json.dumps(row), flush=True)
        kept[name] = state
        del C
    launches = {fn.__name__: fn.launches for fn in
                (pm.pair_matmul_f64, pm.pair_matmul_f32, pm.block_gather,
                 rf.ragged_fill)}
    check(launches["pair_matmul_f64"] > 0 and launches["pair_matmul_f32"] > 0,
          f"the pair kernels were not launched: {launches}")
    check(launches["ragged_fill"] > 0,
          "the block-dense extraction did not launch ragged_fill")
    return kept, launches


def blockdense_stages(torch, pm, tbd, bk, mats: dict, states: dict, dev):
    """Device time of each stage of a block-dense call, timed alone:
    densify (cold calls only), the value and the pattern pair matmul,
    the strips, and the extraction: as the plan runs it (windowed under
    dma_fill="auto" where the cost model takes it) and by the gather
    (dma_fill="off").  Returns the extraction times per matrix."""
    ext_ms = {}
    for name, state in states.items():
        plan = state.plan
        d = plan.dev
        stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
        val = torch.from_numpy(mats[name].val).to(dev)

        def dens():
            tbd.densify(d["a_blk"], d["a_pos"], val, nblk=plan.nab)
            tbd.densify(d["b_blk"], d["b_pos"], val, nblk=plan.nbb)

        def vals():
            return pm.pair_matmul_f64(d["a_dense"], d["b_dense"], *stream,
                                      ncb=plan.ncb)

        def pats():
            return pm.pair_matmul_f32(d["a_pat"], d["b_pat"], *stream,
                                      ncb=plan.ncb)

        cv, cp = vals(), pats()
        specs = tuple((s.nj, s.nrows_blk) for s in plan.strips)

        def strips():
            return tbd._blockdense_strips(d, cv, cp, specs, plan.m,
                                          by_end_pair=False)

        main_out = strips()
        flat = [(oC.reshape(-1), oV.reshape(-1), None)
                for oC, oV in main_out[3]]

        def gather():
            return bk.bucketed_extract(flat, d["slab_start"], main_out[1],
                                       m=plan.m, nnz_cap=plan.nnz_cap)

        row = {"matrix": name, "densify_ms": cuda_ms(dens, 3),
               "values_ms": cuda_ms(vals, 5), "patterns_ms": cuda_ms(pats, 5),
               "strips_ms": cuda_ms(strips, 3),
               "extract_ms": cuda_ms(
                   lambda: tbd.finish_blockdense(plan, main_out), 5),
               "extract_windowed": plan.ext is not None,
               "extract_gather_ms": cuda_ms(gather, 5)}
        ext_ms[name] = row
        print("bdstages " + json.dumps(row), flush=True)
        del cv, cp, main_out, flat
    return ext_ms


def time_pair_kernels(torch, pm, tbd, states: dict) -> dict:
    """The pair matmuls at pwtk's and pdb1HYS's shapes, warm, each in
    turns with torch.bmm of the pre-gathered pairs (kernel, bmm, bmm,
    kernel); block_gather at pwtk's."""
    res = {"pair_matmul_f64": {}, "pair_matmul_f32": {}}
    for matrix in ("pwtk", "pdb1HYS"):
        plan = states[matrix].plan
        d = plan.dev
        stream = (d["pair_a"], d["pair_b"], d["pair_cb"], d["live"])
        G, ncb = int(d["live"].sum()), plan.ncb
        for name, fn, a, b in (
                ("pair_matmul_f64", pm.pair_matmul_f64, d["a_dense"],
                 d["b_dense"]),
                ("pair_matmul_f32", pm.pair_matmul_f32, d["a_pat"],
                 d["b_pat"])):
            ga = a.index_select(0, d["pair_a"])
            gb = b.index_select(0, d["pair_b"])
            turns = {"kernel": [], "bmm": []}
            for who in ("kernel", "bmm", "bmm", "kernel"):
                turns[who].append(cuda_ms(
                    (lambda: fn(a, b, *stream, ncb=ncb)) if who == "kernel"
                    else (lambda: torch.bmm(ga, gb)), 10))
            del ga, gb
            plain_ms = cuda_ms(lambda: pm.pair_matmul_plain(a, b, *stream,
                                                            ncb=ncb), 2,
                               warmup=1)
            ms, lib_ms = min(turns["kernel"]), min(turns["bmm"])
            # each live pair's product; each A and B block a pair names is
            # read once, each C block written once, the four streams once
            flops = 2 * G * BS ** 3
            nblk = (int(torch.unique(d["pair_a"]).numel())
                    + int(torch.unique(d["pair_b"]).numel()) + ncb)
            nbytes = (nblk * BS * BS * a.element_size()
                      + 4 * 4 * d["pair_a"].numel())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            if name == "pair_matmul_f64":
                ops_ms, ops = flops / FP64_TC_FLOPS * 1e3, "DMMA at 67 TFLOP/s"
                extra = {}
            else:
                ops_ms = 3 * flops / TF32_TC_FLOPS * 1e3
                ops = "3 TF32 passes at 495 TFLOP/s"
                extra = {"bound_ffma_ms": max(flops / FP32_FLOPS * 1e3,
                                              bytes_ms)}
            row = {"ms": ms, "ms_turns": turns["kernel"], "plain_ms": plain_ms,
                   "library_ms": lib_ms, "library_ms_turns": turns["bmm"],
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": ("operations" if ops_ms >= bytes_ms
                                else "bytes"),
                   "bound_ops": ops, **extra, "tflops": flops / ms / 1e9,
                   "library_tflops": flops / lib_ms / 1e9, "pairs": G,
                   "c_blocks": ncb, "flop": flops, "bytes": nbytes}
            res[name][matrix] = row
            print(f"timing {name} on {matrix} ({G} pairs, {ncb} C blocks): "
                  f"{turns['kernel']} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
                  f"torch.bmm of the gathered pairs {turns['bmm']} ms "
                  f"({flops / lib_ms / 1e9:.2f} TFLOP/s), in turns; plain "
                  f"{plain_ms:.4f} ms; bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: {ops}; {flops} flop, {nbytes} B)"
                  + (f", FFMA bound {extra['bound_ffma_ms']:.4f} ms"
                     if extra else ""), flush=True)
    per_elem = {n: res[n]["pwtk"]["ms"] * 1e6
                / (res[n]["pwtk"]["pairs"] * BS * BS) for n in res}
    print(f"routing constant _per_elem_s (TPU v5e, unchanged): f64 on the "
          f"pair kernel {tbd._per_elem_s(torch.float64, True) * 1e9:.1f} "
          f"ns, f32 {tbd._per_elem_s(torch.float32, True) * 1e9:.1f} ns "
          f"per dense pair element; measured on pwtk: f64 "
          f"{per_elem['pair_matmul_f64']:.4f} ns, f32 "
          f"{per_elem['pair_matmul_f32']:.4f} ns", flush=True)
    d = states["pwtk"].plan.dev
    G = d["pair_a"].numel()
    table, idx = d["a_dense"], d["pair_a"]
    ms = cuda_ms(lambda: pm.block_gather(table, idx), 10)
    plain_ms = cuda_ms(lambda: pm.block_gather_plain(table, idx), 10)
    lib_ms = cuda_ms(lambda: torch.index_select(table, 0, idx), 10)
    # each distinct table block that idx names is read once, each
    # gathered block written once
    nread = int(torch.unique(idx).numel())
    nbytes = (nread + G) * BS * BS * table.element_size() + 4 * G
    res["block_gather"] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms,
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "bound_by": "bytes"}
    print(f"timing block_gather on pwtk's A blocks by pair ({G} blocks of "
          f"{BS}x{BS} f64 from {nread} distinct): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound "
          f"{res['block_gather']['bound_ms']:.4f} ms ({nbytes} B)",
          flush=True)
    return res


def cli_phase() -> dict:
    """The CLI in a subprocess on pdb1HYS: exit 0, check passes on the
    block-dense engine, and nothing of JAX in its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mh_spgemm_torch", "pdb1HYS", "--check",
           "--stats", "--json", "--iters", "3"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        print("cli", line)
    check(proc.returncode == 0, f"CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][0])
    check(res.get("check") == "pass", "CLI check did not pass")
    check(res["stats"]["engine"] == "blockdense",
          f"CLI ran the {res['stats']['engine']} engine")
    text = (proc.stdout + proc.stderr).lower()
    check("jax" not in text and "mh_spgemm_tpu" not in text,
          "the CLI's output mentions JAX")
    cmd = [sys.executable, "-m", "mh_spgemm_torch", "scircuit", "--mode",
           "masked", "--check", "--iters", "2"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        print("cli-masked", line)
    check(proc.returncode == 0, f"masked CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check("pass" in proc.stdout.splitlines(),
          "the masked CLI's check did not pass")
    cmd = [sys.executable, "-m", "mh_spgemm_torch", "scircuit", "--mode",
           "esc", "--check", "--iters", "3"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        print("cli-esc", line)
    check(proc.returncode == 0, f"ESC CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check("pass" in proc.stdout.splitlines(),
          "the ESC CLI's check did not pass")
    text = (proc.stdout + proc.stderr).lower()
    check("jax" not in text and "mh_spgemm_tpu" not in text,
          "the ESC CLI's output mentions JAX")
    return res


def soak_phase() -> dict:
    """The structured soak on the card (``bench/soak.soak``): the 400
    catalog cases through the five engines under the CUDA defaults, in
    f64, one subprocess per family (``soak.JOBS`` at a time), and the
    repaired cases cold and warm under the setting that showed each
    fault.  No failure; every engine ran every case; the soak reached
    ``SOAK_MUST_LAUNCH``."""
    from mh_spgemm_torch.bench import soak
    rep = soak.soak()
    print("soak " + json.dumps({k: rep[k] for k in (
        "cases", "runs", "failures", "repaired", "launches", "seconds",
        "family_seconds")}), flush=True)
    for fam, errs in rep["errors"].items():
        for e in errs[:5]:
            print(f"soak error {fam}: {e[-1500:]}")
    check(not rep["failures"], f"soak failures: {rep['failures'][:20]}")
    check(rep["cases"] == 400 and all(
        n == 400 for n in rep["runs"].values()),
        f"soak ran {rep['cases']} cases, runs {rep['runs']}")
    check(sum(rep["repaired"]["runs"].values()) == 6,
          f"repaired runs {rep['repaired']}")
    for k in SOAK_MUST_LAUNCH:
        check(rep["launches"][k] > 0, f"the soak launched no {k}")
    return rep


def suite_phase() -> dict:
    """``python -m mh_spgemm_torch.bench.suite`` over the 16 stand-ins in a
    subprocess (plan and oracle caches under ``build/``): exit 0, every
    member's digest check passes, the summary is not partial, the masked
    contract members ran without error, and nothing of JAX is printed."""
    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "build")
    out = os.path.join(build, "suite_summary.json")
    env = dict(os.environ,
               MHSPGEMM_PLAN_CACHE=os.path.join(build, "plan_cache"),
               MHSPGEMM_ORACLE_CACHE=os.path.join(build,
                                                  "oracle_digest.json"))
    cmd = [sys.executable, "-m", "mh_spgemm_torch.bench.suite",
           "--deadline-s", str(SUITE_DEADLINE_S), "--out", out]
    shutil.rmtree(env["MHSPGEMM_PLAN_CACHE"], ignore_errors=True)
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=SUITE_DEADLINE_S + 300, env=env)
    for line in proc.stderr.splitlines()[-60:]:
        print("suite", line)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(bool(lines), f"the suite printed no summary (rc "
          f"{proc.returncode}): {proc.stderr[-2000:]}")
    summ = json.loads(lines[-1])
    for name, row in summ["detail"].items():
        print("suite member " + json.dumps({
            "name": name, "engine": row.get("engine"),
            "gflops": row.get("gflops"), "warm_ms": row.get("total_ms"),
            "intprod": row.get("intprod"), "nnz_c": row.get("nnz_c"),
            "check": row.get("check"), "plan_cache": row.get("plan_cache"),
            "oracle_source": row.get("oracle_source"),
            "seconds": row.get("seconds")}))
    print("suite " + json.dumps({k: summ.get(k) for k in (
        "metric", "value", "unit", "vs_baseline", "partial", "verified",
        "check_failures", "skipped", "masked")}), flush=True)
    check(proc.returncode == 0, f"the suite exited {proc.returncode}")
    check(not summ["partial"] and summ["verified"] == 16
          and summ["metric"] == "spgemm_gflops_geomean_16",
          f"suite: partial {summ['partial']}, verified {summ['verified']}")
    check(all(row.get("check") == "pass" for row in summ["detail"].values()),
          f"suite check failures: {summ['check_failures']}")
    check(sorted(summ.get("masked", {})) == ["cant", "pdb1HYS"] and not any(
        "error" in v for v in summ["masked"].values()),
        f"masked contract entries: {summ.get('masked')}")
    text = (proc.stdout + proc.stderr).lower()
    check("jax" not in text and "mh_spgemm_tpu" not in text,
          "the suite's output mentions JAX")
    # a second process warms its plans from the records the run saved
    warm = [sys.executable, "-m", "mh_spgemm_torch.bench.suite",
            "--matrices", ",".join(SUITE_REWARM), "--masked", "", "--out",
            os.path.join(build, "suite_rewarm.json")]
    proc = subprocess.run(warm, cwd=root, capture_output=True, text=True,
                          timeout=600, env=env)
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith('{"member"')]
    print("suite plan_cache " + json.dumps({
        r["member"]: {k: r.get(k) for k in ("plan_cache", "check",
                                            "total_ms", "seconds")}
        for r in rows}))
    check(proc.returncode == 0 and len(rows) == len(SUITE_REWARM) and all(
        r["plan_cache"] == "hit" and r["check"] == "pass" for r in rows),
        f"plan-cache rerun (rc {proc.returncode}): {rows} "
        f"{proc.stderr[-1500:]}")
    return summ


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mh_spgemm_torch as mt
    from mh_spgemm_torch import _build
    from mh_spgemm_torch.io.suites import load_matrix
    from mh_spgemm_torch.ops import blockdense as tbd
    from mh_spgemm_torch.ops import bucketed as bk
    from mh_spgemm_torch.ops import esc_tail as et
    from mh_spgemm_torch.ops import gather_front as gf
    from mh_spgemm_torch.ops import pair_matmul as pm
    from mh_spgemm_torch.ops import planned as pn
    from mh_spgemm_torch.ops import ragged_fill as rf
    from mh_spgemm_torch.ops import remote_fetch as rfx

    # the plain versions and the library yardstick compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    clock = [t_start]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    ptxas = build_phase(_build)
    for tag, count in (("9tail_warp", 16), ("9tail_tile", 10)):
        ks = [k for k in ptxas["esc_tail"] if tag in k["kernel"]]
        check(len(ks) == count and all(k["spill_bytes"] == 0
                                       and k["stack_bytes"] == 0
                                       for k in ks),
              f"the tail's {tag[1:]} kernels spill or use local memory "
              f"(or are not {count}): {ks}")
    sass = sass_phase(torch, _build, pm)
    done("build and SASS")
    bd_mats = {name: load_matrix(name) for name in BD_MATRICES}
    done("load block-dense stand-ins")
    errs = kernel_phase(torch, et, dev)
    serrs = slab_tail_phase(torch, et, dev)
    ferr = fill_kernel_phase(torch, rf, bk, dev)
    pnerrs = planned_kernel_phase(torch, pn, dev)
    herr = halo_kernel_phase(torch, rfx, dev)
    perrs = pair_kernel_phase(torch, pm, tbd, bd_mats["pdb1HYS"], dev)
    done("kernels")
    tg = gather_front_phase(torch, mt, bk, gf, dev)
    done("gather frontend")
    states, refs, mats, launches = main_path_phase(torch, mt, et, rf, pn,
                                                   gf, dev)
    done("bucketed")
    off_states = planned_vs_off_phase(torch, mt, mats, refs, states, dev)
    done("planned against off")
    dev_rows = device_engine_phase(torch, mt, et, rf, pn, rfx, pm, mats,
                                   refs, states, dev)
    digests = {}          # single-process distributed Cs, by mp_key
    dev_dist = device_dist_phase(torch, mt, mats, refs, digests)
    done("DeviceCSR engines and spgemm_dist(engine='esc')")
    ext_ms = breakdown_phase(et, bk, states)
    breakdown_phase(et, bk, off_states, label="stages_planned_off")
    t = time_tail(torch, et, *widest_pre(bk, off_states[FILL_MATRIX]),
                  label=f"{FILL_MATRIX} (planned off)")
    del off_states
    tf = time_fill(torch, rf, bk, states[FILL_MATRIX])
    tp = time_planned(torch, pn, bk, states[PLANNED_TIMING])
    done("bucketed stages, esc_tail_flat, ragged_fill, pgather and "
         "proute timing")
    fill_state, fill_launches = fill_phase(
        torch, mt, et, rf, mats[FILL_MATRIX], refs[FILL_MATRIX],
        states[FILL_MATRIX], dev)
    ts = time_slab_tail(torch, et, bk, fill_state)
    del states, fill_state
    done("forced fill and esc_tail timing")
    bd_states, bd_launches = blockdense_phase(torch, mt, pm, rf, bd_mats,
                                              dev)
    done("block-dense")
    ext_ms.update(blockdense_stages(torch, pm, tbd, bk, bd_mats, bd_states,
                                    dev))
    pt = time_pair_kernels(torch, pm, tbd, bd_states)
    del bd_states
    done("block-dense stages and pair-kernel timing")
    m_launches = masked_phase(torch, mt, rf, gf, mats, refs, dev)
    done("masked")
    dist_rows, dist_launches, dist_states = dist_phase(
        torch, mt, rfx, et, rf, gf, mats, refs, digests)
    th = time_halo(torch, rfx, dist_states)
    del mats, refs, dist_states
    done("distributed and halo_exchange timing")
    tt, tts, tile_launches = tile_phase(torch, mt, et, bk, dev)
    done("tile path: cage15 and cop20k_A")
    torch.cuda.empty_cache()          # the ranks below share the card
    mp = multiprocess_phase(digests)
    done("multi-process spgemm_dist")
    db = dist_bench_phase()
    db_esc = dist_bench_phase("esc")
    done("dist_bench")
    cli = cli_phase()
    done("cli")
    torch.cuda.empty_cache()          # the subprocesses below need the card
    soak = soak_phase()
    done("soak")
    suite = suite_phase()
    done("suite")
    print("extraction " + json.dumps({
        name: {k: v for k, v in row.items() if k.startswith("extract")}
        for name, row in ext_ms.items()}))
    tail_by_phase = {"bucketed": launches["esc_tail"],
                     "tile": tile_launches["esc_tail"],
                     "forced_fill": fill_launches["esc_tail"],
                     "distributed": dist_launches["esc_tail"],
                     "multiprocess": mp["launches"]["esc_tail"]}
    fill_by_phase = {"bucketed": launches["ragged_fill"],
                     "forced_fill": fill_launches["ragged_fill"],
                     "blockdense": bd_launches["ragged_fill"],
                     "masked": sum(m_launches["ragged_fill"].values()),
                     "distributed": dist_launches["ragged_fill"],
                     "multiprocess": mp["launches"]["ragged_fill"]}
    gather_by_phase = {
        "bucketed": launches["gather_front"],
        "masked": sum(m_launches["gather_front"].values()),
        "distributed": dist_launches["gather_front"],
        "multiprocess": mp["launches"]["gather_front"]}
    replaces = {"pair_matmul_f32": "mh_spgemm_tpu/ops/pallas_gather.py:108",
                "pair_matmul_f64": "mh_spgemm_tpu/ops/ozaki.py:201",
                "block_gather": "mh_spgemm_tpu/ops/pallas_gather.py:43"}
    kernels = {"kernels": [{
        "name": "esc_tail_flat", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/esc_tail.cu",
        "replaces": "mh_spgemm_tpu/ops/esc_tail.py:234",
        "launches": launches["esc_tail_flat"]
        + tile_launches["esc_tail_flat"] + mp["launches"]["esc_tail_flat"],
        "launches_by_phase": {
            "bucketed": launches["esc_tail_flat"],
            "tile": tile_launches["esc_tail_flat"],
            "multiprocess": mp["launches"]["esc_tail_flat"]},
        "max_abs_err": errs[torch.float64],
        "max_abs_err_f32": errs[torch.float32],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "timed_w2": t["w2"], "timed_slots": t["slots"],
        "timed_on": f"{FILL_MATRIX} (planned off), {t['path']} path",
        "tile": dict(tt, timed_on="cage15 (planned off), pre class")}, {
        "name": "esc_tail", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/esc_tail.cu",
        "replaces": "mh_spgemm_tpu/ops/esc_tail.py:286",
        "launches": sum(tail_by_phase.values()),
        "launches_by_phase": tail_by_phase,
        "max_abs_err": serrs[torch.float64],
        "max_abs_err_f32": serrs[torch.float32],
        "ms": ts["ms"], "plain_ms": ts["plain_ms"],
        "bound_ms": ts["bound_ms"], "bound_by": ts["bound_by"],
        "library_ms": ts["library_ms"],
        "timed_w2": ts["w2"], "timed_slots": ts["slots"],
        "timed_on": f"{FILL_MATRIX} forced fill W={ts['w2']}",
        "tile": dict(tts, timed_on="cop20k_A (default), gather class")}, {
        "name": "ragged_fill", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/ragged_fill.cu",
        "replaces": "mh_spgemm_tpu/ops/ragged_fill.py:156",
        "launches": sum(fill_by_phase.values()),
        "launches_by_phase": fill_by_phase,
        "max_abs_err": ferr,
        "ms": tf["ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"],
        "library_ms": tf["library_ms"],
        "timed_on": f"{FILL_MATRIX} windowed extraction",
        "timed_words": tf["words"]}, {
        "name": "gather_front", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/gather_front.cu",
        "replaces": None,
        "launches": sum(gather_by_phase.values()),
        "launches_by_phase": gather_by_phase,
        "timed_launches": tg["timed_launches"],
        "max_abs_err": tg["max_abs_err"],
        **{k: tg["er_s17_ef16"][k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "timed_on": "er_s17_ef16's five gather classes",
        "er_s17_ef16": tg["er_s17_ef16"],
        "g500_s15_ef16": tg["g500_s15_ef16"]}] + [{
            "name": name, "route": "cuda",
            "source": "mh_spgemm_torch/csrc/planned.cu",
            "replaces": f"mh_spgemm_tpu/ops/planned.py:{line}",
            "launches": launches[name], "max_abs_err": pnerrs[name],
            "ms": tp[key]["ms"], "plain_ms": tp[key]["plain_ms"],
            "bound_ms": tp[key]["bound_ms"], "bound_by": tp[key]["bound_by"],
            "library_ms": tp[key]["library_ms"],
            "launch_ms": tp[key]["launch_ms"],
            "device_ms": tp[key]["device_ms"],
            "timed_on": f"{PLANNED_TIMING} widest planned class",
            "extraction": ({k: tp[ext][k] for k in (
                "ms", "launch_ms", "device_ms", "plain_ms", "bound_ms",
                "library_ms")} if ext in tp else None),
            "hold": ({k: tp["hold"][k] for k in (
                "ms", "launch_ms", "device_ms", "plain_ms", "bound_ms", "m",
                "networks", "hold")} if name == "proute" else None),
            "f64_load_off": ({where: {k: tp[at][f"apart_{k}"] for k in (
                "launch_ms", "device_ms")} for where, at in (
                    ("class", key), ("extraction", ext)) if at in tp}
                if name == "pgather" else None),
            "host_us": tp[key].get("host_us"),
            # records device_profile took for each device time (a rising
            # count is the profiler flaking more, not the kernel)
            "profile_attempts": {where: tp[at]["profile_attempts"]
                                 for where, at in (
                                     ("timed", key), ("extraction", ext),
                                     ("hold", "hold" if name == "proute"
                                      else None)) if at in tp},
            "ptxas": [k for k in ptxas["planned"]
                      if any(s in k["kernel"] for s in names)]}
            for name, key, ext, line, names in (
                ("pgather", "class", "ext_gather", 177, ("13gather_blocks",)),
                ("proute", "route", "ext_route", 386,
                 ("9route_all", "12route_gather", "14hold_tile_last")))] + [{
            "name": name, "route": "cuda",
            "source": "mh_spgemm_torch/csrc/pair_matmul.cu",
            "replaces": replaces[name],
            "launches": bd_launches[name], "max_abs_err": perrs[name],
            **{k: pt[name]["pwtk"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "timed_on": "pwtk",
            "pwtk": pt[name]["pwtk"], "pdb1HYS": pt[name]["pdb1HYS"],
            "sass": sass[name],
            "f32_accuracy": (perrs["f32_accuracy"]
                             if name == "pair_matmul_f32" else None),
            "ptxas": [k for k in ptxas["pair_matmul"]
                      if PAIR_KERNELS[name] in k["kernel"]]}
            for name in ("pair_matmul_f32", "pair_matmul_f64")] + [{
            "name": "block_gather", "route": "cuda",
            "source": "mh_spgemm_torch/csrc/pair_matmul.cu",
            "replaces": replaces["block_gather"],
            "launches": bd_launches["block_gather"],
            "max_abs_err": perrs["block_gather"],
            **{k: pt["block_gather"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "timed_on": "pwtk",
            "ptxas": [k for k in ptxas["pair_matmul"]
                      if "block_gather_kernel" in k["kernel"]]}] + [{
        "name": "halo_exchange", "route": "cuda",
        "source": "mh_spgemm_torch/csrc/remote_fetch.cu",
        "replaces": "mh_spgemm_tpu/ops/remote_fetch.py:67",
        "launches": (dist_launches["halo_exchange"]
                     + mp["launches"]["halo_exchange"]),
        "launches_by_phase": {
            "distributed": dist_launches["halo_exchange"],
            "multiprocess": mp["launches"]["halo_exchange"]},
        "max_abs_err": herr,
        "ms": th["cage12"]["ms"], "plain_ms": th["cage12"]["plain_ms"],
        "bound_ms": th["cage12"]["bound_ms"],
        "bound_by": th["cage12"]["bound_by"],
        "library_ms": th["cage12"]["library_ms"],
        "timed_on": f"cage12 D={DIST_SHARDS} ragged exchange",
        "timed_words": th["cage12"]["words"],
        "launch_ms": th["cage12"]["launch_ms"],
        "scircuit": {k: th["scircuit"][k] for k in
                     ("ms", "launch_ms", "plain_ms", "bound_ms",
                      "library_ms", "words")}}]}
    for k in kernels["kernels"]:           # what ptxas made of its source
        src = os.path.basename(k["source"])[:-len(".cu")]
        k.setdefault("ptxas", ptxas[src])
        if k["name"] in soak["launches"]:  # the soak's subprocesses
            k["soak_launches"] = soak["launches"][k["name"]]
    print(json.dumps({"cli_gflops": cli["gflops"],
                      "dist_bench": db["devices"],
                      "dist_bench_esc": db_esc["devices"],
                      "device_engines_warm_ms": {
                          name: {m: row[m]["warm_ms"] for m in
                                 ("esc", "masked") if "warm_ms" in
                                 row.get(m, {})}
                          for name, row in dev_rows.items()},
                      "dist_esc_warm_ms": {
                          f"{r['matrix']} {r['strategy']}": r["warm_ms"]
                          for r in dev_dist},
                      "multiprocess_warm_ms": {
                          f"{r['matrix']} {r['processes']}x"
                          f"{r['shards_per_process']} {r['call']}":
                          r["warm_ms"] for r in mp["rows"]
                          if r["rank"] == 0},
                      "multiprocess_turns": mp["turns"],
                      "soak_seconds": soak["seconds"],
                      "soak_failures": len(soak["failures"]),
                      "suite_metric": suite["metric"],
                      "suite_value": suite["value"],
                      "suite_warm_ms": {
                          name: row["total_ms"]
                          for name, row in suite["detail"].items()},
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
