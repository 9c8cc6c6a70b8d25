"""Planned frontend kernels: a host-scheduled windowed gather (``pgather``)
and a host-simulated routing network (``proute``) — the port of
``mh_spgemm_tpu/ops/planned.py`` (``pgather`` :177, ``proute`` :386).

The precomputed frontend's slot sources are plan constants, so the JAX
package schedules all of its data movement on the host:

* :func:`plan_pgather` sorts a class chunk's sources and bins them into
  output rows of 128 that each read one aligned 8192-word superwindow of
  the table, 8 rows per scheduled block; :func:`pgather` executes the
  schedule, ``out[j, l] = tab[(wblk[g] * 64 + rowsel[j, lane[j, l]]) * 128
  + lane[j, l]]`` per plane;
* :func:`plan_route` simulates a bitonic sort of the static destination
  keys and records every stage's take bit; :func:`proute` replays those
  stages with no comparisons (position ``f`` takes the word at ``f ^ j``
  where its bit is set), which applies the permutation ``out[dest[i]] =
  in[i]``, and can finish with a segmented hold that broadcasts run-head
  words down their runs (the JAX kernel's passes, replayed exactly).

The host functions are numpy and give the JAX package's arrays exactly;
``plan_route``'s simulation works on reshaped views instead of index
gathers, and :func:`plan_routes` runs the chunks of a class at once.  The
kernels (``csrc/planned.cu``) take the schedules unchanged; the TPU
kernels' sublane gathers, 8-way row selects and roll pairs do not come
across.  :func:`pgather` and :func:`proute` launch the CUDA kernels for
CUDA tensors and take :func:`pgather_plain` and :func:`proute_plain` only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..errors import DeviceError


# ---------------------------------------------------------------------------
# Host: windowed gather schedule (the JAX planner's, verbatim)
# ---------------------------------------------------------------------------

def plan_pgather(src: np.ndarray, table_words: int):
    """Schedule a gather of ``src`` (any order, all >= 0) as windowed
    gathers: every scheduled output row reads one aligned 8192-word
    superwindow (64 table rows of 128), and the 8 rows of a scheduled
    block share it.  ``table_words`` is unused (kept from the JAX
    signature).

    Returns (wblk int32[Gb], rowsel int32[Gb*8, 128], lane int32[Gb*8,
    128], perm int64[Gb*1024]): ``wblk[g]`` is the superwindow of rows
    8g..8g+7, ``rowsel[j, l]`` the window row that lane ``l`` of row ``j``
    reads, ``lane[j, l]`` the lane that output position ``l`` of row ``j``
    takes, and ``perm[p]`` the index into ``src`` landing at scheduled
    position ``p`` (-1 pad).

    Returns None when more than 64 x 128 slots fall on one window row
    (the row would need more than 64 copies), where the JAX planner
    asserts; the port's callers leave such a chunk unscheduled."""
    S = src.size
    if S == 0:
        return (np.zeros(1, np.int32), np.zeros((8, 128), np.int32),
                np.zeros((8, 128), np.int32), np.full(1024, -1, np.int64))
    order = np.argsort(src, kind="stable")
    ss = src[order].astype(np.int64)
    win = ss // 8192                      # aligned superwindow id
    wrow = (ss // 128) % 64               # window row 0..63
    lane = (ss % 128).astype(np.int64)
    # rank of each slot's window row among the distinct window rows of
    # its (window, lane)
    key_wl = win * 128 + lane
    o2 = np.argsort(key_wl, kind="stable")
    kw = key_wl[o2]
    wr = wrow[o2]
    new_group = np.concatenate([[True], kw[1:] != kw[:-1]])
    new_val = new_group | (wr != np.concatenate([[-1], wr[:-1]]))
    val_cum = np.cumsum(new_val)
    start_of_group = np.maximum.accumulate(
        np.where(new_group, val_cum - 1, 0))
    rank = val_cum - 1 - start_of_group
    lwin = win[o2]
    assert rank.max(initial=0) < 64    # <= 64 distinct rows per window
    lkey = lwin * 64 + rank
    # more than 128 slots sharing (window, rank) clone the row
    o3 = np.argsort(lkey, kind="stable")
    lk = lkey[o3]
    first = np.searchsorted(lk, lk)
    pos_in = np.arange(lk.size) - first
    clone = pos_in // 128
    col = pos_in % 128
    if clone.max(initial=0) >= 64:
        return None            # a window row would need over 64 copies
    pkey = lk * 64 + np.minimum(clone, 63)
    pu, pinv = np.unique(pkey, return_inverse=True)
    nrows = pu.size
    row_win = pu // (64 * 64)
    # physical rows grouped into 8-row scheduled blocks per window
    wb_starts = np.flatnonzero(np.concatenate(
        [[True], row_win[1:] != row_win[:-1]]))
    wb_ends = np.concatenate([wb_starts[1:], [nrows]])
    wb_pieces = -(-(wb_ends - wb_starts) // 8)
    Gb = int(wb_pieces.sum())
    wblk = np.repeat(row_win[wb_starts], wb_pieces).astype(np.int32)
    sched_row = (np.repeat(
        np.cumsum(wb_pieces) - wb_pieces, wb_ends - wb_starts) * 8
        + np.arange(nrows)
        - np.repeat(wb_starts, wb_ends - wb_starts))
    rowsel = np.zeros((Gb * 8, 128), np.int32)
    lanep = np.zeros((Gb * 8, 128), np.int32)
    perm = np.full(Gb * 1024, -1, np.int64)
    srow = sched_row[pinv]
    sl_lane = lane[o2][o3]
    sl_wrow = wr[o3]
    sl_orig = order[o2][o3]
    rowsel[srow, sl_lane] = sl_wrow.astype(np.int32)
    lanep[srow, col] = sl_lane.astype(np.int32)
    perm[srow * 128 + col] = sl_orig
    return wblk, rowsel, lanep, perm


# ---------------------------------------------------------------------------
# Host: static routing masks (simulated bitonic network)
# ---------------------------------------------------------------------------

def _stage_list(m: int):
    """Bitonic stage (k, j) pairs for width ``m`` (pow2)."""
    out = []
    k = 2
    while k <= m:
        j = k >> 1
        while j >= 1:
            out.append((k, j))
            j >>= 1
        k <<= 1
    return out


def _nstages(m: int) -> int:
    """Stages of the bitonic network of width ``m`` (pow2):
    ``len(_stage_list(m))``."""
    n = m.bit_length() - 1
    return n * (n + 1) // 2


def _pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _simulate(key: np.ndarray) -> np.ndarray:
    """The bitonic simulation of :func:`plan_routes` on ``key`` [n, m]
    (sorted in place); returns the masks as uint32[n, nwords, m]."""
    n, m = key.shape
    stages = _stage_list(m)
    masks = np.zeros(((len(stages) + 31) // 32, n, m), np.uint32)
    for s, (k, j) in enumerate(stages):
        shape = ((n, m // (2 * k), 2, k // (2 * j), 2, j) if k < m
                 else (n, 1, 1, m // (2 * j), 2, j))
        v = key.reshape(shape)
        lo, hi = v[..., 0, :], v[..., 1, :]
        swap = np.greater(lo, hi)                        # ascending
        if k < m:
            np.less(lo[:, :, 1], hi[:, :, 1], out=swap[:, :, 1])
        new_lo = np.where(swap, hi, lo)
        hi[...] = np.where(swap, lo, hi)
        lo[...] = new_lo
        bit = swap.astype(np.uint32) << np.uint32(s & 31)
        mv = masks[s >> 5].reshape(shape)
        mv[..., 0, :] |= bit
        mv[..., 1, :] |= bit
    return masks.transpose(1, 0, 2)


def plan_routes(dest: np.ndarray):
    """:func:`plan_route` for ``n`` networks at once: ``dest`` int64[n, m]
    (each row distinct keys, ``m`` a power of two).  Returns (masks
    int32[n, nwords, m], nstages), each network's masks those of
    ``plan_route`` on its row.

    The simulation is the JAX planner's step for step, on views: at stage
    (k, j) the key array is seen as [n, m/2k, 2, k/2j, 2, j], so a pair
    (f, f ^ j) is (lo, hi) of one view and bit k of f (the direction) is
    an axis.  Both slots of a pair take their partner exactly when the
    lower one is out of order, so one comparison gives both bits.  The
    networks are simulated on up to 8 threads (numpy releases the GIL in
    its loops)."""
    n, m = dest.shape
    assert m & (m - 1) == 0 and m >= 2
    dest = np.asarray(dest, dtype=np.int64)
    small = dest.size == 0 or (dest.max() < 2**31 and dest.min() >= -2**31)
    key = dest.astype(np.int32 if small else np.int64)
    nthreads = min(8, n, os.cpu_count() or 1)
    if nthreads > 1:
        with ThreadPoolExecutor(nthreads) as ex:
            parts = list(ex.map(_simulate, np.array_split(key, nthreads)))
        masks = np.concatenate(parts)
    else:
        masks = _simulate(key)
    assert np.array_equal(key, np.sort(dest, axis=1)), \
        "routing simulation bug"
    return np.ascontiguousarray(masks).view(np.int32), len(_stage_list(m))


def plan_route(dest: np.ndarray, m: int):
    """Simulate a bitonic sort of the static keys ``dest`` (int64[m],
    distinct) and record each stage's take bit, bit-packed into int32
    words (bit ``s & 31`` of word ``s >> 5`` is stage ``s``).  Replaying
    these masks applies the permutation ``out[dest[i]] = in[i]``.
    Returns (masks int32[nwords, m], nstages), the JAX planner's
    arrays."""
    assert m & (m - 1) == 0 and dest.size == m
    masks, nst = plan_routes(np.asarray(dest).reshape(1, m))
    return masks[0], nst


def route_dest(perm: np.ndarray, m: int,
               dst_pos: Optional[np.ndarray] = None) -> np.ndarray:
    """Destination keys of a routing network of width ``m`` after a
    scheduled gather: scheduled position ``p`` with ``perm[p] >= 0`` goes
    to ``dst_pos[perm[p]]`` (to ``perm[p]`` without ``dst_pos``); every
    other position (schedule pads, and the tail past the schedule) takes
    the free destinations in ascending order.  Returns int64[m], the JAX
    planner's ``dest``."""
    pm2 = np.full(m, -1, np.int64)
    pm2[: perm.size] = perm
    live = pm2 >= 0
    dest = np.full(m, -1, np.int64)
    taken = pm2[live] if dst_pos is None else dst_pos[pm2[live]]
    dest[np.flatnonzero(live)] = taken
    dest[~live] = np.setdiff1d(np.arange(m, dtype=np.int64), taken)
    return dest


def pad_schedule(sch, m: int):
    """A :func:`plan_pgather` schedule padded to ``m // 1024`` blocks
    (zero window, row and lane words).  Returns (wblk, rowsel, lane)."""
    wb, rowsel, lane, _ = sch
    G = wb.shape[0]
    Gmax = m // 1024
    wb2 = np.zeros(Gmax, np.int32)
    wb2[:G] = wb
    rs2 = np.zeros((Gmax * 8, 128), np.int32)
    rs2[: G * 8] = rowsel
    ln2 = np.zeros((Gmax * 8, 128), np.int32)
    ln2[: G * 8] = lane
    return wb2, rs2, ln2


# ---------------------------------------------------------------------------
# Device: pgather
# ---------------------------------------------------------------------------

def _check_tabs(tabs: Sequence[torch.Tensor]) -> None:
    if not 1 <= len(tabs) <= 3:
        raise ValueError(f"{len(tabs)} planes given: 1 to 3 are taken")
    for t in tabs:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError("table planes must be 1-D int32 tensors")
        if t.device != tabs[0].device:
            raise ValueError("table planes must share a device")


def _check_schedule(wblk, rowsel, lane) -> tuple:
    if not (wblk.dtype == rowsel.dtype == lane.dtype == torch.int32):
        raise ValueError("wblk, rowsel and lane must be int32")
    if wblk.dim() < 1:
        raise ValueError("wblk must be [..., Gb]")
    batch, Gb = wblk.shape[:-1], wblk.shape[-1]
    want = batch + (Gb * 8, 128)
    if rowsel.shape != want or lane.shape != want:
        raise ValueError(f"rowsel {tuple(rowsel.shape)} and lane "
                         f"{tuple(lane.shape)} must be {tuple(want)}")
    if not (wblk.device == rowsel.device == lane.device):
        raise ValueError("wblk, rowsel and lane must share a device")
    return batch, Gb


def pgather_plain(tabs: Sequence[torch.Tensor], wblk: torch.Tensor,
                  rowsel: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pgather` (same contract): the
    schedule's index arithmetic, then one ``index_select`` per plane."""
    _check_tabs(tabs)
    batch, Gb = _check_schedule(wblk, rowsel, lane)
    ln = (lane.reshape(*batch, Gb, 8, 128).long() & 127)
    rs = rowsel.reshape(*batch, Gb, 8, 128).long()
    idx = ((wblk.long()[..., None, None] * 64 + torch.gather(rs, -1, ln))
           * 128 + ln).reshape(-1)
    outs = []
    for t in tabs:
        n = t.numel()
        ok = (idx >= 0) & (idx < n)
        got = (t.index_select(0, torch.where(ok, idx, 0)) if n
               else torch.zeros_like(idx, dtype=torch.int32))
        outs.append(torch.where(ok, got, 0).reshape(*batch, Gb * 1024))
    return torch.stack(outs)


def _lib():
    lib = _build.load("planned")
    if lib.pgather.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.pgather.argtypes = [p, ll, ll, p, ll, ll, p, ll, ll, i, i, p, p,
                                p, ll, p, ll, p]
        lib.pgather.restype = ctypes.c_int
        lib.proute.argtypes = [p, ll, p, p, ll, i, p, p, i, i, i, i, p]
        lib.proute.restype = ctypes.c_int
        lib.proute_scratch_words.argtypes = [i, i, i, i]
        lib.proute_scratch_words.restype = ll
        lib.proute_tiled.argtypes = lib.proute.argtypes[:-1] + [i, p]
        lib.proute_tiled.restype = ctypes.c_int
        lib.proute_tile_log.argtypes = [i, ll]
        lib.proute_tile_log.restype = i
    return lib


def _launch(dev: torch.device, fn, *args) -> int:
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``dev`` (a tensor's device, so with an index), with ``dev`` the
    current device (switched to only where it is not already).  The
    stream is read as a raw handle, without the host time of building a
    ``torch.cuda.Stream`` on every call."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def _f64_pair(tabs: Sequence[torch.Tensor]) -> int:
    """The first of two neighbouring planes that are the low and high
    words of one f64 array (both of word stride 2, the second one word
    past the first, the first 8-byte aligned), which the kernel reads with
    one 8-byte load; -1 where there is none."""
    for p in range(len(tabs) - 1):
        lo, hi = tabs[p], tabs[p + 1]
        if lo.stride(0) != 2 or hi.stride(0) != 2:
            continue
        at = lo.data_ptr()
        if (at % 8 == 0 and hi.data_ptr() == at + 4
                and lo.numel() == hi.numel()):
            return p
    return -1


def pgather(tabs: Sequence[torch.Tensor], wblk: torch.Tensor,
            rowsel: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Windowed gather of 1 to 3 int32 table planes on a
    :func:`plan_pgather` schedule.

    ``tabs[p]`` is a 1-D int32 tensor (any stride: the words of an f64
    value array are read in place as ``v.view(torch.int32)[w::2]``).
    ``wblk`` int32[..., Gb], ``rowsel`` and ``lane`` int32[..., Gb*8, 128];
    leading batch dimensions (the chunks of a class) run in one launch.
    Output position ``l`` of scheduled row ``j`` of block ``g`` takes
    ``tab[(wblk[g] * 64 + rowsel[j, ln]) * 128 + ln]`` with ``ln =
    lane[j, l] mod 128``; an index outside the table reads 0, as the JAX
    kernel's zero-padded table does.  Returns int32[P, ..., Gb*1024].

    CUDA tensors go through the kernel (``csrc/planned.cu``) on the
    current stream, two neighbouring planes that are one f64 array's
    words with one 8-byte load a value (:func:`_f64_pair`), and each
    launch adds one to ``pgather.launches``; CPU tensors take
    :func:`pgather_plain`.  Any other device raises."""
    _check_tabs(tabs)
    batch, Gb = _check_schedule(wblk, rowsel, lane)
    dev = wblk.device
    if tabs[0].device != dev:
        raise ValueError("tables and schedule must share a device")
    if dev.type == "cpu":
        return pgather_plain(tabs, wblk, rowsel, lane)
    if dev.type != "cuda":
        raise DeviceError(f"pgather has no kernel for {dev.type} tensors")
    nblocks = math.prod(batch) * Gb
    P = len(tabs)
    out = torch.empty((P, *batch, Gb * 1024), dtype=torch.int32, device=dev)
    if nblocks == 0:
        return out
    if not (wblk.is_contiguous() and rowsel.is_contiguous()
            and lane.is_contiguous()):
        raise ValueError("wblk, rowsel and lane must be contiguous")
    if lane.data_ptr() % 16:
        lane = lane.clone()                 # the kernel reads 16-byte rows
    planes = list(tabs) + [tabs[0]] * (3 - P)
    args = []
    for t in planes:
        args += [t.data_ptr(), t.stride(0), t.numel()]
    rc = _launch(dev, _lib().pgather, *args, P, _f64_pair(tabs),
                 wblk.data_ptr(), rowsel.data_ptr(), lane.data_ptr(),
                 nblocks, out.data_ptr(), nblocks * 1024)
    if rc != 0:
        raise DeviceError(f"pgather launch failed: CUDA error {rc} "
                          f"(blocks={nblocks}, planes={P})")
    pgather.launches += 1
    return out


pgather.launches = 0


# ---------------------------------------------------------------------------
# Device: proute
# ---------------------------------------------------------------------------

def _check_route(planes, masks, nstages, hold_w2, flags) -> tuple:
    if planes.dtype != torch.int32 or planes.dim() < 2:
        raise ValueError("planes must be int32 [P, ..., m]")
    P, m = planes.shape[0], planes.shape[-1]
    batch = tuple(planes.shape[1:-1])
    if not 1 <= P <= 3:
        raise ValueError(f"{P} planes given: 1 to 3 are taken")
    if m < 1024 or m & (m - 1):
        raise ValueError(f"m={m} must be a power of two >= 1024")
    nst = _nstages(m)
    if nstages != nst:
        raise ValueError(f"nstages={nstages}, but width {m} has {nst}")
    want = (*batch, (nst + 31) // 32, m)
    if masks.dtype != torch.int32 or tuple(masks.shape) != want:
        raise ValueError(f"masks must be int32 {want}, got "
                         f"{tuple(masks.shape)}")
    if hold_w2 < 1 or hold_w2 & (hold_w2 - 1) or hold_w2 > m:
        raise ValueError(f"hold_w2={hold_w2} must be a power of two <= m")
    if flags is not None and (flags.dtype != torch.int32
                              or tuple(flags.shape) != (*batch, m)):
        raise ValueError(f"flags must be int32 {(*batch, m)}")
    devs = {planes.device, masks.device} | (
        {flags.device} if flags is not None else set())
    if len(devs) != 1:
        raise ValueError("planes, masks and flags must share a device")
    return P, batch, m


def proute_plain(planes: torch.Tensor, masks: torch.Tensor, nstages: int,
                 hold_w2: int = 1,
                 flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`proute` (same contract): the stage
    loop on ``[..., m]`` planes with ``f ^ j`` partner indices, then the
    hold as ``log2(hold_w2)`` Hillis-Steele passes, the JAX kernel's
    steps."""
    P, batch, m = _check_route(planes, masks, nstages, hold_w2, flags)
    dev = planes.device
    nb = math.prod(batch)
    x = planes.reshape(P, nb, m)
    mk = masks.reshape(nb, -1, m)
    idx = torch.arange(m, device=dev)
    for s, (k, j) in enumerate(_stage_list(m)):
        take = ((mk[:, s >> 5] >> (s & 31)) & 1) != 0
        x = torch.where(take[None], x[:, :, idx ^ j], x)
    if hold_w2 > 1 and flags is not None:
        f = flags.reshape(nb, m) != 0
        fmod = idx & (hold_w2 - 1)
        d = 1
        while d < hold_w2:
            inseg = fmod >= d
            sv = torch.zeros_like(x)
            sv[..., d:] = x[..., :-d]
            sf = torch.ones_like(f)
            sf[:, d:] = f[:, :-d]
            x = torch.where(f[None], x, torch.where(inseg, sv, 0))
            f = f | torch.where(inseg, sf, True)
            d <<= 1
    return x.reshape(planes.shape)


def proute(planes: torch.Tensor, masks: torch.Tensor, nstages: int,
           hold_w2: int = 1,
           flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Replay a :func:`plan_route` network on int32 planes.

    ``planes`` int32[P, ..., m] (1 to 3 planes, ``m`` a power of two >=
    1024; leading batch dimensions are independent networks, the chunks
    of a class, run in one call), ``masks`` int32[..., nwords, m]: at
    stage ``s`` (k, j) of ``_stage_list(m)`` position ``f`` takes the
    word at ``f ^ j`` where bit ``s & 31`` of ``masks[s >> 5, f]`` is set.
    With ``hold_w2`` > 1 and ``flags`` int32[..., m] (nonzero at run
    heads), the JAX kernel's segmented hold follows, pass for pass: for d
    = 1, 2, 4, ... < ``hold_w2``, a slot whose flag is 0 takes the word d
    slots before it in its aligned ``hold_w2`` segment (0 past the segment
    start) and ORs in that slot's flag (1 past the segment start).  A slot
    with a flagged slot at or before it in its segment so ends with that
    last flagged slot's word; one without ends with 0 or a copy of an
    unflagged word, as the passes fall.  Returns int32[P, ..., m].

    CUDA tensors go through the kernels (``csrc/planned.cu``: the
    stages replayed on one plane of source indices, then one gather of
    the planes with the hold) on the current stream, and each call adds
    one to ``proute.launches``; CPU tensors take :func:`proute_plain`.
    Any other device raises.  The replay is one cooperative launch whose
    passes meet at grid barriers; a barrier that waits about a second
    (only a fault gets there) traps, so the launch fails and the next
    call that synchronises with the stream raises."""
    P, batch, m = _check_route(planes, masks, nstages, hold_w2, flags)
    dev = planes.device
    if dev.type == "cpu":
        return proute_plain(planes, masks, nstages, hold_w2, flags)
    if dev.type != "cuda":
        raise DeviceError(f"proute has no kernel for {dev.type} tensors")
    if flags is None:
        hold_w2 = 1
    nb = math.prod(batch)
    out = torch.empty_like(planes, memory_format=torch.contiguous_format)
    if nb == 0:
        return out
    if not (planes.is_contiguous() and masks.is_contiguous()
            and (flags is None or flags.is_contiguous())):
        raise ValueError("planes, masks and flags must be contiguous")
    if flags is not None and flags.data_ptr() % 16:
        flags = flags.clone()               # the kernels read 16-byte rows
    lib = _lib()
    scratch = torch.empty(lib.proute_scratch_words(P, nb, m, hold_w2),
                          dtype=torch.int32, device=dev)
    rc = _launch(dev, lib.proute, planes.data_ptr(), nb * m, out.data_ptr(),
                 scratch.data_ptr(), nb * m, P, masks.data_ptr(),
                 flags.data_ptr() if flags is not None else None, nb, m,
                 nstages, hold_w2)
    if rc != 0:
        raise DeviceError(f"proute launch failed: CUDA error {rc} "
                          f"(batch={nb}, m={m}, planes={P}, "
                          f"hold_w2={hold_w2})")
    proute.launches += 1
    return out


proute.launches = 0
