"""ESC tail: sort + accumulate + left-pack over aligned pow2 segments —
the port of ``mh_spgemm_tpu/ops/esc_tail.py:234`` (``esc_tail_flat``) and
``:286`` (``esc_tail``, the ``[rows, w2]`` slab form with a per-row
count).

Input: ``keys`` int32[slots] (2^31-1 marks an empty slot) and ``vals``
[slots] in the port's value type (float64, or float32), with
``slots % w2 == 0`` and ``w2`` a power of two in 2..2^30.  Output, per
aligned segment of ``w2`` slots: the distinct keys ascending with their
summed values, left-packed, then 2^31-1 keys with value 0; plus each
segment's output count.  The TPU kernel carried f64 values as double-f32
(hi, lo) pairs; the card has native f64, so the port computes in its own
value type.

The slab form :func:`esc_tail` is the same function on ``[rows, W]``
with one addition: slot j of row r counts as empty (key 2^31-1, value 0)
when ``j >= row_len[r]``, before the sort.  The fill frontend's slabs
hold undefined words past each row's products, so the count, not the
keys, says where a row ends.  W is ``w2`` or any width above ``w2 / 2``
(the 1.5x width grid's classes): up to 8192 each row is then sorted as a
segment of ``w2`` whose slots W..w2-1 are empty, and comes back at stride
W (a row keeps at most W survivors).

Rows wider than 8192, in either form, take the kernel's wide path
(:func:`path_for`): the tile path sorts, sums and packs each piece of
8192 slots (the last piece of a row shorter where 8192 does not divide
W), and rounds of pairwise merges join the packed runs, a key held by
both runs of a merge summed as left + right.  So the sums of a wide row
are added in that tree's order, which the plain version follows, and
not in one network's.

:func:`esc_tail_flat` and :func:`esc_tail` launch the CUDA kernel
``csrc/esc_tail.cu`` for CUDA tensors and take their plain versions only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..errors import DeviceError

I32_MAX = 2**31 - 1
_JAX_MAX_W2 = 1 << 16          # the JAX package's widest flat segment
_MAX_WARP_W2 = 1 << 8          # the warp path's widest segment
_MAX_PADDED_W = 1 << 13        # the tile path's widest segment
_PIECE = _MAX_PADDED_W         # the wide path's pieces
_MAX_FLAT_W2 = 1 << 30         # the widest flat segment (int32 slots)


def supported_w2(w: int) -> bool:
    """True when ``w`` is a flat segment width that the JAX package's
    tail takes too (a power of two in 2..65536): the widths that every
    device, CPU tensors included, sends to the kernel or its plain
    version."""
    return 2 <= w <= _JAX_MAX_W2 and (w & (w - 1)) == 0


def pad_w2(w: int) -> int:
    """The segment width that rows of ``w`` slots sort in: the next power
    of two at or above ``w``."""
    return 1 << max(0, int(w) - 1).bit_length()


def path_for(w2: int) -> str:
    """The path of ``csrc/esc_tail.cu`` that segments of width ``w2`` (a
    power of two) and rows of ``w2 / 2 < W <= w2`` slots take, the one
    table of the spans, the counters and the smoke (the kernel's dispatch
    splits at its ``kWarpMaxW2`` and ``kSmemMaxW2``, which a CUDA test
    holds to this): ``"warp"`` (w2 <= 256, a tile in each warp's
    registers), ``"tile"`` (to 8192, a block's shared memory) or
    ``"wide"`` (pieces on the tile path, then merge rounds in device
    memory)."""
    if w2 <= _MAX_WARP_W2:
        return "warp"
    return "tile" if w2 <= _MAX_PADDED_W else "wide"


def _tail_plain(K: torch.Tensor, V: torch.Tensor):
    """The tail on ``[segments, w2]`` in torch ops, step for step the
    kernel's warp and tile paths: the same bitonic network (ties
    never swap), then the same Hillis-Steele passes, so values are added
    in the kernel's order (and the TPU kernel's).  Returns (packed keys,
    packed values, counts)."""
    S, w2 = K.shape
    dev = K.device
    idx = torch.arange(w2, device=dev)
    k = 2
    while k <= w2:
        j = k >> 1
        while j >= 1:
            partner = idx ^ j
            pk, pv = K[:, partner], V[:, partner]
            # the lower slot of a pair takes the minimum on an ascending
            # stage (bit k of its index clear), the upper one the maximum
            want_min = ((idx & j) == 0) == ((idx & k) == 0)
            take = torch.where(want_min, pk < K, pk > K)
            K = torch.where(take, pk, K)
            V = torch.where(take, pv, V)
            j >>= 1
        k <<= 1
    d = 1
    while d < w2:
        same = torch.zeros_like(K, dtype=torch.bool)
        same[:, d:] = K[:, d:] == K[:, :-d]
        prev = torch.zeros_like(V)
        prev[:, d:] = V[:, :-d]
        V = torch.where(same, V + prev, V)
        d <<= 1
    valid = K < I32_MAX
    head = valid.clone()
    head[:, 1:] &= K[:, 1:] != K[:, :-1]
    end = valid.clone()
    end[:, :-1] &= K[:, 1:] != K[:, :-1]
    rank = torch.cumsum(head, dim=1, dtype=torch.int64) - 1
    counts = head.sum(dim=1, dtype=torch.int32)
    dst = (torch.arange(S, device=dev, dtype=torch.int64)[:, None] * w2
           + rank)[end]
    out_k = torch.full((S * w2,), I32_MAX, dtype=torch.int32, device=dev)
    out_v = torch.zeros(S * w2, dtype=V.dtype, device=dev)
    out_k[dst] = K[end]
    out_v[dst] = V[end]
    return out_k, out_v, counts


def _wide_plain(K: torch.Tensor, V: torch.Tensor):
    """The wide path on ``[rows, W]`` (W > 8192; slots to leave out
    already empty) in torch ops, in the kernel's order of additions: each
    piece of 8192 slots (the last one padded with empty slots) through
    :func:`_tail_plain`, then pairwise merges of the packed runs, run 2q
    with run 2q + 1 (a run without a partner merges with an empty one),
    a key of both runs summed as left + right.  Returns (packed keys
    [rows, W], packed values [rows, W], counts)."""
    rows, W = K.shape
    n = -(-W // _PIECE)
    pad = n * _PIECE - W
    if pad:
        K = torch.cat([K, K.new_full((rows, pad), I32_MAX)], dim=1)
        V = torch.cat([V, V.new_zeros((rows, pad))], dim=1)
    oK, oV, counts = _tail_plain(K.reshape(rows * n, _PIECE),
                                 V.reshape(rows * n, _PIECE))
    oK, oV, run = oK.view(rows, n, _PIECE), oV.view(rows, n, _PIECE), _PIECE
    while n > 1:
        if n % 2:
            oK = torch.cat([oK, oK.new_full((rows, 1, run), I32_MAX)], dim=1)
            oV = torch.cat([oV, oV.new_zeros((rows, 1, run))], dim=1)
            n += 1
        n, run = n // 2, run * 2
        # run 2q then run 2q + 1: a stable sort puts a left key before its
        # right twin
        sK, order = torch.sort(oK.reshape(rows, n, run), dim=-1, stable=True)
        sV = torch.gather(oV.reshape(rows, n, run), -1, order)
        twin = (sK[..., 1:] == sK[..., :-1]) & (sK[..., :-1] < I32_MAX)
        sV = torch.cat([torch.where(twin, sV[..., :-1] + sV[..., 1:],
                                    sV[..., :-1]), sV[..., -1:]], dim=-1)
        keep = sK < I32_MAX
        keep[..., 1:] &= ~twin
        first = torch.sort((~keep).to(torch.int8), dim=-1, stable=True)[1]
        counts = keep.sum(dim=-1, dtype=torch.int32)
        live = (torch.arange(run, device=K.device)
                < counts[..., None].to(torch.int64))
        oK = torch.where(live, torch.gather(sK, -1, first), I32_MAX)
        oV = torch.where(live, torch.gather(sV, -1, first),
                         torch.zeros((), dtype=V.dtype, device=V.device))
    return (oK.reshape(rows, -1)[:, :W].contiguous(),
            oV.reshape(rows, -1)[:, :W].contiguous(), counts.reshape(rows))


def esc_tail_flat_plain(keys: torch.Tensor, vals: torch.Tensor, *,
                        w2: int):
    """Plain PyTorch version of the flat tail (same contract as
    :func:`esc_tail_flat`, same order of additions)."""
    S = keys.shape[0] // w2
    if w2 > _PIECE:
        oK, oV, cnt = _wide_plain(keys.view(S, w2), vals.view(S, w2))
        return oK.view(-1), oV.view(-1), cnt
    return _tail_plain(keys.view(S, w2), vals.view(S, w2))


def _check(keys: torch.Tensor, vals: torch.Tensor, w2: int,
           w: Optional[int] = None) -> None:
    w = w2 if w is None else w
    if w2 < 2 or w2 & (w2 - 1) or (w == w2 and w2 > _MAX_FLAT_W2):
        raise ValueError(f"w2={w2}: segments must be a power of two in "
                         f"2..{_MAX_FLAT_W2}")
    if w != w2 and not (2 <= w <= I32_MAX and pad_w2(w) == w2):
        raise ValueError(f"rows of {w} slots do not pad to w2={w2} (w2 / 2 "
                         f"< W <= w2, W <= {I32_MAX})")
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("keys must be a 1-D int32 tensor")
    if vals.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"values of type {vals.dtype} are not supported")
    if vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError("keys and values must match in shape and device")
    if keys.shape[0] % w:
        raise ValueError(f"{keys.shape[0]} slots are not a multiple of "
                         f"{w}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and values must be contiguous")


def _kernel_fn(vdtype: torch.dtype, slab: bool = False):
    lib = _build.load("esc_tail")
    name = ("esc_tail" if slab else "esc_tail_flat") + (
        "_f64" if vdtype == torch.float64 else "_f32")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p] * (6 if slab else 5)
                       + [ctypes.c_longlong, ctypes.c_int, p, p])
        fn.restype = ctypes.c_int
        lib.esc_tail_flat_scratch_bytes.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.esc_tail_flat_scratch_bytes.restype = ctypes.c_longlong
    return lib, fn


def esc_tail_flat(keys: torch.Tensor, vals: torch.Tensor, *, w2: int):
    """Flat tail over ``[slots]`` planes; returns (packed keys int32
    [slots], packed values [slots], per-segment counts int32
    [slots / w2]).

    CUDA tensors go through the kernel (``csrc/esc_tail.cu``) on the
    current stream, and each launch adds one to
    ``esc_tail_flat.launches``; CPU tensors take
    :func:`esc_tail_flat_plain`.  Any other device raises."""
    _check(keys, vals, w2)
    if keys.device.type == "cpu":
        return esc_tail_flat_plain(keys, vals, w2=w2)
    if keys.device.type != "cuda":
        raise DeviceError(f"esc_tail_flat has no kernel for "
                          f"{keys.device.type} tensors")
    slots = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    counts = torch.empty(slots // w2, dtype=torch.int32, device=keys.device)
    if slots == 0:
        return out_k, out_v, counts
    lib, fn = _kernel_fn(vals.dtype)
    nbytes = lib.esc_tail_flat_scratch_bytes(slots, w2, vals.element_size())
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=keys.device)
               if nbytes else None)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), vals.data_ptr(), out_k.data_ptr(),
                out_v.data_ptr(), counts.data_ptr(), slots, w2,
                scratch.data_ptr() if scratch is not None else None, stream)
    if rc != 0:
        raise DeviceError(f"esc_tail_flat launch failed: CUDA error {rc} "
                          f"(slots={slots}, w2={w2}, {vals.dtype})")
    esc_tail_flat.launches += 1
    return out_k, out_v, counts


esc_tail_flat.launches = 0


def esc_tail_plain(keys: torch.Tensor, vals: torch.Tensor,
                   row_len: torch.Tensor, *, w2: int):
    """Plain PyTorch version of :func:`esc_tail` (same contract, same
    order of additions): pad each row of W slots to ``w2`` with empty
    slots (2^31-1, 0), mask the slots past each row's count, run the flat
    tail's steps and cut each row back to W; rows wider than 8192 take
    the wide path's steps."""
    rows, W = keys.shape
    live = (torch.arange(W, device=keys.device)[None, :]
            < row_len.to(torch.int64)[:, None])
    if W > _MAX_PADDED_W:
        return _wide_plain(torch.where(live, keys, I32_MAX),
                           torch.where(live, vals, torch.zeros(
                               (), dtype=vals.dtype, device=vals.device)))
    K = torch.full((rows, w2), I32_MAX, dtype=keys.dtype,
                   device=keys.device)
    V = torch.zeros((rows, w2), dtype=vals.dtype, device=vals.device)
    K[:, :W] = torch.where(live, keys, I32_MAX)
    V[:, :W] = torch.where(live, vals, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device))
    oK, oV, cnt = _tail_plain(K, V)
    return (oK.view(rows, w2)[:, :W].contiguous(),
            oV.view(rows, w2)[:, :W].contiguous(), cnt)


def esc_tail(keys: torch.Tensor, vals: torch.Tensor, row_len: torch.Tensor,
             *, w2: int):
    """Tail over ``[rows, W]`` slabs with per-row counts, ``w2 / 2 < W <=
    w2`` (``w2`` is :func:`pad_w2` of W, any W up to 2^31-1); returns
    (packed keys int32 [rows, W], packed values [rows, W], per-row output
    counts int32 [rows]).  Slots at or past ``row_len[r]`` are empty
    whatever they hold.

    CUDA tensors go through the kernel (``csrc/esc_tail.cu``) on the
    current stream, and each launch adds one to ``esc_tail.launches``;
    CPU tensors take :func:`esc_tail_plain`.  Any other device raises."""
    if keys.dim() != 2:
        raise ValueError(f"keys must be [rows, W], got {tuple(keys.shape)}")
    W = keys.shape[1]
    if row_len.dtype != torch.int32 or row_len.shape != keys.shape[:1] \
            or row_len.device != keys.device \
            or not row_len.is_contiguous():
        raise ValueError("row_len must be a contiguous int32 [rows] tensor "
                         "on the keys' device")
    if vals.shape != keys.shape or not (keys.is_contiguous()
                                        and vals.is_contiguous()):
        raise ValueError("keys and values must be contiguous and of one "
                         "shape")
    _check(keys.view(-1), vals.view(-1), w2, W)
    if keys.device.type == "cpu":
        return esc_tail_plain(keys, vals, row_len, w2=w2)
    if keys.device.type != "cuda":
        raise DeviceError(f"esc_tail has no kernel for {keys.device.type} "
                          "tensors")
    rows = keys.shape[0]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    counts = torch.empty(rows, dtype=torch.int32, device=keys.device)
    if rows == 0:
        return out_k, out_v, counts
    lib, fn = _kernel_fn(vals.dtype, slab=True)
    nbytes = lib.esc_tail_flat_scratch_bytes(keys.numel(), W,
                                             vals.element_size())
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=keys.device)
               if nbytes else None)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), vals.data_ptr(), row_len.data_ptr(),
                out_k.data_ptr(), out_v.data_ptr(), counts.data_ptr(),
                keys.numel(), W,
                scratch.data_ptr() if scratch is not None else None, stream)
    if rc != 0:
        raise DeviceError(f"esc_tail launch failed: CUDA error {rc} "
                          f"(rows={rows}, W={W}, w2={w2}, {vals.dtype})")
    esc_tail.launches += 1
    return out_k, out_v, counts


esc_tail.launches = 0
