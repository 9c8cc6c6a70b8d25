"""Times ``proute``'s replay with its tile forced to each width it takes
(2^10 .. 2^13 words), beside the width its rule (``tile_log`` in
``csrc/planned.cu``) picks, at the widths, batches, plane counts and holds
of the planned frontend's networks.  The rule is read off what this
prints.

The forced widths go through the C entry ``proute_tiled`` of the port's
own build; every width's output is checked against a ``proute`` call.
Needs a CUDA card and nvcc.  Prints one JSON line per shape: the device
time of the C entry's launches (CUDA events around 30 back-to-back
launches) per forced width, and the pick.

Usage:  python -m mh_spgemm_torch.bench.tune_proute
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import planned as pn

# (m, networks, planes, hold): scircuit's B routes, A routes and planned
# extraction, and smaller batches of the same widths
SHAPES = ((131072, 5, 3, 1), (131072, 14, 3, 1), (16384, 8, 2, 2048),
          (65536, 2, 3, 1), (65536, 2, 2, 64), (32768, 4, 3, 1),
          (32768, 2, 2, 1024), (16384, 3, 3, 1), (8192, 4, 3, 1))


def _ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_proute needs a CUDA card")
    dev = torch.device("cuda")
    lib = pn._lib()
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for m, nb, P, hold in SHAPES:
        masks, nst = pn.plan_routes(
            np.stack([rng.permutation(m) for _ in range(nb)]))
        mk = torch.from_numpy(masks).to(dev)
        x = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, (P, nb, m), dtype=np.int64).astype(
                np.int32)).to(dev)
        fl = torch.from_numpy(
            (rng.random((nb, m)) < 0.05).astype(np.int32)).to(dev)
        want = pn.proute(x, mk, nst, hold_w2=hold, flags=fl)
        n = m.bit_length() - 1
        row = {"m": m, "networks": nb, "planes": P, "hold": hold,
               "pick": lib.proute_tile_log(n, nb * m), "ms": {}}
        out = torch.empty_like(x)
        scratch = torch.empty(lib.proute_scratch_words(P, nb, m, hold),
                              dtype=torch.int32, device=dev)
        for lt in range(10, min(n, 13) + 1):
            args = (x.data_ptr(), nb * m, out.data_ptr(), scratch.data_ptr(),
                    nb * m, P, mk.data_ptr(), fl.data_ptr(), nb, m, nst,
                    hold, lt, stream)
            rc = lib.proute_tiled(*args)
            if rc != 0:
                raise RuntimeError(f"proute_tiled failed: CUDA error {rc}")
            row["ms"][lt] = _ms(lambda: lib.proute_tiled(*args))
            if not torch.equal(out, want):
                raise AssertionError(f"tile 2^{lt} differs at {row}")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
