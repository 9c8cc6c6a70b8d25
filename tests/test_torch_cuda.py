"""CUDA-only tests of the PyTorch port: the esc_tail_flat kernel against
its plain PyTorch version on the card, and the bucketed engine on the card
against the scipy oracle.  They skip where there is no CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only torch: ``python -m pytest --noconftest
tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mh_spgemm_torch import SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.ops import esc_tail as et
from mh_spgemm_torch.pipeline import spgemm_bucketed

I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tail_inputs(w2: int, nseg: int, seed: int):
    """Keys with duplicate-heavy segments, empty segments, one all-same
    segment and invalid tails; values standard normal."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(2, w2 // 4), (nseg, w2)).astype(np.int32)
    n = rng.integers(0, w2 + 1, nseg)
    n[0] = 0                                  # an empty segment
    if nseg > 1:
        keys[1] = 7                           # every key the same
        n[1] = w2
    keys[np.arange(w2)[None, :] >= n[:, None]] = I32_MAX
    vals = rng.standard_normal((nseg, w2))
    vals[keys == I32_MAX] = 0.0
    return keys.reshape(-1), vals.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w2", [2, 8, 256, 2048, 8192, 32768, 65536])
def test_kernel_matches_plain(cuda, w2, dtype):
    nseg = max(3, (1 << 17) // w2)
    k, v = tail_inputs(w2, nseg, seed=w2)
    keys = torch.from_numpy(k).to(cuda)
    vals = torch.from_numpy(v).to(dtype).to(cuda)
    before = et.esc_tail_flat.launches
    oK, oV, cnt = et.esc_tail_flat(keys, vals, w2=w2)
    torch.cuda.synchronize()
    assert et.esc_tail_flat.launches == before + 1
    pK, pV, pc = et.esc_tail_flat_plain(keys, vals, w2=w2)
    assert torch.equal(oK, pK)
    assert torch.equal(cnt, pc)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    err = (oV - pV).abs()
    assert bool((err <= tol * torch.clamp(pV.abs(), min=1.0)).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float64", "float32"])
def test_engine_on_card(cuda, value_dtype):
    A = gen.powerlaw(3000, avg_nnz=5, seed=42)
    ref = oracle_spgemm(A, A)
    cfg = SpGEMMConfig(value_dtype=value_dtype)
    tol = 1e-9 if value_dtype == "float64" else 1e-4
    before = et.esc_tail_flat.launches
    state = None
    for _ in range(3):                        # cold, then warm
        C, state = spgemm_bucketed(A, A, config=cfg, state=state,
                                   device=cuda)
        assert C.host().equals(ref, tol=tol)
    assert et.esc_tail_flat.launches > before
