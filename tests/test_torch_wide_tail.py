"""The ESC tail's wide path (rows wider than 8192: pieces of 8192 slots on
the tile path, then pairwise merge rounds) in its plain version, on the
CPU.

``esc_tail_plain`` and ``esc_tail_flat_plain`` at W past 8192 against the
sort tail ``_chunk_tail`` on the same masked rows, the port's and the JAX
package's (keys and counts exact, values within 1e-12 of the summed
magnitudes in f64 and 1e-4 in f32: they add in different orders); the
path that each width takes (the route that ``tail_route`` gives each (W,
route, device type) is in tests/test_torch_padded_tail.py); the
``wide_tail_slots`` and ``wide_tail_live_slots`` counters of a bucketed
plan; and a Graph500 Kronecker matrix (the ``g500_s15_ef16`` benchmark's
generator at scale 10) through ``spgemm_host`` against the benchmark's
plain reference.  The kernel itself runs in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mh_spgemm_torch import CSR, SpGEMMConfig, pipeline
from mh_spgemm_tpu.ops import bucketed as jbk
from mh_spgemm_torch.ops import bucketed as tbk
from mh_spgemm_torch.ops import esc_tail as tet

I32_MAX = 2**31 - 1
CPU = torch.device("cpu")
WIDTHS = [12288, 16384, 24576, 98304, 196608]
DTYPES = [torch.float64, torch.float32]
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the test workers share the host's cores, and the
    plain version's sorts over wide rows spin torch's thread pool
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide_rows(W: int, dtype, seed: int):
    """Rows of W slots with keys from W / 4 columns: row 0 full, row 1
    empty, row 2 full of one column, row 3 with a random count; random
    keys and NaN values past each count."""
    rng = np.random.default_rng(seed)
    rows = 4
    keys = rng.integers(0, max(2, W // 4), (rows, W)).astype(np.int32)
    row_len = np.array([W, 0, W, rng.integers(0, W + 1)], dtype=np.int32)
    keys[2] = 11
    vals = rng.standard_normal((rows, W))
    vals[np.arange(W)[None, :] >= row_len[:, None]] = np.nan
    return (torch.from_numpy(keys), torch.from_numpy(vals).to(dtype),
            torch.from_numpy(row_len))


def masked(keys, vals, row_len):
    """The rows with the slots past each count emptied."""
    W = keys.shape[1]
    live = torch.arange(W)[None, :] < row_len.long()[:, None]
    return (torch.where(live, keys, I32_MAX),
            torch.where(live, vals, torch.zeros((), dtype=vals.dtype)))


def sort_tail(keys, vals, row_len):
    """The port's sort tail on the masked rows, with the magnitude sums."""
    K, V = masked(keys, vals, row_len)
    passes = max(1, (keys.shape[1] - 1).bit_length())
    oK, oV, cnt = tbk._chunk_tail(K, V, seg_passes=passes)
    _, mag, _ = tbk._chunk_tail(K, V.abs(), seg_passes=passes)
    return oK, oV, cnt, mag


def jax_tail(keys, vals, row_len, mag):
    """The JAX package's sort tail (its XLA ``_chunk_tail``) on the same
    masked rows, with the port's magnitude sums ``mag``.  Its slots past
    a row's count hold whatever its last sort left there, so they are
    emptied here as the port's contract empties them."""
    K, V = masked(keys, vals, row_len)
    rows, W = K.shape
    oK, oV, cnt = (torch.from_numpy(np.array(x)) for x in jbk._chunk_tail(
        jnp.asarray(K.numpy()), jnp.asarray(V.numpy()), rb=rows,
        seg_passes=max(1, (W - 1).bit_length()), W=W))
    live = torch.arange(W)[None, :] < cnt.long()[:, None]
    return (torch.where(live, oK, I32_MAX),
            torch.where(live, oV, torch.zeros((), dtype=oV.dtype)), cnt, mag)


def check_rows(out, ref, dtype):
    oK, oV, cnt = out
    rK, rV, rc, mag = ref
    assert torch.equal(oK, rK) and torch.equal(cnt, rc)
    live = rK < I32_MAX
    assert bool((oV[~live] == 0).all())
    err = (oV[live] - rV[live]).abs().to(torch.float64)
    bound = TOL[dtype] * (1 + mag[live].to(torch.float64))
    assert bool((err <= bound).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W", WIDTHS)
def test_wide_plain_matches_sort_tail(W, dtype):
    keys, vals, row_len = wide_rows(W, dtype, seed=W)
    out = tet.esc_tail(keys, vals, row_len, w2=tet.pad_w2(W))
    assert out[0].shape == (4, W) and out[1].dtype == dtype
    ref = sort_tail(keys, vals, row_len)
    check_rows(out, ref, dtype)
    check_rows(out, jax_tail(keys, vals, row_len, ref[3]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("w2", [16384, 131072])
def test_wide_flat_plain_matches_sort_tail(w2, dtype):
    """The flat form (empty slots carry 2^31-1) at power-of-two widths
    past 8192, the pre classes' widths."""
    keys, vals, row_len = wide_rows(w2, dtype, seed=w2 + 1)
    ref = sort_tail(keys, vals, row_len)
    live = torch.arange(w2)[None, :] < row_len.long()[:, None]
    fk = torch.where(live, keys, I32_MAX).reshape(-1)
    fv = torch.where(live, vals, torch.zeros((), dtype=dtype)).reshape(-1)
    oK, oV, cnt = tet.esc_tail_flat(fk, fv, w2=w2)
    out = (oK.view(4, w2), oV.view(4, w2), cnt)
    check_rows(out, ref, dtype)
    check_rows(out, jax_tail(keys, vals, row_len, ref[3]), dtype)


def test_wide_plain_adds_in_the_merge_tree_order():
    """Three pieces (W = 24576) whose only key is one column: the sum is
    (piece 0 + piece 1) + piece 2, each piece's own sum first, the order
    the kernel adds in; values whose sums round differently in another
    order tell them apart."""
    W = 24576
    keys = torch.zeros((1, W), dtype=torch.int32)
    vals = torch.zeros((1, W), dtype=torch.float64)
    vals[0, 0], vals[0, 8192], vals[0, 16384] = 1.0, 2.0**53, -(2.0**53)
    row_len = torch.tensor([W], dtype=torch.int32)
    _, oV, cnt = tet.esc_tail(keys, vals, row_len, w2=32768)
    assert cnt.tolist() == [1]
    assert oV[0, 0].item() == (1.0 + 2.0**53) - 2.0**53 == 0.0


@pytest.mark.parametrize("w2,path", [(256, "warp"), (512, "tile"),
                                     (8192, "tile"), (16384, "wide"),
                                     (1 << 20, "wide")])
def test_path_for(w2, path):
    assert tet.path_for(w2) == path


def kron(scale: int, seed: int):
    """The benchmark's Graph500 Kronecker generator at ``scale``."""
    from spgemm_bench import gen as sg
    return sg.rmat(scale, 16, 0.57, 0.19, 0.19, permute=True, symmetric=True,
                   rng=np.random.default_rng([seed, 0]))


@pytest.mark.parametrize("mode", ["auto", "bucketed"])
def test_kronecker_host_product_matches_reference(mode):
    """A scale-10 Graph500 Kronecker matrix squared through ``spgemm_host``
    against the benchmark's plain reference: structure exact, values
    within 1e-10 of |A| @ |A| (the benchmark's limit)."""
    from spgemm_bench import check
    M = kron(10, seed=1234567890123)
    A = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
    C = pipeline.spgemm_host(A, None, SpGEMMConfig(mode=mode), device=CPU)
    r = check.compare(M, M, [C], CPU)
    wrong = (r["shape_wrong"], r["rows_wrong"], r["entries_wrong"])
    assert wrong == (0, 0, 0)
    assert r["val_gap"] <= 1e-10


@pytest.mark.parametrize("dma_fill", ["off", "on"])
def test_stats_count_the_wide_slots(dma_fill):
    """``wide_tail_slots`` is the slots one run sends to the wide path: on
    CPU tensors the power-of-two classes past 8192 (the kernel's plain
    version); the same after a warm run; none under ``esc_tail="off"``.
    ``wide_tail_live_slots`` is those that it reads: every slot of the
    flat pre classes (``dma_fill="off"`` here), the products of the fill
    classes' slabs (their rows' counts, under ``dma_fill="on"``)."""
    M = kron(10, seed=7)
    A = CSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
    cfg = SpGEMMConfig(dma_fill=dma_fill)
    _, st = pipeline.spgemm_bucketed(A, A, cfg, device=CPU)
    wide_cls = [c for c in st.plan.classes if c.W > 8192]
    wide = sum(c.W * c.rb * c.nchunks for c in wide_cls)
    live = sum(c.W * c.rb * c.nchunks if c.pre else int(c.row_len.sum())
               for c in wide_cls)
    assert all(c.pre == (dma_fill == "off") for c in wide_cls)
    assert 0 < live <= wide and (live < wide) == (dma_fill == "on")
    stats = st.plan.stats()
    assert (stats["wide_tail_slots"], stats["wide_tail_live_slots"]) == (
        wide, live)
    _, st = pipeline.spgemm_bucketed(A, A, cfg, state=st)
    stats = st.plan.stats()
    assert (stats["wide_tail_slots"], stats["wide_tail_live_slots"]) == (
        wide, live)
    _, off = pipeline.spgemm_bucketed(
        A, A, SpGEMMConfig(dma_fill=dma_fill, esc_tail="off"), device=CPU)
    assert off.plan.stats()["wide_tail_slots"] == 0
    assert off.plan.stats()["wide_tail_live_slots"] == 0
