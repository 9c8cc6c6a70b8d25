"""The port's halo exchange (``mh_spgemm_torch/ops/remote_fetch.py``) and
meshes (``parallel/mesh.py``) on the CPU.

- ``halo_exchange_plain`` and ``halo_exchange`` on CPU shards (which
  takes the plain version and launches nothing) equal the JAX
  ``halo_exchange`` run with ``interpret=True`` under ``shard_map`` over
  ``make_row_mesh(d)`` on the 8 virtual CPU devices, for d in {1, 4, 8},
  exact on every word; so does ``exchange_planes`` with 3 planes of a
  capacity that is no multiple of 128.
- The wrapper refuses inputs the kernel does not take.
- Meshes: shards placed round-robin over the given devices; without
  ``devices`` a mesh needs CUDA and raises where it is absent.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mh_spgemm_tpu.ops import remote_fetch as jrf
from mh_spgemm_tpu.parallel.mesh import ROWS, make_row_mesh as jrow_mesh
from mh_spgemm_torch.errors import DeviceError
from mh_spgemm_torch.ops import remote_fetch as trf
from mh_spgemm_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch ops run on one thread here: the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return jrow_mesh(n)


def jax_halo(x: np.ndarray) -> np.ndarray:
    """The JAX kernel in interpret mode on ``x`` [D(shard), D, vr, 128]."""
    d = x.shape[0]
    mesh = jax_mesh(d)
    xs = jax.device_put(x, NamedSharding(mesh, P(ROWS)))
    fn = jax.jit(jax.shard_map(
        lambda s: jrf.halo_exchange(s[0], axis=ROWS, n_devices=d,
                                    interpret=True)[None],
        mesh=mesh, in_specs=(P(ROWS),), out_specs=P(ROWS),
        check_vma=False))
    return np.asarray(fn(xs))


@pytest.mark.parametrize("d", [1, 4, 8])
def test_halo_exchange_matches_pallas(d):
    rng = np.random.default_rng(5 + d)
    x = rng.integers(-2**31, 2**31 - 1, size=(d, d, 3, 128),
                     dtype=np.int64).astype(np.int32)
    want = jax_halo(x)
    np.testing.assert_array_equal(want, np.swapaxes(x, 0, 1))
    sends = [torch.from_numpy(x[s]) for s in range(d)]
    before = trf.halo_exchange.launches
    for fn in (trf.halo_exchange, trf.halo_exchange_plain):
        got = fn(sends, n_devices=d)
        assert len(got) == d
        for s in range(d):
            assert got[s].dtype == torch.int32
            np.testing.assert_array_equal(got[s].numpy(), want[s])
    assert trf.halo_exchange.launches == before   # CPU tensors: plain


def test_exchange_planes_matches_pallas():
    """Three planes of cap 300 packed into one exchange and unpacked,
    against the JAX ``exchange_planes`` in interpret mode."""
    d, cap = 4, 300
    mesh = jax_mesh(d)
    rng = np.random.default_rng(9)
    planes = [rng.integers(-2**31, 2**31 - 1, size=(d, d, cap),
                           dtype=np.int64).astype(np.int32)
              for _ in range(3)]

    def body(*ps):
        outs = jrf.exchange_planes([p[0] for p in ps], axis=ROWS,
                                   n_devices=d, interpret=True)
        return tuple(o[None] for o in outs)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(ROWS),) * 3,
                               out_specs=(P(ROWS),) * 3, check_vma=False))
    want = [np.asarray(o) for o in fn(*[
        jax.device_put(p, NamedSharding(mesh, P(ROWS))) for p in planes])]
    got = trf.exchange_planes(
        [[torch.from_numpy(p[s]) for p in planes] for s in range(d)],
        n_devices=d)
    for s in range(d):
        assert len(got[s]) == 3
        for i in range(3):
            assert tuple(got[s][i].shape) == (d, cap)
            np.testing.assert_array_equal(got[s][i].numpy(), want[i][s])
            np.testing.assert_array_equal(got[s][i].numpy(),
                                          planes[i][:, s])


@pytest.mark.parametrize("bad", ["count", "dtype", "shape", "lanes",
                                 "devices"])
def test_halo_exchange_rejects(bad):
    d = 3
    sends = [torch.zeros((d, 2, 128), dtype=torch.int32) for _ in range(d)]
    if bad == "count":
        sends = sends[:2]
    elif bad == "dtype":
        sends[1] = sends[1].to(torch.int64)
    elif bad == "shape":
        sends[2] = torch.zeros((d, 3, 128), dtype=torch.int32)
    elif bad == "lanes":
        sends = [torch.zeros((d, 2, 64), dtype=torch.int32)] * d
    else:
        sends[0] = sends[0].to("meta")
    for fn in (trf.halo_exchange, trf.halo_exchange_plain):
        with pytest.raises(ValueError):
            fn(sends, n_devices=d)


def test_meshes_place_shards_round_robin():
    m = tmesh.make_row_mesh(8, devices=["cpu"])
    assert m.size == 8 and m.shape == {tmesh.ROWS: 8}
    assert m.axis_names == (tmesh.ROWS,)
    assert all(d == torch.device("cpu") for d in m.devices)
    m = tmesh.make_row_mesh(devices=["cpu", "cpu"])
    assert m.size == 2
    g = tmesh.make_grid_mesh(4, 2, devices=["cpu"])
    assert g.shape == {tmesh.ROWS: 4, tmesh.COLS: 2} and g.size == 8
    with pytest.raises(ValueError):
        tmesh.make_row_mesh(0, devices=["cpu"])


def test_mesh_default_needs_cuda():
    """Without ``devices`` the shards go on the CUDA devices; where there
    is none, making a mesh raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tmesh.make_row_mesh(),
                 lambda: tmesh.make_row_mesh(8),
                 lambda: tmesh.make_grid_mesh(2, 2)):
        with pytest.raises(DeviceError):
            make()
