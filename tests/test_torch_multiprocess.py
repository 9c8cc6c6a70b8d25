"""The port's multi-process mesh (``parallel/mesh.init_multihost``,
``parallel/comm.py``, ``parallel/worker.py``) on the CPU, against the
port's own single-process ``spgemm_dist`` and the JAX package's.

- A module fixture spawns ``python -m mh_spgemm_torch.parallel.worker`` as
  2 CPU ranks x 2 shards (gloo over localhost, a free port, a timeout on
  every wait and on the process group), the counterpart of the JAX
  package's ``test_dist_multiprocess``, on ``gen.banded(64, band=5,
  nnz_per_row=4, seed=42)`` and ``gen.powerlaw(150, avg_nnz=4,
  seed=43)``, running every call of ``worker.ALL_CALLS``: both engines,
  every strategy, both backends, the forced fill, the forced overlap and
  the forced row-chunked fallback, each cold and twice warm.
- Per (matrix, call), both ranks' C equals the port's oracle
  (``CSR.equals``, 1e-9); ptr, col and the values' bits equal the port's
  single-process ``spgemm_dist`` of the same call at D = 4 (a 2 x 2 grid
  for grid2d); and C equals the JAX package's single-process
  ``spgemm_dist`` at D = 4 on the 8 virtual CPU devices of
  ``tests/conftest.py`` (``CSR.equals``, 1e-9: the JAX side carries f64
  values as Dekker pairs).  JAX's Pallas paths on the CPU need
  ``dma_fill="interpret"``, so its "pallas" and fill calls run with it;
  its ESC engine ignores ``comm_backend``, so one JAX call serves both of
  the port's ESC backends.
- In-process: ``init_multihost``'s no-op cases, the rank-major layout of
  ``make_row_mesh`` / ``make_grid_mesh`` with ``process_index`` and
  ``is_local`` (the gather of the processes' device lists patched), the
  halo exchange into a subset of the receiving shards, the plan-digest
  check raising ``SpGEMMError``, and IPC refused under expandable
  segments.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.errors import DeviceError, SpGEMMError
from mh_spgemm_torch.ops import remote_fetch as trf
from mh_spgemm_torch.parallel import comm
from mh_spgemm_torch.parallel import mesh as tmesh
from mh_spgemm_torch.parallel import spgemm_dist as tsd
from mh_spgemm_torch.parallel import worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["cpu"]
NPROC, SHARDS = 2, 2
MATRICES = ("banded", "powerlaw")
WAIT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' records and Cs, by (matrix, call)."""
    out = tmp_path_factory.mktemp("ranks")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mh_spgemm_torch.parallel.worker", str(port),
         str(r), str(NPROC), str(SHARDS), "--device", "cpu", "--matrix",
         ",".join(MATRICES), "--out", str(out), "--save-c",
         "--timeout", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        for r in range(NPROC)]
    try:
        logs = [p.communicate(timeout=WAIT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"rank {r}: multiprocess dist OK" in log
    got = {}
    for r in range(NPROC):
        with open(out / f"rank{r}.json") as f:
            for rec in json.load(f):
                tag = rec["call"].replace(":", "-")
                z = np.load(out / f"rank{r}_{rec['matrix']}_{tag}.npz")
                C = CSR(M=int(z["shape"][0]), N=int(z["shape"][1]),
                        ptr=z["ptr"], col=z["col"], val=z["val"])
                got.setdefault((rec["matrix"], rec["call"]), []).append(
                    (rec, C))
    return got


def single_process(A, call, monkeypatch) -> CSR:
    """The port's single-process spgemm_dist of ``call`` at D = 4."""
    cfg = SpGEMMConfig(comm_backend=call["backend"], dma_fill=call["fill"])
    D = NPROC * SHARDS
    mesh = (tmesh.make_grid_mesh(D // 2, 2, devices=CPU)
            if call["strategy"] == "grid2d"
            else tmesh.make_row_mesh(D, devices=CPU))
    if call["force"]:
        monkeypatch.setenv("MHSPGEMM_FORCE_OVERLAP", "1")
    if call["chunked"]:
        return tsd._dist_chunked(A, A, mesh, cfg, call["strategy"],
                                 budget=max(1, worker._products(A) // 3))
    return tsd.spgemm_dist(A, None, mesh, config=cfg,
                           b_strategy=call["strategy"],
                           engine=call["engine"])


_JAX = {}


def jax_single_process(A, name, call) -> CSR:
    """The JAX package's spgemm_dist at D = 4, memoised per what its
    result depends on."""
    import jax
    from mh_spgemm_tpu import SpGEMMConfig as JConfig
    from mh_spgemm_tpu.csr import CSR as JCSR
    from mh_spgemm_tpu.parallel import mesh as jmesh
    from mh_spgemm_tpu.parallel import spgemm_dist as jsd

    D = NPROC * SHARDS
    pallas = call["backend"] == "pallas" and call["engine"] == "bucketed"
    interpret = pallas or call["fill"] == "on"
    key = (name, call["engine"], call["strategy"], pallas, interpret)
    if key not in _JAX:
        if len(jax.devices()) < D:
            pytest.skip(f"needs {D} JAX devices")
        mesh = (jmesh.make_grid_mesh(D // 2, 2)
                if call["strategy"] == "grid2d" else jmesh.make_row_mesh(D))
        cfg = JConfig(comm_backend="pallas" if pallas else "xla",
                      dma_fill="interpret" if interpret else "off")
        old = os.environ.get("MHSPGEMM_FORCE_OVERLAP")
        os.environ["MHSPGEMM_FORCE_OVERLAP"] = "1" if call["force"] else "0"
        try:
            J = jsd.spgemm_dist(JCSR(M=A.M, N=A.N, ptr=A.ptr, col=A.col,
                                     val=A.val), None, mesh, config=cfg,
                                b_strategy=call["strategy"],
                                engine=call["engine"])
        finally:
            if old is None:
                os.environ.pop("MHSPGEMM_FORCE_OVERLAP")
            else:
                os.environ["MHSPGEMM_FORCE_OVERLAP"] = old
        _JAX[key] = CSR(M=J.M, N=J.N, ptr=np.asarray(J.ptr),
                        col=np.asarray(J.col), val=np.asarray(J.val))
    return _JAX[key]


@pytest.mark.parametrize("call", worker.ALL_CALLS)
@pytest.mark.parametrize("name", MATRICES)
def test_multiprocess_matches_single_process_and_jax(ranks, name, call,
                                                     monkeypatch):
    A = worker.load(name)
    spec = worker.parse_call(call)
    ref = oracle_spgemm(A, A)
    got = ranks[(name, call)]
    assert [rec["rank"] for rec, _ in got] == list(range(NPROC))
    one = single_process(A, spec, monkeypatch)
    J = jax_single_process(A, name, spec)
    for rec, C in got:
        assert rec["D"] == NPROC * SHARDS
        assert C.equals(ref, tol=1e-9), rec["rank"]
        assert np.array_equal(C.ptr, one.ptr)
        assert np.array_equal(C.col, one.col)
        assert C.val.dtype == one.val.dtype
        assert np.array_equal(C.val.view(np.uint64), one.val.view(np.uint64))
        assert rec["digest"] == worker.csr_sha(one)
        assert C.equals(J, tol=1e-9)
        if not spec["chunked"]:
            assert rec["warm_ms"] > 0 and rec["program_ms"] > 0
        assert rec["launches"]["halo_exchange"] == 0     # CPU: no kernel


# ---------------------------------------------------------------------------
# In-process units
# ---------------------------------------------------------------------------

def test_init_multihost_no_op_single_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    tmesh.init_multihost()
    assert not torch.distributed.is_initialized()
    assert tmesh.process_rank() == 0 and tmesh.process_count() == 1


def test_init_multihost_no_op_when_a_group_exists():
    """A second call (here with other arguments) keeps the first group."""
    dist = torch.distributed
    assert not dist.is_initialized()
    tmesh.init_multihost(f"localhost:{free_port()}", 1, 0,
                         timeout=datetime.timedelta(seconds=30))
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        tmesh.init_multihost("localhost:1", 2, 1)
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        # a one-process group lays its meshes out as a single process
        m = tmesh.make_row_mesh(3, devices=CPU)
        assert m.process_index == (0, 0, 0)
        assert all(m.is_local(d) for d in range(3))
    finally:
        dist.destroy_process_group()


def fake_job(monkeypatch, rank: int, world: int, peer_devices):
    """This process as ``rank`` of ``world``; the other processes'
    device lists come from ``peer_devices(r)``."""
    monkeypatch.setattr(tmesh, "process_rank", lambda: rank)
    monkeypatch.setattr(tmesh, "process_count", lambda: world)
    monkeypatch.setattr(comm, "process_count", lambda: world)

    def all_gather_object(out, mine):
        for r in range(world):
            out[r] = mine if r == rank else peer_devices(r)

    monkeypatch.setattr(tmesh.dist, "all_gather_object", all_gather_object)


def test_row_mesh_is_rank_major(monkeypatch):
    fake_job(monkeypatch, 1, 3, lambda r: ["cpu", "cpu"])
    m = tmesh.make_row_mesh(6, devices=CPU)
    assert m.size == 6 and m.shape == {tmesh.ROWS: 6}
    assert m.process_index == (0, 0, 1, 1, 2, 2)
    assert [d for d in range(6) if m.is_local(d)] == [2, 3]
    assert comm.local_shards(m) == [2, 3] and comm.spans_processes(m)
    # default: one shard per local device of every process
    fake_job(monkeypatch, 1, 3, lambda r: ["cpu"])
    m = tmesh.make_row_mesh(devices=["cpu"])
    assert m.process_index == (0, 1, 2)


def test_grid_mesh_is_rank_major(monkeypatch):
    fake_job(monkeypatch, 0, 2, lambda r: ["cpu", "cpu"])
    g = tmesh.make_grid_mesh(2, 2, devices=CPU)
    assert g.shape == {tmesh.ROWS: 2, tmesh.COLS: 2}
    assert g.process_index == (0, 0, 1, 1)
    assert [d for d in range(4) if g.is_local(d)] == [0, 1]


def test_mesh_processes_must_agree(monkeypatch):
    fake_job(monkeypatch, 0, 2, lambda r: ["cpu"] * 3)
    with pytest.raises(ValueError, match="different shard counts"):
        tmesh.make_row_mesh(4, devices=CPU)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.make_row_mesh(5, devices=CPU)


def test_spanning_mesh_needs_cuda_or_cpu(monkeypatch):
    fake_job(monkeypatch, 0, 2, lambda r: ["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="devices=\\['cpu'\\]"):
        tmesh.make_row_mesh()
    with pytest.raises(DeviceError):
        tmesh.make_grid_mesh(2, 1)


def test_single_process_mesh_unchanged():
    m = tmesh.make_row_mesh(4, devices=CPU)
    assert m.process_index == (0,) * 4
    assert comm.local_shards(m) == [0, 1, 2, 3]
    assert not comm.spans_processes(m)


@pytest.mark.parametrize("first,count", [(0, 5), (0, 2), (2, 2), (4, 1)])
def test_halo_exchange_into_a_subset(first, count):
    """The exchange into receiving shards first .. first + count - 1 equals
    that slice of the whole exchange, from the plain version and from the
    wrapper (CPU tensors: the plain version, which takes no ``out``)."""
    rng = np.random.default_rng(11)
    D = 5
    sends = [torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, (D, 2, 128), dtype=np.int64).astype(np.int32))
        for _ in range(D)]
    whole = trf.halo_exchange_plain(sends, n_devices=D)
    sub = trf.halo_exchange_plain(sends, n_devices=D, dst_first=first,
                                  dst_count=count)
    via = trf.halo_exchange(sends, n_devices=D, dst_first=first,
                            dst_count=count)
    assert len(sub) == len(via) == count
    for j in range(count):
        assert torch.equal(sub[j], whole[first + j])
        assert torch.equal(via[j], whole[first + j])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        trf.halo_exchange(sends, n_devices=D, dst_first=first,
                          dst_count=count,
                          out=[torch.empty_like(sends[0])] * count)
    with pytest.raises(ValueError, match="range"):
        trf.halo_exchange_plain(sends, n_devices=D, dst_first=4,
                                dst_count=2)


def test_exchange_planes_takes_an_exchange():
    """``exchange_planes`` through a caller's exchange (None for shards
    another process owns) unpacks what that exchange returns."""
    rng = np.random.default_rng(12)
    D, cap = 3, 200
    planes = [[torch.from_numpy(rng.integers(0, 99, (D, cap)).astype(
        np.int32)) for _ in range(2)] for _ in range(D)]
    want = trf.exchange_planes(planes, n_devices=D)

    def exchange(sends):
        got = trf.halo_exchange_plain(sends, n_devices=D)
        return [None, got[1], None]

    got = trf.exchange_planes(planes, n_devices=D, exchange=exchange)
    assert got[0] is None and got[2] is None
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))


def test_plan_digest_mismatch_raises(monkeypatch):
    m = tmesh.Mesh(axis_names=(tmesh.ROWS,), shape={tmesh.ROWS: 4},
                   devices=(torch.device("cpu"),) * 4,
                   process_index=(0, 0, 1, 1))
    a = {"x": np.arange(6, dtype=np.int32), "y": [1.5, (2, "z")]}
    b = {"x": np.arange(6, dtype=np.int32), "y": [1.5, (2, "z")]}
    assert comm.digest(a) == comm.digest(b)
    b["x"][3] = 7
    assert comm.digest(a) != comm.digest(b)
    assert comm.digest(torch.zeros(3), a) == comm.digest(a)   # uploads skipped
    monkeypatch.setattr(comm, "all_gather_object",
                        lambda obj: [obj, comm.digest(b)])
    with pytest.raises(SpGEMMError, match="planned different"):
        comm.check_same(m, "shard plans", a)
    monkeypatch.setattr(comm, "all_gather_object", lambda obj: [obj, obj])
    comm.check_same(m, "shard plans", a)


def test_ipc_refused_under_expandable_segments(monkeypatch):
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF",
                       "max_split_size_mb:64,expandable_segments:True")
    with pytest.raises(DeviceError, match="expandable_segments"):
        comm._check_ipc()
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:64")
    comm._check_ipc()
