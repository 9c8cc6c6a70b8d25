"""The port's ``spgemm_dist(engine="esc")`` against the JAX package's, on
the CPU: eight shards of the CPU (``make_row_mesh(8, devices=["cpu"])``)
against the JAX package's eight virtual CPU devices (``tests/conftest.py``).

- C of ``replicate``, ``allgather`` and ``ragged``, cold and through a
  warm state, equals the scipy oracle and the JAX package's C under
  ``CSR.equals`` (1e-9; both add each (row, col) group's products in
  sorted order by the same Hillis-Steele scan, so they agree closely, not
  by construction bit for bit); the port's two ``comm_backend`` settings
  give the same C bit for bit (the ESC branch's exchange is the
  ``all_to_all`` of torch copies either way, as the JAX package's is
  ``lax.all_to_all``).
- A strategy the ESC branch lacks raises ``SpGEMMError`` in both.
"""

import numpy as np
import pytest
import torch

from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.errors import SpGEMMError as JSpGEMMError
from mh_spgemm_tpu.parallel import mesh as jmesh
from mh_spgemm_tpu.parallel import spgemm_dist as jsd
from mh_spgemm_torch import CSR, SpGEMMConfig, oracle_spgemm
from mh_spgemm_torch.errors import SpGEMMError
from mh_spgemm_torch.parallel import spgemm_dist as tsd
from mh_spgemm_torch.parallel.mesh import make_row_mesh

CPU = ["cpu"]
D = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch ops run on one thread here: the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(J) -> CSR:
    return CSR.from_arrays(J.M, J.N, J.ptr, J.col, J.val)


MATRICES = {
    "powerlaw": lambda: jgen.powerlaw(300, avg_nnz=5, seed=3),
    # M = 9 at D = 8: trailing shards own no rows
    "m9": lambda: jgen.random_uniform(9, nnz_per_row=3, seed=12),
}


@pytest.mark.parametrize("strategy", ["replicate", "allgather", "ragged"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dist_esc_matches_jax(name, strategy):
    J = MATRICES[name]()
    A = port(J)
    ref = oracle_spgemm(A, A)
    st = {}
    mesh = make_row_mesh(D, devices=CPU)
    C = tsd.spgemm_dist(A, None, mesh, b_strategy=strategy, state=st,
                        engine="esc")
    assert C.equals(ref, tol=1e-9)
    JC = jsd.spgemm_dist(J, None, jmesh.make_row_mesh(D),
                         b_strategy=strategy, engine="esc")
    assert C.equals(port(JC), tol=1e-9)
    assert st["fn"] is not None and st["R"] == -(-A.M // D)
    Cw = tsd.spgemm_dist(A, None, mesh, b_strategy=strategy, state=st,
                         engine="esc")
    assert Cw.equals(C, tol=0.0)
    if strategy == "ragged":
        Cp = tsd.spgemm_dist(A, None, mesh, engine="esc",
                             b_strategy=strategy,
                             config=SpGEMMConfig(comm_backend="pallas"))
        assert Cp.equals(C, tol=0.0)


def test_dist_esc_f32_and_rect():
    rng = np.random.default_rng(31)
    A = CSR.from_coo(60, 90, rng.integers(0, 60, 400),
                     rng.integers(0, 90, 400), rng.standard_normal(400),
                     sum_duplicates=True)
    B = CSR.from_coo(90, 40, rng.integers(0, 90, 300),
                     rng.integers(0, 40, 300), rng.standard_normal(300),
                     sum_duplicates=True)
    mesh = make_row_mesh(4, devices=CPU)
    C = tsd.spgemm_dist(A, B, mesh, b_strategy="ragged", engine="esc",
                        config=SpGEMMConfig(value_dtype="float32"))
    assert C.val.dtype == np.float32
    assert C.equals(oracle_spgemm(A, B), tol=1e-4)


@pytest.mark.parametrize("strategy", ["grid2d", "ragged_overlap",
                                      "scatter"])
def test_dist_esc_unknown_strategy_raises_as_jax(strategy):
    J = jgen.tiny_fixture()
    with pytest.raises(JSpGEMMError):
        jsd.spgemm_dist(J, None, jmesh.make_row_mesh(2),
                        b_strategy=strategy, engine="esc")
    with pytest.raises(SpGEMMError):
        tsd.spgemm_dist(port(J), None, make_row_mesh(2, devices=CPU),
                        b_strategy=strategy, engine="esc")
