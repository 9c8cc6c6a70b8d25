"""The port's foundation modules against the JAX package's: Matrix Market
parsing, the synthetic generators and suite stand-ins, capacity
quantization, the scipy oracle and the CSR comparator.  Every comparison
here is exact (bit for bit): both packages run the same numpy code on the
same inputs.

The last test runs the port in a fresh interpreter and shows that it loads
neither JAX nor the JAX package (this process has both loaded through
``tests/conftest.py``).
"""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mh_spgemm_tpu import read_mtx as jread_mtx
from mh_spgemm_tpu.baseline import digest_host as jdigest_host
from mh_spgemm_tpu.baseline import oracle_spgemm as joracle
from mh_spgemm_tpu.csr import CSR as JCSR
from mh_spgemm_tpu.bench import gen as jgen
from mh_spgemm_tpu.io import suites as jsuites
from mh_spgemm_tpu.ops.shapes import quantize as jquantize
from mh_spgemm_tpu.utils import native as jnative
from mh_spgemm_torch import CSR, oracle_spgemm, read_mtx
from mh_spgemm_torch.baseline import digest_check, digest_device, digest_host
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.errors import MatrixFormatError
from mh_spgemm_torch.io import suites
from mh_spgemm_torch.ops.shapes import quantize
from mh_spgemm_torch.pipeline import spgemm_bucketed
from mh_spgemm_torch.utils import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "*.mtx")))
SMALL_STANDINS = ("scircuit", "mac_econ_fwd500")


def assert_same_csr(t, j):
    """Port CSR ``t`` equals JAX CSR ``j`` bit for bit."""
    assert (t.M, t.N, t.nnz, t.is_symmetric) == (j.M, j.N, j.nnz,
                                                 j.is_symmetric)
    for f in ("ptr", "col", "val"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture(params=["numpy", "native"])
def parser(request, monkeypatch, tmp_path_factory):
    """Select the .mtx body parser in both packages: numpy, or the native
    host library built from the repository's source."""
    if request.param == "native":
        gxx = shutil.which("g++")
        if gxx is None:
            pytest.skip("g++ not available to build the native library")
        path = str(tmp_path_factory.mktemp("native") / "libmhspgemm_host.so")
        subprocess.run([gxx, "-O2", "-fopenmp", "-shared", "-fPIC", "-o",
                        path, os.path.join(ROOT, "native",
                                           "host_runtime.cpp")],
                       check=True)
        tlib = tnative.load(path)
        monkeypatch.setenv("MHSPGEMM_NATIVE_LIB", path)
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        assert jnative.available()
    else:
        tlib = None
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", tlib)
    return request.param


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_fixtures_parse_identically(path, parser):
    assert_same_csr(read_mtx(path), jread_mtx(path))


@pytest.mark.parametrize("family,kwargs", [
    ("banded", dict(n=500, band=20, nnz_per_row=9, seed=3)),
    ("random", dict(n=400, nnz_per_row=7, seed=4)),
    ("powerlaw", dict(n=600, avg_nnz=5, max_row=80, seed=5)),
    ("kron", dict(scale=9, edge_factor=6, seed=6)),
    ("diag_blocks", dict(n=256, block=8, seed=7)),
])
def test_generators_match(family, kwargs):
    assert_same_csr(gen.FAMILIES[family](**kwargs),
                    jgen.FAMILIES[family](**kwargs))


def test_tiny_fixture_matches():
    assert_same_csr(gen.tiny_fixture(), jgen.tiny_fixture())


def test_suite_table_matches():
    assert suites.SYNTHETIC_16 == jsuites.SYNTHETIC_16
    assert suites.SIXTEEN_MATRICES == jsuites.SIXTEEN_MATRICES


@pytest.mark.parametrize("name", SMALL_STANDINS)
def test_standins_match(name):
    assert_same_csr(suites.load_matrix(name), jsuites.load_matrix(name))


def test_quantize_matches():
    ns = list(range(0, 300)) + [int(x) for x in np.unique(
        np.random.default_rng(0).integers(1, 2**31 - 1, 2000))]
    assert [quantize(n) for n in ns] == [jquantize(n) for n in ns]
    assert [quantize(n, 1) for n in ns[:64]] == [jquantize(n, 1)
                                                for n in ns[:64]]


def test_oracle_matches():
    """Including structural zeros: a row whose products cancel exactly."""
    A = gen.powerlaw(300, avg_nnz=5, seed=21)
    rows, cols, vals = [0, 0, 1, 1], [0, 1, 0, 1], [1.0, 1.0, 1.0, -1.0]
    Z = CSR.from_coo(2, 2, rows, cols, vals)     # Z @ Z has a cancelled 0
    for M in (A, Z):
        J = JCSR(M=M.M, N=M.N, ptr=M.ptr, col=M.col, val=M.val)
        assert_same_csr(oracle_spgemm(M, M), joracle(J, J))
    assert oracle_spgemm(Z, Z).nnz == 4


def test_digests_match():
    """The host digest equals the JAX package's; the torch digest of the
    same result on a device equals the host digest, and a changed value
    fails the check."""
    A = gen.powerlaw(300, avg_nnz=5, seed=21)
    C = oracle_spgemm(A, A)
    J = JCSR(M=C.M, N=C.N, ptr=C.ptr, col=C.col, val=C.val)
    assert digest_host(C) == jdigest_host(J)
    dev = spgemm_bucketed(A, A, device="cpu")[0]
    assert digest_check(digest_device(dev), digest_host(C)) == (True, "pass")
    bad = CSR.from_arrays(C.M, C.N, C.ptr, C.col, C.val + 1e-3)
    assert not digest_check(digest_host(bad), digest_host(C))[0]


def test_from_arrays_and_equals():
    J = jgen.powerlaw(200, avg_nnz=4, seed=2)
    T = CSR.from_arrays(J.M, J.N, J.ptr, J.col, J.val)
    assert_same_csr(T, J)
    U = CSR.from_arrays(T.M, T.N, T.ptr, T.col, T.val * (1 + 5e-10))
    assert T.equals(U, tol=1e-9) and not T.equals(U, tol=1e-11)
    U.col[0] += 1
    assert not T.equals(U)
    with pytest.raises(MatrixFormatError):
        CSR.from_arrays(T.M, T.N, T.ptr, T.col[:-1], T.val[:-1])


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (the CLI
    driver and the block-dense engine by name too) and chip_smoke.py,
    runs one CPU SpGEMM on each engine, and has loaded neither JAX nor the
    JAX package."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import mh_spgemm_torch as mt",
        "for m in pkgutil.walk_packages(mt.__path__, 'mh_spgemm_torch.'):",
        "    importlib.import_module(m.name)",
        "import chip_smoke",
        "import mh_spgemm_torch.bench.driver, mh_spgemm_torch.ops.blockdense",
        "from mh_spgemm_torch.bench import gen",
        "A = gen.powerlaw(200, avg_nnz=4, seed=1)",
        "C = mt.spgemm_host(A, device='cpu')",
        "assert C.equals(mt.oracle_spgemm(A, A), tol=1e-9)",
        "cfg = mt.SpGEMMConfig(mode='blockdense')",
        "D = mt.spgemm_host(A, config=cfg, device='cpu')",
        "assert D.equals(C, tol=1e-9)",
        "bad = [m for m in sys.modules",
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'mh_spgemm_tpu')]",
        "assert not bad, bad",
        "print('ok', C.nnz)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


def test_build_reads_the_log_kept_beside_a_library(tmp_path, monkeypatch):
    """A library built earlier is loaded without nvcc, and its ptxas
    diagnostics come back from the log kept beside it, so a run that
    reuses a build still reports the registers of what it runs."""
    from mh_spgemm_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    path = _build.library_path("planned")
    assert os.path.dirname(path) == str(tmp_path)
    open(path, "wb").close()
    with open(path + ".log", "w") as f:
        f.write("ptxas info    : Used 93 registers")
    assert _build.build("planned") == path
    assert _build.build_seconds["planned"] == 0.0
    assert "93 registers" in _build.build_log["planned"]


def test_build_names_a_library_after_its_source(tmp_path, monkeypatch):
    """The library's file name follows the source's bytes: an edited
    source gets a library of its own and is rebuilt, an unchanged one
    keeps its name and is loaded as it is."""
    from mh_spgemm_torch import _build
    os.makedirs(tmp_path / "csrc")
    src = tmp_path / "csrc" / "k.cu"
    monkeypatch.setattr(_build, "_PKG", str(tmp_path))
    src.write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert os.path.basename(first).startswith("libk_")


def test_ptxas_kernels_reads_each_entry():
    from mh_spgemm_torch import _build
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN1a6kernelIdEEv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN1a6kernelIdEEv",
        "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 4096 bytes smem",
        "ptxas info    : Compiling entry function '_ZN1a6kernelIfEEv' for "
        "'sm_90a'",
        "ptxas info    : Used 255 registers"])
    assert _build.ptxas_kernels(log) == [
        {"kernel": "_ZN1a6kernelIdEEv", "registers": 128, "smem_bytes": 4096,
         "stack_bytes": 16, "spill_bytes": 16},
        {"kernel": "_ZN1a6kernelIfEEv", "registers": 255, "smem_bytes": 0,
         "stack_bytes": 0, "spill_bytes": 0}]
