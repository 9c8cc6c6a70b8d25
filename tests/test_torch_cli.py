"""The port's benchmark CLI (``mh_spgemm_torch.bench.driver``) against the
JAX package's, on the CPU (``--device cpu``).

Both drivers run the same .mtx file under the same mode with ``--check
--json --stats``.  The port must return 0 and pass its check, and its
``nnz_C``, ``intprod`` and time-free ``stats`` fields must equal the JAX
driver's (``ns_per_product`` is a time; the JAX driver's
``floor_ns_per_product`` is a TPU figure the port does not print; the
port's replan counters, ``replanned``, ``replan_share`` and
``demoted_classes``, have no JAX key and are checked in
``test_torch_trace.py``; so have its ``padded_tail_slots``, checked in
``test_torch_padded_tail.py``, ``wide_tail_slots`` and
``wide_tail_live_slots``, checked in ``test_torch_wide_tail.py``, and
``gather_front_slots`` and ``gather_front_live_slots``, checked in
``test_torch_gather_front.py``).  Under
``--mode auto`` the two compare only where both chose the same engine.
"""

import json
import os

import pytest
import torch

from mh_spgemm_tpu.bench.driver import main as jax_main
from mh_spgemm_torch import CSR
from mh_spgemm_torch.bench import gen
from mh_spgemm_torch.bench.driver import main as port_main
from mh_spgemm_torch.io.mmio import write_mtx

MATRICES = {
    "band": lambda: gen.banded(300, band=11, nnz_per_row=6, seed=7),
    "dense_band": lambda: gen.banded(384, band=50, nnz_per_row=50, seed=3),
}
TIMED = ("ns_per_product", "floor_ns_per_product")
PORT_ONLY = ("replanned", "replan_share", "demoted_classes",
             "padded_tail_slots", "wide_tail_slots", "wide_tail_live_slots",
             "gather_front_slots", "gather_front_live_slots")


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    paths = {}
    for name, make in MATRICES.items():
        paths[name] = str(d / f"{name}.mtx")
        write_mtx(paths[name], make())
    return paths


def json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][0])


def run(main, path, mode, capsys, *extra):
    rc = main([path, "--mode", mode, "--check", "--json", "--stats",
               "--iters", "1", *extra])
    return rc, json_line(capsys.readouterr().out)


@pytest.mark.parametrize("mode", ["auto", "blockdense", "bucketed"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cli_matches_jax(name, mode, mtx, capsys):
    rc, got = run(port_main, mtx[name], mode, capsys, "--device", "cpu")
    assert rc == 0 and got["check"] == "pass"
    jrc, want = run(jax_main, mtx[name], mode, capsys)
    assert jrc == 0 and want["check"] == "pass"
    assert (got["nnz_C"], got["intprod"]) == (want["nnz_C"],
                                              want["intprod"])
    if mode == "auto" and got["stats"]["engine"] != want["stats"]["engine"]:
        return
    for k in TIMED:
        got["stats"].pop(k, None)
        want["stats"].pop(k, None)
    if got["stats"]["engine"] == "bucketed":
        for k in PORT_ONLY:
            got["stats"].pop(k)
    assert got["stats"] == want["stats"]


def test_cli_auto_engines(mtx, capsys):
    """The port's auto mode reaches both engines on these inputs."""
    engines = {}
    for name, path in mtx.items():
        assert port_main([path, "--device", "cpu", "--stats", "--iters",
                          "1"]) == 0
        out = capsys.readouterr().out
        stats = json.loads(out.split("engine stats:", 1)[1].splitlines()[0])
        engines[name] = stats["engine"]
        assert f"auto engine: {stats['engine']}" in out
    assert engines == {"band": "bucketed", "dense_band": "blockdense"}


def test_cli_text_output(mtx, capsys):
    rc = port_main([mtx["band"], "--device", "cpu", "--iters", "2",
                    "--check", "--dtype", "float32", "--aat", "--profile"])
    out = capsys.readouterr().out
    assert rc == 0
    for line in ("SpGEMM Start!!!", "SpGEMM intermediate result =",
                 "Calculate_C_nnz", "Gflops is", "pass", "SpGEMM   End!!!"):
        assert line in out


def test_cli_failures_return_1(mtx, tmp_path, capsys):
    assert port_main(["/nonexistent/not_there.mtx", "--device", "cpu"]) == 1
    assert "FAILED" in capsys.readouterr().out
    # A @ A of a rectangular matrix fails in both CLIs
    rect = str(tmp_path / "rect.mtx")
    write_mtx(rect, CSR.from_coo(3, 5, [0, 1, 2], [4, 0, 3],
                                 [1.0, 2.0, 3.0]))
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        assert main([rect, "--mode", "esc", *extra]) == 1
        assert "ShapeMismatchError" in capsys.readouterr().out


def test_cli_masked_matches_jax(mtx, capsys):
    """The masked engine through both CLIs on the band: the check passes
    and the time-free stats (classes by frontend) agree."""
    rc, got = run(port_main, mtx["band"], "masked", capsys, "--device",
                  "cpu")
    assert rc == 0 and got["check"] == "pass"
    jrc, want = run(jax_main, mtx["band"], "masked", capsys)
    assert jrc == 0 and want["check"] == "pass"
    assert (got["nnz_C"], got["intprod"]) == (want["nnz_C"],
                                              want["intprod"])
    for k in TIMED:
        got["stats"].pop(k, None)
        want["stats"].pop(k, None)
    if got["stats"]["engine"] == "bucketed":
        for k in PORT_ONLY:
            got["stats"].pop(k)
    assert got["stats"] == want["stats"]


def test_cli_needs_cuda_by_default(mtx, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_main([mtx["band"], "--iters", "1"]) == 1
    assert "failed!!!" in capsys.readouterr().out
