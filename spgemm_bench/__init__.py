"""The benchmark of ``mh_spgemm_torch`` on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for ``--seconds`` seconds and prints one JSON line::

    python3 -m spgemm_bench.run --workload er_s17_ef16.warm --seed 7 \\
        --seconds 10 --trace 0

Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``), the loops the mixes name (``loops/<name>.py``)
and metrics (``metrics/<name>.py``) are files of their own, found by the
names ``BENCHMARK.json`` gives.  The generator (``gen.py``), the plain
reference (``reference.py``), the comparison (``check.py``) and the
profile reader (``profile.py``) are frozen here, so a change to the program cannot move the yardstick.  Nothing in
this package imports JAX or ``mh_spgemm_tpu``; only ``harness.py`` and
the loops import ``mh_spgemm_torch``, the system under test.
"""
