"""gridbench: the benchmark of mettagrid_tpu_torch on one NVIDIA H100.

One command runs one cell (BENCHMARK.json's ``workloads``) once:

    python3 -m gridbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (sizes and settings) beside ``configs/<config>.py``
(the system under test built from them), its traffic in
``traffic/<traffic>.json`` (the parameters that the one generator,
``traffic.py``, reads), the plain reference of its game in
``reference/<game>.py`` and of its maps in ``reference/maps/<kind>.py``, and
each per-layer metric's reader in ``metrics/<metric>.py``. Nothing here
imports jax or the JAX package.
"""
