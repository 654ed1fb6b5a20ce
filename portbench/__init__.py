"""The benchmark of the PyTorch / CUDA port of the autoscaler
(``wva_tpu_torch``): one command, ``python3 portbench/run.py``, that
drives the port on the card for one cell of ``BENCHMARK.json`` and prints
its metrics and whether what it produced agrees with the plain reference.

Everything is found by name: a configuration in ``configs/<name>.json``, a
traffic mix in ``traffic/<name>.json`` (whose ``generator`` names the
driver in ``drivers/``), a per-layer metric's reader in
``metrics/<name>.py``, a kernel's work count in ``kernels/<name>.py``
and a compared number in ``checks/<name>.py``.
"""
