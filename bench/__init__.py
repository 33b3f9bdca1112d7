"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA card and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by name:

* ``bench/configs/<config>.json``: the deployment; its ``generator`` names
  ``bench/datagen/<generator>.py``;
* ``bench/traffic/<traffic>.json``: the mix; its ``loop`` names
  ``bench/loops/<loop>.py``;
* ``bench/metrics/<metric>.py``: one reader a per-layer metric.

Nothing here imports JAX or the JAX package ``repro``; the plain reference
(``bench/reference.py``) imports nothing of the port either.
"""
