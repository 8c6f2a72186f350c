"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found from its entry by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, an optional
``cells/<cell>.json`` of serving settings for that pair, the generator
``generators/<kind>.py`` the traffic names and, in a traced run, the
per-layer readers ``metrics/<metric>.py``.  ``counts`` holds the frozen
FLOP and byte formulas, ``reference`` the plain float32 model that
decides ``correct``.  Nothing here imports JAX or the JAX package.
"""
