"""The benchmark of the PyTorch/CUDA port (``latent_feature_grid_compression_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` on the card and prints one JSON
line::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so a later change adds a cell as files and
entries only: a configuration is ``configs/<file>.json`` (named by its entry in
``BENCHMARK.json``), a traffic mix ``traffic/<traffic>.json`` (parameters that
``generator.py`` reads), a metric ``metrics/<metric>.py`` (a ``read(run)``
that returns a number or None), and the operation counts sit in ``counts/``.
The plain reference that decides ``correct`` is ``reference/``; it imports
nothing of the port.  Nothing here imports JAX or the JAX package.
"""
