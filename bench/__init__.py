"""The benchmark of ``repro_torch``: label propagation served from a fitted
variational dual tree through ``repro_torch.serving.PropagateEngine``.

One command runs one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on one CUDA card::

    python3 bench/run.py --workload secstr.vdt_r55 --seed 7 --seconds 30 --trace 0

Everything that belongs to one configuration, mix, metric or backend sits in
a file of its own that the harness finds by the name ``BENCHMARK.json``
gives it (``layout.py``): ``configs/<config>.json``, ``traffic/<mix>.json``
(with ``traffic/<loop>.py`` the generator its ``loop`` names),
``metrics/<metric>.py`` (or its stem's), ``data/<generator>.py``, ``reference/<backend>.py``
and ``limits/<workload>.json``.  The yardstick (work counts and peaks,
traffic, data, the plain reference and the comparison) lives here, so a
change to the program cannot move it.  Nothing here imports ``jax`` or the
JAX package ``repro``; the reference imports nothing of ``repro_torch``.
"""
