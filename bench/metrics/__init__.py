"""Metric readers, one module per metric of ``BENCHMARK.json``.

Each defines ``read(run) -> float | None`` over a ``harness.Run``; ``None``
means that the run holds nothing to read, and the metric is left out.  A
metric split by the end-to-end metric it moves (``serve_mfu.rate`` moves
``lp_requests_per_s``) is read by its stem's module (``serve_mfu.py``)
unless it has one of its own.
"""
