"""Seeded data generators, one module per configuration's ``generator``.

Each defines ``make(gen, device, **sizes) -> (N, d) float32 tensor``, drawn
from the torch generator ``gen`` on ``device`` in a few large calls.
"""
