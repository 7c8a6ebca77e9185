"""PASCAL alpha-like points (PASCAL Large Scale Learning Challenge 2008,
data set "alpha": 500,000 x 500 dense, 2 balanced classes).

The distribution of ``repro_torch/data/synthetic.py::alpha_like``, copied so
that the yardstick stays fixed: exactly balanced labels in a random order,
class means drawn as ``mean_scale`` x N(0, 1) a coordinate, and unit
Gaussian noise around them.  Drawn on the device from a torch generator.
"""
from __future__ import annotations

import torch


def make(gen: torch.Generator, device, n: int, d: int,
         mean_scale: float = 0.8) -> torch.Tensor:
    labels = torch.arange(n, device=device) % 2
    labels = labels[torch.randperm(n, generator=gen, device=device)]
    mean = torch.randn((2, d), generator=gen, device=device) * mean_scale
    noise = torch.randn((n, d), generator=gen, device=device)
    return mean[labels] + noise
