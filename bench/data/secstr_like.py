"""SecStr-like points (Chapelle, Schoelkopf and Zien, *Semi-Supervised
Learning*, MIT Press 2006, ch. 21: 83,679 amino-acid windows, 315 binary
features, 2 classes).

The distribution of ``repro_torch/data/synthetic.py::secstr_like``, copied
so that the yardstick stays fixed: labels uniform over the 2 classes, each
feature of a class-0 point on with probability ``p_on[0]`` (class 1:
``p_on[1]``).  Drawn on the device from a torch generator.
"""
from __future__ import annotations

import torch


def make(gen: torch.Generator, device, n: int, d: int,
         p_on=(0.08, 0.12)) -> torch.Tensor:
    labels = torch.randint(0, 2, (n,), generator=gen, device=device)
    p = torch.tensor(p_on, dtype=torch.float32, device=device)[labels]
    u = torch.rand((n, d), generator=gen, device=device)
    return (u < p[:, None]).to(torch.float32)
