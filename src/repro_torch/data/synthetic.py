"""``repro_torch/data/synthetic.py`` ↔ ``repro/data/synthetic.py``: a verbatim
copy (pure numpy), so the port makes its data without importing ``repro``.

Deterministic synthetic surrogates for the paper's SSL benchmark data.

Real datasets (SecStr, Digit1, USPS, Pascal alpha/ocr) are unavailable
offline; these generators match their N / d / class structure so the paper's
*relative* comparisons (exact vs kNN vs VDT under identical conditions, §5)
are reproducible:

  secstr_like  — high-dim sparse binary features, 2 classes (SecStr: 83 679
                 x 315 binary)
  digit1_like  — smooth low-dim manifold embedded in 241 dims (Digit1)
  usps_like    — clustered image-like features, 2 classes (USPS subset)
  alpha_like   — 500-dim dense, 2 balanced classes (Pascal alpha)
  blobs        — generic Gaussian mixture for unit tests / scaling sweeps
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["SslDataset", "blobs", "digit1_like", "usps_like", "secstr_like",
           "alpha_like", "two_moons", "by_name"]


class SslDataset(NamedTuple):
    x: np.ndarray        # (N, d) float32
    labels: np.ndarray   # (N,) int64
    name: str
    n_classes: int


def blobs(n: int, d: int = 8, n_classes: int = 2, sep: float = 6.0,
          spread: float = 1.0, seed: int = 0) -> SslDataset:
    r = np.random.RandomState(seed)
    labels = r.randint(0, n_classes, size=n)
    centers = r.randn(n_classes, d) * sep
    x = centers[labels] + r.randn(n, d) * spread
    return SslDataset(x.astype(np.float32), labels.astype(np.int64),
                      f"blobs{n}", n_classes)


def two_moons(n: int, noise: float = 0.08, seed: int = 0) -> SslDataset:
    r = np.random.RandomState(seed)
    n1 = n // 2
    t1 = np.pi * r.rand(n1)
    t2 = np.pi * r.rand(n - n1)
    x1 = np.stack([np.cos(t1), np.sin(t1)], 1)
    x2 = np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], 1)
    x = np.concatenate([x1, x2]) + r.randn(n, 2) * noise
    labels = np.concatenate([np.zeros(n1), np.ones(n - n1)])
    return SslDataset(x.astype(np.float32), labels.astype(np.int64),
                      f"moons{n}", 2)


def digit1_like(n: int = 1500, d: int = 241, seed: int = 1) -> SslDataset:
    """Two concentric-loop manifolds embedded in d dims + noise (Digit1 is an
    artificial manifold dataset; graph methods reach ~0.9+ CCR on it)."""
    r = np.random.RandomState(seed)
    labels = r.randint(0, 2, size=n)
    t = r.rand(n) * 2 * np.pi
    radius = 1.0 + 1.2 * labels
    base = np.stack([np.cos(t) * radius, np.sin(t) * radius,
                     0.1 * np.sin(3 * t)], 1)
    proj = r.randn(3, d) / np.sqrt(3)
    x = base @ proj + r.randn(n, d) * 0.02
    return SslDataset(x.astype(np.float32), labels.astype(np.int64),
                      "digit1-like", 2)


def usps_like(n: int = 1500, d: int = 241, seed: int = 2) -> SslDataset:
    """Clustered, heavier-tailed features (USPS handwritten digits, 2-class)."""
    r = np.random.RandomState(seed)
    labels = r.randint(0, 2, size=n)
    n_proto = 10
    protos = r.randn(2, n_proto, d) * 3.0
    which = r.randint(0, n_proto, size=n)
    x = protos[labels, which] + r.standard_t(df=4, size=(n, d)).astype(np.float64)
    return SslDataset(x.astype(np.float32), labels.astype(np.int64),
                      "usps-like", 2)


def secstr_like(n: int = 83679, d: int = 315, seed: int = 3) -> SslDataset:
    """Sparse binary features, 2 classes (SecStr: amino-acid windows)."""
    r = np.random.RandomState(seed)
    labels = r.randint(0, 2, size=n)
    p = np.where(labels[:, None] == 0, 0.08, 0.12)
    x = (r.rand(n, d) < p).astype(np.float32)
    return SslDataset(x, labels.astype(np.int64), "secstr-like", 2)


def alpha_like(n: int = 500000, d: int = 500, seed: int = 4) -> SslDataset:
    """Pascal alpha surrogate: dense 500-dim, 2 balanced classes."""
    r = np.random.RandomState(seed)
    labels = (np.arange(n) % 2).astype(np.int64)
    r.shuffle(labels)
    mean = r.randn(2, d) * 0.8
    x = mean[labels] + r.randn(n, d).astype(np.float32)
    return SslDataset(x.astype(np.float32), labels, "alpha-like", 2)


_REGISTRY = {
    "blobs": blobs,
    "moons": two_moons,
    "digit1": digit1_like,
    "usps": usps_like,
    "secstr": secstr_like,
    "alpha": alpha_like,
}


def by_name(name: str, **kw) -> SslDataset:
    return _REGISTRY[name](**kw)
