"""``repro_torch/core/convert.py`` (new): a fitted state carried across.

:func:`vdt_from_numpy` builds the port's model from a fitted state given as
plain numpy arrays — for instance the reference package's fit, so that the
port's later stages can be held against the reference on the reference's
own tree (the port's own tree build may order near-tied points differently).
The optional ``divergence`` key names the fitted divergence: a registry name,
or a ``mahalanobis`` scale vector; without it the model is ``sqeuclidean``.
The port binds it to the carried tree, computing its own Bregman stats.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import divergence as div_mod
from repro_torch.core.blocks import BlockPartition
from repro_torch.core.qopt import QState
from repro_torch.core.tree import PartitionTree
from repro_torch.core.vdt import VariationalDualTree, VdtStats

__all__ = ["STATE_KEYS", "vdt_from_numpy"]

STATE_KEYS = (
    # tree
    "L", "n_points", "dim", "x_leaf", "w_leaf", "slot_of", "leaf_of", "W",
    "S1", "S2",
    # block partition
    "a", "b", "mirror", "active", "refined", "n", "cap",
    # q-state
    "log_q", "log_v", "log_z", "log_zt", "bound",
    "sigma",
)


def _divergence(spec) -> div_mod.Divergence:
    """A registry name, or the scale vector of a ``mahalanobis`` divergence."""
    if spec is None or isinstance(spec, str):
        return div_mod.resolve_divergence(spec)
    return div_mod.mahalanobis(spec)


def vdt_from_numpy(arrays: dict, *, device) -> VariationalDualTree:
    """A :class:`VariationalDualTree` on ``device`` from ``STATE_KEYS`` arrays
    and, optionally, ``divergence`` (see the module docstring)."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"fitted state lacks {missing}")
    dev = resolve_device(device)

    def tensor(key, dtype=torch.float32):
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype, device=dev)

    tree = PartitionTree(
        L=int(arrays["L"]), n_points=int(arrays["n_points"]),
        dim=int(arrays["dim"]), x_leaf=tensor("x_leaf"),
        w_leaf=tensor("w_leaf"), slot_of=tensor("slot_of", torch.int64),
        leaf_of=tensor("leaf_of", torch.int64), W=tensor("W"),
        S1=tensor("S1"), S2=tensor("S2"))
    bp = BlockPartition(
        a=np.array(arrays["a"], np.int32), b=np.array(arrays["b"], np.int32),
        mirror=np.array(arrays["mirror"], np.int32),
        active=np.array(arrays["active"], bool), n=int(arrays["n"]),
        cap=int(arrays["cap"]), refined=np.array(arrays["refined"], bool))
    qstate = QState(log_q=tensor("log_q"), log_v=tensor("log_v"),
                    log_z=tensor("log_z"), log_zt=tensor("log_zt"),
                    bound=tensor("bound"))
    sigma = tensor("sigma")
    bound = div_mod.bind_divergence(_divergence(arrays.get("divergence")),
                                    tree)
    stats = VdtStats(n_blocks=bp.n_active, bound=float(arrays["bound"]),
                     sigma=float(arrays["sigma"]), divergence=bound.name)
    return VariationalDualTree(tree=tree, bp=bp, qstate=qstate, sigma=sigma,
                               stats=stats, divergence=bound)
