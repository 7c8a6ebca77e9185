"""``repro_torch/serving`` ↔ ``repro/serving``: the public serving API.

Everything a serving user needs imports from HERE::

    from repro_torch.serving import EngineFleet, PropagateEngine, PropagateRequest

The layers underneath:

* :class:`Engine` / :class:`FitParams` / :class:`DispatchState` /
  :class:`ResultSlab` — the abstract engine contract
  (:mod:`repro_torch.serving.engine_api`): params/state separation,
  slot-based result slabs, the lifecycle every engine implements.
* :class:`PropagateEngine` — the continuous-batching engine over one
  fitted variational dual tree, on the model's device (the card unless the
  model was fitted with ``device="cpu"``).
* :class:`ShardedPropagateEngine` — the same scheduler with every dispatch
  decomposed over a power-of-two mesh of shards (row stripes of the leaf
  order and of the exact matrix), bit for bit the single engine's output.
* :class:`EngineFleet` / :class:`FleetMetricsSnapshot` — the multi-tenant
  front-end: tenant -> fitted tree -> engine routing with weighted
  deficit-round-robin fair queueing.
* :func:`propagate_many` — static-list batching over one fitted tree.
* :class:`PropagateRequest` — the one request type every entry point
  accepts; :class:`QueueFull` / :class:`DeadlineExceeded` — the
  backpressure / deadline exceptions; :class:`MetricsSnapshot` — per-engine
  observability.

The deep modules
``repro_torch.serving.engine``, ``.propagate``, ``.queue`` and ``.metrics``
are deprecated shims over the private ``_*`` modules, as in the reference;
``serving/decode.py`` is the LM decode path and re-exports the
label-propagation names with the same deprecation warning.
"""
from repro_torch.serving._batching import (DEFAULT_WIDTH_BUCKETS,
                                           PropagateRequest)
from repro_torch.serving._engine import PropagateEngine
from repro_torch.serving._metrics import MetricsSnapshot
from repro_torch.serving._propagate import propagate_many
from repro_torch.serving._queue import DeadlineExceeded, QueueFull
from repro_torch.serving._sharded import ShardedPropagateEngine
from repro_torch.serving.engine_api import (DispatchState, Engine, FitParams,
                                            ResultSlab)
from repro_torch.serving.fleet import EngineFleet, FleetMetricsSnapshot

__all__ = [
    "DEFAULT_WIDTH_BUCKETS",
    "DeadlineExceeded",
    "DispatchState",
    "Engine",
    "EngineFleet",
    "FitParams",
    "FleetMetricsSnapshot",
    "MetricsSnapshot",
    "PropagateEngine",
    "PropagateRequest",
    "QueueFull",
    "ResultSlab",
    "ShardedPropagateEngine",
    "propagate_many",
]

