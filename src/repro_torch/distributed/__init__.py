"""``repro_torch/distributed`` ↔ ``repro/distributed``: the leaf-order layout
the sharded serving engine runs on (``sharding.py``).

The reference's LM-side sharding (``ShardCtx``, ``use_ctx``, ``shard_act``,
``shard_attn_logits``, ``param_shardings``), its pipeline and its gradient
compression are what is left of this package: ROADMAP Queue 1 item 12g,
with the runtime, the data pipeline and the training launcher.
"""
from repro_torch.distributed.sharding import (LEAF_AXIS, LeafMesh,
                                              LeafSharding, leaf_mesh,
                                              leaf_sharding)

__all__ = ["LEAF_AXIS", "LeafMesh", "LeafSharding", "leaf_mesh",
           "leaf_sharding"]
