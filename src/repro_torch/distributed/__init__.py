"""``repro_torch/distributed`` ↔ ``repro/distributed``: the leaf-order layout
the sharded serving engine runs on (``sharding.py``).

The reference's LM-side sharding (``ShardCtx``, ``use_ctx``, ``shard_act``,
``shard_attn_logits``, ``param_shardings``), its pipeline and its gradient
compression are not ported yet (ROADMAP Queue 1 item 12g).
"""
from repro_torch.distributed.sharding import (LEAF_AXIS, LeafMesh,
                                              LeafSharding, leaf_mesh,
                                              leaf_sharding)

__all__ = ["LEAF_AXIS", "LeafMesh", "LeafSharding", "leaf_mesh",
           "leaf_sharding"]
