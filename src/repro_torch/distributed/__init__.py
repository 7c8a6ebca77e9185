"""``repro_torch/distributed`` ↔ ``repro/distributed``: the leaf-order layout
the sharded serving engine runs on and the LM sharding context
(``sharding.py``), the GPipe schedule over a device axis (``pipeline.py``)
and gradient compression (``compression.py``).
"""
from repro_torch.distributed.compression import (bf16_compress,
                                                 bf16_decompress,
                                                 compress_tree,
                                                 decompress_tree,
                                                 int8_compress,
                                                 int8_decompress)
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.distributed.sharding import (LEAF_AXIS, LeafMesh,
                                              LeafSharding, ShardCtx,
                                              current_ctx, leaf_mesh,
                                              leaf_sharding, param_shardings,
                                              shard_act, shard_attn_logits,
                                              use_ctx)

__all__ = ["LEAF_AXIS", "LeafMesh", "LeafSharding", "ShardCtx",
           "bf16_compress", "bf16_decompress", "compress_tree", "current_ctx",
           "decompress_tree", "int8_compress", "int8_decompress", "leaf_mesh",
           "leaf_sharding", "param_shardings", "pipeline_forward",
           "shard_act", "shard_attn_logits", "use_ctx"]
