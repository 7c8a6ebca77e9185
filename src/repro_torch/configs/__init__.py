"""``repro_torch/configs`` ↔ ``repro/configs``: copies of the dense, MoE,
SSM, hybrid and vlm architectures' configurations and the registry that
resolves them."""
