"""``repro_torch/configs`` ↔ ``repro/configs``: copies of the dense, MoE,
SSM, hybrid, vlm and audio architectures' configurations and the registry that
resolves them."""
