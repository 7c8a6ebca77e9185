"""``repro_torch/configs`` ↔ ``repro/configs``: copies of the dense
architectures' configurations and the registry that resolves them."""
