"""``repro_torch/configs`` ↔ ``repro/configs``: copies of the dense, MoE,
SSM, hybrid, vlm and audio architectures' configurations and the registry that
resolves them, the dry run's shape cells (``shapes.py``) and the paper's own
cell (``paper_vdt.py``)."""
