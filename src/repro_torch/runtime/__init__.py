"""``repro_torch/runtime`` ↔ ``repro/runtime``: checkpoints that interchange
with the reference's (``checkpoint.py``) and preemption handling
(``preemption.py``)."""
