"""``repro_torch/serving`` ↔ ``repro/serving``: LM prefill and KV-cache
decode for the dense family (``decode.py``).  The label-propagation serving
engine is not ported yet (ROADMAP Queue 1 item 7)."""
