"""``repro_torch/launch`` ↔ ``repro/launch``: the local device mesh
(``mesh.py``) and the training launcher (``train.py``,
``python -m repro_torch.launch.train``).  The reference's dry-run tooling
(``dryrun``, ``perf_iter``, ``roofline``, ``summarize``) and its production
mesh are ROADMAP Queue 1 item 12h."""
