"""``repro_torch/launch`` ↔ ``repro/launch``: the device meshes and the
launcher's ranks (``mesh.py``), the training launcher (``train.py``,
``python -m repro_torch.launch.train``, on every local card) and the
dry-run tooling (``dryrun.py``, ``perf_iter.py``, ``roofline.py``,
``summarize.py``: every cell's work counted on ``meta`` tensors and priced
at the H100's roofline)."""
