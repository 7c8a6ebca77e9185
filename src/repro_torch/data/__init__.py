"""``repro_torch/data`` ↔ ``repro/data``: the deterministic, resumable token
and feature pipelines (``pipeline.py``) and the synthetic SSL datasets
(``synthetic.py``), both copies of the reference's numpy code."""
from repro_torch.data.pipeline import FeaturePipeline, TokenPipeline
from repro_torch.data.synthetic import SslDataset, by_name

__all__ = ["FeaturePipeline", "SslDataset", "TokenPipeline", "by_name"]
