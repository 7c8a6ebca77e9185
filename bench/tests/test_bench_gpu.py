"""The tiny cells on a CUDA card (``pytest -m gpu bench/tests``)."""
from __future__ import annotations

import pytest
import torch

from bench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tiny.vdt", "tiny.exact"])
def test_tiny_cell_on_the_card(tiny_layout, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = harness.run_cell(tiny_layout, workload, 5, 1.0, True,
                                      "cuda")
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
