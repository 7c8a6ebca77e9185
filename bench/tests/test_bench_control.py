"""The control fails the cells' limits: the plain reference in the next
precision below float32 (bfloat16 carriers for the vdt walk, one TF32
product for the exact one, eq. 12's refit of sigma in bfloat16), put in the
program's place, reads above each real cell's ``answer_err`` and
``sigma_err`` limits, while the program reads below them.  At the cells' own
sizes this is run on the card by ``bench/control.py``."""
from __future__ import annotations

import pytest

from bench import harness


@pytest.mark.parametrize("workload,control", [("tiny.vdt", "bfloat16"),
                                              ("tiny.exact", "tf32")])
def test_control_fails_the_limit(tiny_layout, workload, control):
    backend = tiny_layout.cell(workload).mix["backend"]
    assert tiny_layout.module("reference", backend).CONTROL == control
    result, checks = harness.run_cell(tiny_layout, workload, 2**32 + 3, 1.0,
                                      False, "cpu", control=True)
    assert result["correct"]
    for name in ("answer_err", "sigma_err"):
        value, limit = checks[name]
        assert value <= limit
        assert result["control"][name] > 3 * limit, name
