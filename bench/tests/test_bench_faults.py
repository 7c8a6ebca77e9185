"""A run whose timed path is broken underneath comes out not correct, once
for each fault these one-card cells can have: a step that returns its state
unchanged; half of each dispatch's batch left out, the mean of the rest in
its place; an answer altered where it is produced; a fit whose bandwidth is
never refitted while it refines.  (No cell exchanges anything between
cards.)"""
from __future__ import annotations

import pytest
import torch

from bench import harness


def _unchanged_state(monkeypatch):
    import repro_torch.core.vdt as vdt_mod

    monkeypatch.setattr(vdt_mod, "lp_scan_leaforder_resume",
                        lambda y_leaf, *a, **k: y_leaf)
    monkeypatch.setattr(vdt_mod, "lp_scan_fused_resume",
                        lambda x, y, *a, **k: y)


def _half_batch(monkeypatch):
    from repro_torch.serving import PropagateEngine

    scan = PropagateEngine._scan

    def half(self, vdt, stack, alphas, n_iters, backend, **kw):
        bb = stack.shape[0]
        keep = max(1, bb // 2)
        out = scan(self, vdt, stack[:keep], alphas[:keep], n_iters, backend,
                   **kw)
        rest = out.mean(0, keepdim=True).expand(bb - keep, *out.shape[1:])
        return torch.cat([out, rest])

    monkeypatch.setattr(PropagateEngine, "_scan", half)


def _altered_answer(monkeypatch):
    from repro_torch.serving import PropagateEngine

    scan = PropagateEngine._scan

    def altered(self, *args, **kw):
        out = scan(self, *args, **kw).clone()
        out[0, :, 0] *= 1.01
        return out

    monkeypatch.setattr(PropagateEngine, "_scan", altered)


def _no_sigma_refit(monkeypatch):
    import repro_torch.core.refine as refine_mod

    refine = refine_mod.refine_to_budget

    def kept(*args, **kwargs):
        kwargs["refit_sigma"] = False
        return refine(*args, **kwargs)

    monkeypatch.setattr(refine_mod, "refine_to_budget", kept)


CAUGHT_BY = {_no_sigma_refit: "sigma_err"}   # the others: answer_err


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer, _no_sigma_refit])
@pytest.mark.parametrize("workload", ["tiny.vdt", "tiny.exact"])
def test_fault_is_not_correct(tiny_layout, monkeypatch, fault, workload):
    fault(monkeypatch)
    result, checks = harness.run_cell(tiny_layout, workload, 11, 1.0, False,
                                      "cpu")
    value, limit = checks[CAUGHT_BY.get(fault, "answer_err")]
    assert result["correct"] is False and value > limit
