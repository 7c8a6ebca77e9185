"""The plain references follow the configuration's divergence: the block
divergences equal the sum over each block's point pairs, a ``kl`` or
``itakura_saito`` run comes out correct and its control does not, a program
fitted under another divergence than the configuration's is caught, and a
divergence or points that the references cannot check fail at set-up."""
from __future__ import annotations

import copy
import dataclasses
import re

import pytest
import torch

from bench import harness
from bench.reference import bregman, vdt

L_SMALL = 3      # 8 leaf slots: 7 points and one ghost


def _subtree_rows(node: int, leaf_of: torch.Tensor, n: int) -> list:
    """The rows in the leaf slots under heap node ``node``."""
    first, count = node, 1
    while first < (1 << L_SMALL) - 1:
        first, count = 2 * first + 1, 2 * count
    slots = leaf_of[first - ((1 << L_SMALL) - 1):][:count]
    return [int(r) for r in slots if r < n]


def _disjoint(a: int, b: int) -> bool:
    def ancestors(k):
        out = {k}
        while k:
            k = (k - 1) // 2
            out.add(k)
        return out
    return a not in ancestors(b) and b not in ancestors(a)


def _pair(div: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d(a, b) by its definition, one pair at a time."""
    if div == "sqeuclidean":
        return ((a - b) ** 2).sum()
    if div == "kl":
        return (a * torch.log(a / b) - a + b).sum()
    return (a / b - torch.log(a / b) - 1.0).sum()


@pytest.mark.parametrize("div", ["kl", "itakura_saito", "sqeuclidean"])
def test_block_div_is_the_sum_over_point_pairs(div):
    gen = torch.Generator().manual_seed(35)
    n, d = 7, 5
    x = torch.rand((n, d), generator=gen, dtype=torch.float64) * 2.0 + 0.1
    leaf_of = torch.tensor([3, 0, 6, 7, 1, 5, 2, 4])   # slot 3 is a ghost
    nodes = range((1 << (L_SMALL + 1)) - 1)
    pairs = [(a, b) for a in nodes for b in nodes if a != b and _disjoint(a, b)]
    fitted = {"leaf_of": leaf_of, "L": L_SMALL,
              "a": torch.tensor([a for a, _ in pairs]),
              "b": torch.tensor([b for _, b in pairs])}
    got = vdt.block_div(x, fitted, {"fit": {"divergence": div}})
    want = torch.stack([
        sum((_pair(div, x[i], x[j]) for i in _subtree_rows(a, leaf_of, n)
             for j in _subtree_rows(b, leaf_of, n)),
            torch.zeros((), dtype=torch.float64))
        for a, b in pairs])
    assert got.dtype == torch.float64 and bool((want > 0).any())
    torch.testing.assert_close(got, want, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("workload", ["tiny_kl.vdt", "tiny_kl.exact",
                                      "tiny_is.vdt", "tiny_is.exact"])
def test_bregman_cell_is_correct_and_its_control_is_not(tiny_layout,
                                                        workload):
    cfg = tiny_layout.cell(workload).config
    assert cfg["fit"]["divergence"] in bregman.POSITIVE
    result, checks = harness.run_cell(tiny_layout, workload, 2**33 + 35, 1.0,
                                      False, "cpu", control=True)
    assert result["correct"], checks
    for name in ("answer_err", "sigma_err"):
        value, limit = checks[name]
        assert value <= limit
        assert result["control"][name] > limit, name


@pytest.mark.parametrize("workload", ["tiny_kl.vdt", "tiny_kl.exact"])
def test_fit_under_another_divergence_is_not_correct(tiny_layout,
                                                     monkeypatch, workload):
    """The fault: the program fits (and so serves) squared Euclidean while
    the configuration says ``kl``."""
    from repro_torch.core.vdt import VariationalDualTree

    fit = VariationalDualTree.fit
    monkeypatch.setattr(VariationalDualTree, "fit", classmethod(
        lambda cls, *a, **k: fit(*a, **{**k, "divergence": "sqeuclidean"})))
    result, checks = harness.run_cell(tiny_layout, workload, 35, 1.0, False,
                                      "cpu")
    assert result["correct"] is False
    assert checks["answer_err"][0] > checks["answer_err"][1]


def _configured(monkeypatch, layout, workload: str, divergence: str):
    """``layout``'s ``workload`` with its configuration's divergence set."""
    cell = layout.cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["fit"]["divergence"] = divergence
    monkeypatch.setattr(layout, "cell", lambda w: dataclasses.replace(
        cell, config=cfg))


def _never_fitted(*args, **kwargs):
    raise AssertionError("the program was fitted before the refusal")


@pytest.mark.parametrize("workload,divergence", [
    ("tiny_kl.vdt", "mahalanobis"),
    ("tiny_kl.exact", "mahalanobis[1a2b3c4d]"),
    ("tiny.vdt", "cosine"),
    ("tiny.vdt", "kl"),                 # SecStr-like points hold zeros
    ("tiny.exact", "itakura_saito"),
])
def test_unchecked_divergence_fails_at_setup(tiny_layout, monkeypatch,
                                             workload, divergence):
    _configured(monkeypatch, tiny_layout, workload, divergence)
    monkeypatch.setattr(harness, "fit_model", _never_fitted)
    with pytest.raises(ValueError,
                       match=re.escape(f"divergence {divergence!r}")):
        harness.run_cell(tiny_layout, workload, 35, 1.0, False, "cpu")
