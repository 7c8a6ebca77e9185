"""The port's surface: isolation from JAX and the reference, the device rule,
and the parts of the reference that are not ported yet."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import VariationalDualTree
from repro_torch._device import resolve_device
from repro_torch.core.divergence import SQEUCLIDEAN, resolve_divergence
from test_torch_fit import port_of

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_pulls_neither_jax_nor_reference_and_is_warning_free():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "fused_lp, repro_torch.data.synthetic, repro_torch.core.grf, "
            "repro_torch.core.baselines, repro_torch.kernels.grf, "
            "repro_torch.kernels.pairwise\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-W", "error", "-c", code],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_file_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_modules_name_their_reference():
    """Every port module mirrors a reference module it names, or says it is new."""
    for path in sorted(PORT.rglob("*.py")):
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        rel = path.relative_to(PORT)
        if path.name == "__init__.py" or "no counterpart" in doc \
                or "(new)" in doc:
            continue
        ref = f"repro/{rel.as_posix()}"
        assert ref in doc, f"{rel} does not name {ref}"
        assert (REPO / "src" / ref).is_file(), ref


def test_fit_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(16, 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VariationalDualTree.fit(x, max_blocks=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("name", ["kl", "itakura_saito", "mahalanobis"])
def test_unported_divergences_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        resolve_divergence(name)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        VariationalDualTree.fit(np.zeros((8, 2), np.float32), divergence=name,
                                device="cpu")


def test_sqeuclidean_is_the_only_divergence():
    for spec in (None, "sqeuclidean", SQEUCLIDEAN):
        assert resolve_divergence(spec) is SQEUCLIDEAN
    with pytest.raises(ValueError, match="unknown divergence"):
        resolve_divergence("cosine")


def test_streaming_is_not_ported_yet(small_fitted_vdt):
    port = port_of(small_fitted_vdt[-1])
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port.insert_points(np.zeros((1, 4), np.float32))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        port.delete_points([0])
