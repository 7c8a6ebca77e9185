"""The port's surface: isolation from JAX and the reference, the device rule,
the divergence registry and streaming entry points, and the parts of the
reference that are not ported yet."""
import ast
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import VariationalDualTree
from repro_torch._device import resolve_device
from repro_torch.core.divergence import (DIVERGENCES, SQEUCLIDEAN,
                                         resolve_divergence)
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


SERVING_PRIVATE = ("_batching", "_deprecation", "_engine", "_metrics",
                   "_propagate", "_queue", "_sharded", "engine_api", "fleet")
# the deprecated deep modules: each warns once per process on import
SERVING_SHIMS = ("engine", "metrics", "propagate", "queue", "decode")


def test_import_pulls_neither_jax_nor_reference_and_is_warning_free():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "fused_lp, repro_torch.data.synthetic, repro_torch.core.grf, "
            "repro_torch.core.baselines, repro_torch.core.streaming, "
            "repro_torch.core.divergence, repro_torch.kernels.grf, "
            "repro_torch.kernels.pairwise, repro_torch.models, "
            "repro_torch.models.moe, repro_torch.distributed, "
            "repro_torch.core.distributed, "
            "repro_torch.configs.registry, repro_torch.serving, "
            "repro_torch.data, repro_torch.runtime.checkpoint, "
            "repro_torch.runtime.preemption, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.distributed.pipeline, "
            "repro_torch.distributed.compression, "
            + "".join(f"repro_torch.serving.{m}, " for m in SERVING_PRIVATE)
            + "repro_torch.kernels.flash_attention\n"
            "from repro_torch.serving import (PropagateEngine, "
            "PropagateRequest, EngineFleet, ShardedPropagateEngine, "
            "propagate_many)\n"
            "from repro_torch.configs.registry import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
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
    for new in ("models/attention.py", "models/transformer.py",
                "serving/decode.py", "configs/registry.py",
                "configs/gemma3_1b.py", "kernels/flash_attention/ops.py",
                "serving/__init__.py", "serving/_engine.py",
                "serving/fleet.py", "serving/_queue.py",
                "core/streaming.py", "core/divergence.py",
                "serving/_sharded.py", "core/distributed.py",
                "distributed/sharding.py", "models/moe.py",
                "configs/deepseek_moe_16b.py", "configs/mixtral_8x7b.py",
                "data/pipeline.py", "runtime/checkpoint.py",
                "runtime/preemption.py", "distributed/compression.py",
                "distributed/pipeline.py", "launch/mesh.py",
                "launch/train.py"):
        assert PORT / new in files, new
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
    """ROADMAP Queue 1 item 6 is done: each of the reference's other
    divergences resolves by name and a port fit on the CPU carries it."""
    from repro.core.divergence import get_divergence as ref_divergence

    div = resolve_divergence(name)
    assert div.name == name == ref_divergence(name).name
    x = (np.random.RandomState(0).rand(8, 2) + 0.5).astype(np.float32)
    vdt = VariationalDualTree.fit(x, divergence=name, device="cpu")
    assert vdt.divergence_name == vdt.stats.divergence == name
    assert np.isfinite(vdt.bound)


def test_sqeuclidean_is_the_only_divergence():
    """``sqeuclidean`` is the default among the reference's registry."""
    from repro.core.divergence import DIVERGENCES as REF_DIVERGENCES

    for spec in (None, "sqeuclidean", SQEUCLIDEAN):
        assert resolve_divergence(spec) is SQEUCLIDEAN
    assert sorted(DIVERGENCES) == sorted(REF_DIVERGENCES)
    with pytest.raises(ValueError, match="unknown divergence"):
        resolve_divergence("cosine")


def test_streaming_is_not_ported_yet(small_fitted_vdt):
    """ROADMAP Queue 1 item 8 is done: insert and delete on the carried
    reference model give the reference's rows and point counts."""
    x, ref = small_fitted_vdt
    port = port_of(ref)
    x_new = np.random.RandomState(1).randn(2, x.shape[1]).astype(np.float32)
    for model in (ref, port):
        ins = model.insert_points(x_new)
        assert ins.vdt.tree.n_points == ref.tree.n_points + 2
        np.testing.assert_array_equal(ins.rows, [33, 34])
        dele = ins.vdt.delete_points([0])
        assert dele.vdt.tree.n_points == ref.tree.n_points + 1
        assert dele.row_map[0] == -1 and dele.row_map[1] == 0
    assert port.tree.n_points == ref.tree.n_points  # copy-on-write


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-130m",
                                  "whisper-medium"])
def test_non_dense_architectures_name_their_roadmap_item(arch):
    """The MoE (ROADMAP Queue 1 item 12b), SSM (12c) and audio (12e)
    families resolve to their configurations; nothing is left unported."""
    from repro_torch.configs.registry import (ARCH_IDS, NOT_PORTED,
                                              get_config, get_smoke_config)

    assert NOT_PORTED == ()
    family = {"mixtral-8x7b": "moe", "mamba2-130m": "ssm",
              "whisper-medium": "audio"}
    assert arch in ARCH_IDS
    for get in (get_config, get_smoke_config):
        assert get(arch).family == family[arch]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import init_lm
    from repro_torch.serving.decode import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, 1, 8)
    assert init_lm(cfg, device="cpu")["embed"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "internvl2-1b"])
def test_ssm_hybrid_and_vlm_entry_points_raise_without_a_card(arch,
                                                             monkeypatch):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import init_lm
    from repro_torch.serving.decode import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, 1, 8)
    params = init_lm(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in
               _param_leaves(params)), arch


def _param_leaves(tree):
    for v in tree.values():
        yield from (_param_leaves(v) if isinstance(v, dict) else (v,))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-W", "error", "-c", code],
                          capture_output=True, text=True,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})


def test_serving_surface_is_the_reference_minus_the_sharded_engine():
    """``repro_torch.serving.__all__`` is the reference's whole blessed
    surface: ``ShardedPropagateEngine`` is ported (ROADMAP Queue 1 item
    10) and imports."""
    import repro.serving as r_serving
    import repro_torch.serving as t_serving
    from repro_torch.serving import ShardedPropagateEngine

    assert sorted(t_serving.__all__) == sorted(r_serving.__all__)
    for name in t_serving.__all__:
        assert getattr(t_serving, name) is not None
    assert issubclass(ShardedPropagateEngine, t_serving.PropagateEngine)
    with pytest.raises(AttributeError):
        t_serving.NoSuchName


@pytest.fixture(scope="module")
def shim_report():
    """One fresh process: the blessed import first (it must leave the
    deprecation ledger empty), then each deep module imported, reloaded and
    imported again under ``warnings.simplefilter('always')``."""
    code = (
        "import importlib, json, warnings\n"
        "import repro_torch.serving as s\n"
        "from repro_torch.serving._deprecation import _WARNED\n"
        "report = {'ledger_after_blessed_import': sorted(_WARNED)}\n"
        f"for shim in {SERVING_SHIMS!r}:\n"
        "    name = 'repro_torch.serving.' + shim\n"
        "    with warnings.catch_warnings(record=True) as w:\n"
        "        warnings.simplefilter('always')\n"
        "        m = importlib.import_module(name)\n"
        "        importlib.reload(m)\n"
        "        importlib.import_module(name)\n"
        "    report[shim] = dict(\n"
        "        warnings=[str(x.message) for x in w\n"
        "                  if issubclass(x.category, DeprecationWarning)],\n"
        "        all=sorted(m.__all__),\n"
        "        not_canonical=[n for n in m.__all__ if hasattr(s, n)\n"
        "                       and getattr(m, n) is not getattr(s, n)])\n"
        "print(json.dumps(report))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout)


@pytest.mark.parametrize("shim", SERVING_SHIMS)
def test_deprecated_serving_modules_warn_once_with_canonical_objects(
        shim, shim_report):
    """Each deep module warns once per process, naming itself; a reload or
    a second import stays silent; its names are the reference module's, and
    those on the blessed surface are its canonical objects."""
    ref_mod = importlib.import_module(f"repro.serving.{shim}")
    got = shim_report[shim]
    assert len(got["warnings"]) == 1, got["warnings"]
    assert got["warnings"][0].startswith(
        f"repro_torch.serving.{shim} is deprecated; import ")
    assert got["all"] == sorted(ref_mod.__all__)
    assert not got["not_canonical"]


def test_blessed_serving_import_never_warns(shim_report):
    assert shim_report["ledger_after_blessed_import"] == []


def test_divergence_name_is_the_fitted_divergence(small_fitted_vdt):
    ref = small_fitted_vdt[-1]
    port = port_of(ref)
    assert port.divergence_name == ref.divergence_name == "sqeuclidean"
    x = np.random.RandomState(2).randn(12, 3).astype(np.float32)
    own = VariationalDualTree.fit(x, max_blocks=48, device="cpu",
                                  divergence=None)
    assert own.divergence_name == own.stats.divergence == "sqeuclidean"


# the reference's names a port module leaves out, each with its reason
# (README.md): none since collective_bytes sums the sharded dry run's
# collective records (launch/dryrun.py::count_sharded)
NOT_IN_PORT: dict = {}


@pytest.mark.parametrize("module", ["data.pipeline", "runtime.checkpoint",
                                    "runtime.preemption",
                                    "distributed.compression",
                                    "distributed.pipeline", "launch.mesh",
                                    "configs.shapes", "launch.roofline"])
def test_new_modules_export_the_reference_names(module):
    """Each module the last two slices ported exports the reference's
    ``__all__``, ``launch/roofline.py``'s ``collective_bytes`` included."""
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    want = set(ref.__all__) - NOT_IN_PORT.get(module, set())
    assert sorted(port.__all__) == sorted(want)
    for name in port.__all__:
        assert callable(getattr(port, name)) == callable(getattr(ref, name))


def test_sharding_exports_the_reference_names_and_the_leaf_layout():
    import repro.distributed.sharding as ref
    import repro_torch.distributed.sharding as port

    extra = set(port.__all__) - set(ref.__all__)
    assert set(ref.__all__) <= set(port.__all__)
    assert extra == {"LEAF_AXIS", "LeafMesh", "LeafSharding"}
