"""The port's dry-run tooling against the reference on the CPU.

``configs/shapes.py``, ``configs/paper_vdt.py``, ``launch/{dryrun,
perf_iter,roofline,summarize}.py`` and ``launch/mesh.py::
make_production_mesh``.  The reference's ``launch/dryrun.py`` and
``launch/perf_iter.py`` set ``XLA_FLAGS`` when imported (512 forced host
devices), which must not happen in a test process: their names, flags and
literals are read from their source with ``ast``.  Every count here runs on
``meta`` or small CPU tensors.
"""
import ast
import dataclasses
import itertools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_vdt as r_paper_vdt
from repro.configs import registry as r_registry
from repro.configs import shapes as r_shapes
from repro.launch import roofline as r_roofline
from repro.launch import summarize as r_summarize
from repro.models import transformer as r_tf
from repro.models import whisper as r_whisper
from repro_torch import _tree
from repro_torch.configs import paper_vdt, registry, shapes
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.flash_attention import (
    attention_pairs, attention_work)
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.launch import dryrun, perf_iter, roofline, summarize
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer, whisper

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

REF_LAUNCH = Path(r_roofline.__file__).resolve().parent
CELLS = list(itertools.product(registry.ARCH_IDS, shapes.SHAPES))
# one SMOKE architecture of each family
FAMILIES = ("smollm-360m", "deepseek-moe-16b", "mamba2-130m", "zamba2-1.2b",
            "internvl2-1b", "whisper-medium")


def _ref_source(name: str) -> ast.Module:
    return ast.parse((REF_LAUNCH / f"{name}.py").read_text())


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1] if isinstance(x, torch.Tensor) \
        else str(np.dtype(x.dtype))


def _same_leaves(port_tree, ref_tree):
    got = [x for x in _tree.flatten(port_tree)[0]
           if isinstance(x, torch.Tensor)]
    want = jax.tree_util.tree_leaves(ref_tree)
    assert [(tuple(x.shape), _dtype(x)) for x in got] == \
        [(tuple(x.shape), _dtype(x)) for x in want]
    assert all(x.device.type == "meta" for x in got)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_applicable_matches_reference(arch, shape):
    assert shapes.cell_is_applicable(registry.get_config(arch),
                                     shapes.SHAPES[shape]) == \
        r_shapes.cell_is_applicable(r_registry.get_config(arch),
                                    r_shapes.SHAPES[shape])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Leaf for leaf in shape and type, the decode state in JAX's order;
    the same metadata."""
    got, meta = shapes.input_specs(registry.get_config(arch),
                                   shapes.SHAPES[shape])
    want, r_meta = r_shapes.input_specs(r_registry.get_config(arch),
                                        r_shapes.SHAPES[shape])
    assert meta == r_meta
    _same_leaves(got, want)
    assert dataclasses.asdict(shapes.SHAPES[shape]) == \
        dataclasses.asdict(r_shapes.SHAPES[shape])


def test_input_specs_batch_override_and_device():
    cfg = registry.get_smoke_config("smollm-360m")
    got, meta = shapes.input_specs(cfg, shapes.SHAPES["decode_32k"], 3,
                                   device="cpu")
    assert got["token"].shape == (3, 1) and got["token"].device.type == "cpu"
    assert got["state"].kv.k.shape[1] == 3 and meta == {"tokens_per_step": 3}


def test_tree_round_trips_a_decode_state():
    """``_tree`` walks a dataclass's fields in order (its ``ring`` flag a
    leaf) and rebuilds it: ``map_leaves`` over a decode state keeps its type
    and every field."""
    cfg = registry.get_smoke_config("gemma3-1b")
    state, _ = shapes.input_specs(cfg, shapes.SHAPES["decode_32k"], 2,
                                  device="cpu")
    state = state["state"]
    leaves, treedef = _tree.flatten(state)
    assert _tree.unflatten(treedef, leaves) == state
    doubled = _tree.map_leaves(
        lambda x: x + 1 if isinstance(x, torch.Tensor) else x, state)
    assert type(doubled) is type(state) and type(doubled.kv) is type(state.kv)
    assert doubled.kv.ring == state.kv.ring
    assert torch.equal(doubled.kv.k, state.kv.k + 1)
    assert "KVCache(k=*" in str(treedef)


def test_tree_walks_leave_no_reference_cycle():
    """A tensor that ``flatten`` / ``unflatten`` saw is freed as soon as the
    caller drops it, with no garbage collection: a card step counted by
    ``count_work`` must not hold its outputs past the count."""
    import gc
    import weakref

    x = torch.zeros(3)
    seen = weakref.ref(x)
    gc.disable()
    try:
        leaves, treedef = _tree.flatten({"a": [x, (x,)], "b": None})
        _tree.unflatten(treedef, leaves)
        del x, leaves
        assert seen() is None
    finally:
        gc.enable()


def test_paper_vdt_specs_match_reference():
    got, meta = paper_vdt.input_specs()
    want, r_meta = r_paper_vdt.input_specs()
    assert meta == r_meta
    _same_leaves(got, want)
    for name in ("NAME", "N_POINTS", "N_CLASSES", "BLOCKS_PER_POINT",
                 "ALPHA"):
        assert getattr(paper_vdt, name) == getattr(r_paper_vdt, name)


def test_long_context_rules_match_design():
    """DESIGN.md §5: long_500k runs for ssm/hybrid/pure-SWA only."""
    runs = {a for a in registry.ARCH_IDS
            if shapes.cell_is_applicable(registry.get_config(a),
                                         shapes.SHAPES["long_500k"])[0]}
    assert runs == {"mamba2-130m", "zamba2-1.2b", "mixtral-8x7b"}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_meta_init_matches_reference_shapes(arch):
    """Full-size parameters on ``meta``: the reference's ``jax.eval_shape``
    of its init, leaf for leaf in shape and type."""
    cfg = registry.get_config(arch)
    init, r_init = ((whisper.init_encdec, r_whisper.init_encdec)
                    if cfg.family == "audio" else
                    (transformer.init_lm, r_tf.init_lm))
    want = jax.eval_shape(lambda: r_init(r_registry.get_config(arch),
                                         jax.random.PRNGKey(0)))
    _same_leaves(init(cfg, device="meta"), want)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_meta_init_gives_the_cpu_shapes_and_types(arch):
    cfg = registry.get_smoke_config(arch)
    init = whisper.init_encdec if cfg.family == "audio" else \
        transformer.init_lm
    got = _tree.flatten(init(cfg, 3, device="meta"))[0]
    want = _tree.flatten(init(cfg, 3, device="cpu"))[0]
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in want]
    # the CPU draws are those of a CPU generator with the same seed
    again = _tree.flatten(init(cfg, 3, device="cpu"))[0]
    assert all(torch.equal(a, b) for a, b in zip(want, again))


K6_CASES = [(True, 0), (True, 5), (False, 0), (False, 5)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("causal,window", K6_CASES)
def test_k6_op_counts_its_formula(device, causal, window):
    """K6 is one operator to ``FlopCounterMode``: its FLOPs are the
    unmasked pairs' products (``attention_work``), not the plain
    version's tile products; its meta output has q's shape; the CPU runs
    launch nothing."""
    b, hq, hkv, s, d = 2, 4, 2, 13, 64
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to(device)
               for h in (hq, hkv, hkv))
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_route))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as mode:
        out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == device
    assert mode.get_total_flops() == attention_work(
        b, hq, hkv, s, d, window, 4, causal)[0]
    assert (flash_attention.launches,
            flash_attention.launches_by_route) == before
    assert dryrun.count_work(flash_attention_fwd, q, k, v, causal, window) \
        == tuple(int(x) for x in attention_work(
            b, hq, hkv, s, d, window, 4, causal))


@pytest.mark.parametrize("s", [1, 7, 64, 100])
@pytest.mark.parametrize("causal,window", K6_CASES + [(True, 64),
                                                      (False, 100)])
def test_attention_pairs_count_the_mask(s, causal, window):
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = (j <= i) if causal else np.ones((s, s), bool)
    if window:
        keep &= (i - j < window)
    assert attention_pairs(s, window, causal) == int(keep.sum())


def test_k6_gradient_on_meta_has_the_operand_shapes():
    q, k, v = (torch.empty(1, h, 16, 64, device="meta", requires_grad=True)
               for h in (4, 2, 2))
    flash_attention(q, k, v, causal=True, window=0).sum().backward()
    assert (q.grad.shape, k.grad.shape, v.grad.shape) == \
        (q.shape, k.shape, k.shape)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_count_equals_the_cpu_count(arch, kind, monkeypatch):
    """``count_work`` of a cell's step at SMOKE width (trains with remat
    on, as the full configurations) on meta tensors equals the same step's
    count on CPU tensors, FLOPs and bytes."""
    name = {"prefill": "prefill_32k", "decode": "decode_32k",
            "train": "train_4k"}[kind]
    monkeypatch.setitem(dryrun.SHAPES, name,
                        shapes.ShapeSpec(name, 24, 2, kind))
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              remat=kind == "train", ssm_chunk=8)
    counts = []
    for device in ("meta", "cpu"):
        fn, args, arg_bytes, *_ = dryrun.build_cell(
            arch, name, False, cfg_override=cfg, device=device)
        counts.append(dryrun.count_work(fn, *args) + (arg_bytes,))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0 and counts[0][1] > 0


def test_roofline_as_dict_keys_match_reference():
    rl = roofline.roofline_terms({"flops": 1e15, "bytes accessed": 2e12},
                                 {}, 4, model_flops=5e14, tokens_per_step=8)
    ref = r_roofline.roofline_terms({"flops": 1e15, "bytes accessed": 2e12},
                                    {"total": 0}, 4, model_flops=5e14,
                                    tokens_per_step=8)
    assert list(rl.as_dict()) == list(ref.as_dict())
    assert rl.coll_bytes == 0.0 and rl.bottleneck == "compute"
    assert rl.t_compute == 1e15 / (4 * roofline.HW.PEAK_FLOPS)
    assert rl.mfu == 5e14 / (4 * roofline.HW.PEAK_FLOPS * rl.step_time)


def test_bound_is_the_larger_of_the_two_times():
    assert roofline.bound(989e9, 1.0, roofline.HW.PEAK_FLOPS) == \
        (1.0, "operations")
    assert roofline.bound(0.0, 3.35e9) == (1.0, "bytes")


def test_run_cell_on_a_smoke_override_is_ok(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    cfg = registry.get_smoke_config("smollm-360m")
    rec = dryrun.run_cell("smollm-360m", "train_4k", False,
                          cfg_override=cfg)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["counted"] == "meta" and rec["n_chips"] == 256
    assert rec["model_flops"] == 6 * cfg.active_param_count() * 256 * 4096
    assert rec["roofline"]["flops"] == rec["flops"] > 0
    assert 0 < rec["argument_bytes_per_device"] < 3 * 4 * cfg.param_count()
    assert "compile_s" not in rec
    # a dense cell is counted per device as the sharded program and
    # globalised as the reference does: FLOPs and bytes x chips, the
    # collectives once (the row-parallel products' reductions among them;
    # SMOKE's 60 columns divide no axis of 16, so no weight is sharded and
    # nothing is gathered: the vocabulary-sharded embedding's masked sum is
    # all-reduced, not gathered)
    assert rec["sharded"] is True
    assert rec["flops"] == rec["flops_per_device"] * 256
    assert rec["bytes"] == rec["bytes_per_device"] * 256
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0 and coll["all-gather"] == 0
    assert coll["total"] == rec["roofline"]["coll_bytes"] > 0
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec
    # a second call reads the record back
    assert dryrun.run_cell("smollm-360m", "train_4k", False) == rec


def test_run_cell_of_a_family_not_sharded_counts_globally(tmp_path,
                                                          monkeypatch):
    """No family is left outside ``SHARDED_FAMILIES`` (the vlm and audio
    families joined it last): the cell this test once counted globally,
    internvl2-1b's ``train_4k``, is now counted per device as the sharded
    program, its collectives counted, globalised over the chips."""
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    cfg = registry.get_smoke_config("internvl2-1b")
    assert set(dryrun.SHARDED_FAMILIES) == {
        registry.get_config(a).family for a in registry.ARCH_IDS}
    rec = dryrun.run_cell("internvl2-1b", "train_4k", False,
                          cfg_override=cfg)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["sharded"] is True and rec["collectives"]["total"] > 0
    assert rec["flops"] == rec["flops_per_device"] * 256 > 0
    assert rec["bytes"] == rec["bytes_per_device"] * 256
    assert rec["roofline"]["coll_bytes"] == rec["collectives"]["total"]
    assert rec["n_chips"] == 256


def test_run_cell_skips_full_attention_long_500k(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    rec = dryrun.run_cell("glm4-9b", "long_500k", True)
    assert rec["status"] == "skipped"
    assert rec["cell"] == "glm4-9b__long_500k__multi_pod"
    assert rec["reason"] == r_shapes.cell_is_applicable(
        r_registry.get_config("glm4-9b"), r_shapes.SHAPES["long_500k"])[1]


def test_run_vdt_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    rec = dryrun.run_vdt_cell(False, force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cell"] == "paper-vdt__lp_1m__single_pod"
    assert rec["model_flops"] == 2 * 4 * 2 ** 18 * 8
    assert rec["bytes"] > 0 and rec["n_chips"] == 256


def test_summarize_writes_the_reference_table(tmp_path, monkeypatch):
    """The same records (in the reference's format: with collectives and a
    compile time; a skipped cell, an error and a variant) give the same
    table in both packages."""
    monkeypatch.setattr(dryrun, "ART", tmp_path / "port" / "dryrun_torch")
    recs = [dryrun.run_vdt_cell(False, force=True),
            dryrun.run_cell("glm4-9b", "long_500k", False),
            dryrun.run_cell("smollm-360m", "decode_32k", False,
                            cfg_override=registry.get_smoke_config(
                                "smollm-360m"))]
    recs.append(dict(recs[-1], cell=recs[-1]["cell"] + "__chunked_ce"))
    recs.append({"cell": "x__train_4k__single_pod", "arch": "x",
                 "shape": "train_4k", "mesh": "single_pod",
                 "status": "error", "error": "ValueError: no"})
    tables = []
    for mod, art in ((summarize, tmp_path / "port" / "dryrun_torch"),
                     (r_summarize, tmp_path / "ref" / "dryrun")):
        art.mkdir(parents=True, exist_ok=True)
        for i, rec in enumerate(recs):
            rec = {k: v for k, v in rec.items() if k != "counted"}
            rec.update(compile_s=1.5 + i, collectives={"total": 1e9 * i})
            (art / f"{rec['cell']}.json").write_text(json.dumps(rec))
        monkeypatch.setattr(mod, "ART", art)
        mod.main()
        out = "roofline_torch.md" if mod is summarize else "roofline.md"
        summ = "summary_torch.json" if mod is summarize else "summary.json"
        tables.append(((art.parent / out).read_text(),
                       json.loads((art.parent / summ).read_text())))
    assert tables[0] == tables[1]
    assert "paper-vdt__lp_1m__single_pod" in tables[0][0]


def test_summarize_shows_the_port_records_roofline(tmp_path, monkeypatch):
    """The port's own records (counted on meta, no compile): the paper
    cell, with 0 FLOPs, shows its memory-bound roofline, and no row reads a
    compile time."""
    monkeypatch.setattr(dryrun, "ART", tmp_path / "dryrun_torch")
    monkeypatch.setattr(summarize, "ART", tmp_path / "dryrun_torch")
    dryrun.run_vdt_cell(False, force=True)
    dryrun.run_cell("smollm-360m", "decode_32k", False,
                    cfg_override=registry.get_smoke_config("smollm-360m"))
    summarize.main()
    rows = {ln.split(" | ")[0][2:]: ln.split(" | ")[1:] for ln in
            (tmp_path / "roofline_torch.md").read_text().splitlines()
            if ln.startswith("| ") and "__" in ln}
    assert set(rows) == {"paper-vdt__lp_1m__single_pod",
                         "smollm-360m__decode_32k__single_pod"}
    for cells in rows.values():
        assert cells[0] == "-" and cells[4] in ("compute", "memory")
    vdt = rows["paper-vdt__lp_1m__single_pod"]
    assert vdt[4] == "memory" and float(vdt[1]) == 0.0 and float(vdt[2]) > 0


def _function_literals(tree: ast.Module, fn_name: str) -> list:
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return [ast.literal_eval(e) for n in ast.walk(fn)
            if isinstance(n, ast.IfExp) for e in (n.body, n.orelse)]


def test_make_production_mesh_has_the_reference_shape_and_axes():
    shape_multi, shape_single, axes_multi, axes_single = _function_literals(
        _ref_source("mesh"), "make_production_mesh")
    for multi, shape, axes in ((False, shape_single, axes_single),
                               (True, shape_multi, axes_multi)):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.sizes == shape and mesh.axis_names == axes
        assert len(mesh.devices) == int(np.prod(shape))
        assert {d.type for d in mesh.devices} == {"meta"}


def test_perf_iter_variants_have_the_reference_keys():
    tree = _ref_source("perf_iter")
    assign = next(n for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "VARIANTS")
    keys = [ast.literal_eval(k) for k in assign.value.keys]
    assert list(perf_iter.VARIANTS) == keys
    assert perf_iter.VARIANTS["noremat"]["cfg"] == {"remat": False}


def test_perf_iter_counts_a_variant(tmp_path, monkeypatch):
    """``chunked_ce`` re-counts the cell; the knobs are cleared after."""
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    monkeypatch.setattr(perf_iter, "get_config", registry.get_smoke_config)
    rec = perf_iter.run_variant("smollm-360m", "train_4k", "chunked_ce",
                                force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cell"].endswith("__chunked_ce")
    assert dryrun.CTX_KW == {} and dryrun.TRAIN_KW == {}


@pytest.mark.parametrize("module", ["dryrun", "perf_iter", "summarize"])
def test_launch_modules_keep_the_reference_names_and_flags(module):
    tree = _ref_source(module)
    port = ast.parse(Path(getattr(
        {"dryrun": dryrun, "perf_iter": perf_iter, "summarize": summarize}
        [module], "__file__")).read_text())

    def public(t):
        return {n.name for n in t.body if isinstance(n, ast.FunctionDef)
                and not n.name.startswith("_")}

    def flags(t):
        return sorted(n.args[0].value for n in ast.walk(t)
                      if isinstance(n, ast.Call)
                      and getattr(n.func, "attr", "") == "add_argument")

    assert public(tree) <= public(port)
    assert flags(tree) == flags(port)
