"""The port's sharded train step held to the reference's collective bytes, on
the CPU.

The reference's float32 train step (AdamW) of each ``test_torch_spmd.py``
case is compiled (not run) on a 2 x 2 ("data", "model") mesh of 4 forced
host devices, at B 4 x S 16 and B 16 x S 256, and with ``remat`` at B 16 x S
256 for six cases; its optimized HLO's collectives are summed by the
reference's own ``launch/roofline.py::collective_bytes``.  The port's step
on the same mesh is counted on meta tensors under a fake process group by
``launch/dryrun.py::count_sharded`` and ``collective_bytes``: one device's
result-shape bytes, by kind, as the reference counts them.  Both are
printed beside each other.

The reference's HLO scans its layers: a ``while`` loop whose body holds one
layer's collectives, which ``collective_bytes`` counts once, whatever the
trip count, where the port's count holds every layer's.  So each case is
also held to the reference's bytes with every loop body counted once a trip
(``_per_step``, the step's real bytes on a device), and the per-layer
reductions of the residual stream, which both programs make, can put the
port above the once-counted total when the model has several layers
(gemma3-1b: 18 all-reduces of the (8, 256, 64) residual, 9.4 MB, against
5.9 MB in all).  Such a case is held to its count at the time its bound was
set (``HELD``), beside the 1.10 x of the per-step bytes, and named with its
remaining collectives in ROADMAP Queue 3.

When a bound fails, the port's collectives of that case are printed by the
line of ``src/repro_torch/`` that issued them (:func:`_attribute`).

The reference's compiles run in four subprocesses side by side, each within
``TIMEOUT``.
"""
import collections
import re
import subprocess
import sys
import textwrap
import traceback

import pytest
from _spmd_count import port_bytes, step_fn
from test_torch_spmd import (CASES, OPT, OVERRIDES, SRC, WAS_COLLECTIVES,
                             _env)

from repro.launch.roofline import collective_bytes as reference_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group

TIMEOUT = 400
SMALL, LONG = (4, 16), (16, 256)
REMAT = ("smollm-360m", "gemma3-1b", "deepseek-moe-16b", "mixtral-8x7b",
         "mamba2-130m", "zamba2-1.2b")
JOBS = ([(c, SMALL, False) for c in CASES] + [(c, LONG, False) for c in CASES]
        + [(c, LONG, True) for c in REMAT])
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# at B 16 x S 256, a port total of at most 1.10 x the reference's HLO total
RATIO = 1.10
TIGHT = ("gemma3-1b", "internlm2-1.8b", "glm4-9b", "mamba2-130m",
         "mamba2-130m@3heads", "zamba2-1.2b")
# the port's totals before its collectives were held to the reference's:
# no case may rise above them (B 4 x S 16, B 16 x S 256, and with remat)
WAS = {
    SMALL: WAS_COLLECTIVES,
    LONG: {"smollm-360m": 8_173_712, "gemma3-1b": 18_813_456,
           "internlm2-1.8b": 5_933_584, "glm4-9b": 5_933_584,
           "deepseek-moe-16b": 14_021_144,
           "deepseek-moe-16b@drop": 14_021_144, "mixtral-8x7b": 21_683_736,
           "mamba2-130m": 20_818_672, "mamba2-130m@3heads": 7_725_816,
           "zamba2-1.2b": 44_832_720},
    "remat": {"smollm-360m": 10_894_992, "gemma3-1b": 23_286_288,
              "deepseek-moe-16b": 18_831_896, "mixtral-8x7b": 26_583_576,
              "mamba2-130m": 28_365_552, "zamba2-1.2b": 62_187_472},
}
# cases that a once-counted layer body puts out of the 1.10 x's reach, held
# to their counts when the bound was set (ROADMAP Queue 3), without and with
# remat
HELD = {"gemma3-1b": (11_520_264, 12_847_368)}


def _reference_code(out, jobs) -> str:
    """The reference's compiles of ``jobs`` on 4 forced host devices, each
    job's optimized HLO written to ``out``."""
    return textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import dataclasses, sys, warnings
        sys.path.insert(0, {SRC!r})
        warnings.simplefilter("ignore", DeprecationWarning)
        import jax, jax.numpy as jnp
        from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
        from repro.configs.registry import get_smoke_config
        from repro.distributed.sharding import (ShardCtx, param_shardings,
                                                use_ctx)
        from repro.models.transformer import init_lm
        from repro.training.optimizer import AdamWConfig
        from repro.training.train_step import (init_train_state,
                                               make_train_step)

        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto, AxisType.Auto))
        ctx = ShardCtx(mesh=mesh)
        opt = AdamWConfig(**{OPT!r})
        for case, (b, s), remat, name in {jobs!r}:
            over = {OVERRIDES!r}.get(case, {{}})
            cfg = dataclasses.replace(get_smoke_config(case.split("@")[0]),
                                      dtype="float32", remat=remat, **over)
            params = init_lm(cfg, jax.random.PRNGKey(0))
            params = jax.device_put(params, param_shardings(
                params, ctx, expert_parallel=cfg.expert_parallel))
            tokens = jax.device_put(jnp.zeros((b, s + 1), jnp.int32),
                                    NamedSharding(mesh, P("data", None)))
            step = make_train_step(cfg, opt)

            def train(st, batch):
                with use_ctx(ctx):
                    return step(st, batch)

            with mesh:
                state = init_train_state(params, opt)
                hlo = jax.jit(train).lower(
                    state, {{"tokens": tokens}}).compile().as_text()
            with open(f"{out}/{{name}}.hlo", "w") as f:
                f.write(hlo)
    """)


def _name(case, shape, remat) -> str:
    return f"{case}_{shape[0]}x{shape[1]}{'_remat' if remat else ''}"


def _per_step(hlo: str) -> dict:
    """The reference's ``collective_bytes`` of ``hlo`` with each ``while``
    body counted once a trip (its ``known_trip_count``, 1 if none), a called
    computation once a call, and a conditional's dearest branch: the bytes
    one device moves in the step."""
    comps, cur, entry = {}, None, None
    for line in hlo.splitlines():
        head = re.match(r"^(ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head:
            cur = head.group(2)
            comps[cur] = []
            entry = cur if head.group(1) else entry
        elif cur is not None:
            comps[cur].append(line)
    memo = {}

    def total(name):
        if name not in memo:
            lines = comps.get(name, [])
            got = reference_bytes("\n".join(lines))
            out = collections.Counter({k: got[k] for k in KINDS})
            for line in lines:
                body = re.search(r"\bwhile\(.*\bbody=%?([\w.\-]+)", line)
                if body:
                    n = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
                    for k, v in total(body.group(1)).items():
                        out[k] += v * (int(n.group(1)) if n else 1)
                if "fusion(" not in line:
                    for call in re.finditer(r"\b(?:calls|to_apply)=%?([\w.\-]+)",
                                            line):
                        out.update(total(call.group(1)))
                branches = re.search(r"branch_computations=\{([^}]*)\}", line)
                if branches:
                    out.update(max((total(b.strip().lstrip("%")) for b in
                                    branches.group(1).split(",")),
                                   key=lambda c: sum(c.values())))
            memo[name] = out
        return memo[name]

    out = {k: total(entry)[k] for k in KINDS}
    out["total"] = sum(out.values())
    return out


class _Issued(dryrun.DeviceWork):
    """A device's count that also records, for each collective, the lines
    of ``src/repro_torch/`` on the stack that issued it."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def add(self, func, args, kwargs, out):
        n = len(self.collectives)
        super().add(func, args, kwargs, out)
        if len(self.collectives) > n:
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      and "repro_torch/launch/" not in f.filename]
            where = " <- ".join(
                f"{f.filename.split('src/')[-1]}:{f.lineno}"
                for f in frames[-3:][::-1])
            self.lines.append((*self.collectives[-1],
                               tuple(getattr(out, "shape", ())), where))


def _attribute(case, shape, remat, top: int = 20) -> str:
    """The port's collectives of one case summed by kind, result shape and
    issuing lines, the largest first."""
    work = _Issued()
    with fake_process_group(4):
        fn, *args = step_fn(case, shape, remat)
        original = dryrun.DeviceWork
        dryrun.DeviceWork = lambda: work
        try:
            dryrun.count_sharded(fn, *args)
        finally:
            dryrun.DeviceWork = original
    sums, counts = collections.Counter(), collections.Counter()
    for kind, size, shp, where in work.lines:
        sums[kind, shp, where] += size
        counts[kind, shp, where] += 1
    return "\n".join(f"{size:>12,} x{counts[key]:<3} {key[0]:<15} "
                     f"{key[1]} {key[2]}"
                     for key, size in sums.most_common(top))


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    """``{(case, shape, remat): (reference, reference per step, port)}``:
    the reference's compiles in four subprocesses side by side, the port's
    counts meanwhile."""
    out = tmp_path_factory.mktemp("bytes")
    jobs = [(c, shape, remat, _name(c, shape, remat))
            for c, shape, remat in JOBS]
    groups = [jobs[i::4] for i in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _reference_code(str(out), group)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for group in groups]
    try:
        port = {job: port_bytes(*job) for job in JOBS}
        for proc, group in zip(procs, groups):
            _, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, \
                f"the reference's compiles of {group}:\n" + stderr[-4000:]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    got = {}
    for job in JOBS:
        hlo = (out / f"{_name(*job)}.hlo").read_text()
        got[job] = (reference_bytes(hlo), _per_step(hlo), port[job])
        ref, step, mine = got[job]
        print(f"{_name(*job)}: port {mine['total']:,} "
              f"{ {k: mine[k] for k in KINDS} }; reference HLO "
              f"{ref['total']:,} { {k: ref[k] for k in KINDS} } "
              f"(x{mine['total'] / ref['total']:.2f}); per step "
              f"{step['total']:,} (x{mine['total'] / step['total']:.2f})")
    return got


def _check(case, shape, remat, ok, what):
    assert ok, f"{_name(case, shape, remat)}: {what}\n" + _attribute(
        case, shape, remat)


@pytest.mark.parametrize("case,remat", [(c, False) for c in CASES]
                         + [(c, True) for c in REMAT])
def test_long_step_moves_no_more_than_the_reference(case, remat, counts):
    """At B 16 x S 256, without remat and (six cases) with it: the six
    ``TIGHT`` cases within 1.10 x the reference's HLO total (a ``HELD``
    case within its count instead), the others no higher than before;
    every case within 1.10 x the reference's per-step bytes."""
    ref, step, port = counts[case, LONG, remat]
    total = port["total"]
    assert total == sum(port[k] for k in KINDS)
    if case in HELD:
        bound = HELD[case][remat]
        _check(case, LONG, remat, total <= bound,
               f"port {total:,} > its held count {bound:,}")
    elif case in TIGHT:
        _check(case, LONG, remat, total <= RATIO * ref["total"],
               f"port {total:,} > {RATIO} x reference {ref['total']:,}")
    else:
        was = WAS["remat" if remat else LONG][case]
        _check(case, LONG, remat, total <= was,
               f"port {total:,} > its earlier {was:,}")
    _check(case, LONG, remat, total <= RATIO * step["total"],
           f"port {total:,} > {RATIO} x the reference's per-step "
           f"{step['total']:,}")


@pytest.mark.parametrize("case", CASES)
def test_short_step_moves_no_more_than_before(case, counts):
    """At B 4 x S 16, where the weights outweigh the activations: no case
    above its count before this bound; both reduce their activations."""
    ref, _, port = counts[case, SMALL, False]
    _check(case, SMALL, False, port["total"] <= WAS[SMALL][case],
           f"port {port['total']:,} > its earlier {WAS[SMALL][case]:,}")
    assert port["all-reduce"] > 0 and ref["all-reduce"] > 0


def test_per_step_bytes_weight_a_loop_body_by_its_trips():
    """``_per_step`` on a hand-written module: an all-reduce in a while
    body of 4 trips counts 4 times, one beside it once, one in a called
    computation once a call, a conditional's dearest branch once."""
    hlo = textwrap.dedent("""\
        %body (p: f32[8]) -> f32[8] {
          %ar = f32[8]{0} all-reduce(f32[8]{0} %p), replica_groups={}
        }
        %small (p: f32[2]) -> f32[2] {
          %ag = f32[2]{0} all-gather(f32[1]{0} %p), dimensions={0}
        }
        %big (p: f32[2]) -> f32[2] {
          %ag = f32[4]{0} all-gather(f32[2]{0} %p), dimensions={0}
        }
        ENTRY %main (a: f32[8]) -> f32[8] {
          %w = f32[8]{0} while(f32[8]{0} %a), condition=%c, body=%body, backend_config={"known_trip_count":{"n":"4"}}
          %r = f32[16]{0} reduce-scatter(f32[32]{0} %a), dimensions={0}
          %k = f32[2]{0} call(f32[2]{0} %a), to_apply=%small
          %b = f32[2]{0} conditional(pred[] %a), branch_computations={%small, %big}
        }
        """)
    got = _per_step(hlo)
    assert got["all-reduce"] == 4 * 32 and got["reduce-scatter"] == 64
    assert got["all-gather"] == 8 + 16
    assert reference_bytes(hlo)["all-reduce"] == 32
