"""The port's training launcher on several ranks (``repro_torch/launch/
train.py --nproc N``: N spawned gloo ranks on the CPU, a ``(N, 1)``
``("data", "model")`` mesh, the parameters and optimizer state as
DTensors) against the reference's launcher on N host devices, against its
own one-rank run, across preemption and across rank counts.

smollm-360m ``SMOKE`` in float32 (``tests/_launcher_f32.py``, which also
logs every step's loss in full), 4 steps, a checkpoint every 2, each
launcher a subprocess with one CPU thread a rank (``OMP_NUM_THREADS=1``:
a product's sums then never depend on how many threads the BLAS took, so
two runs of one layout agree bit for bit) and a time limit of 120 s:

- (a) the reference's launcher on 4 forced host devices (a mesh of ``Auto``
  axes: its own fails under jax 0.9, ROADMAP Queue 3), its step-2
  checkpoint resumed by ``--nproc 4`` (the two packages draw their initial
  parameters from different generators): the losses of steps 2 and 3 and
  the step-4 checkpoint's leaves within ``2e-3`` of the reference's
  (``tests/test_torch_launch.py``'s ``TOL``, moments ``2e-3`` of each
  tensor's largest magnitude), the step counters equal;
- (b) ``--nproc 4`` against the one-rank run: losses and every leaf
  ``rtol=1e-5``, ``atol`` 1e-6 of the tensor's largest magnitude (the SPMD
  tolerance of ``tests/test_torch_spmd.py``: the shards add in another
  order), a parameter's ``atol`` at least ``1e-3`` of the learning rates
  summed over the steps taken.  That test's step takes Adam's ``eps`` at
  1e-4; the launcher's is 1e-8, so an element whose gradient nearly
  cancels moves by about ``lr`` a step whatever its size, and carries the
  gradient's relative rounding into the parameter in full: up to 9.4e-5 of
  the summed rates here, 1.24 x the SPMD tolerance on a leaf that is all
  Adam steps (a norm bias), while a wrong shard moves a parameter by about
  ``lr`` a step;
- (c) SIGTERM to rank 2 of a 4-rank run (not to the spawning process):
  every rank stops after the same step, one ``step_X`` is written, the
  spawner exits 0; restarted on 4 ranks, the final checkpoint equals the
  uninterrupted 4-rank run's bit for bit; a SIGTERM to the spawning
  process of a 2-rank run, which passes it on, stops it so too;
- (d) elastic: the 4-rank step-2 checkpoint resumed on 2 ranks and on the
  one-rank path, and a 2-rank step-2 checkpoint resumed on 4, each within
  (b)'s tolerance of the uninterrupted 4-rank run;
- (e) one ``SMOKE`` architecture of each family (in its own type) trains
  two steps on 2 ranks;
- (f) no fallback: ``--device cuda --nproc 2`` without a card raises, and
  so does ``--nproc`` above the card count.
"""
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as p_train
from repro_torch.runtime import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WRAPPER = str(ROOT / "tests" / "_launcher_f32.py")
TOL = 2e-3                   # the port against the reference
RTOL, ATOL_FRAC = 1e-5, 1e-6  # N ranks against one
LR_FRAC = 1e-3               # of the summed learning rates, parameters
LIMIT = 120                  # seconds, each launcher process
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) ")
FLAGS = ["--arch", "smollm-360m", "--smoke", "--steps", "4",
         "--ckpt-every", "2", "--log-every", "1"]
FINAL = "step_00000004"

# the reference's launcher on a mesh of Auto axes, its SMOKE configuration
# in float32 (as tests/test_torch_launch.py runs it in process)
REFERENCE = """
import dataclasses, sys
import jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch import train
train.make_local_mesh = lambda: jax.make_mesh(
    (len(jax.devices()), 1), ("data", "model"),
    axis_types=(AxisType.Auto, AxisType.Auto))
train.get_smoke_config = lambda arch: dataclasses.replace(
    registry.get_smoke_config(arch), dtype="float32")
sys.exit(train.main(sys.argv[1:]))
"""


def _env(**extra):
    return {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu", **extra}


def _port(ckpt_dir: Path, nproc: int, *extra) -> list:
    return [sys.executable, WRAPPER, *FLAGS, "--device", "cpu", "--nproc",
            str(nproc), "--ckpt-dir", str(ckpt_dir), *extra]


class Run:
    """A launcher subprocess: its output (in files, so that no pipe fills
    while other runs are waited on), and each step's loss in full."""

    def __init__(self, cmd, ckpt_dir: Path, env=None):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.losses_at, *self.logs = (self.dir.parent / f"{self.dir.name}.{x}"
                                      for x in ("losses", "out", "err"))
        with open(self.logs[0], "w") as out, open(self.logs[1], "w") as err:
            self.proc = subprocess.Popen(
                cmd, stdout=out, stderr=err, text=True,
                env=env or _env(LOSS_LOG=str(self.losses_at)))
        self.t0 = time.monotonic()

    def wait(self):
        try:
            self.proc.wait(timeout=max(1.0, LIMIT - (time.monotonic()
                                                     - self.t0)))
        finally:
            self.proc.kill()
        self.out, err = (p.read_text() for p in self.logs)
        assert self.proc.returncode == 0, self.out[-2000:] + err[-4000:]
        return self

    @property
    def losses(self) -> list:
        return [float(x) for x in self.losses_at.read_text().split()]

    @property
    def printed(self) -> dict:
        return {int(m.group(1)): float(m.group(2)) for m in
                map(STEP_LINE.match, self.out.splitlines()) if m}


def _rank_pids(parent: int) -> list:
    """The pids of the ranks ``parent`` spawned, in rank order (the
    ranks start in order; the resource tracker is not one)."""
    pids = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            cmd = (stat.parent / "cmdline").read_bytes()
        except OSError:
            continue
        if int(fields[1]) == parent and b"--multiprocessing-fork" in cmd:
            pids.append(int(stat.parent.name))
    return sorted(pids)


def _preempted(ckpt_dir: Path, nproc: int = 4, rank=2):
    """An ``nproc``-rank run, SIGTERM to ``rank`` (None: to the spawning
    process) once rank 0 prints step 0."""
    proc = subprocess.Popen(_port(ckpt_dir, nproc), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
    t0 = time.monotonic()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step     0 "):
                pids = _rank_pids(proc.pid)
                assert len(pids) == nproc, pids
                os.kill(proc.pid if rank is None else pids[rank],
                        signal.SIGTERM)
                break
        rest, err = proc.communicate(
            timeout=max(1.0, LIMIT - (time.monotonic() - t0)))
    finally:
        proc.kill()
    return dict(rc=proc.returncode, out="".join(lines) + rest, err=err,
                dirs=sorted(p.name for p in ckpt_dir.iterdir()),
                stopped=ckpt.latest_step(ckpt_dir))


def _arrays(step_dir: Path) -> list:
    n = json.loads((step_dir / "manifest.json").read_text())["n_leaves"]
    with np.load(step_dir / "arrays.npz") as data:
        return [data[str(i)] for i in range(n)]


def _resumable(src: Path, step: int, dst: Path) -> Path:
    """A fresh checkpoint directory holding ``src``'s ``step`` alone."""
    dst.mkdir(parents=True)
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)
    (dst / "LATEST").write_text(name)
    return dst


def _lr_sum(steps: int) -> float:
    """The learning rates of the launcher's first ``steps`` steps at
    ``FLAGS`` (4 steps, lr 3e-3), summed."""
    from repro_torch.training.optimizer import AdamWConfig, warmup_cosine

    cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=4)
    return sum(float(warmup_cosine(cfg, torch.tensor(s)))
               for s in range(1, steps + 1))


def _assert_spmd_close(got: list, want: list, steps: int = 4):
    """(b)'s tolerance, leaf by leaf (``params, step, mu, nu, step``)."""
    assert len(got) == len(want)
    n_params = (len(want) - 2) // 3
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        atol = ATOL_FRAC * (float(np.abs(b).max()) if b.size else 0.0)
        if i < n_params:
            atol = max(atol, LR_FRAC * _lr_sum(steps))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=str(i))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run (a)-(d) compare, one at a time: with all side by side,
    their ranks starved the other test files' subprocesses in a six-worker
    run."""
    tmp = tmp_path_factory.mktemp("launch_multi")
    ref = Run([sys.executable, "-c", REFERENCE, *FLAGS, "--ckpt-dir",
               str(tmp / "ref")], tmp / "ref", env=_env(
                   XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    runs = {"ref": ref.wait()}
    for name, n in (("r4", 4), ("r1", 1), ("r2", 2)):
        runs[name] = Run(_port(tmp / name, n), tmp / name).wait()
    runs["cut"] = _preempted(tmp / "cut")
    runs["spawner_cut"] = _preempted(tmp / "spawner_cut", 2, None)
    runs["restart"] = Run(_port(tmp / "cut", 4), tmp / "cut").wait()
    for name, src, n in (("ref_on_4", "ref", 4), ("r4_on_2", "r4", 2),
                         ("r4_on_1", "r4", 1), ("r2_on_4", "r2", 4)):
        d = _resumable(tmp / src, 2, tmp / name)
        runs[name] = Run(_port(d, n), d).wait()
    return runs


def test_four_ranks_match_the_reference_on_four_devices(runs):
    ref, port = runs["ref"], runs["ref_on_4"]
    assert sorted(ref.printed) == [0, 1, 2, 3]
    assert "resumed from step 2" in port.out
    assert sorted(port.printed) == [2, 3]
    np.testing.assert_allclose(port.losses, [ref.printed[2], ref.printed[3]],
                               rtol=TOL, atol=TOL)
    got, want = _arrays(port.dir / FINAL), _arrays(ref.dir / FINAL)
    n_params = (len(want) - 2) // 3   # params, step, mu, nu, step
    assert len(got) == len(want) == 3 * n_params + 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == np.int32:                       # the step counters
            np.testing.assert_array_equal(a, b)
        elif i < n_params:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, rtol=TOL,
                                       atol=TOL * float(np.abs(b).max()),
                                       err_msg=str(i))


def test_four_ranks_match_one_rank(runs):
    r4, r1 = runs["r4"], runs["r1"]
    assert r4.printed.keys() == r1.printed.keys()
    np.testing.assert_allclose(r4.losses, r1.losses, rtol=RTOL, atol=0)
    for steps in (2, 4):
        name = f"step_{steps:08d}"
        _assert_spmd_close(_arrays(r4.dir / name), _arrays(r1.dir / name),
                           steps)
    # only rank 0 prints: one line a step, as the reference's one process
    assert r4.out.count("done: loss") == 1
    assert len(r4.out.splitlines()) == len(r1.out.splitlines())


def _assert_clean_stop(cut: dict) -> int:
    """Exit 0, one ``preemption requested`` line (rank 0's), and one
    checkpoint, none half written: every rank stopped after one step."""
    assert cut["rc"] == 0, cut["out"][-2000:] + cut["err"][-4000:]
    assert cut["out"].count("preemption requested: checkpointing and "
                            "exiting") == 1
    stopped = cut["stopped"]
    assert stopped in (1, 2, 3)
    assert cut["dirs"] == ["LATEST", f"step_{stopped:08d}"]
    return stopped


def test_sigterm_to_one_rank_stops_every_rank_and_resumes_bit_for_bit(runs):
    stopped = _assert_clean_stop(runs["cut"])
    again = runs["restart"]
    assert f"resumed from step {stopped}" in again.out
    assert sorted(again.printed) == list(range(stopped, 4))
    for a, b in zip(_arrays(again.dir / FINAL),
                    _arrays(runs["r4"].dir / FINAL)):
        np.testing.assert_array_equal(a, b)


def test_sigterm_to_the_spawning_process_reaches_every_rank(runs):
    _assert_clean_stop(runs["spawner_cut"])


@pytest.mark.parametrize("run", ["r2", "r4_on_2", "r4_on_1", "r2_on_4"])
def test_checkpoints_move_between_rank_counts(runs, run):
    """Each within (b)'s tolerance of the uninterrupted 4-rank run: the
    uninterrupted 2-rank run, and the three resumed ones."""
    got = runs[run]
    if run != "r2":
        assert "resumed from step 2" in got.out
    assert sorted(got.printed) == ([0, 1, 2, 3] if run == "r2" else [2, 3])
    _assert_spmd_close(_arrays(got.dir / FINAL),
                       _arrays(runs["r4"].dir / FINAL))


FAMILIES = ["smollm-360m", "deepseek-moe-16b", "mamba2-130m", "zamba2-1.2b",
            "internvl2-1b", "whisper-medium"]


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    """(e)'s six 2-rank runs, two at a time (four ranks busy, as one
    4-rank run keeps them)."""
    tmp = tmp_path_factory.mktemp("families")
    runs = {}
    for pair in (FAMILIES[i:i + 2] for i in range(0, len(FAMILIES), 2)):
        started = {arch: Run([
            sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
            "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-every", "1", "--log-every", "1", "--device", "cpu",
            "--nproc", "2", "--ckpt-dir", str(tmp / arch)], tmp / arch)
            for arch in pair}
        runs.update({arch: run.wait() for arch, run in started.items()})
    return runs


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_trains_two_steps_on_two_ranks(arch, family_runs):
    run = family_runs[arch]
    losses = list(run.printed.values())
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert sorted(p.name for p in run.dir.iterdir()) == [
        "LATEST", "step_00000001", "step_00000002"]
    assert len(_arrays(run.dir / "step_00000002")) > 3


def test_no_rank_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1",
                      "--device", "cuda", "--nproc", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="more CUDA ranks than the 1"):
        p_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1",
                      "--nproc", "2"])
