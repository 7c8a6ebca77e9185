"""The port's training launcher (``repro_torch/launch/train.py``) on the CPU.

- Resume from the reference: the reference's ``repro.launch.train.main``
  runs smollm-360m ``--smoke`` for 4 steps with a checkpoint every 2; its
  step-2 checkpoint, copied alone into a fresh directory, is resumed by the
  port's ``main(... --device cpu)`` to step 4, and the port's final state is
  held to the reference's step-4 checkpoint at the train-step tolerance of
  ``tests/test_torch_train.py`` (parameters ``2e-3``; moments ``2e-3`` of
  each tensor's largest magnitude).  Both run the ``SMOKE`` configuration
  in float32, where that tolerance applies (bfloat16 compute differs
  between the packages by its own rounding).  The reference's launcher does
  not run under jax 0.9 as it is: ``jax.make_mesh`` now makes ``Explicit``
  axes, which its ``shard_act`` (``with_sharding_constraint``) refuses; the
  test hands it a local mesh of ``Auto`` axes (ROADMAP Queue 3).
- Preempt and restart: the port's launcher as a subprocess, SIGTERM after
  its ``step 2`` line; it prints ``preemption requested``, checkpoints and
  exits 0; the same command again resumes and runs to the end; the final
  checkpoint equals an uninterrupted run's bit for bit, wherever the
  signal landed.
- One ``SMOKE`` architecture of each family trains 2 steps: finite losses
  and a checkpoint written.
- No card and no ``--device cpu``: the launcher raises.
"""
import dataclasses
import json
import math
import re
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as p_train
from repro_torch.runtime import checkpoint as ckpt

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 2e-3
STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) ")


@pytest.fixture
def handlers_kept():
    """The reference's ``GracefulShutdown`` installs SIGTERM / SIGINT
    handlers it never removes: put this process's back afterwards."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, handler in prev.items():
        signal.signal(s, handler)


def _arrays(step_dir: Path) -> list:
    n = json.loads((step_dir / "manifest.json").read_text())["n_leaves"]
    with np.load(step_dir / "arrays.npz") as data:
        return [data[str(i)] for i in range(n)]


def _float32_smoke(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


def test_port_resumes_a_reference_checkpoint(tmp_path, monkeypatch, capsys,
                                             handlers_kept):
    import jax
    from jax.sharding import AxisType
    from repro.configs import registry as r_registry
    from repro.launch import train as r_train
    from repro_torch.configs import registry

    monkeypatch.setattr(r_train, "make_local_mesh", lambda: jax.make_mesh(
        (len(jax.devices()), 1), ("data", "model"),
        axis_types=(AxisType.Auto, AxisType.Auto)))
    monkeypatch.setattr(r_train, "get_smoke_config",
                        _float32_smoke(r_registry.get_smoke_config))
    monkeypatch.setattr(p_train, "get_smoke_config",
                        _float32_smoke(registry.get_smoke_config))
    flags = ["--arch", "smollm-360m", "--smoke", "--steps", "4",
             "--ckpt-every", "2"]
    assert r_train.main(flags + ["--ckpt-dir", str(tmp_path / "ref")]) == 0
    resumed = tmp_path / "port"
    resumed.mkdir()
    shutil.copytree(tmp_path / "ref" / "step_00000002",
                    resumed / "step_00000002")
    (resumed / "LATEST").write_text("step_00000002")
    capsys.readouterr()
    assert p_train.main(flags + ["--ckpt-dir", str(resumed),
                                 "--device", "cpu", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [int(m.group(1)) for m in map(STEP_LINE.match, out.splitlines())
            if m] == [2, 3]
    assert ckpt.latest_step(resumed) == 4
    got = _arrays(resumed / "step_00000004")
    want = _arrays(tmp_path / "ref" / "step_00000004")
    manifest = json.loads((tmp_path / "ref" / "step_00000004" /
                           "manifest.json").read_text())
    n_params = (manifest["n_leaves"] - 2) // 3   # params, step, mu, nu, step
    assert len(got) == len(want) == 3 * n_params + 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == np.int32:                       # the two step counters
            np.testing.assert_array_equal(a, b)
        elif i < n_params:                            # parameters
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=str(i))
        else:                                         # mu, nu
            np.testing.assert_allclose(a, b, rtol=TOL,
                                       atol=TOL * float(np.abs(b).max()),
                                       err_msg=str(i))


def _launch(ckpt_dir, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "smollm-360m", "--smoke", "--steps", "40", "--ckpt-every", "5",
            "--device", "cpu", "--ckpt-dir", str(ckpt_dir), *extra]


def _env():
    return {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "2"}


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          env=_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_preempted_then_restarted_run_equals_an_uninterrupted_one(tmp_path):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    proc = subprocess.Popen(_launch(cut, "--log-every", "1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env())
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step     2 "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    assert "preemption requested: checkpointing and exiting" in out
    stopped = ckpt.latest_step(cut)
    assert 3 <= stopped < 40
    assert not [p for p in cut.iterdir() if ".tmp" in p.name]
    again = _run(_launch(cut))
    assert f"resumed from step {stopped}" in again
    assert "done: loss" in again
    _run(_launch(whole))
    for a, b in zip(_arrays(cut / "step_00000040"),
                    _arrays(whole / "step_00000040")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-moe-16b",
                                  "mamba2-130m", "zamba2-1.2b",
                                  "internvl2-1b", "whisper-medium"])
def test_every_family_trains_two_steps(arch, tmp_path, capsys):
    assert p_train.main(["--arch", arch, "--smoke", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--ckpt-every", "1",
                         "--log-every", "1", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(m.group(2)) for m in map(STEP_LINE.match,
                                             out.splitlines()) if m]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert ckpt.latest_step(tmp_path) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000001", "step_00000002"]
    assert len(_arrays(tmp_path / "step_00000002")) > 3


def test_launcher_raises_without_a_card_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
