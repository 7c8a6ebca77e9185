"""The port's training launcher (``repro_torch.launch.train``) with every
``SMOKE`` configuration in float32, each step's loss logged in full:

    python tests/_launcher_f32.py ARGS...

``ARGS`` are the launcher's.  The patches below run at import, so the
ranks the launcher spawns, which import this file as their main module,
run under them too.  With ``LOSS_LOG`` set, rank 0 (or the one process)
appends each step's loss there, one ``repr`` a line: the launcher prints
four decimals.
"""
import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train  # noqa: E402

train.get_smoke_config = lambda arch: dataclasses.replace(
    registry.get_smoke_config(arch), dtype="float32")
_make_train_step = train.make_train_step


def _logged_step(*args, **kwargs):
    step = _make_train_step(*args, **kwargs)
    log = os.environ.get("LOSS_LOG")

    def run(state, batch):
        state, metrics = step(state, batch)
        loss = train._value(metrics["loss"])   # every rank: may gather
        if log and (not dist.is_initialized() or dist.get_rank() == 0):
            with open(log, "a") as f:
                f.write(f"{loss!r}\n")
        return state, metrics
    return run


train.make_train_step = _logged_step

if __name__ == "__main__":
    raise SystemExit(train.main(sys.argv[1:]))
