"""``repro_torch/training`` ↔ ``repro/training``: AdamW (``optimizer.py``)
and the LM train step (``train_step.py``) over the port's parameter dicts."""
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            global_norm, warmup_cosine)
from repro_torch.training.train_step import (TrainState, init_train_state,
                                             lm_loss, make_train_step)

__all__ = ["AdamWConfig", "AdamWState", "TrainState", "adamw_init",
           "adamw_update", "global_norm", "init_train_state", "lm_loss",
           "make_train_step", "warmup_cosine"]
