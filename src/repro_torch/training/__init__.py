"""Training: AdamW, the train step, checkpoints and the fault-tolerant
loop (port of ``repro.training``)."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, cosine_schedule,
                                            global_norm)
from repro_torch.training.train_loop import TrainState, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "make_train_step", "TrainState"]
