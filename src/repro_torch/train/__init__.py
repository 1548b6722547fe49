from .steps import (cross_entropy, init_train_state, make_loss_fn,
                    make_train_step)
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "cross_entropy", "init_train_state",
           "make_loss_fn", "make_train_step"]
