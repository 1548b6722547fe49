from .steps import (cross_entropy, generate, init_train_state, make_loss_fn,
                    make_prefill_step, make_serve_step, make_train_step)
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "cross_entropy", "generate",
           "init_train_state", "make_loss_fn", "make_prefill_step",
           "make_serve_step", "make_train_step"]
