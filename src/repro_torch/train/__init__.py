from repro_torch.train.train_step import (TrainConfig, lm_loss, make_grad_fn,
                                         make_train_step, value_and_grad)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainConfig", "Trainer", "TrainerConfig", "lm_loss",
           "make_grad_fn", "make_train_step", "value_and_grad"]
