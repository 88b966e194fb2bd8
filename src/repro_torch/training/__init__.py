"""Training on one device: ``make_train_step``, ``make_eval_step`` and
``Trainer`` (the port of ``repro.training``; federated training is a later
slice)."""
from repro_torch.training.train_loop import (Trainer, loss_and_grads,
                                             make_eval_step, make_train_step)

__all__ = ["Trainer", "make_train_step", "make_eval_step", "loss_and_grads"]
