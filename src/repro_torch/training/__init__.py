"""Training: ``make_train_step``, ``make_eval_step`` and ``Trainer`` on
one device or data-parallel on a mesh, and ``FederatedTrainer`` (FedAvg
over a mesh's data axis): the port of ``repro.training``."""
from repro_torch.training.federated import FederatedTrainer
from repro_torch.training.train_loop import (Trainer, loss_and_grads,
                                             make_eval_step, make_train_step)

__all__ = ["FederatedTrainer", "Trainer", "make_train_step",
           "make_eval_step", "loss_and_grads"]
