"""Loss, train step and the host training loop (a port of ``repro/training``)."""
from .loop import cross_entropy, loss_fn, make_train_step, run_train

__all__ = ["cross_entropy", "loss_fn", "make_train_step", "run_train"]
