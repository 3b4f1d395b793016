"""Training of the port: one optimizer step of the car model.

:class:`Trainer` runs ``haet_tpu.train.Trainer``'s step
(``haet_tpu/train/trainer.py:541-570``) eagerly: forward in train mode,
loss, backward through the kernels' autograd functions, torch's gradient
clipping, Adam and OneCycle. :mod:`haet_torch.train.car` has the car
batches and loss. ``fit``, checkpointing, early stopping, the logger and
the data layer are queued in ``ROADMAP.md`` (queue 1: Trainer and drivers).
"""

from .trainer import Trainer, make_optimizer, onecycle_horizon  # noqa: F401
