"""Training of the port: the car model's step, loop and checkpoints.

:class:`Trainer` runs ``haet_tpu.train.Trainer``'s step
(``haet_tpu/train/trainer.py:541-570``): forward in train mode, loss,
backward through the kernels' autograd functions, torch's gradient
clipping, Adam and OneCycle, on the card as a CUDA graph (:mod:`.graphs`),
eagerly on the CPU; :meth:`Trainer.fit` is its training loop, with eval,
:class:`MetricsLogger`, :class:`EarlyStopping` and the
:class:`Checkpointer`. :mod:`haet_torch.train.car` has the car batches,
loss and evaluation; :mod:`.losses` and :mod:`.normalizer` the reference's
losses and normalizers.
"""

from .checkpoint import Checkpointer  # noqa: F401
from .trainer import (Adam, EarlyStopping, MetricsLogger,  # noqa: F401
                      Trainer, make_optimizer, onecycle_horizon)
