"""Model, training and experiment configs and the presets, PyTorch.

``ModelConfig``, ``TrainConfig`` and ``ExperimentConfig`` are
``haet_tpu/utils/config.py``'s field for field, so one config describes
the same model and the same training in both packages.
:meth:`ModelConfig.build` returns the torch model of any of the three
variants. ``ModelConfig.bf16`` builds it with the bf16 compute dtype over
float32 parameters, and ``TrainConfig.mu_bf16`` stores Adam's first moment
in bf16, as in JAX. The PDE presets (``darcy_config`` ...
``plasticity_config``) and :data:`PRESETS` are the JAX package's
(``:157-302``); the ShapeNet-Car model and training keep their own
functions (:func:`shapenet_car_config`, :func:`shapenet_car_train_config`),
which ``PRESETS["shapenet_car"]`` joins into one experiment.
``ModelConfig.pallas_auto_threshold`` defaults to the card's
:data:`PALLAS_AUTO_THRESHOLD`, measured on the card, not the JAX
package's TPU value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import math

import torch

#: ``use_pallas="auto"``'s base threshold in points at G 32, the card's:
#: the smallest N measured, from which the kernel step is no slower than
#: the plain one (``models/physics_attention.py:pallas_auto_enabled``)
PALLAS_AUTO_THRESHOLD = 256
#: the G span over which the threshold would fall to zero, ``scale =
#: max(0.25, 1 - (G - 32) / PALLAS_AUTO_G_SPAN)``: infinite, no scaling,
#: since the threshold measured at G 128 is G 32's
PALLAS_AUTO_G_SPAN = math.inf

#: the model class of each ``ModelConfig.variant``
VARIANTS = {"irregular": "HAETransolverIrregularMesh",
            "structured_2d": "HAETransolverStructuredMesh2D",
            "structured_3d": "HAETransolverStructuredMesh3D"}


@dataclass
class ModelConfig:
    variant: str = "irregular"  # irregular | structured_2d | structured_3d
    space_dim: int = 2
    n_layers: int = 5
    n_hidden: int = 256
    dropout: float = 0.0
    n_head: int = 8
    Time_Input: bool = False
    act: str = "gelu"
    mlp_ratio: int = 1
    fun_dim: int = 1
    out_dim: int = 1
    slice_num: int = 32
    ref: int = 8
    unified_pos: bool = False
    H: int = 85
    W: int = 85
    D: int = 32
    c_hidden: Optional[Sequence[int]] = None
    ball_sizes: Optional[Sequence[int]] = None
    enc_num_heads: Optional[Sequence[int]] = None
    enc_depths: Optional[Sequence[int]] = None
    dec_num_heads: Optional[Sequence[int]] = None
    dec_depths: Optional[Sequence[int]] = None
    strides: Optional[Sequence[int]] = None
    rotate: int = 45
    decode: bool = True
    mp_steps: int = 0
    embed: bool = False
    dim_head: Optional[int] = None
    erwin_mlp_ratio: Optional[int] = None
    use_checkpoint: bool = False
    use_dist_bias: bool = True
    grouping: str = "median"
    use_pallas: bool | str = False  # False | True | "auto"
    pallas_auto_threshold: int = PALLAS_AUTO_THRESHOLD  # the card's
    bf16: bool = False
    shard_axes: Optional[tuple] = None

    def model_kwargs(self) -> dict:
        """Constructor kwargs of this config's model class (what
        :meth:`build` passes): the grid's ``H``, ``W`` (and ``D``) for the
        structured variants; ``bf16`` becomes ``dtype=torch.bfloat16``."""
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        kw = dataclasses.asdict(self)
        grid = {"irregular": (), "structured_2d": ("H", "W"),
                "structured_3d": ("H", "W", "D")}[self.variant]
        for k in ("variant", "bf16",
                  *(k for k in ("H", "W", "D") if k not in grid)):
            kw.pop(k)
        kw["dtype"] = torch.bfloat16 if self.bf16 else None
        return kw

    def model_class(self) -> type:
        """The torch model class of :attr:`variant`."""
        from .. import models

        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        return getattr(models, VARIANTS[self.variant])

    def build(self, device=None, seed: int = 0):
        """The torch model for this config on ``device`` (None = CUDA)."""
        return self.model_class()(**self.model_kwargs(), device=device,
                                  seed=seed)


def shapenet_car_config() -> ModelConfig:
    """The ShapeNet-Car model (``haet_tpu/utils/config.py:262-291``):
    2 blocks, n_hidden 256, 8 heads, dim_head 32, G 32; Erwin c_hidden
    (32, 64), balls (32, 16), heads 8/8/8, depths 4/4/4, mlp_ratio 4 and a
    Linear embedding. 1,757,190 parameters."""
    return ModelConfig(
        variant="irregular", space_dim=7, fun_dim=0, out_dim=4,
        n_layers=2, n_hidden=256, n_head=8, slice_num=32,
        mlp_ratio=2, unified_pos=False,
        enc_num_heads=(8, 8), enc_depths=(4, 4),
        dec_num_heads=(8,), dec_depths=(4,),
        erwin_mlp_ratio=4, embed=True, rotate=45,
    )


@dataclass
class TrainConfig:
    """``haet_tpu/utils/config.py:TrainConfig``, field for field.

    The port's ``Trainer`` runs Adam or AdamW (``mu_bf16`` stores the first
    moment in bf16) under OneCycle (``cycle_momentum`` included),
    ``cosine_annealing`` (``t_max``) or a ``constant`` rate, torch's
    gradient clipping and ``accum_steps`` microbatches per step, and
    ``Trainer.fit`` the training loop with early stopping, periodic
    checkpoints (``checkpoint_every``), ``stop_on_nonfinite`` and
    ``preempt_save``; :meth:`check_ported` raises for an unknown optimizer
    or schedule. ``weight_decay`` is read by AdamW only, as in JAX.
    ``seed`` seeds the drivers' models.
    """

    lr: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 500
    batch_size: int = 8
    max_grad_norm: Optional[float] = None
    schedule: str = "onecycle"  # onecycle | cosine_annealing | constant
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    t_max: Optional[int] = None
    optimizer: str = "adamw"  # adamw | adam
    mu_bf16: bool = False
    seed: int = 0
    early_stop_patience: Optional[int] = None
    early_stop_min_delta: float = 0.0
    checkpoint_every: Optional[int] = None
    accum_steps: int = 1
    stop_on_nonfinite: bool = True
    preempt_save: bool = True

    def check_ported(self) -> None:
        """Raise ``ValueError`` for an unknown optimizer or schedule, or
        ``accum_steps`` < 1."""
        if self.optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.schedule not in ("onecycle", "cosine_annealing", "constant"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.accum_steps < 1:
            raise ValueError(
                f"accum_steps must be >= 1, got {self.accum_steps}")


def shapenet_car_train_config() -> TrainConfig:
    """The ShapeNet-Car training (``haet_tpu/utils/config.py:284-290``):
    Adam, lr 1e-3, OneCycle with ``final_div_factor`` 1000 and torch's other
    defaults, clipping at 1.0, batch 1, 200 epochs, early stopping after 7
    evals without improvement."""
    return TrainConfig(lr=1e-3, optimizer="adam", final_div_factor=1000.0,
                       epochs=200, batch_size=1, max_grad_norm=1.0,
                       early_stop_patience=7)


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data_path: str = "./data"
    checkpoint_dir: str = "./checkpoints"
    ntrain: int = 1000
    ntest: int = 200

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# The PDE presets of ``haet_tpu/utils/config.py:157-259`` (the reference's
# committed run configs): AdamW, lr 1e-3, weight decay 1e-5, 500 epochs,
# OneCycle (elasticity: cosine annealing with T_max = epochs, stepped per
# batch), 8 blocks of n_hidden 128 (NS 256), 8 heads, G 64.

def darcy_config(downsample: int = 5) -> ExperimentConfig:
    """reference exp_darcy.py defaults + scripts/HAET_Darcy.sh: the 421^2
    grid downsampled to 85 x 85, ``unified_pos`` with ref 8."""
    s = int((421 - 1) / downsample) + 1
    return ExperimentConfig(
        name="darcy",
        model=ModelConfig(
            variant="structured_2d", space_dim=2, fun_dim=1, out_dim=1,
            n_layers=8, n_hidden=128, n_head=8, slice_num=64,
            mlp_ratio=1, ref=8, unified_pos=True, H=s, W=s,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=4,
                          checkpoint_every=100),
    )


def airfoil_config() -> ExperimentConfig:
    """reference exp_airfoil.py: 221x51 mesh coords, fun_dim=0."""
    return ExperimentConfig(
        name="airfoil",
        model=ModelConfig(
            variant="structured_2d", space_dim=2, fun_dim=0, out_dim=1,
            n_layers=8, n_hidden=128, n_head=8, slice_num=64,
            mlp_ratio=1, unified_pos=False, H=221, W=51,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=4,
                          checkpoint_every=100),
    )


def pipe_config() -> ExperimentConfig:
    """reference exp_pipe.py: 129x129 mesh coords, fun_dim=0."""
    return ExperimentConfig(
        name="pipe",
        model=ModelConfig(
            variant="structured_2d", space_dim=2, fun_dim=0, out_dim=1,
            n_layers=8, n_hidden=128, n_head=8, slice_num=64,
            mlp_ratio=1, unified_pos=False, H=129, W=129,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=4,
                          checkpoint_every=100),
    )


def ns_config() -> ExperimentConfig:
    """reference exp_ns.py: 64x64, T_in=10 channels, autoregressive
    rollout (its driver is :mod:`haet_torch.benchmarks.exp_ns`)."""
    return ExperimentConfig(
        name="ns",
        model=ModelConfig(
            variant="structured_2d", space_dim=2, fun_dim=10, out_dim=1,
            n_layers=8, n_hidden=256, n_head=8, slice_num=64,
            mlp_ratio=1, unified_pos=True, ref=8, H=64, W=64,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=2,
                          checkpoint_every=100),
    )


def elasticity_config() -> ExperimentConfig:
    """reference exp_elas.py: 972-point clouds, fun_dim=0, irregular model,
    ``CosineAnnealingLR(T_max=epochs)`` stepped per batch (exp_elas.py:128,
    226)."""
    return ExperimentConfig(
        name="elasticity",
        model=ModelConfig(
            variant="irregular", space_dim=2, fun_dim=0, out_dim=1,
            n_layers=8, n_hidden=128, n_head=8, slice_num=64,
            mlp_ratio=1, unified_pos=False,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=1,
                          checkpoint_every=100,
                          schedule="cosine_annealing", t_max=500),
    )


def plasticity_config() -> ExperimentConfig:
    """reference exp_plas.py: 101x31 grid, Time_Input=True, out_dim=4 (its
    driver is :mod:`haet_torch.benchmarks.exp_plas`)."""
    return ExperimentConfig(
        name="plasticity",
        model=ModelConfig(
            variant="structured_2d", space_dim=2, fun_dim=0, out_dim=4,
            n_layers=8, n_hidden=128, n_head=8, slice_num=64,
            mlp_ratio=1, unified_pos=False, H=101, W=31, Time_Input=True,
        ),
        train=TrainConfig(lr=1e-3, weight_decay=1e-5, epochs=500, batch_size=8,
                          checkpoint_every=100),
    )


def shapenet_car_experiment() -> ExperimentConfig:
    """The ShapeNet-Car preset as one experiment
    (``haet_tpu/utils/config.py:262-291``): :func:`shapenet_car_config` and
    :func:`shapenet_car_train_config`."""
    return ExperimentConfig(name="shapenet_car", model=shapenet_car_config(),
                            train=shapenet_car_train_config())


PRESETS = {
    "darcy": darcy_config,
    "airfoil": airfoil_config,
    "pipe": pipe_config,
    "ns": ns_config,
    "elasticity": elasticity_config,
    "plasticity": plasticity_config,
    "shapenet_car": shapenet_car_experiment,
}
