"""Model and training configs and the ShapeNet-Car presets, PyTorch.

``ModelConfig`` and ``TrainConfig`` are ``haet_tpu/utils/config.py``'s
field for field, so one config describes the same model and the same
training in both packages. :meth:`ModelConfig.build` returns the torch
model; only the irregular variant is ported so far. ``ModelConfig.bf16``
builds it with the bf16 compute dtype over float32 parameters, and
``TrainConfig.mu_bf16`` stores Adam's first moment in bf16, as in JAX.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

TRAINER_TODO = ("{} is not ported yet (ROADMAP.md, queue 1: Trainer and "
                "drivers)")
VARIANT_TODO = ("the {} variant is not ported yet (ROADMAP.md, queue 1: "
                "2D/3D variants, unified_pos and Time_Input)")


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
    pallas_auto_threshold: int = 1_700_000
    bf16: bool = False
    shard_axes: Optional[tuple] = None

    def model_kwargs(self) -> dict:
        """Constructor kwargs of :class:`HAETransolverIrregularMesh` for
        this config (what :meth:`build` passes); ``bf16`` becomes
        ``dtype=torch.bfloat16``."""
        if self.variant != "irregular":
            raise NotImplementedError(VARIANT_TODO.format(self.variant))
        if self.shard_axes is not None:
            raise NotImplementedError(
                "shard_axes is not ported yet (ROADMAP.md, queue 1: parallel)")
        kw = dataclasses.asdict(self)
        for k in ("variant", "H", "W", "D", "pallas_auto_threshold", "bf16",
                  "shard_axes"):
            kw.pop(k)
        kw["dtype"] = torch.bfloat16 if self.bf16 else None
        return kw

    def build(self, device=None, seed: int = 0):
        """The torch model for this config on ``device`` (None = CUDA)."""
        from ..models import HAETransolverIrregularMesh

        return HAETransolverIrregularMesh(**self.model_kwargs(),
                                          device=device, seed=seed)


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

    The port's ``Trainer`` runs Adam with OneCycle (``cycle_momentum``
    included; ``mu_bf16`` stores the first moment in bf16) and torch's
    gradient clipping, and ``Trainer.fit`` the
    training loop with early stopping, periodic checkpoints
    (``checkpoint_every``), ``stop_on_nonfinite`` and ``preempt_save``;
    :meth:`check_ported` raises for the settings it does not run yet.
    ``weight_decay`` is read by AdamW only, as in JAX. ``seed`` seeds the
    car driver's model; its batches hold one sample, the preset's
    ``batch_size``.
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
        """Raise ``NotImplementedError`` for a setting the port does not run
        yet, naming its ``ROADMAP.md`` item."""
        if self.optimizer == "adamw":
            raise NotImplementedError(TRAINER_TODO.format("optimizer='adamw'"))
        if self.optimizer != "adam":
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.schedule in ("cosine_annealing", "constant"):
            raise NotImplementedError(
                TRAINER_TODO.format(f"schedule={self.schedule!r}"))
        if self.schedule != "onecycle":
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.accum_steps != 1:
            raise NotImplementedError(TRAINER_TODO.format("accum_steps > 1"))


def shapenet_car_train_config() -> TrainConfig:
    """The ShapeNet-Car training (``haet_tpu/utils/config.py:284-290``):
    Adam, lr 1e-3, OneCycle with ``final_div_factor`` 1000 and torch's other
    defaults, clipping at 1.0, batch 1, 200 epochs, early stopping after 7
    evals without improvement."""
    return TrainConfig(lr=1e-3, optimizer="adam", final_div_factor=1000.0,
                       epochs=200, batch_size=1, max_grad_norm=1.0,
                       early_stop_patience=7)
