"""Airfoil benchmark driver (reference ``exp_airfoil.py``).

    python -m haet_torch.benchmarks.exp_airfoil [--smoke] [--device cpu]
        [--data_path DIR]

Counterpart of ``benchmarks/exp_airfoil.py``: :func:`exp_pipe.run` on the
221 x 51 structured mesh of ``NACA_Cylinder_{X,Y,Q}.npy`` (channel 4 of
Q), ``fun_dim`` 0, the ``airfoil_config`` preset.
"""

from __future__ import annotations

from ..utils.config import airfoil_config
from .exp_pipe import run
from .pde_common import base_parser, shrink_for_smoke


def main(argv=None) -> float:
    args = base_parser("haet_torch Airfoil").parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    return run(args, prefix="NACA_Cylinder", h=221, w=51,
               config_fn=airfoil_config, name="airfoil")


if __name__ == "__main__":
    main()
