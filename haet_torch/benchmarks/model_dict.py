"""Model registry (reference ``benchmarks/04-.../model_dict.py:8-14``).

Counterpart of ``benchmarks/model_dict.py:19-36``: maps ``--model`` names
to the port's model classes, so that drivers can stay generic.
"""

from __future__ import annotations

from ..models import (HAETransolverIrregularMesh,
                      HAETransolverStructuredMesh2D,
                      HAETransolverStructuredMesh3D)

MODEL_DICT = {
    "Transolver_2D": HAETransolverStructuredMesh2D,
    "Transolver_3D": HAETransolverStructuredMesh3D,
    "Transolver_1D": HAETransolverIrregularMesh,
    "HAETransolver_Structured_Mesh_2D": HAETransolverStructuredMesh2D,
    "HAETransolver_Structured_Mesh_3D": HAETransolverStructuredMesh3D,
    "HAETransolver_Irregular_Mesh": HAETransolverIrregularMesh,
}


def get_model(args):
    """The model class for ``args.model`` (or ``args`` itself, a name)."""
    name = args.model if hasattr(args, "model") else args
    if name not in MODEL_DICT:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_DICT)}")
    return MODEL_DICT[name]
