"""Model zoo of the PyTorch port (mirrors ``haet_tpu.models``)."""

from .erwin import (  # noqa: F401
    BallMSA,
    BallPooling,
    BallUnpooling,
    BasicLayer,
    ErwinEmbedding,
    ErwinTransformer,
    ErwinTransformerBlock,
    Node,
)
from .haet import HAETransolverIrregularMesh, TransolverErwinBlock  # noqa: F401
from .physics_attention import PhysicsAttentionIrregularMesh  # noqa: F401

# Reference-spelling aliases (reference models/__init__.py:15-23).
HAETransolver_Irregular_Mesh = HAETransolverIrregularMesh
Physics_Attention_Irregular_Mesh = PhysicsAttentionIrregularMesh
