"""Model zoo of the PyTorch port (mirrors ``haet_tpu.models``)."""

from .erwin import (  # noqa: F401
    BallMSA,
    BallPooling,
    BallUnpooling,
    BasicLayer,
    ErwinEmbedding,
    ErwinTransformer,
    ErwinTransformerBlock,
    MPNN,
    Node,
)
from .haet import (  # noqa: F401
    HAETransolverIrregularMesh,
    HAETransolverStructuredMesh2D,
    HAETransolverStructuredMesh3D,
    TransolverErwinBlock,
)
from .physics_attention import (  # noqa: F401
    PhysicsAttentionIrregularMesh,
    PhysicsAttentionStructuredMesh2D,
    PhysicsAttentionStructuredMesh3D,
)

# Reference-spelling aliases (reference models/__init__.py:15-23 and
# models/PhysicsAttention/__init__.py:2-4).
HAETransolver_Structured_Mesh_2D = HAETransolverStructuredMesh2D
HAETransolver_Structured_Mesh_3D = HAETransolverStructuredMesh3D
HAETransolver_Irregular_Mesh = HAETransolverIrregularMesh
Physics_Attention_Structured_Mesh_2D = PhysicsAttentionStructuredMesh2D
Physics_Attention_Structured_Mesh_3D = PhysicsAttentionStructuredMesh3D
Physics_Attention_Irregular_Mesh = PhysicsAttentionIrregularMesh
