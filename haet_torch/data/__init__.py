"""Data layer of the port: the ShapeNet-Car pipeline on numpy and scipy.

Copies of ``haet_tpu/data``'s car modules (that package imports JAX at
its root, so the port keeps its own): :mod:`.vtk_io` (legacy VTK reader
and writer), :mod:`.shapenet_car` (samples, folds, normalization, the
``.npy`` cache, padding), :mod:`.car_metrics` (drag coefficient, Spearman
rho), :mod:`.synthetic` (the stand-in when no dataset is present),
:mod:`.preprocess_car` (grid SDF) and :mod:`.prefetch` (background
batches).
"""

from .prefetch import Prefetcher  # noqa: F401
