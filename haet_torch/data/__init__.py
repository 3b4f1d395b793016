"""Data layer of the port: the ShapeNet-Car pipeline and the PDE loaders on
numpy and scipy.

Copies of ``haet_tpu/data``'s modules (that package imports JAX at its
root, so the port keeps its own): :mod:`.vtk_io` (legacy VTK reader and
writer), :mod:`.shapenet_car` (samples, folds, normalization, the ``.npy``
cache, padding), :mod:`.car_metrics` (drag coefficient, Spearman rho),
:mod:`.pde_datasets` (the six PDE benchmarks' files), :mod:`.synthetic`
(the stand-ins when no dataset is present, and ``batch_iter``),
:mod:`.preprocess_car` (grid SDF) and :mod:`.prefetch` (background
batches).
"""

from .prefetch import Prefetcher  # noqa: F401
