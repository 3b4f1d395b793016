"""ShapeNet-Car physics metrics of the port: drag coefficient from surface
fields (``haet_tpu/data/car_metrics.py:27-117``).

Pure-numpy re-implementation of the reference's VTK-based pipeline
(reference ``benchmarks/02-.../utils/drag_coefficient.py``), operating on
arrays instead of VTK objects so it has no `vtk` dependency:

* frontal area = 2D convex hull over the (x, y) plane (:25-28),
* quad cell areas = half-sum of the two triangle cross products (:49-59),
* per-cell velocity gradients by the reference's finite differences
  (:108-114),
* cell normals: per-quad Newell normal, consistently oriented outward
  (approximates vtkPolyDataNormals with AutoOrientNormals, :135-144),
* ``F_d = -sum(p*A*n_z) - mu * sum(grad_u_z*A*n_z)``,
  ``C_d = 2 F_d / (rho v^2 A)`` with ``v=72/3.6, rho=0.3, mu=1.8e-5``
  (:121-131, :198-201).
"""

from __future__ import annotations

import numpy as np

DYNAMIC_VISCOSITY = 1.8e-5
FLOW_SPEED = 72 / 3.6
AIR_DENSITY = 0.3


def frontal_area(points: np.ndarray) -> float:
    """Convex-hull area over the first two coordinates (:25-28)."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(points[:, :2])
    return float(hull.volume)  # 2D hull "volume" is the area


def quad_cell_areas(points: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """[num_quads] areas (:49-59)."""
    p1, p2, p3, p4 = (points[quads[:, i]] for i in range(4))
    a1 = np.linalg.norm(np.cross(p2 - p1, p3 - p1), axis=-1)
    a2 = np.linalg.norm(np.cross(p3 - p1, p4 - p1), axis=-1)
    return 0.5 * (a1 + a2)


def quad_cell_normals(points: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """[num_quads, 3] unit normals, oriented away from the body centroid.

    The reference uses vtkPolyDataNormals with AutoOrientNormals (:135-144);
    centroid-outward orientation is the standard approximation for
    star-shaped closed surfaces like car bodies.
    """
    p1, p2, p3, p4 = (points[quads[:, i]] for i in range(4))
    n = np.cross(p3 - p1, p4 - p2)  # Newell-style quad normal
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    centers = 0.25 * (p1 + p2 + p3 + p4)
    outward = centers - points.mean(axis=0, keepdims=True)
    sign = np.sign(np.sum(n * outward, axis=-1, keepdims=True))
    sign = np.where(sign == 0, 1.0, sign)
    return n * sign


def quad_velocity_gradients(points: np.ndarray, quads: np.ndarray,
                            velocity: np.ndarray) -> np.ndarray:
    """[num_quads, 3] per-cell velocity gradient (reference :108-114)."""
    p1, p2, p3, p4 = (points[quads[:, i]] for i in range(4))
    u1, u2, u3, u4 = (velocity[quads[:, i]] for i in range(4))
    eps = 1e-8

    def fd(un, pn):
        return un / (np.linalg.norm(pn, axis=-1, keepdims=True) + eps)

    du_dx = fd(u2 - u1 + u3 - u4, p2 - p1 + p3 - p4)
    du_dy = fd(u3 - u1 + u4 - u2, p3 - p1 + p4 - p2)
    du_dz = fd(u4 - u1 + u2 - u3, p4 - p1 + p2 - p3)
    return du_dx + du_dy + du_dz


def point_to_cell(quads: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Point data -> cell data by vertex averaging (vtkPointDataToCellData)."""
    return values[quads].mean(axis=1)


def drag_force(cell_areas, normals_z, press_cell, grad_u_z,
               mu: float = DYNAMIC_VISCOSITY) -> float:
    """reference :121-131 (z components only)."""
    pressure_comp = -np.dot(press_cell.ravel() * cell_areas.ravel(),
                            normals_z.ravel())
    shear_comp = -np.dot(grad_u_z.ravel() * cell_areas.ravel(),
                         normals_z.ravel()) * mu
    return float(np.sum(pressure_comp + shear_comp))


def drag_coefficient(points: np.ndarray, quads: np.ndarray,
                     press_point: np.ndarray,
                     velo_point: np.ndarray) -> float:
    """C_d from surface point pressures and velocities (reference
    ``cal_coefficient``, :148-202).

    Args:
        points: ``[n_surf, 3]`` surface mesh points.
        quads: ``[n_quads, 4]`` connectivity.
        press_point: ``[n_surf]`` pressures at points.
        velo_point: ``[n_surf, 3]`` velocities at points.
    """
    normals = quad_cell_normals(points, quads)
    A = frontal_area(points)
    areas = quad_cell_areas(points, quads)
    grad_u = quad_velocity_gradients(points, quads, velo_point)
    press_cell = point_to_cell(quads, np.asarray(press_point).reshape(-1))
    fd = drag_force(areas, normals[:, -1], press_cell, grad_u[:, -1])
    return (2.0 / (FLOW_SPEED ** 2 * A * AIR_DENSITY)) * fd


def spearman_rho(a, b) -> float:
    """Spearman rank correlation (reference uses scipy.stats.spearmanr for
    the Cd ranking metric, ``main_evaluation.py:338-342``)."""
    from scipy.stats import spearmanr

    return float(spearmanr(a, b).statistic)
