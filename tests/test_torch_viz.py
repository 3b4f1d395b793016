"""PyTorch port, the visualization utilities
(``haet_torch/utils/visualization.py``) against the JAX package's.

* ``get_slice_weights`` of a small 2-layer irregular model (JAX built once:
  ``jax.eval_shape`` of its init, numpy weights from
  ``test_torch_model.init_like``) equals JAX's capture within 1e-6, for the
  last block and for block 0, with the kernel flags off (the weights the
  plain path computed) and on (recomputed by the plain formula in the
  capturing forward; on the CPU the kernels' plain versions run); the
  capture leaves the model's mode and every capture switch as they were,
  and an ordinary forward captures nothing.
* With the same numpy sample and weights, each plotting function writes the
  same file names as JAX's (matplotlib, Agg backend).
"""

import os

import jax
import numpy as np
import pytest
import torch

from haet_torch.data.shapenet_car import CarSample
from haet_torch.models import HAETransolverIrregularMesh as TIrr
from haet_torch.models.physics_attention import _PhysicsAttentionBase
from haet_torch.utils import visualization as tviz
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.data.shapenet_car import CarSample as JCarSample
from haet_tpu.models import HAETransolverIrregularMesh as JIrr
from haet_tpu.utils import visualization as jviz
from test_torch_model import init_like

B, N = 2, 80
ATOL = 1e-6
KW = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=2, n_hidden=32,
          n_head=4, slice_num=8, ball_sizes=(4, 2), mlp_ratio=1)


@pytest.fixture(scope="module")
def jax_weights():
    rng = np.random.RandomState(4)
    x = rng.rand(B, N, 3).astype(np.float32)
    fx = rng.randn(B, N, 1).astype(np.float32)
    jm = JIrr(**KW)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx)
    variables = init_like(template, rng, KW["n_hidden"])
    want = {blk: jviz.get_slice_weights(jm, variables, x, fx, block=blk)
            for blk in (-1, 0)}
    return variables, x, fx, want


@pytest.mark.parametrize("block", [-1, 0], ids=["last", "first"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_slice_weights_match_jax(jax_weights, block, kernels):
    variables, x, fx, want = jax_weights
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        m = TIrr(**KW, use_pallas=kernels, use_pallas_erwin=kernels,
                 device="cpu")
        load_jax_variables(m, variables)
        m.train()
        got = tviz.get_slice_weights(m, torch.from_numpy(x),
                                     torch.from_numpy(fx), block=block)
        attns = [a for a in m.modules()
                 if isinstance(a, _PhysicsAttentionBase)]
        assert m.training
        assert not any(a.capture_slice_weights or a.slice_weights is not None
                       for a in attns)
        with torch.no_grad():
            m(torch.from_numpy(x), torch.from_numpy(fx))
        assert all(a.slice_weights is None for a in attns)
    finally:
        torch.set_num_threads(threads)
    assert got.shape == (B, KW["n_head"], N, KW["slice_num"])
    assert got.dtype == np.float32
    err = np.abs(got - want[block]).max()
    print(f"PARITY slice weights block {block} kernels={kernels}: "
          f"max_abs_err {err:.3e}")
    assert err <= ATOL, err
    np.testing.assert_allclose(got.sum(axis=2), 1.0, atol=1e-5)


def _files(d):
    return sorted(os.listdir(d))


def test_plots_write_jax_file_names(jax_weights, tmp_path):
    _, _, _, want = jax_weights
    w = want[-1]                       # [B, H, N, G]
    rng = np.random.RandomState(5)
    pos = rng.rand(N, 3).astype(np.float32)
    surf = np.zeros(N, bool)
    surf[:40] = True
    fields = dict(pos=pos, x=rng.rand(N, 7).astype(np.float32),
                  y=rng.rand(N, 4).astype(np.float32), surf=surf)
    calls = [
        ("car", lambda viz, cls, d: viz.visualize_car_and_slices(
            cls(**fields), w, d, sample_idx=3, top_k=2, max_slice_figs=2,
            dpi=30)),
        ("cloud", lambda viz, cls, d: viz.plot_slice_weights_cloud(
            pos, w, d, head=1, top_k=2)),
        ("triptych", lambda viz, cls, d: viz.plot_prediction_triptych(
            rng.rand(64), rng.rand(64), 8, 8, d, 2)),
        ("grid", lambda viz, cls, d: viz.plot_field_grid(
            rng.rand(64), 8, 8, os.path.join(d, "sub", "f.png"),
            title="t", clim=(0, 1))),
    ]
    for name, call in calls:
        dt, dj = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        call(tviz, CarSample, str(dt))
        call(jviz, JCarSample, str(dj))
        assert _files(dt) == _files(dj), name
        assert _files(dt), name
    assert _files(tmp_path / "t_grid" / "sub") == ["f.png"]
    assert "slice_1_sample_3.png" in _files(tmp_path / "t_car")
    assert "slice_2_sample_3.png" not in _files(tmp_path / "t_car")
