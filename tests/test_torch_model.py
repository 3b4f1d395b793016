"""PyTorch port, the whole ShapeNet-Car model vs the JAX package.

The car preset at full width (2 layers, n_hidden 256, 8 heads, G 32,
1,757,190 params) at a small point count (N = 1000, B = 2), in eval mode,
with both ``use_pallas`` settings (``use_pallas`` and ``use_pallas_erwin``
together, as the server runs them), against one JAX reference built once
for the module: the model's plain path, which the JAX package's own tests
hold to its Pallas kernels (``tests/test_pallas_*.py``). The port runs its
kernels' plain versions on the CPU; its kernel modules are held to the
Pallas kernels in interpret mode in ``test_torch_slice.py`` and
``test_torch_erwin.py``.

Weights: the JAX model's parameter tree comes from ``jax.eval_shape`` of its
init (no init compile), and each leaf is drawn with numpy from the init's
own distribution (trunc-normal 0.02 kernels, zero biases, unit scales,
``sigma_att ~ -1 + 0.01 N``, placeholder ``U/n_hidden``) and then perturbed
by ``0.05 N(0, 1)``, with BatchNorm statistics moved off (0, 1). At plain init
weights the Erwin stage barely moves the output, which would hide a wrong
Erwin port.

Tolerance: 1e-4 of max |out| (float32, sums in another order through two
layers and 24 Erwin blocks).
"""

import jax
import numpy as np
import pytest
import torch

from haet_torch.models import HAETransolverIrregularMesh
from haet_torch.ops.kernels import plain_route_counts, reset_launch_counts
from haet_torch.utils.config import shapenet_car_config as torch_car_config
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk
from haet_tpu.utils.config import shapenet_car_config as jax_car_config

B, N = 2, 1000
RTOL = 1e-4


def init_like(template, rng, n_hidden, noise=0.05):
    """numpy variables for a JAX shape tree: the init distributions plus
    ``noise * N(0, 1)``."""
    def leaf(path, sds):
        name = path[-1].key
        shape = sds.shape
        if path[0].key == "batch_stats":
            if name == "var":
                return (0.5 + rng.rand(*shape)).astype(np.float32)
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name in ("kernel", "in_project_slice_kernel", "ada_temp_kernel"):
            base = 0.02 * rng.randn(*shape)
        elif name == "scale":
            base = np.ones(shape)
        elif name == "sigma_att":
            base = -1.0 + 0.01 * rng.randn(*shape)
        elif name == "placeholder":
            base = rng.rand(*shape) / n_hidden
        else:
            base = np.zeros(shape)
        return (base + noise * rng.randn(*shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, template)


@pytest.fixture(scope="module")
def car():
    sk_mode, eb_mode = jsk.INTERPRET, jeb.INTERPRET
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, 7).astype(np.float32)
    jm = jax_car_config().model.build()
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = init_like(template, rng, jm.n_hidden)
    plain = jm.clone(use_pallas=False, use_pallas_erwin=False)
    ref = np.asarray(jax.jit(plain.apply)(variables, x))
    yield jm, variables, x, ref
    jsk.INTERPRET, jeb.INTERPRET = sk_mode, eb_mode
    torch.set_num_threads(threads)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_car_forward_matches_jax(car, use_pallas):
    _, variables, x, ref = car
    kwargs = torch_car_config().model_kwargs()
    kwargs["use_pallas"] = use_pallas
    tm = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=use_pallas,
                                    device="cpu").eval()
    load_jax_variables(tm, variables)
    reset_launch_counts()
    with torch.inference_mode():
        out = tm(torch.from_numpy(x)).numpy()
    assert out.shape == (B, N, 4)
    # every car Erwin block passes the kernel's gate: none falls back
    assert plain_route_counts() == {"fused_erwin_block": 0,
                                    "fused_erwin_block_bwd": 0}
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    print(f"PARITY car forward use_pallas={use_pallas}: max_abs_err "
          f"{err:.3e} max|ref| {scale:.3e}")  # shown with `pytest -s`
    assert err <= RTOL * scale, (err, scale)


def test_erwin_stage_moves_the_output(car):
    """The perturbed weights make the Erwin stage matter: dropping its
    output (identity Erwin) changes the model output by far more than the
    parity tolerance, so the parity test above could see a wrong Erwin."""
    _, variables, x, _ = car
    tm = HAETransolverIrregularMesh(**torch_car_config().model_kwargs(),
                                    device="cpu").eval()
    load_jax_variables(tm, variables)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        full = tm(xt)
        for blk in tm.blocks:
            blk.Attn.erwin.forward = lambda s, pos, mask=None, group=None: s
        skipped = tm(xt)
    rel = float((full - skipped).abs().max() / full.abs().max())
    assert rel > 100 * RTOL, rel


def test_unified_pos_irregular_matches_jax(car):
    """The irregular model's ``unified_pos`` features (distances to a
    ``ref x ref`` grid) on a small model with perturbed weights."""
    from haet_tpu.models import HAETransolverIrregularMesh as JModel

    kw = dict(space_dim=2, fun_dim=1, out_dim=2, n_layers=1, n_hidden=32,
              n_head=4, slice_num=8, unified_pos=True, ref=4)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 64, 2).astype(np.float32)
    fx = rng.randn(2, 64, 1).astype(np.float32)
    jm = JModel(**kw)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx)
    variables = init_like(template, rng, kw["n_hidden"])
    ref = np.asarray(jax.jit(jm.apply)(variables, x, fx))
    tm = HAETransolverIrregularMesh(**kw, device="cpu").eval()
    load_jax_variables(tm, variables)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), torch.from_numpy(fx)).numpy()
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    print(f"PARITY unified_pos model: max_abs_err {err:.3e} max|ref| "
          f"{scale:.3e}")  # shown with `pytest -s`
    assert err <= RTOL * scale
