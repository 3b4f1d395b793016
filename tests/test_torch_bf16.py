"""PyTorch port in bf16 against the JAX package in bf16.

``ModelConfig.bf16`` computes in bf16 over float32 parameters, module by
module as the JAX package does (flax ``dtype=jnp.bfloat16``): bf16 Dense
layers, float32 normalisations, a float32 slice softmax, the fused kernels'
float32 arithmetic on bf16 inputs, and ``mu_bf16``'s bf16 first moment.
The same numpy inputs go through both packages on the CPU, the Pallas
kernels in interpret mode. Tolerances, each with its reason:

* a bf16 output that both sides compute in float32 from the same bf16
  inputs and round once differs by at most one bf16 ulp where the float32
  values straddle a rounding boundary: ``ULP`` = 2^-7 of max |out|;
* float32 outputs of the same computations (``m``, ``s``, the float32
  states residual, parameter gradients): as the float32 parity tests;
* the small model's bf16 forward: flax's bf16 ``gelu`` (``0.5 x erfc(-x
  / sqrt 2)``, each op rounded to bf16) and torch's (float32, rounded once)
  differ by one ulp in a quarter to a third of the elements for x >= -1
  and by up to a quarter of the value below, where flax's rounded
  ``erfc`` argument is off (traced in
  :func:`test_bf16_dense_and_gelu_against_flax`); that moves the bf16
  states, the pseudo-positions and so the ball trees: the
  two bf16 outputs differ by ~1.1e-2 of max |out| (measured), about as far
  as each is from the float32 output (JAX 7.4e-3, the port 9.3e-3). The
  test holds 2e-2, and the port's distance from float32 to twice JAX's and
  above zero (the port really computes in bf16).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.ops import ball_groups as tbg
from haet_torch.ops.dense import linear
from haet_torch.ops.kernels import count_kernels
from haet_torch.ops.kernels import slice_kernels as tsk
from haet_torch.export import ServingBundle
from haet_torch.serve import BatchingServer, export_batch_family
from haet_torch.train import Checkpointer, Trainer
from haet_torch.train import car as tcar
from haet_torch.train.trainer import Adam
from haet_torch.utils import env
from haet_torch.utils.config import shapenet_car_train_config
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel
from haet_tpu.models.erwin import ErwinTransformer as JErwin
from haet_tpu.models.erwin import ErwinTransformerBlock as JBlock
from haet_tpu.ops import ball_groups as jbg
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk
from haet_tpu.train import Trainer as JTrainer
from haet_tpu.train.trainer import TrainState
from haet_tpu.utils.config import TrainConfig as JTrainConfig
from test_torch_model import init_like
from test_torch_train import MODEL, N_PAD, N_POINTS, _sample

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
BF = torch.bfloat16
ULP = 2.0 ** -7
B, H, N, C, G = 1, 2, 300, 16, 8
MODEL_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    modes = jsk.INTERPRET, jeb.INTERPRET
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET, jeb.INTERPRET = modes
    torch.set_num_threads(threads)


def _bf16(a):
    """numpy float32 rounded to bf16, as a float32 numpy array (exact in
    either framework)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def _t(a, bf=False):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(BF) if bf else t


def _j(a, bf=False):
    a = jnp.asarray(np.asarray(a, np.float32))
    return a.astype(jnp.bfloat16) if bf else a


def _np(a):
    """A torch tensor or JAX array, bf16 or not, as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(name, got, want, rtol, atol_of_max=0.0):
    got, want = _np(got), _np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    print(f"PARITY {name}: max_abs_err {err:.3e} max|ref| {scale:.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * scale, err_msg=name)


def _within_ulp(name, got, want):
    """bf16 outputs of one float32 computation: one bf16 ulp of max."""
    got, want = _np(got), _np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    print(f"PARITY {name} (bf16): max_abs_err {err:.3e} max|ref| "
          f"{scale:.3e}")
    assert err <= ULP * scale, (name, err, scale)


@pytest.fixture(scope="module")
def slice_data():
    rng = np.random.RandomState(0)
    return dict(
        x=_bf16(rng.randn(B, H, N, C)),
        ws=(0.4 * rng.randn(C, G)).astype(np.float32),
        bs=(0.1 * rng.randn(G)).astype(np.float32),
        wa=(0.1 * rng.randn(C, 1)).astype(np.float32),
        ba=np.zeros(1, np.float32),
        st=_bf16(rng.randn(B, H, G, C)),
        g_st=_bf16(rng.randn(B, H, G, C)),
        g_out=_bf16(rng.randn(B, H, N, C)))


PARAMS = ("ws", "bs", "wa", "ba")


@pytest.mark.parametrize("kind", ["slice_states", "deslice"])
def test_slice_forwards_bf16_match_jax(slice_data, kind):
    """The port's plain versions against the Pallas kernels on the same bf16
    ``x_proj`` (and bf16 states): bf16 outputs within one ulp, ``m``, ``s``
    and the float32 residual at 1e-5, dtypes as JAX's."""
    d = slice_data
    xj, xt = _j(d["x"], True), _t(d["x"], True)
    pj = [_j(d[k]) for k in PARAMS]
    pt = [_t(d[k]) for k in PARAMS]
    st_j, m_j, s_j = jsk.slice_states(xj, *pj)
    if kind == "slice_states":
        res_j, _, _ = jsk._slice_states_impl_f32(xj, *pj, 0.5, 1e-6, 32)
        st_t, res_t, m_t, s_t = tsk.slice_states_with_residual(xt, *pt)
        assert (st_t.dtype, res_t.dtype, m_t.dtype) == (
            BF, torch.float32, torch.float32)
        assert str(st_j.dtype) == "bfloat16" and str(m_j.dtype) == "float32"
        _within_ulp("slice_states states", st_t, st_j)
        assert torch.equal(st_t, res_t.to(BF))   # the residual, rounded
        _close("slice_states float32 states", res_t, res_j, 1e-5, 1e-6)
        _close("slice_states m", m_t, m_j, 1e-5, 1e-6)
        _close("slice_states s", s_t, s_j, 1e-5, 1e-6)
    else:
        m, s = _t(_np(m_j)), _t(_np(s_j))
        out_j = jsk.deslice(xj, *pj, _j(d["st"], True), m_j, s_j)
        out_t = tsk.deslice(xt, *pt, _t(d["st"], True), m, s)
        assert out_t.dtype == BF and str(out_j.dtype) == "bfloat16"
        _within_ulp("deslice out", out_t, out_j)


@pytest.mark.parametrize("kind", ["slice_states", "deslice"])
def test_slice_backwards_bf16_match_jax(slice_data, kind):
    """Autograd through ``SliceStatesFn``/``DesliceFn`` on bf16 ``x_proj``
    against ``jax.vjp`` of the Pallas kernels, each side from its own
    forward's residuals: the parameter gradients (float32 on both sides,
    the float32 states residual keeping bf16 out of the backward) at the
    near-float32 tightness of ``tests/test_pallas_slice.py:109-135``
    (rtol 5e-3 or 5e-5 of the largest gradient), and ``dx`` (and
    ``dstates``), bf16 on both sides, within one ulp of their max."""
    d = slice_data
    xj = _j(d["x"], True)
    pj = [_j(d[k]) for k in PARAMS]
    xt = _t(d["x"], True).requires_grad_()
    pt = [_t(d[k]).requires_grad_() for k in PARAMS]
    if kind == "slice_states":
        gj = _j(d["g_st"], True)
        want = jax.jit(lambda x, p, g: jax.vjp(
            lambda x, *p: jsk.slice_states(x, *p)[0], x, *p)[1](g))(
                xj, pj, gj)
        states, _, _ = tsk.slice_states(xt, *pt)
        states.backward(_t(d["g_st"], True))
        got = [xt.grad, *(p.grad for p in pt)]
        names = ("dx",) + tuple(f"d{k}" for k in PARAMS)
    else:
        _, m_j, s_j = jsk.slice_states(xj, *pj)
        stj = _j(d["st"], True)
        want = jax.jit(lambda x, st, p, g: jax.vjp(
            lambda x, st, *p: jsk.deslice(x, *p, st, m_j, s_j), x, st,
            *p)[1](g))(xj, stj, pj, _j(d["g_out"], True))
        stt = _t(d["st"], True).requires_grad_()
        out = tsk.deslice(xt, *pt, stt, _t(_np(m_j)), _t(_np(s_j)))
        out.backward(_t(d["g_out"], True))
        got = [xt.grad, stt.grad, *(p.grad for p in pt)]
        names = ("dx", "dstates") + tuple(f"d{k}" for k in PARAMS)
    scale = max(np.abs(_np(w)).max() for w in want[-4:])
    for name, g, w in zip(names, got, want):
        if name in ("dx", "dstates"):
            assert g.dtype == BF and str(w.dtype) == "bfloat16", name
            _within_ulp(f"{kind} {name}", g, w)
        else:
            assert g.dtype == torch.float32, name
            _close(f"{kind} {name}", g, w, 5e-3, 5e-5 * scale / max(
                np.abs(_np(w)).max(), 1e-30))


@pytest.mark.parametrize("n,c,ball,heads", [(32, 32, 32, 8), (16, 64, 16, 8)])
def test_erwin_block_bf16_matches_jax(n, c, ball, heads):
    """The fused block on bf16 ``x`` and ``pos`` (the car's two block
    shapes): the port's plain version (float32 arithmetic, the output
    rounded once) against ``fused_erwin_block`` in interpret mode, forward
    and ``jax.vjp``: ``out`` and ``dx`` bf16 within one ulp, the parameter
    gradients float32 at the float32 block tolerance (2e-5,
    ``tests/test_torch_erwin.py``)."""
    rng = np.random.RandomState(3)
    x = _bf16(rng.randn(8, n, c))
    pos = _bf16(rng.rand(8, n, 3))
    dout = _bf16(rng.randn(8, n, c))
    kw = dict(dim=c, num_heads=heads, ball_size=ball, mlp_ratio=4,
              dimensionality=3, use_dist_bias=True)
    variables = jax.jit(JBlock(**kw).init)(jax.random.PRNGKey(1),
                                           _j(x), _j(pos))
    params = variables["params"]
    fn = lambda x, pos, p: jeb.fused_erwin_block(  # noqa: E731
        x, pos, p, ball_size=ball, num_heads=heads, use_dist_bias=True)
    @jax.jit
    def fwd_bwd(x, pos, p, dout):
        out, vjp = jax.vjp(fn, x, pos, p)
        return (out, *vjp(dout))

    out_j, dx_j, dpos_j, dparams_j = fwd_bwd(_j(x, True), _j(pos, True),
                                             params, _j(dout, True))
    assert str(out_j.dtype) == "bfloat16" and str(dx_j.dtype) == "bfloat16"

    blk = _port_block(c, heads, ball, variables)
    xt = _t(x, True).requires_grad_()
    pt = _t(pos, True)
    out_t = blk(xt, pt)
    assert out_t.dtype == BF
    _within_ulp(f"erwin n{n} c{c} out", out_t, out_j)
    out_t.backward(_t(dout, True))
    assert xt.grad.dtype == BF
    _within_ulp(f"erwin n{n} c{c} dx", xt.grad, dx_j)
    want = from_jax_variables({"params": jax.device_get(dparams_j)})
    for name, p in blk.named_parameters():
        if name.endswith("sigma_att"):
            assert p.grad is None
            continue
        assert p.grad.dtype == torch.float32
        _close(f"erwin n{n} c{c} d{name}", p.grad, want[name], 2e-5, 2e-5)


def _port_block(c, heads, ball, variables):
    from haet_torch.models.erwin import ErwinTransformerBlock

    blk = ErwinTransformerBlock(c, heads, ball, 4, 3, True, True,
                                dtype=BF)
    load_jax_variables(blk, jax.device_get(variables))
    return blk


@pytest.fixture(scope="module")
def model_run():
    """The small HAET (1 layer, n_hidden 32, G 16) with perturbed weights:
    JAX's float32 output, JAX's bf16 output and pseudo-positions (the
    Erwin stage's ``pos``, intercepted) for both ``use_pallas`` settings."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 256, 7).astype(np.float32)
    template = jax.eval_shape(JModel(**MODEL).init, jax.random.PRNGKey(0), x)
    variables = init_like(template, rng, MODEL["n_hidden"])
    ref32 = np.asarray(jax.jit(JModel(**MODEL).apply)(variables, x))
    runs = {}
    for up in (False, True):
        jm = JModel(**MODEL, use_pallas=up, use_pallas_erwin=up,
                    dtype=jnp.bfloat16)

        def run(v, x, jm=jm):
            pos = []

            def grab(next_fun, args, kwargs, ctx):
                if isinstance(ctx.module, JErwin) and \
                        ctx.method_name == "__call__":
                    pos.append(args[1])
                return next_fun(*args, **kwargs)
            with nn.intercept_methods(grab):
                out = jm.apply(v, x)
            return out, pos[0]
        runs[up] = jax.jit(run)(variables, x)
    return x, variables, ref32, runs


@pytest.mark.parametrize("use_pallas", [False, True])
def test_small_model_bf16_forward_matches_jax(model_run, use_pallas):
    """The bf16 forward against JAX's bf16 forward (``MODEL_RTOL`` of max
    |out|, see the module note), each side's distance from the float32
    output (the port's at most twice JAX's, and not zero), and the
    pseudo-positions' dtype."""
    x, variables, ref32, runs = model_run
    out_j, pos_j = runs[use_pallas]
    assert str(out_j.dtype) == "bfloat16" and str(pos_j.dtype) == "bfloat16"
    tm = TModel(**MODEL, use_pallas=use_pallas, use_pallas_erwin=use_pallas,
                dtype=BF, device="cpu").eval()
    load_jax_variables(tm, variables)
    pos_t = []
    hook = tm.blocks[0].Attn.erwin.register_forward_pre_hook(
        lambda m, a: pos_t.append(a[1]))
    with torch.inference_mode():
        out_t = tm(torch.from_numpy(x))
    hook.remove()
    assert out_t.dtype == BF and pos_t[0].dtype == BF
    scale = np.abs(ref32).max()
    d_both = np.abs(_np(out_t) - _np(out_j)).max() / scale
    d_port = np.abs(_np(out_t) - ref32).max() / scale
    d_jax = np.abs(_np(out_j) - ref32).max() / scale
    print(f"PARITY small HAET bf16 use_pallas={use_pallas}: port vs JAX "
          f"{d_both:.3e}; from float32: port {d_port:.3e}, JAX {d_jax:.3e}")
    assert d_both <= MODEL_RTOL
    assert 0 < d_port <= 2 * d_jax


def test_bf16_ball_trees_equal_on_the_same_positions(model_run):
    """The median-split ball tree and the rotated levels' permutations of
    JAX's bf16 pseudo-positions, built by both packages: equal integer for
    integer (bf16 positions tie more often; both sorts are stable). The
    two forwards' own positions differ where their bf16 states do (see the
    module note), so this is the tree's own parity."""
    _, _, _, runs = model_run
    pos = runs[False][1]
    kw = dict(ball_sizes=(16, 8), strides=(2,), rotate_angle=45.0,
              grouping="median")
    want = jbg.build_erwin_perms(pos, **kw)
    got = tbg.build_erwin_perms(_t(_np(pos), True), **kw)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.unperm.numpy(),
                                  np.asarray(want.unperm))
    for a, b in zip(got.rot_perms, want.rot_perms):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_dtypes_at_module_boundaries(slice_data):
    """The dtypes JAX gives each boundary (``jax.eval_shape``), held by the
    port: ``x_proj``, the states, the Erwin block's and deslice's outputs
    and the model's are bf16; ``m``, ``s``, the parameters and their
    gradients float32."""
    d = slice_data
    xj, pj = _j(d["x"], True), [_j(d[k]) for k in PARAMS]
    st, m, s = jax.eval_shape(jsk.slice_states, xj, *pj)
    out = jax.eval_shape(jsk.deslice, xj, *pj, st, m, s)
    xs = jax.ShapeDtypeStruct((8, 32, 32), jnp.bfloat16)
    ps = jax.ShapeDtypeStruct((8, 32, 3), jnp.bfloat16)
    bparams = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(JBlock(32, 8, 32, 4).init, jax.random.PRNGKey(0), xs,
                       ps))["params"]
    blk = jax.eval_shape(
        lambda x, p: jeb.fused_erwin_block(x, p, bparams, ball_size=32,
                                           num_heads=8), xs, ps)
    jm = JModel(**MODEL, dtype=jnp.bfloat16)
    xm = jax.ShapeDtypeStruct((1, 64, 7), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), xm)
    model_out = jax.eval_shape(jm.apply, shapes, xm)
    want = {"states": st.dtype, "m": m.dtype, "out": out.dtype,
            "erwin": blk.dtype, "model": model_out.dtype}

    tm = TModel(**MODEL, dtype=BF, device="cpu", use_pallas=True,
                use_pallas_erwin=True)
    seen = {}

    def dtype_of(key):
        def hook(module, args, out):   # returns None: the output stays
            seen.setdefault(key, out.dtype)
        return hook

    attn = tm.blocks[0].Attn
    attn.in_project_x.register_forward_hook(dtype_of("x_proj"))
    attn.erwin.encoder[0].blocks[0].register_forward_hook(dtype_of("erwin"))
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 64, 7).astype(
        np.float32))
    out = tm(x)
    out.float().square().mean().backward()
    st_t, m_t, s_t = tsk.slice_states(_t(d["x"], True),
                                      *[_t(d[k]) for k in PARAMS])
    out_t = tsk.deslice(_t(d["x"], True), *[_t(d[k]) for k in PARAMS],
                        st_t, m_t, s_t)
    got = {"states": st_t.dtype, "m": m_t.dtype, "out": out_t.dtype,
           "erwin": seen["erwin"], "model": out.dtype}
    assert {k: str(v).replace("torch.", "") for k, v in got.items()} == \
        {k: str(v) for k, v in want.items()}
    assert seen["x_proj"] == BF and s_t.dtype == torch.float32
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in tm.parameters()
            if p.grad is not None} == {torch.float32}
    assert {str(v.dtype) for v in jax.tree_util.tree_leaves(shapes)} == \
        {"float32"}


def test_bf16_dense_and_gelu_against_flax():
    """The port's bf16 Linear rounds as flax's ``nn.Dense(dtype=bf16)``
    (the product rounded, then the bias added and rounded again): equal bit
    for bit. ``gelu`` in bf16 is where the two frameworks part: flax
    computes ``0.5 x erfc(-x / sqrt 2)`` op by op in bf16, torch computes
    gelu in float32 and rounds once. For x >= -1 they differ by at most
    one ulp of each element (in a quarter to a third of them, measured
    here); below, the bf16 rounding of flax's ``erfc`` argument (relative
    2^-9) is amplified by ``erfc``'s slope, up to ~25 % of the (small)
    value at x ~ -3. The root of the small model's bf16 difference."""
    rng = np.random.RandomState(5)
    x = rng.randn(64, 48).astype(np.float32)
    dense = nn.Dense(40, dtype=jnp.bfloat16)
    v = dense.init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(lambda a: a + 0.3 * rng.randn(*a.shape)
                               .astype(np.float32), v)
    want = _np(dense.apply(v, x))
    w = torch.from_numpy(np.asarray(v["params"]["kernel"]).T.copy())
    b = torch.from_numpy(np.asarray(v["params"]["bias"]))
    got = linear(torch.from_numpy(x), w, b, BF)
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), want)
    g_j = _np(nn.gelu(jnp.asarray(want).astype(jnp.bfloat16),
                      approximate=False))
    g_t = _np(torch.nn.functional.gelu(got))
    share = float(np.mean(g_j != g_t))
    print(f"PARITY bf16 gelu: {share:.2%} of the elements differ, by at "
          f"most {np.abs(g_j - g_t).max():.3e}")
    bulk = want >= -1
    err = np.abs(g_j - g_t)
    assert np.all(err[bulk] <= ULP * np.maximum(np.abs(g_j), np.abs(g_t))
                  [bulk])
    assert err.max() <= ULP * np.abs(g_j).max()


@pytest.fixture(scope="module")
def train_run():
    """3 training steps of the small HAET in bf16 with ``mu_bf16`` on the
    JAX side: the losses, and the parameters and first moments after; and
    step 1's gradients of the bf16 model and of the float32 one."""
    rng = np.random.RandomState(0)
    batch = tcar.make_batch(tcar.CarSample(*_sample(N_POINTS)), n_pad=N_PAD)
    template = jax.eval_shape(JModel(**MODEL).init, jax.random.PRNGKey(0),
                              batch["x"])
    variables = init_like(template, rng, MODEL["n_hidden"])
    jm = JModel(**MODEL, dtype=jnp.bfloat16)
    jcfg = JTrainConfig(lr=1e-3, optimizer="adam", final_div_factor=1000.0,
                        batch_size=1, max_grad_norm=1.0, mu_bf16=True)
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from car_train import loss_fn_builder

    jtr = JTrainer(model=jm, loss_fn=loss_fn_builder(0.5), cfg=jcfg,
                   total_steps=10, batch_args=lambda b: (b["x"], None))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtr.tx.init(variables["params"]))
    key = jax.random.PRNGKey(1)
    grads = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("float32", jnp.float32)):
        jtr_g = dataclasses.replace(jtr, model=JModel(**MODEL, dtype=dtype))

        def loss(params, jtr_g=jtr_g):
            out, _ = jtr_g._apply(params, variables["batch_stats"], batch,
                                  True, key)
            return jtr_g.loss_fn(out, batch)[0]
        grads[name] = {k: v.numpy() for k, v in from_jax_variables(
            {"params": jax.device_get(jax.jit(jax.grad(loss))(
                variables["params"]))}).items()}
    losses = []
    for _ in range(3):
        state, metrics = jtr.train_step(state, batch, key)
        losses.append(float(metrics["loss"]))
    mus = [leaf for leaf in jax.tree_util.tree_leaves(state.opt_state)
           if getattr(leaf, "dtype", None) == jnp.bfloat16]
    return batch, variables, losses, state, mus, grads


def test_bf16_training_matches_jax(train_run):
    """3 steps of the small bf16 HAET with ``mu_bf16`` (both kernel flags)
    against JAX's ``Trainer``: the losses within 2e-2 (the bf16 forward's
    difference, module note), every parameter within 2 * (sum of the
    steps' learning rates) of JAX's (an Adam step moves an entry by about
    the rate whatever its gradient), the first moments stored in bf16 on
    both sides."""
    batch, variables, jlosses, state, jmus, _ = train_run
    assert jmus and {str(m.dtype) for m in jmus} == {"bfloat16"}
    tm = TModel(**MODEL, use_pallas=True, use_pallas_erwin=True, dtype=BF,
                device="cpu")
    load_jax_variables(tm, variables)
    cfg = dataclasses.replace(shapenet_car_train_config(), mu_bf16=True)
    trainer = Trainer(tm, tcar.loss_fn_builder(0.5), cfg, 10,
                      batch_args=lambda b: (b["x"], None))
    lrs = []
    for step in range(3):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        m = trainer.train_step(batch)
        print(f"PARITY bf16 training step {step + 1}: loss "
              f"{float(m['loss']):.6f} JAX {jlosses[step]:.6f}")
        np.testing.assert_allclose(float(m["loss"]), jlosses[step],
                                   rtol=MODEL_RTOL)
    assert {st["exp_avg"].dtype for st in trainer.optimizer.state.values()
            } == {BF}
    want = from_jax_variables({"params": jax.device_get(state.params)})
    bound = 2 * sum(lrs)
    worst = 0.0
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32
        err = float(np.abs(p.detach().numpy() - want[name].numpy()).max())
        worst = max(worst, err)
        assert err <= bound, (name, err, bound)
    print(f"PARITY bf16 training: params after 3 steps max_abs_err "
          f"{worst:.3e} (bound {bound:.3e})")


#: step 1's gradients of the bf16 model, the port's against JAX's, each
#: leaf's relative L2 distance (see the test)
GRAD_LEAF_RTOL = 0.15
#: a leaf is held to GRAD_LEAF_RTOL where JAX's own bf16 and float32
#: gradients agree within this
GRAD_WELL_POSED = 0.1


def _grad_gaps(got, want):
    """``(global, {leaf: relative distance})``: the L2 distance of ``got``
    from ``want`` over all leaves and per leaf, relative to ``want``'s."""
    per = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
           for k, w in want.items() if np.linalg.norm(w) > 0}
    total = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                    / sum(np.sum(w ** 2) for w in want.values()))
    return float(total), per


def test_bf16_step1_gradients_match_jax(train_run):
    """Step 1's float32 parameter gradients of the small bf16 HAET (both
    kernel flags, ``mu_bf16``), unclipped from the port's ``Trainer``,
    against ``jax.grad`` of the same loss on JAX's bf16 model: the whole
    model's bf16 backward (the bf16 Dense casts, the float32
    normalisations, the bf16 slice and Erwin chain).

    bf16 rounding moves the gradients about as far as the port is from
    JAX: JAX's bf16 gradients are 6.4e-3 (over all leaves) from its
    float32 ones, the port's bf16 ones 7.6e-3 from JAX's bf16 ones, and
    the port's float32 gradients happen to be as close to JAX's bf16 ones
    (6.4e-3), so no tolerance here could tell the two dtypes apart: the
    port's bf16 gradients are held to be bf16 by their distance from
    JAX's float32 ones, above zero (float32 parity is ~2e-6) and at most
    twice JAX's own (as the forward test holds the outputs). Per leaf:
    where JAX's bf16 and float32 gradients agree within
    ``GRAD_WELL_POSED`` (all but ten leaves: the biases ahead of a
    train-mode BatchNorm and other leaves whose gradient cancels to ~1e-4
    of the largest), the port's within ``GRAD_LEAF_RTOL`` of JAX's bf16
    one (measured worst 7.7e-2, ``ada_temp_linear.bias``, which JAX's own
    bf16 moves 6.8e-2); over all leaves 2e-2 (measured 7.6e-3). Controls
    that must fail the same checks: the largest leaf scaled by 1.2 (a 20 %
    error where bf16 moves it 0.4 %), or the smallest held leaf negated."""
    batch, variables, _, _, _, jgrads = train_run
    tm = TModel(**MODEL, use_pallas=True, use_pallas_erwin=True, dtype=BF,
                device="cpu")
    load_jax_variables(tm, variables)
    cfg = dataclasses.replace(shapenet_car_train_config(), mu_bf16=True)
    trainer = Trainer(tm, tcar.loss_fn_builder(0.5), cfg, 10,
                      batch_args=lambda b: (b["x"], None))
    m = trainer.train_step(batch)
    coef = min(1.0, cfg.max_grad_norm / (float(m["grad_norm"]) + 1e-6))
    got = {k: p.grad.numpy() / coef for k, p in tm.named_parameters()
           if p.grad is not None}
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters()
               if p.grad is not None)
    jb, jf = jgrads["bf16"], jgrads["float32"]
    assert set(got) == {k for k, v in jb.items() if v.any()}
    jb = {k: jb[k] for k in got}
    jax_own, jax_per = _grad_gaps(jf, jb)
    held = sorted(k for k, v in jax_per.items() if v <= GRAD_WELL_POSED)
    assert len(held) >= len(jb) - 10, sorted(set(jb) - set(held))

    def gaps(g):
        total, per = _grad_gaps(g, jb)
        return total, max(per[k] for k in held), max(held, key=per.get)

    total, worst, leaf = gaps(got)
    from_f32 = _grad_gaps(got, {k: jf[k] for k in got})[0]
    print(f"PARITY bf16 step-1 grads: port vs JAX {total:.3e} (worst held "
          f"leaf {worst:.3e}, {leaf}; {len(held)} of {len(jb)} held); "
          f"from JAX float32: port {from_f32:.3e}, JAX {jax_own:.3e}")
    assert total <= 2e-2 and worst <= GRAD_LEAF_RTOL
    assert 1e-4 < from_f32 <= 2 * jax_own
    by_size = sorted(held, key=lambda k: np.linalg.norm(jb[k]))
    for ctrl, k in ((1.2, by_size[-1]), (-1.0, by_size[0])):
        t, w, _ = gaps({**got, k: ctrl * got[k]})
        print(f"PARITY control: {k} times {ctrl}: worst held leaf {w:.3e}")
        assert w > GRAD_LEAF_RTOL or t > 2e-2


def test_adam_mu_bf16_matches_optax():
    """The port's ``Adam(mu_dtype=bf16)`` against ``optax.adam(mu_dtype=
    bfloat16)`` with its rates injected as arrays, as the JAX trainer builds
    it (``haet_tpu/train/trainer.py:234-237``), on fixed gradients over 4
    steps: the stored bf16 first moments equal bit for bit, the parameters
    within 1e-6 of their max (the bias corrections are rounded in another
    order). (With a Python-float ``b1``, optax would take ``b1 * mu`` in
    bf16, a weakly typed product; an injected ``b1`` is float32.)"""
    rng = np.random.RandomState(7)
    init = {"a": rng.randn(5, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in init.items()} for _ in range(4)]
    tx = optax.inject_hyperparams(optax.adam, static_args=("mu_dtype",))(
        learning_rate=1e-3, b1=0.9, mu_dtype=jnp.bfloat16)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
          for k in init]
    opt = Adam(tp, lr=1e-3, mu_dtype=BF)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        for p, k in zip(tp, init):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for p, k in zip(tp, init):
        want = np.asarray(params[k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        mu = opt.state[p]["exp_avg"]
        assert mu.dtype == BF
        np.testing.assert_array_equal(_np(mu),
                                      _np(state.inner_state[0].mu[k]))


def test_bf16_checkpoint_round_trip(tmp_path):
    """A ``mu_bf16`` trainer's checkpoint: restored in place (every state
    tensor keeps its storage and dtype, the bf16 moments too) and read by
    ``restore_raw`` as numpy, the bf16 moments as their exact float32
    widening."""
    tm = TModel(**MODEL, dtype=BF, device="cpu")
    cfg = dataclasses.replace(shapenet_car_train_config(), mu_bf16=True)
    batch = tcar.make_batch(tcar.CarSample(*_sample(N_POINTS)), n_pad=N_PAD)
    trainer = Trainer(tm, tcar.loss_fn_builder(0.5), cfg, 10,
                      batch_args=lambda b: (b["x"], None))
    trainer.train_step(batch)
    ck = Checkpointer(str(tmp_path))
    ck.save_last(trainer.state_dict(), 0)
    saved = {i: {k: v.clone() for k, v in st.items()}
             for i, st in enumerate(trainer.optimizer.state.values())}
    trainer.train_step(batch)
    tensors = [t for st in trainer.optimizer.state.values()
               for t in st.values()]
    ptrs = [t.data_ptr() for t in tensors]
    assert trainer.maybe_restore(ck)
    assert ptrs == [t.data_ptr() for st in trainer.optimizer.state.values()
                    for t in st.values()]
    for i, st in enumerate(trainer.optimizer.state.values()):
        assert st["exp_avg"].dtype == BF
        for k, v in st.items():
            assert torch.equal(v, saved[i][k]), (i, k)
    raw = ck.restore_raw("last")
    for i, st in raw["optimizer"]["state"].items():
        assert st["exp_avg"].dtype == np.float32
        np.testing.assert_array_equal(st["exp_avg"],
                                      saved[i]["exp_avg"].float().numpy())


def test_bf16_host_outputs_are_exact(tmp_path):
    """The server's (over the bf16 model's exported program) and
    ``car.predict``'s host outputs of a bf16 model: float32 arrays equal to
    the model's bf16 output value for value."""
    tm = TModel(**MODEL, dtype=BF, device="cpu").eval()
    rng = np.random.RandomState(9)
    x = rng.randn(N_PAD, 7).astype(np.float32)
    with torch.inference_mode():
        direct = tm(torch.from_numpy(x[None]))
    assert direct.dtype == BF
    export_batch_family(str(tmp_path), tm, None, (x[None], None),
                        batch_sizes=(1,))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    with BatchingServer(bundle, tm.state_dict(), device="cpu") as srv:
        served = srv.predict(x, None, timeout=120)
    assert served.dtype == np.float32
    np.testing.assert_array_equal(served, direct[0].float().numpy())
    pred = tcar.predict(tm, {"x": x[None]})
    assert pred.dtype == np.float32
    np.testing.assert_array_equal(pred, direct.float().numpy())
    assert env.host_numpy(torch.tensor([1.0, 2.5], dtype=BF)).dtype == \
        np.float32


def test_bf16_kernel_names_map_to_the_port():
    """The profiler's names of the bf16 instantiations map to the port's
    kernels as the float32 ones do (the fused backward's kind is its last
    template argument), so a replay's calls count the same."""
    names = (
        "void slice_states_fast<32, 32, __nv_bfloat16>(__nv_bfloat16 const*)",
        "void erwin_block_fwd<true, __nv_bfloat16>(__nv_bfloat16 const*)",
        "void deslice_fast<32, 32, 32, __nv_bfloat16>(__nv_bfloat16 const*)",
        "void slice_bwd_fused<__nv_bfloat16, 32, false>(BwdArgs)",
        "void slice_bwd_fused<__nv_bfloat16, 32, true>(BwdArgs)",
        "void erwin_block_bwd<true, __nv_bfloat16>(__nv_bfloat16 const*)",
        "erwin_block_sum_partials(float const*, float*, int, int)")
    got = count_kernels(names)
    assert got["calls"] == {
        "slice_states": 1, "deslice": 1, "slice_states_bwd": 1,
        "deslice_bwd": 1, "fused_erwin_block": 1,
        "fused_erwin_block_bwd": 1, "copy_scale": 0}
    assert got["launches"]["slice_states_bwd"] == 1
    assert got["launches"]["deslice_bwd"] == 1
    assert got["other"] == 0 and len(got["names"]) == 7


def test_precision_policy_keeps_bf16_products_in_float32():
    """The policy that every entry point applies: no TF32, and bf16
    products reduced in float32 (as XLA's bf16 dots)."""
    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            True
        env.default_device("cpu")
        assert not torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            before
