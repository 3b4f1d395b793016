"""PyTorch port, gradients vs the JAX package.

The same numpy inputs, weights and output gradients go through ``jax.grad``
of ``haet_tpu``'s Pallas kernels (interpret mode, their ``custom_vjp``
backwards) and through the port's autograd on the CPU:

* ``SliceStatesFn`` / ``DesliceFn``, whose backwards ``slice_states_bwd`` /
  ``deslice_bwd`` are the code the card runs too. N = 100 with a backward
  chunk of 32 points (four chunks, the last one ragged) and with one chunk.
  Tolerance: each gradient within 1e-4 of its max |JAX gradient| (float32,
  sums over N in another order and grouping). The two bias gradients are
  held to 1e-4 of their weight's max |gradient| instead: each sums the
  weight gradient's per-point terms without the factor x ~ N(0, 1), and
  those cancel (sum_n dL/dlogit = 0 at a constant temperature), so their
  float32 error follows the terms, not the small sum (measured 8e-4 of
  max |db_slice| against JAX).
* the Erwin block in the four cases of ``test_block_matches_jax``, both
  ``use_pallas`` settings (on the CPU both run the plain block; on CUDA the
  backward kernel, held against the same plain version by
  ``chip_smoke.py``). Tolerance: 2e-5 of each gradient's max |JAX gradient|
  (float32 through one block, as the forward's).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.models.erwin import ErwinTransformerBlock as TBlock
from haet_torch.ops.kernels import erwin_block as teb
from haet_torch.ops.kernels import slice_kernels as tsk
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models.erwin import ErwinTransformerBlock as JBlock
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk

B, H, N, C, G = 1, 2, 100, 16, 8
SLICE_RTOL = 1e-4
BLOCK_RTOL = 2e-5
SLICE_ARGS = ("x", "ws", "bs", "wa", "ba")
#: a bias gradient is held against its weight gradient's scale
SCALE_OF = {"bs": "ws", "ba": "wa"}


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET = jeb.INTERPRET = False
    torch.set_num_threads(threads)


def _close(name, got, want, rtol, scale=None):
    """``max |got - want| <= rtol * scale`` with ``scale`` max |want| by
    default; the measured error is printed (shown with ``pytest -s``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() if scale is None else scale
    print(f"PARITY {name}: max_abs_err {err:.3e} max|ref| "
          f"{np.abs(want).max():.3e}")
    assert err <= rtol * scale, (name, err, scale)


def _slice_close(tag, got, want):
    """The six slice gradients (``SLICE_ARGS`` and the states)."""
    got = dict(zip((*SLICE_ARGS, "states"), (np.asarray(g) for g in got)))
    want = dict(zip((*SLICE_ARGS, "states"), (np.asarray(w) for w in want)))
    for name in got:
        scale = np.abs(want[SCALE_OF.get(name, name)]).max()
        _close(f"{tag} d{name}", got[name], want[name], SLICE_RTOL, scale)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return dict(
        x=rng.randn(B, H, N, C).astype(np.float32),
        ws=rng.randn(C, G).astype(np.float32),
        bs=rng.randn(G).astype(np.float32),
        # raw Ada-Temp values on both sides of the +-0.4 clip
        wa=(0.3 * rng.randn(C, 1)).astype(np.float32),
        ba=(0.1 * rng.randn(1)).astype(np.float32),
        st=rng.randn(B, H, G, C).astype(np.float32),
        g_states=rng.randn(B, H, G, C).astype(np.float32),
        g_out=rng.randn(B, H, N, C).astype(np.float32),
    )


def _jax_grads(d):
    """``jax.grad`` of ``<states, g_states> + <deslice(st), g_out>`` through
    the Pallas kernels (tile 32: four tiles over N)."""
    def loss(x, ws, bs, wa, ba, st):
        states, m, s = jsk.slice_states(x, ws, bs, wa, ba, 0.5, 1e-6, 32)
        out = jsk.deslice(x, ws, bs, wa, ba, st, m, s, 0.5, 1e-6, 32)
        return (jnp.sum(states * d["g_states"])
                + jnp.sum(out * d["g_out"]))
    args = [jnp.asarray(d[k]) for k in (*SLICE_ARGS, "st")]
    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)


def _torch_grads(d, slice_states, deslice):
    leaves = [torch.from_numpy(d[k]).requires_grad_()
              for k in (*SLICE_ARGS, "st")]
    states, m, s = slice_states(*leaves[:5])
    out = deslice(*leaves[:5], leaves[5], m, s)
    loss = ((states * torch.from_numpy(d["g_states"])).sum()
            + (out * torch.from_numpy(d["g_out"])).sum())
    return torch.autograd.grad(loss, leaves)


@pytest.fixture(scope="module")
def jax_slice_grads(data):
    return _jax_grads(data)


@pytest.mark.parametrize("chunk", [32, 1 << 16])
def test_slice_autograd_matches_jax(data, jax_slice_grads, chunk,
                                    monkeypatch):
    """``SliceStatesFn`` and ``DesliceFn`` gradients for every input against
    the JAX ``custom_vjp`` backwards; with a 32-point chunk N = 100 runs
    four chunks, the last of 4 points."""
    monkeypatch.setattr(tsk, "BWD_CHUNK", chunk)
    got = _torch_grads(data, tsk.slice_states, tsk.deslice)
    _slice_close(f"slice grads chunk {chunk}", got, jax_slice_grads)


def test_slice_autograd_matches_plain_autograd(data, monkeypatch):
    """The same gradients against autograd of the plain versions, where
    ``m`` and ``s`` carry their own graph: the closed-form coupling of
    ``slice_states_bwd`` and the two passes of ``deslice_bwd`` equal the
    softmax's own derivative."""
    monkeypatch.setattr(tsk, "BWD_CHUNK", 32)
    got = _torch_grads(data, tsk.slice_states, tsk.deslice)
    want = _torch_grads(data, tsk.slice_states_plain, tsk.deslice_plain)
    _slice_close("slice grads vs plain", got, want)


def test_slice_bwd_functions_direct(data, monkeypatch):
    """``slice_states_bwd`` / ``deslice_bwd`` called on the residuals give
    what the autograd functions give (to float32 round-off: the autograd
    side works on copies, and a CPU matmul's rounding depends on where its
    buffers lie), and ``m``, ``s`` get no gradient."""
    monkeypatch.setattr(tsk, "BWD_CHUNK", 32)
    x, ws, bs, wa, ba, st = (torch.from_numpy(data[k])
                             for k in (*SLICE_ARGS, "st"))
    g_st = torch.from_numpy(data["g_states"])
    g_out = torch.from_numpy(data["g_out"])
    states, m, s = tsk.slice_states(x, ws, bs, wa, ba)
    assert not m.requires_grad and not s.requires_grad
    d_ss = tsk.slice_states_bwd(x, ws, bs, wa, ba, states, m, s, g_st)
    d_ds = tsk.deslice_bwd(x, ws, bs, wa, ba, st, m, s, g_out)
    leaves = [t.clone().requires_grad_() for t in (x, ws, bs, wa, ba, st)]
    s2, m2, ss2 = tsk.slice_states(*leaves[:5])
    assert m2.grad_fn is None and ss2.grad_fn is None
    auto_ss = torch.autograd.grad(s2, leaves[:5], g_st)
    out = tsk.deslice(*leaves[:5], leaves[5], m2, ss2)
    auto_ds = torch.autograd.grad(out, leaves, g_out)
    _slice_close("slice_states_bwd direct", d_ss + (st,), auto_ss + (st,))
    _slice_close("deslice_bwd direct", d_ds, auto_ds)


def _mk(b, n, c, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            rng.rand(b, n, d).astype(np.float32),
            rng.randn(b, n, c).astype(np.float32))


@pytest.mark.parametrize("n,c,ball,heads,use_dist_bias", [
    (32, 32, 32, 4, True),    # full-ball level (car level 0 width)
    (32, 32, 16, 8, True),    # two balls per cloud
    (32, 32, 8, 2, False),    # flash-parity mode, many balls
    (16, 64, 16, 8, True),    # the car's bottleneck block
])
def test_block_grads_match_jax(n, c, ball, heads, use_dist_bias):
    """dx, dpos and every parameter gradient of one Erwin block against
    ``jax.grad`` through the fused Pallas block (its ``_bwd_kernel``);
    ``sigma_att`` gets no gradient in the port (JAX: exact zeros)."""
    x, pos, dout = _mk(8, n, c, 3)
    kw = dict(dim=c, num_heads=heads, ball_size=ball, mlp_ratio=4,
              dimensionality=3, use_dist_bias=use_dist_bias)
    variables = jax.jit(JBlock(**kw).init)(jax.random.PRNGKey(1), x, pos)
    fused = JBlock(use_pallas=True, **kw)

    def loss(params, x, pos):
        return jnp.sum(fused.apply({"params": params}, x, pos) * dout)

    gp, gx, gpos = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        variables["params"], x, pos)
    want = from_jax_variables({"params": jax.device_get(gp)})
    if use_dist_bias:
        assert not np.asarray(want.pop("BMSA.sigma_att")).any()
    assert sorted(want) == sorted(teb.GRAD_NAMES)
    tag = f"block n{n} c{c} ball{ball} h{heads} bias{int(use_dist_bias)}"

    for use_pallas in (False, True):
        blk = TBlock(c, heads, ball, 4, 3, use_dist_bias, use_pallas)
        load_jax_variables(blk, jax.device_get(variables))
        xt = torch.from_numpy(x).requires_grad_()
        pt = torch.from_numpy(pos).requires_grad_()
        blk(xt, pt).backward(torch.from_numpy(dout))
        _close(f"{tag} use_pallas={use_pallas} dx", xt.grad, gx, BLOCK_RTOL)
        _close(f"{tag} use_pallas={use_pallas} dpos", pt.grad, gpos,
               BLOCK_RTOL)
        for name, p in blk.named_parameters():
            if name == "BMSA.sigma_att":
                assert p.grad is None
                continue
            _close(f"{tag} use_pallas={use_pallas} d{name}", p.grad,
                   want[name].numpy(), BLOCK_RTOL)

    # the backward wrapper's CPU route (its plain version) gives the same
    dx, dpos, grads = teb.fused_erwin_block_bwd(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(dout),
        dict(blk.named_parameters()), ball_size=ball, num_heads=heads,
        use_dist_bias=use_dist_bias)
    torch.testing.assert_close(dx, xt.grad)
    torch.testing.assert_close(dpos, pt.grad)
    for name, p in blk.named_parameters():
        if name != "BMSA.sigma_att":
            torch.testing.assert_close(grads[name], p.grad)


@pytest.mark.parametrize("n,c,ball", [(32, 32, 32), (16, 64, 16),
                                      (128, 32, 32), (64, 64, 16)])
def test_bwd_layout(n, c, ball):
    """The backward's buffers fit in one CTA's shared memory at the car
    shapes; at the largest clouds the one-CTA gate admitted, what does not fit
    goes to the global scratch while the buffers the ranks exchange stay in
    shared memory, and no two buffers of one space overlap."""
    hidden, heads = 4 * c, 8
    assert teb.eligible(n, c, heads, c, hidden)
    layout = teb.bwd_layout(n, c, 3, hidden, heads, ball)
    nbuf = len(teb.BWD_BUFFERS)
    offs, flags = layout.ints[:nbuf], layout.ints[nbuf:2 * nbuf]
    assert layout.ints[2 * nbuf] == layout.scratch
    assert len(layout.ints) == 2 * nbuf + 1
    assert layout.smem <= teb.MAX_SMEM_BYTES
    floats = teb._buffer_floats(n, c, 3, hidden, heads, ball)
    sizes = [floats[name] for name, _ in teb.BWD_BUFFERS]
    kinds = [kind for _, kind in teb.BWD_BUFFERS]
    for space, total in ((1, layout.smem // 4), (0, layout.scratch)):
        spans = sorted((o, o + s) for o, s, f, k in
                       zip(offs, sizes, flags, kinds)
                       if f == space and not (space == 0 and k == "weight"))
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(end <= total for _, end in spans)
    car = n * c in (32 * 32, 16 * 64)
    assert (layout.scratch == 0) == car
    assert all(f for f, k in zip(flags, kinds) if k != "local")


def test_param_grad_sizes():
    """The partials' length P is the sum of the gradient sizes in
    ``GRAD_NAMES`` order (the C entry point checks the same count)."""
    c, d, hidden = 32, 3, 128
    shapes = teb.param_shapes(c, d, 8, hidden)
    sizes = [math.prod(shapes[k]) for k in teb.GRAD_NAMES]
    assert sum(sizes) == (c + c * d + c + 3 * c * c + 3 * c + c * c + c + c
                          + 3 * hidden * c + 2 * hidden + c)
    assert len(teb.GRAD_NAMES) == 14 and "BMSA.sigma_att" not in \
        teb.GRAD_NAMES
