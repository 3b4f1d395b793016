"""PyTorch port, Erwin block / Erwin stage / ball groups vs the JAX package.

The same numpy inputs and the JAX init weights (carried over with
``haet_torch.utils.weights``) go through ``haet_tpu`` (the fused Pallas block
in interpret mode, and the XLA block) and through ``haet_torch`` on the CPU,
where the fused wrapper runs its plain version. Block tolerances are those
of ``tests/test_pallas_erwin_block.py`` (rtol/atol 2e-5); the whole Erwin
stage keeps its 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.models.erwin import ErwinTransformer as TErwin
from haet_torch.models.erwin import ErwinTransformerBlock as TBlock
from haet_torch.ops import ball_groups as tbg
from haet_torch.ops.kernels import erwin_block as teb
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models.erwin import ErwinTransformer as JErwin
from haet_tpu.models.erwin import ErwinTransformerBlock as JBlock
from haet_tpu.ops import ball_groups as jbg
from haet_tpu.ops.pallas import erwin_block as jeb


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jeb.INTERPRET = False
    torch.set_num_threads(threads)


def _report(name, got, want):
    """Print the measured parity error (shown with ``pytest -s``)."""
    print(f"PARITY {name}: max_abs_err {np.abs(got - want).max():.3e} "
          f"max|ref| {np.abs(want).max():.3e}")


def _mk(b, n, c, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            rng.rand(b, n, d).astype(np.float32))


@pytest.mark.parametrize("n,c,ball,heads,use_dist_bias", [
    (32, 32, 32, 4, True),    # full-ball level (car level 0 width)
    (32, 32, 16, 8, True),    # two balls per cloud
    (32, 32, 8, 2, False),    # flash-parity mode, many balls
    (16, 64, 16, 8, True),    # the car's bottleneck block
])
def test_block_matches_jax(n, c, ball, heads, use_dist_bias):
    x, pos = _mk(8, n, c, 3)
    kw = dict(dim=c, num_heads=heads, ball_size=ball, mlp_ratio=4,
              dimensionality=3, use_dist_bias=use_dist_bias)
    variables = jax.jit(JBlock(**kw).init)(jax.random.PRNGKey(1), x, pos)
    ref = np.asarray(JBlock(**kw).apply(variables, x, pos))
    fused = np.asarray(JBlock(use_pallas=True, **kw).apply(variables, x, pos))
    np.testing.assert_allclose(fused, ref, rtol=2e-5, atol=2e-5)

    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    for use_pallas in (False, True):
        blk = TBlock(c, heads, ball, 4, 3, use_dist_bias, use_pallas)
        load_jax_variables(blk, jax.device_get(variables))
        with torch.no_grad():
            out = blk(xt, pt).numpy()
        _report(f"erwin block n{n} c{c} ball{ball} h{heads} "
                f"bias{int(use_dist_bias)} use_pallas={use_pallas} vs "
                "pallas", out, fused)
        np.testing.assert_allclose(out, fused, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    params = dict(blk.named_parameters())
    plain = teb.erwin_block_plain(xt, pt, params, ball_size=ball,
                                  num_heads=heads,
                                  use_dist_bias=use_dist_bias)
    np.testing.assert_allclose(plain.detach().numpy(), fused, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("c,hidden,edge", [(32, 128, 512), (64, 256, 512)])
def test_eligible_at_its_edge(c, hidden, edge):
    """The gate is the JAX gate (n a power of two up to 512): at its edge
    both kernels' per-CTA layouts still fit in 227 KB of shared memory, the
    rest in their global scratch."""
    for layout in (teb.fwd_layout(edge, c, 3, hidden, 8, 32),
                   teb.bwd_layout(edge, c, 3, hidden, 8, 32)):
        assert layout.smem <= teb.MAX_SMEM_BYTES
        assert layout.scratch > 0
    assert jeb.eligible(edge, c, 8, c) and not jeb.eligible(2 * edge, c, 8, c)
    assert teb.eligible(edge, c, 8, c, hidden)
    assert not teb.eligible(2 * edge, c, 8, c, hidden)
    assert not teb.eligible(edge - 1, c, 8, c, hidden)      # not a power of 2
    assert not teb.eligible(edge, c, 8, c + 8, hidden)      # c != dim
    assert not teb.eligible(edge, c, 7, c, hidden)          # heads ∤ c


def test_block_routes_outside_gate_to_plain():
    """A cloud beyond the gate takes the plain block at the module level
    (as JAX routes to XLA) instead of reaching the kernel, and the plain
    route counter shows it; a cloud inside the gate does not count."""
    blk = TBlock(32, 4, 32, 4, 3, True, use_pallas=True)
    with torch.no_grad():
        blk.BMSA.sigma_att.fill_(-1.0)
    x, pos = _mk(1, 1024, 32, 3)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    assert not blk.fused_ok(xt, pt)
    teb.PLAIN_ROUTES.reset()
    with torch.no_grad():
        out = blk(xt, pt)
        assert teb.PLAIN_ROUTES.value == 1
        blk(xt[:, :128], pt[:, :128])
        assert teb.PLAIN_ROUTES.value == 1
        blk.use_pallas = False
        np.testing.assert_array_equal(out.numpy(), blk(xt, pt).numpy())
    assert teb.PLAIN_ROUTES.value == 1


def _prefixed(variables, prefix="erwin"):
    return {col: {prefix: tree} for col, tree in variables.items()}


def test_erwin_stage_matches_jax():
    """A whole ErwinTransformer with rotation on non-full-ball levels,
    pooling/unpooling BatchNorm in eval, fused blocks on and off."""
    kw = dict(c_in=16, c_hidden=(16, 32), ball_sizes=(16, 8),
              enc_num_heads=(2, 4), enc_depths=(2, 2), dec_num_heads=(2,),
              dec_depths=(2,), strides=(2,), rotate=45, mp_steps=0,
              embed=True, dimensionality=3)
    x, pos = _mk(2, 64, 16, 3, seed=5)
    jm = JErwin(**kw)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), x,
                                                pos))
    rng = np.random.RandomState(7)
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.rand(*a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = np.asarray(jax.jit(jm.apply)(variables, x, pos))
    sd = {k[len("erwin."):]: v
          for k, v in from_jax_variables(_prefixed(variables)).items()}
    for use_pallas in (False, True):
        tm = TErwin(**kw, use_pallas_blocks=use_pallas).eval()
        tm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out = tm(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
        _report(f"erwin stage use_pallas={use_pallas}", out, ref)
        np.testing.assert_allclose(out, ref, rtol=5e-5, atol=5e-5)


def _assert_perms_equal(pt, pj):
    np.testing.assert_array_equal(pt.perm.numpy(), np.asarray(pj.perm))
    np.testing.assert_array_equal(pt.unperm.numpy(), np.asarray(pj.unperm))
    assert len(pt.rot_perms) == len(pj.rot_perms)
    for a, b in zip(pt.rot_perms + pt.rot_inv_perms,
                    pj.rot_perms + pj.rot_inv_perms):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["random", "tied", "padded_G24"])
def test_ball_perms_integer_equal(case):
    rng = np.random.RandomState(11)
    mask = None
    if case == "random":
        pos = rng.rand(3, 64, 3).astype(np.float32)
    elif case == "tied":
        # coordinates on a coarse grid: many exactly tied sort keys
        pos = (rng.randint(0, 3, (3, 64, 3)) / 2.0).astype(np.float32)
    else:
        # a non-power-of-two slice count padded like physics attention
        g = 24
        feat = rng.rand(3, g, 3).astype(np.float32)
        _, pos_j, mask_j = jbg.pad_pow2(jnp.zeros((3, g, 4)),
                                        jnp.asarray(feat))
        _, pos_t, mask_t = tbg.pad_pow2(torch.zeros(3, g, 4),
                                        torch.from_numpy(feat))
        np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
        pos, mask = np.array(pos_j), np.array(mask_j)  # writable copies
    kw = dict(ball_sizes=(16, 8), strides=(2,), rotate_angle=45.0)
    pj = jbg.build_erwin_perms(jnp.asarray(pos), mask=None if mask is None
                               else jnp.asarray(mask), **kw)
    ptt = tbg.build_erwin_perms(torch.from_numpy(pos), mask=None
                                if mask is None else torch.from_numpy(mask),
                                **kw)
    assert ptt.rot_perms[0] is not None  # the rotated path is exercised
    _assert_perms_equal(ptt, pj)


def test_car_shapes_build_no_rotation_perms():
    """Every car level is one full ball: no rotation perm is built, the
    median perm still orders the stride-2 pooling pairs."""
    rng = np.random.RandomState(3)
    pos = rng.rand(8, 32, 3).astype(np.float32)
    kw = dict(ball_sizes=(32, 16), strides=(2,), rotate_angle=45.0)
    ptt = tbg.build_erwin_perms(torch.from_numpy(pos), **kw)
    _assert_perms_equal(ptt, jbg.build_erwin_perms(jnp.asarray(pos), **kw))
    assert ptt.rot_perms == [None, None]
    assert not torch.equal(ptt.perm[0], torch.arange(32))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_rotation_matrix_matches(dim):
    np.testing.assert_array_equal(tbg.rotation_matrix(45.0, dim).numpy(),
                                  np.asarray(jbg.rotation_matrix(45.0, dim)))


def test_effective_ball_size_and_invert():
    for bs, n in [(32, 32), (16, 32), (32, 16), (24, 64), (1, 8)]:
        assert tbg.effective_ball_size(bs, n) == jbg.effective_ball_size(bs,
                                                                         n)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(16))[None]
    inv = tbg.invert_perm(perm)
    np.testing.assert_array_equal(torch.gather(perm, 1, inv).numpy()[0],
                                  np.arange(16))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="morton"):
        tbg.build_erwin_perms(torch.rand(1, 8, 3), ball_sizes=(4,),
                              strides=(), grouping="morton")
    kw = dict(c_in=8, c_hidden=(8, 16), ball_sizes=(8, 4),
              enc_num_heads=(2, 2), enc_depths=(1, 1), dec_num_heads=(2,),
              dec_depths=(1,), strides=(2,))
    with pytest.raises(NotImplementedError, match="morton"):
        TErwin(**kw, mp_steps=0, grouping="morton")
    with pytest.raises(NotImplementedError, match="MPNN"):
        TErwin(**kw, mp_steps=3, embed=True)
