"""PyTorch port, the parallel layer: the mesh, head TP, the point axis.

One gloo group of four CPU ranks (spawned once for the module, one thread
each, importing only the port) runs every case of this file
(:func:`_rank_cases`) and returns numpy results; each test then asserts
its own case. The ranks' tiny model is the JAX tensor-parallel test's
(``tests/test_tensor_parallel.py``: 2 blocks, n_hidden 32, 4 heads, G 16),
with one input feature, on a batch of 4 samples of 64 points, from numpy
weights crossed over by ``haet_torch/utils/weights.py``.

References, both single-device:

* the JAX model, train-mode forward and ``jax.grad`` of ``mean((out -
  y)^2)`` (three ``jax.jit`` programs in all, no JAX mesh: JAX's own tests
  hold its mesh runs to these within rtol 1e-5 / atol 1e-6). The port
  against JAX: the output within ``RTOL`` (1e-4) of max |out|, as
  ``tests/test_torch_model.py``; gradients leaf by leaf within 1e-3 of the
  leaf's max |gradient| or 1e-5 of the largest, and the BatchNorm running
  statistics at rtol 1e-5, as ``tests/test_torch_train.py``;
* the port on one rank (no mesh), in this process: the mesh runs within
  ``MESH_RTOL`` (rtol 1e-5, atol 1e-6 of the largest |value|), every rank
  bitwise equal to the others.
"""

import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from haet_torch import parallel
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.models import HAETransolverStructuredMesh2D as TModel2D
from haet_torch.models import HAETransolverStructuredMesh3D as TModel3D
from haet_torch.models import physics_attention as tpa

WORLD = 4
MODEL = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=2, n_hidden=32,
             n_head=4, slice_num=16, mlp_ratio=2, rotate=45)
MODEL_2D = dict(space_dim=2, fun_dim=1, out_dim=1, n_layers=1, n_hidden=32,
                n_head=4, slice_num=16, mlp_ratio=1, rotate=0, H=16, W=16)
MODEL_3D = dict(space_dim=3, fun_dim=1, out_dim=1, n_layers=1, n_hidden=32,
                n_head=4, slice_num=16, mlp_ratio=1, rotate=0, H=4, W=4,
                D=4)
B, N = 4, 64
RTOL = 1e-4
MESH_RTOL = 1e-5


# -- the rank group ------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank, world, port, payload, queue):
    torch.set_num_threads(1)
    parallel.init_distributed(f"127.0.0.1:{port}", world, rank,
                              device="cpu")
    try:
        queue.put((rank, target(rank, payload)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(target, payload, world: int = WORLD,
                timeout: float = 240.0):
    """Start ``world`` spawned gloo CPU ranks running ``target(rank,
    payload)`` (``target`` a module-level function of a module that imports
    no JAX); returns a function that waits for them and returns ``{rank:
    result}``, so that the caller works meanwhile."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, port, payload, queue))
             for r in range(world)]
    for p in procs:
        p.start()

    def collect() -> dict:
        try:
            out = dict(queue.get(timeout=timeout) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        errors = [v["error"] for v in out.values() if "error" in v]
        assert not errors, errors[0]
        return out

    return collect


def run_cases(cases: dict, rank: int, payload) -> dict:
    """Each case's result, or its traceback (the case's test fails)."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn(rank, payload)
        except Exception:
            out[name] = {"failed": traceback.format_exc()}
    return out


def case_result(ranks: dict, name: str, same: bool = True) -> dict:
    """Rank 0's result of case ``name``; raises with any rank's traceback,
    and with ``same`` checks that every rank returned the same arrays bit
    for bit."""
    for r in sorted(ranks):
        res = ranks[r][name]
        assert "failed" not in res, f"rank {r}:\n{res['failed']}"
    first = ranks[0][name]

    def equal(a, b, path):
        if isinstance(b, dict):
            for k in b:
                equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)

    for r in (sorted(ranks)[1:] if same else ()):
        equal(ranks[r][name], first, f"rank {r} {name}")
    return first


def assert_mesh_close(got, want, what=""):
    """The mesh run against the one-rank run: ``MESH_RTOL``, atol 1e-6 of
    the largest |want|."""
    if isinstance(want, dict):
        scale = max(float(np.abs(v).max()) for v in want.values())
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=MESH_RTOL,
                                       atol=1e-6 * scale,
                                       err_msg=f"{what} {k}")
        return
    np.testing.assert_allclose(got, want, rtol=MESH_RTOL,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


# -- what each rank and the one-rank reference run -----------------------

def batch(n_batch=B, n_points=N, space_dim=3, out_dim=2, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(n_batch, n_points, d),
                              dtype=torch.float32)
                 for d in (space_dim, 1, out_dim))


def build(state, cls=TModel, kw=MODEL, **extra):
    m = cls(**kw, device="cpu", **extra)
    m.load_state_dict(state)
    return m


def train_run(model, x, fx, y, mesh=None):
    """A train-mode forward and ``mean((out - y)^2)``'s gradients (summed
    over the mesh as the trainer sums them): ``{"out", "grads", "stats"}``
    as numpy."""
    if mesh is not None:
        parallel.bind_mesh(model, mesh)
    model.train()
    out = model(x, fx)
    loss = ((out - y) ** 2).mean()
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    live = [(k, p, g) for (k, p), g in zip(named, grads) if g is not None]
    flat = torch.cat([g.reshape(-1) for _, _, g in live])
    if mesh is not None:
        parallel.reduce_gradients(
            flat, mesh, mesh.layout(x.shape[0], x.shape[1]),
            parallel.tp_ranges([p for _, p, _ in live],
                               parallel.tp_partial_parameters(model)))
    parts = flat.split([g.numel() for _, _, g in live])
    return {"out": out.detach().numpy(),
            "grads": {k: t.view_as(g).numpy()
                      for (k, _, g), t in zip(live, parts)},
            "stats": {k: v.numpy().copy() for k, v in
                      model.state_dict().items() if "running" in k
                      or "num_batches" in k}}


def _mesh_case(n_dp, n2, axis="tp", shard=None, **model_kw):
    def case(rank, payload):
        mesh = parallel.make_mesh(n_dp, n2, axis)
        m = build(payload["state"], shard_axes=shard, **model_kw)
        return train_run(m, *batch(), mesh=mesh)
    return case


def _case_2d(rank, payload):
    mesh = parallel.make_mesh(2, 2)
    m = build(payload["state_2d"], TModel2D, MODEL_2D,
              shard_axes=("dp", "tp"))
    x, fx, y = batch(B, 256, 2, 1, seed=1)
    return train_run(m, x, fx, y, mesh)


def _case_3d(rank, payload):
    mesh = parallel.make_mesh(1, 4)
    m = build(payload["state_3d"], TModel3D, MODEL_3D,
              shard_axes=("dp", "tp"))
    return train_run(m, *batch(2, 64, 3, 1, seed=2), mesh=mesh)


class _Spy:
    """Counts calls of the slice kernels' wrapper."""

    def __init__(self):
        self.calls = 0
        self.real = tpa.sk.slice_states

    def __call__(self, *a, **k):
        self.calls += 1
        return self.real(*a, **k)


def _routes(rank, payload):
    """The routes of a model with ``shard_axes`` under meshes that divide
    the heads or not, with ``"auto"`` taking the kernels on the CPU (the
    rule made to answer yes here) and ``True``: the kernels either way."""
    out = {}
    real_rule = tpa.pallas_auto_enabled
    spy = _Spy()
    tpa.pallas_auto_enabled = lambda *a: True
    tpa.sk.slice_states = spy
    try:
        x, fx, y = batch()
        mesh = parallel.make_mesh(1, 4)
        # 2 heads on tp 4: the mesh does not divide the heads
        kw = dict(MODEL, n_head=2)
        for use in ("auto", True):
            m = TModel(**kw, device="cpu", shard_axes=("dp", "tp"),
                       use_pallas=use)
            m.load_state_dict(payload["state_2heads"])
            spy.calls = 0
            out[f"heads_{use}"] = train_run(m, x, fx, y, mesh)["out"]
            out[f"heads_{use}_split"] = np.array(
                m.blocks[0].Attn.head_split is not None)
            out[f"heads_{use}_kernels"] = np.array(spy.calls)
        # 4 heads on tp 4 divide: auto takes the kernels
        m = build(payload["state"], shard_axes=("dp", "tp"),
                  use_pallas="auto")
        spy.calls = 0
        out["divides_auto"] = train_run(m, x, fx, y, mesh)["out"]
        out["divides_auto_kernels"] = np.array(spy.calls)
    finally:
        tpa.pallas_auto_enabled = real_rule
        tpa.sk.slice_states = spy.real
    return out


def _uneven(rank, payload):
    """A trailing batch of 3 on dp 2: whole on every rank, the heads split
    over tp, on the plain path and through the kernels."""
    mesh = parallel.make_mesh(2, 2)
    x, fx, y = batch(3)
    layout = mesh.layout(3, N)
    res = train_run(build(payload["state"], shard_axes=("dp", "tp")),
                    x, fx, y, mesh)
    res["layout_dp"] = np.array(layout.dp)
    res["shard_rows"] = np.array(layout.shard(x).shape[0])
    res["kernels"] = train_run(
        build(payload["state"], shard_axes=("dp", "tp"), use_pallas=True,
              use_pallas_erwin=True), x, fx, y, mesh)
    return res


def _dropout_ckpt(rank, payload):
    mesh = parallel.make_mesh(2, 2)
    m = build(payload["state"], shard_axes=("dp", "tp"), dropout=0.1,
              use_checkpoint=True, seed=5)
    return train_run(m, *batch(), mesh=mesh)


def _checks(rank, payload):
    """``process_batch_slice``, the mesh's checks and ``Layout.shard`` on
    four ranks."""
    out = {"slice": np.array([parallel.process_batch_slice(8).start,
                              parallel.process_batch_slice(8).stop])}
    for name, fn in (("uneven", lambda: parallel.process_batch_slice(6)),
                     ("mesh", lambda: parallel.make_mesh(3, 1)),
                     ("axis", lambda: parallel.make_mesh(2, 2, "pp"))):
        try:
            fn()
            out[name] = np.array("")
        except ValueError as e:
            out[name] = np.array(str(e))
    mesh = parallel.make_mesh(2, 2)
    t = torch.arange(4 * 6).reshape(4, 6)
    out["dp_rows"] = mesh.layout(4, 6).shard(t).numpy()
    out["none"] = np.array(mesh.layout(4, 6).shard(None) is None)
    cp = parallel.make_mesh(2, 2, "cp").layout(4, 6)
    out["cp_part"] = cp.shard(t).numpy()
    out["cp_rows"] = cp.shard(t, points=False).numpy()
    out["coords"] = np.array([mesh.coords["dp"], mesh.coords["tp"]])
    return {k: v for k, v in out.items()}


CASES = {
    "dp4": _mesh_case(4, 1),
    "dp2tp2": _mesh_case(2, 2, shard=("dp", "tp")),
    "dp2tp2_kernels": _mesh_case(2, 2, shard=("dp", "tp"), use_pallas=True,
                                 use_pallas_erwin=True),
    "cp4": _mesh_case(1, 4, "cp"),
    "dp2cp2_kernels": _mesh_case(2, 2, "cp", use_pallas=True,
                                 use_pallas_erwin=True),
    "structured_2d": _case_2d,
    "structured_3d": _case_3d,
    "routes": _routes,
    "uneven": _uneven,
    "dropout_ckpt": _dropout_ckpt,
    "checks": _checks,
}


def _rank_cases(rank, payload):
    return run_cases(CASES, rank, payload)


# -- the fixtures ---------------------------------------------------------

@pytest.fixture(scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(threads):
    """The JAX models and their numpy variables (``init_like``), and the
    ranks' payload: the port's state dicts of the same weights."""
    import jax

    from haet_tpu.models import HAETransolverIrregularMesh as JModel
    from haet_tpu.models import HAETransolverStructuredMesh2D as JModel2D
    from haet_torch.utils.weights import from_jax_variables
    from test_torch_model import init_like

    rng = np.random.RandomState(3)
    x, fx, _ = (t.numpy() for t in batch())
    x2, fx2, _ = (t.numpy() for t in batch(B, 256, 2, 1, seed=1))
    jm, jm2 = JModel(**MODEL), JModel2D(**MODEL_2D)
    v = init_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx),
                  rng, 32)
    v2 = init_like(jax.eval_shape(jm2.init, jax.random.PRNGKey(0), x2, fx2),
                   rng, 32)
    two = TModel(**dict(MODEL, n_head=2), device="cpu", seed=2)
    three = TModel3D(**MODEL_3D, device="cpu", seed=4)
    return dict(jm=jm, jm2=jm2, v=v, v2=v2, payload=dict(
        state=from_jax_variables(v), state_2d=from_jax_variables(v2),
        state_2heads=two.state_dict(), state_3d=three.state_dict()))


@pytest.fixture(scope="module")
def started(weights):
    """The rank group, started before the JAX compiles (collected by
    :func:`ranks`)."""
    return start_ranks(_rank_cases, weights["payload"])


@pytest.fixture(scope="module")
def jax_side(weights, started):
    """JAX's single-device train-mode forwards (irregular and 2D), the
    irregular model's gradients and its updated BatchNorm statistics."""
    import jax
    import jax.numpy as jnp

    from haet_torch.utils.weights import from_jax_variables

    jm, v = weights["jm"], weights["v"]
    x, fx, y = (t.numpy() for t in batch())

    def fwd(v, x, fx):
        return jm.apply(v, x, fx, train=True, mutable=["batch_stats"])

    out, upd = jax.jit(fwd)(v, x, fx)

    def loss(params):
        o, _ = fwd({"params": params, "batch_stats": v["batch_stats"]},
                   x, fx)
        return jnp.mean((o - y) ** 2)

    grads = jax.jit(jax.grad(loss))(v["params"])
    x2, fx2, _ = (t.numpy() for t in batch(B, 256, 2, 1, seed=1))
    out2, _ = jax.jit(lambda v, x, fx: weights["jm2"].apply(
        v, x, fx, train=True, mutable=["batch_stats"]))(weights["v2"], x2,
                                                        fx2)
    return dict(
        out=np.asarray(out), out_2d=np.asarray(out2),
        grads={k: t.numpy() for k, t in
               from_jax_variables({"params": grads}).items()},
        stats={k: t.numpy() for k, t in from_jax_variables(
            {"batch_stats": jax.device_get(upd["batch_stats"])}).items()},
        payload=weights["payload"])


@pytest.fixture(scope="module")
def ranks(started, jax_side):
    return started()


@pytest.fixture(scope="module")
def one_rank(jax_side):
    """The port's single-rank runs of the cases' models."""
    p = jax_side["payload"]
    plain = train_run(build(p["state"]), *batch())
    return dict(
        plain=plain,
        kernels=train_run(build(p["state"], use_pallas=True,
                                use_pallas_erwin=True), *batch()),
        uneven=train_run(build(p["state"]), *batch(3)),
        uneven_kernels=train_run(build(p["state"], use_pallas=True,
                                       use_pallas_erwin=True), *batch(3)),
        structured_2d=train_run(build(p["state_2d"], TModel2D, MODEL_2D),
                                *batch(B, 256, 2, 1, seed=1)),
        structured_3d=train_run(build(p["state_3d"], TModel3D, MODEL_3D),
                                *batch(2, 64, 3, 1, seed=2)),
        dropout_ckpt=train_run(build(p["state"], dropout=0.1,
                                     use_checkpoint=True, seed=5), *batch()),
        two_heads=train_run(build(p["state_2heads"], kw=dict(
            MODEL, n_head=2)), *batch()))


def _against_jax_out(got, want):
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


def _against_jax_grads(got: dict, want: dict):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        if k.endswith("sigma_att"):
            assert k not in got and not w.any(), k
            continue
        err = float(np.abs(got[k] - w).max())
        assert err <= max(1e-3 * float(np.abs(w).max()), 1e-5 * gmax), (
            k, err)


# -- the tests ------------------------------------------------------------

@pytest.mark.parametrize("name", ["dp4", "dp2tp2"])
def test_forward_matches_jax_and_one_rank(ranks, one_rank, jax_side, name):
    """dp 4 and dp 2 x tp 2 (heads split, 2 a rank): the gathered output
    of the train-mode forward on every rank equals the one-rank run and
    JAX's single-device forward, with the BatchNorms' statistics global."""
    got = case_result(ranks, name)
    assert_mesh_close(got["out"], one_rank["plain"]["out"], name)
    _against_jax_out(got["out"], jax_side["out"])


@pytest.mark.parametrize("name,ref", [("dp2tp2", "plain"),
                                      ("dp2tp2_kernels", "kernels")])
def test_tp_gradients_match_jax_and_one_rank(ranks, one_rank, jax_side,
                                             name, ref):
    """tp 2 (with dp 2): the head-sharded core's parameters summed over tp,
    the rest equal on every tp rank and summed over dp only; on the plain
    path and through the kernels' autograd functions (their plain versions
    on the CPU), each against its own one-rank run and JAX's
    ``jax.grad``."""
    got = case_result(ranks, name)
    assert_mesh_close(got["grads"], one_rank[ref]["grads"], name)
    _against_jax_grads(got["grads"], jax_side["grads"])


def test_structured_2d_under_tp(ranks, one_rank, jax_side):
    """The Conv2d projection's output channels split by head: dp 2 x tp
    2 on a 16 x 16 grid equals the one-rank run and JAX's forward."""
    got = case_result(ranks, "structured_2d")
    assert_mesh_close(got["out"], one_rank["structured_2d"]["out"])
    assert_mesh_close(got["grads"], one_rank["structured_2d"]["grads"])
    _against_jax_out(got["out"], jax_side["out_2d"])


def test_structured_3d_under_tp(ranks, one_rank):
    """The Conv3d projection under tp 4 (one head a rank) on a 4 x 4 x 4
    volume: the output, the gradients and the statistics of the one-rank
    run (the 2D test holds the variants' shared core to JAX)."""
    got = case_result(ranks, "structured_3d")
    for k in ("out", "grads", "stats"):
        assert_mesh_close(got[k], one_rank["structured_3d"][k], k)


@pytest.mark.parametrize("name,ref", [("cp4", "plain"),
                                      ("dp2cp2_kernels", "kernels")])
def test_point_axis(ranks, one_rank, jax_side, name, ref):
    """cp 4 on the plain path (the softmax's max and sum and the states'
    sums over the axis) and dp 2 x cp 2 with the slice kernels (the points
    gathered, the kernels on the whole cloud, the rank's rows kept): the
    output, every gradient (summed over dp and cp) and the statistics."""
    got = case_result(ranks, name)
    assert_mesh_close(got["out"], one_rank[ref]["out"], name)
    assert_mesh_close(got["grads"], one_rank[ref]["grads"], name)
    assert_mesh_close(got["stats"], one_rank[ref]["stats"], name)
    _against_jax_out(got["out"], jax_side["out"])
    _against_jax_grads(got["grads"], jax_side["grads"])


def test_shard_axes_without_mesh_unchanged(jax_side):
    """A model with ``shard_axes`` and no mesh runs unsharded, bit for bit
    the model without, on the plain path and with ``use_pallas=True``
    (where JAX's ``shard_map`` raises for want of a mesh)."""
    p = jax_side["payload"]
    x, fx, _ = batch()
    for use in (False, True):
        with torch.no_grad():
            want = build(p["state"], use_pallas=use).eval()(x, fx)
            got = build(p["state"], shard_axes=("dp", "tp"),
                        use_pallas=use).eval()(x, fx)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_auto_under_a_mesh_that_does_not_divide_the_heads(ranks, one_rank):
    """2 heads on tp 4: the heads are not split, and ``"auto"`` and
    ``True`` both take the kernels on every rank's whole heads (one call a
    block), with the one-rank output; JAX's ``shard_map`` cannot, and
    falls back or raises. 4 heads on tp 4 divide, and ``"auto"`` takes the
    kernels there, each rank on its one head."""
    got = case_result(ranks, "routes")
    for use in ("auto", True):
        assert not bool(got[f"heads_{use}_split"])
        assert int(got[f"heads_{use}_kernels"]) == MODEL["n_layers"]
        assert_mesh_close(got[f"heads_{use}"], one_rank["two_heads"]["out"],
                          str(use))
    assert int(got["divides_auto_kernels"]) == MODEL["n_layers"]
    assert_mesh_close(got["divides_auto"], one_rank["plain"]["out"])


def test_uneven_trailing_batch(ranks, one_rank):
    """A batch of 3 on dp 2 x tp 2 stays whole on every rank
    (the layout does not split it), its
    gradients are not summed over dp, and the result is the one-rank
    run's, on the plain path and with ``use_pallas=True`` (the kernels run
    on the whole batch and the rank's heads, where JAX's ``shard_map``
    needs dp to divide the batch)."""
    got = case_result(ranks, "uneven")
    assert not bool(got["layout_dp"]) and int(got["shard_rows"]) == 3
    for name, res in (("uneven", got), ("uneven_kernels", got["kernels"])):
        for k in ("out", "grads", "stats"):
            assert_mesh_close(res[k], one_rank[name][k], f"{name} {k}")


def test_batch_norm_statistics_are_global(ranks, one_rank, jax_side):
    """Train-mode BatchNorm over dp 4 and dp 2 x tp 2: the running
    statistics come out equal on every rank (``case_result``) and equal to
    the one-rank run's and JAX's (flax's biased variance, momentum 0.9),
    updated once."""
    for name in ("dp4", "dp2tp2"):
        got = case_result(ranks, name)["stats"]
        assert_mesh_close(got, one_rank["plain"]["stats"], name)
        for k, want in jax_side["stats"].items():
            if not k.endswith("num_batches_tracked"):  # flax has none
                np.testing.assert_allclose(got[k], want, rtol=1e-5,
                                           err_msg=f"{name} {k}")
        assert all(int(v) == 1 for k, v in got.items()
                   if k.endswith("num_batches_tracked"))


def test_dropout_and_checkpoint_under_mesh(ranks, one_rank):
    """Dropout 0.1 and ``use_checkpoint`` under dp 2 x tp 2: each rank's
    masks are its rows of the single-device masks (the same seed), the
    recompute replays the collectives and the masks, and the statistics
    are updated once."""
    got = case_result(ranks, "dropout_ckpt")
    want = one_rank["dropout_ckpt"]
    assert_mesh_close(got["out"], want["out"])
    assert_mesh_close(got["grads"], want["grads"])
    assert_mesh_close(got["stats"], want["stats"])
    # dropout acted: the outputs differ from the model without it
    assert np.abs(want["out"] - one_rank["plain"]["out"]).max() > 1e-3


def test_process_batch_slice_and_mesh_checks(ranks):
    """On four ranks: rank 0's slice of a global batch of 8 is rows 0-1,
    6 does not divide; a (3, 1) mesh raises JAX's message, a third axis
    name is refused; ``Layout.shard`` keeps rank 0's dp rows (and, on a
    cp axis, its half of dim 1 unless told ``points=False``)."""
    got = case_result(ranks, "checks", same=False)
    assert got["slice"].tolist() == [0, 2]
    assert "not divisible by process count 4" in str(got["uneven"])
    assert "dp(3) * tp(1) != device count (4)" in str(got["mesh"])
    assert "'pp'" in str(got["axis"])
    t = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(got["dp_rows"], t[:2])
    assert bool(got["none"])
    np.testing.assert_array_equal(got["cp_part"], t[:2, :3])
    np.testing.assert_array_equal(got["cp_rows"], t[:2])
    assert got["coords"].tolist() == [0, 0]
    assert [ranks[r]["checks"]["coords"].tolist() for r in range(4)] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    assert [ranks[r]["checks"]["cp_part"].tolist() for r in range(4)] == [
        t[:2, :3].tolist(), t[:2, 3:].tolist(), t[2:, :3].tolist(),
        t[2:, 3:].tolist()]
