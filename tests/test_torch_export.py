"""PyTorch port, serving artifacts (``haet_torch.export``) and the kernels'
operators, against the JAX package.

The same numpy weights (through ``haet_torch/utils/weights.py``) and inputs
go to the JAX model's eval forward under ``jax.jit`` and to the port's
artifact, exported with both kernel flags set (on the CPU the operators run
their kernels' plain versions), written, loaded back and run with the
weights passed in and bound. The model and point count are
``tests/test_torch_serve.py``'s. Tolerance: 1e-5 of max |out| (float32).

Also: the operators ``haet::slice_states``, ``haet::deslice`` and
``haet::erwin_block`` pass ``torch.library.opcheck`` (their fakes give the
kernels' exact outputs, the bf16 states' float32 residual included) and
appear in the program 1 + 1 + 3 times for 1 layer of 3 Erwin blocks; a
batch-2 program differs from batch 1 on a shared sample as JAX's does;
shape, dtype, variables and device mismatches raise naming what differs;
the manifest carries the JAX manifest's fields; a fresh process that
imports only ``haet_torch.export`` runs an artifact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from haet_torch import export as hexport
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.ops.kernels import erwin_block as eb
from haet_torch.ops.kernels import slice_kernels as sk
from haet_torch.serve import export_batch_family
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel
from test_torch_serve import KW, N_PTS, _init_like

RTOL = 1e-5


def _inputs(b, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, N_PTS, 3).astype(np.float32),
            r.randn(b, N_PTS, 1).astype(np.float32))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jm = JModel(**KW)
    x2, f2 = _inputs(2)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x2, f2)
    jvars = _init_like(template, np.random.RandomState(1))
    tm = TModel(**KW, use_pallas=True, use_pallas_erwin=True,
                device="cpu").eval()
    load_jax_variables(tm, jvars)
    root = str(tmp_path_factory.mktemp("bundle"))
    # float64 example data (a float32 program, as jax.export canonicalises)
    # and extras that may not override the measured fields
    export_batch_family(root, tm, tm.state_dict(),
                        (x2[:1].astype(np.float64), f2[:1]),
                        batch_sizes=(1, 2),
                        extra_manifest={"input_dtypes": ["bfloat16"],
                                        "note": "mine"})
    bundle = hexport.ServingBundle.load(root, device="cpu")
    apply = jax.jit(jm.apply)
    ref = {b: np.asarray(apply(jvars, x2[:b], f2[:b])) for b in (1, 2)}
    yield dict(tm=tm, root=root, bundle=bundle, x=x2, fx=f2, ref=ref,
               variables={k: v.numpy() for k, v in tm.state_dict().items()})
    torch.set_num_threads(threads)


def _program(env, b):
    return env["bundle"]._by_key[((b, N_PTS, 3), (b, N_PTS, 1))]


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b", [1, 2])
def test_artifact_matches_jax_eval_forward(env, b):
    em = _program(env, b)
    d = os.path.join(env["root"], f"b{b}_{N_PTS}x3-float32_{N_PTS}x1-float32")
    assert sorted(os.listdir(d)) == ["apply.pt2", "manifest.json"]
    x, fx, ref = env["x"][:b], env["fx"][:b], env["ref"][b]
    passed = _rel(em(env["variables"], x, fx), ref)
    bound = _rel(em.bind(env["variables"])(x, fx), ref)
    print(f"PARITY artifact b{b} vs JAX: passed {passed:.3e}, bound "
          f"{bound:.3e} of max")  # shown with `pytest -s`
    assert passed <= RTOL and bound <= RTOL


def test_batch_size_is_part_of_the_program(env):
    """Sample 0 alone and in a batch of 2 differ (the Erwin positions are
    normalised over the whole batch) by what JAX's forwards differ by."""
    b1 = _program(env, 1).bind(env["variables"])(env["x"][:1],
                                                 env["fx"][:1])[0].numpy()
    b2 = _program(env, 2).bind(env["variables"])(env["x"], env["fx"])[0]
    port_gap = b1 - b2.numpy()
    jax_gap = env["ref"][1][0] - env["ref"][2][0]
    scale = np.abs(env["ref"][1]).max()
    assert np.abs(jax_gap).max() > 100 * RTOL * scale
    assert np.abs(port_gap - jax_gap).max() <= 2 * RTOL * scale


def test_shape_and_dtype_mismatches_raise(env):
    em = _program(env, 2)
    v, x, fx = env["variables"], env["x"], env["fx"]
    with pytest.raises(ValueError, match=r"shape mismatch.*\[\[2, 64, 3\]"):
        em(v, x[:, :32], fx[:, :32])
    with pytest.raises(ValueError, match="shape mismatch"):
        em.bind(v)(x[:1], fx[:1])
    with pytest.raises(ValueError, match="dtype mismatch"):
        em(v, x.astype(np.float64), fx)
    with pytest.raises(ValueError, match="no artifact for input shapes"):
        env["bundle"].predict(v, x[:, :32], fx[:, :32])


def _wrong(variables, how):
    bad = dict(variables)
    key = "blocks.0.Attn.in_project_slice.weight"
    if how == "missing":
        bad.pop(key)
    elif how == "extra":
        bad["blocks.0.spare"] = np.zeros(3, np.float32)
    elif how == "shape":
        bad[key] = bad[key][:, :-1]
    else:
        bad[key] = bad[key].astype(np.float64)
    return bad


@pytest.mark.parametrize("how,named", [
    ("missing", "'blocks.0.Attn.in_project_slice.weight' is missing"),
    ("extra", "'blocks.0.spare' is not a variable"),
    ("shape", "'blocks.0.Attn.in_project_slice.weight' has shape"),
    ("dtype", "float64, the program takes"),
])
def test_wrong_variables_raise_naming_the_mismatch(env, how, named):
    em = _program(env, 1)
    bad = _wrong(env["variables"], how)
    for call in (lambda: em.bind(bad), lambda: env["bundle"].bind(bad),
                 lambda: em(bad, env["x"][:1], env["fx"][:1])):
        with pytest.raises(ValueError, match="variables tree mismatch") as e:
            call()
        assert named in str(e.value)


def test_manifest_fields(env):
    """The JAX manifest's fields (``haet_tpu/export.py:372-390``): input
    shapes, the canonical dtypes (the float64 example data exported a
    float32 program, which refuses float64), the variables with their
    shapes, and caller extras that cannot override them."""
    man = _program(env, 2).manifest
    assert man["input_shapes"] == [[2, N_PTS, 3], [2, N_PTS, 1]]
    assert man["input_dtypes"] == ["float32", "float32"]
    assert man["note"] == "mine"
    assert man["batch_size"] == 2 and man["device"] == "cpu"
    assert man["nr_devices"] == 1
    assert man["model"] == "HAETransolverIrregularMesh"
    state = env["tm"].state_dict()
    assert man["n_arrays_variables"] == len(state)
    assert man["variables"] == {k: [list(t.shape), str(t.dtype)[6:]]
                                for k, t in state.items()}
    d = os.path.join(env["root"], f"b1_{N_PTS}x3-float32_{N_PTS}x1-float32")
    assert json.load(open(os.path.join(d, "manifest.json"))) == \
        _program(env, 1).manifest
    with pytest.raises(ValueError, match="dtype mismatch"):
        _program(env, 1)(env["variables"], env["x"][:1].astype(np.float64),
                         env["fx"][:1])


def test_programs_call_the_kernel_operators(env):
    """A forward of 1 layer calls slice_states and deslice once per layer
    and the fused Erwin block once per Erwin block (3 per layer)."""
    graph = _program(env, 1).program.graph
    targets = [str(n.target) for n in graph.nodes
               if n.op == "call_function"]
    counts = {op: sum(t.startswith(f"haet.{op}") for t in targets)
              for op in ("slice_states", "deslice", "erwin_block")}
    assert counts == {"slice_states": 1, "deslice": 1, "erwin_block": 3}


def test_a_fresh_process_runs_the_artifact(env, tmp_path):
    """Only ``haet_torch.export`` imported (no model code): the loaded
    program, bound to the weights, answers as this process's."""
    d = os.path.join(env["root"], f"b1_{N_PTS}x3-float32_{N_PTS}x1-float32")
    np.savez(tmp_path / "io.npz", x=env["x"][:1], fx=env["fx"][:1],
             **{f"v:{k}": v for k, v in env["variables"].items()})
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from haet_torch.export import load_artifact\n"
        f"z = np.load({str(tmp_path / 'io.npz')!r})\n"
        "v = {k[2:]: z[k] for k in z.files if k.startswith('v:')}\n"
        f"em = load_artifact({d!r}, device='cpu')\n"
        "out = em.bind(v)(z['x'], z['fx'])\n"
        "assert 'haet_torch.models' not in sys.modules\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=str(Path(__file__).resolve().parents[1]))
    got = np.load(tmp_path / "out.npy")
    assert _rel(got, env["ref"][1]) <= RTOL


def test_devices_and_unported_programs_raise(env, monkeypatch):
    d = os.path.join(env["root"], f"b1_{N_PTS}x3-float32_{N_PTS}x1-float32")
    with pytest.raises(ValueError, match="exported on cpu"):
        hexport.load_artifact(d, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hexport.load_artifact(d)
    # rollout programs are ported (tests/test_torch_rollout.py): a
    # rollout takes exactly (pos, fx0)
    with pytest.raises(ValueError, match="exactly"):
        hexport.export_rollout(env["tm"], None, (env["x"], None), steps=2)
    with pytest.raises(ValueError, match="exactly"):
        hexport.save_rollout_artifact(os.path.join(env["root"], "r"),
                                      env["tm"], None, (env["x"], None),
                                      steps=2)
    # multi-chip programs are ported (tests/test_torch_mesh_serve.py):
    # a mesh pins the device, so mesh= and platforms= exclude each other
    with pytest.raises(ValueError, match="mutually exclusive"):
        hexport.export_apply(env["tm"], None, (env["x"], None),
                             mesh=object(), platforms=["cpu"])


def test_ambiguous_bundle_raises():
    class Stub:
        def __init__(self, dts):
            self.input_shapes = [[1, 4, 3]]
            self.manifest = {"input_dtypes": dts}

    hexport.ServingBundle([Stub(["float32"])])
    with pytest.raises(ValueError, match="ambiguous bundle"):
        hexport.ServingBundle([Stub(["float32"]), Stub(["bfloat16"])])


def _slice_args(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 40, 8, generator=g).to(dtype)
    return (x, torch.randn(8, 4, generator=g), torch.randn(4, generator=g),
            torch.randn(8, 1, generator=g), torch.randn(1, generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_operators_pass_opcheck(dtype):
    """The fakes give the kernels' outputs exactly (shapes, dtypes, the
    residual empty for float32 and the float32 states for bf16), and each
    operator equals its plain version."""
    args = _slice_args(dtype)
    torch.library.opcheck(sk.slice_states_op, (*args, 0.5, 1e-6))
    states, m, s, res = sk.slice_states_op(*args, 0.5, 1e-6)
    f32, m_p, s_p = sk.slice_states_plain_f32(*args)
    assert states.dtype == dtype and m.dtype == s.dtype == torch.float32
    if dtype == torch.float32:
        assert res.shape == (0,)
    else:
        torch.testing.assert_close(res, f32, rtol=0, atol=0)
    torch.testing.assert_close(states, f32.to(dtype), rtol=0, atol=0)
    dargs = (*args, states, m, s, 0.5, 1e-6)
    torch.library.opcheck(sk.deslice_op, dargs)
    torch.testing.assert_close(sk.deslice_op(*dargs),
                               sk.deslice_plain(*dargs), rtol=0, atol=0)

    g = torch.Generator().manual_seed(1)
    shapes = eb.param_shapes(16, 3, 2, 64)
    params = [torch.randn(shapes[k], generator=g) for k in eb.PARAM_NAMES]
    x = torch.randn(2, 32, 16, generator=g).to(dtype)
    pos = torch.rand(2, 32, 3, generator=g).to(dtype)
    eargs = (x, pos, params, 16, 2, True)
    torch.library.opcheck(eb.erwin_block_op, eargs)
    want = eb.erwin_block_plain(x, pos, dict(zip(eb.PARAM_NAMES, params)),
                                ball_size=16, num_heads=2)
    torch.testing.assert_close(eb.erwin_block_op(*eargs), want, rtol=0,
                               atol=0)
