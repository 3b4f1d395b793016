"""PyTorch port, the reference-checkpoint importer
(``haet_torch/utils/torch_import.py``) against the JAX package's
(``haet_tpu/utils/torch_import.py``).

Three small JAX models (irregular, 2D on 8 x 8, 3D on 4 x 4 x 4), each
built once (``jax.eval_shape`` of its init, numpy weights from
``test_torch_model.init_like``). JAX's ``to_torch_state_dict`` of their
variables, wrapped as the reference's ``train.py`` saves a checkpoint
(``{"epoch", "model_state_dict", "val_loss": np.float64}``, the keys under
a ``module.`` prefix), is one ``.pt`` file per variant:

* loaded with the port's ``load_torch_checkpoint`` into a port model and
  with JAX's into the JAX template, the two eval forwards agree within
  1e-5 of max |out| (float32, another summation order);
* the port's ``to_torch_state_dict`` of a port model holding the same
  weights equals JAX's export key for key and value for value;
* ``strict``: a missing key, an unused key and both raise ``ValueError`` in
  both importers, with the same sections of message; with
  ``strict=False`` neither raises and an unfilled leaf keeps the
  template's value; a shape mismatch raises in both;
* ``rename`` loads the reference's naming of the Erwin-only car baseline
  (``model.``, ``pred_head.0.``, ``pred_head.2.``) strictly.
"""

import jax
import numpy as np
import pytest
import torch

from haet_torch.benchmarks.erwin_baseline import ErwinCarModel
from haet_torch.models import (HAETransolverIrregularMesh as TIrr,
                               HAETransolverStructuredMesh2D as T2D,
                               HAETransolverStructuredMesh3D as T3D)
from haet_torch.utils import torch_import as tti
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.models import (HAETransolverIrregularMesh as JIrr,
                             HAETransolverStructuredMesh2D as J2D,
                             HAETransolverStructuredMesh3D as J3D)
from haet_tpu.utils import torch_import as jti
from test_torch_model import init_like

B = 2
RTOL = 1e-5
SMALL = dict(n_layers=1, n_hidden=32, n_head=4, slice_num=8,
             ball_sizes=(4, 2), mlp_ratio=1)
VARIANTS = {
    "irregular": (JIrr, TIrr, dict(SMALL, space_dim=3, fun_dim=1,
                                   out_dim=2), 48),
    "structured_2d": (J2D, T2D, dict(SMALL, space_dim=2, fun_dim=1,
                                     out_dim=1, H=8, W=8), 64),
    "structured_3d": (J3D, T3D, dict(SMALL, space_dim=3, fun_dim=1,
                                     out_dim=1, H=4, W=4, D=4), 64),
}


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def reference_checkpoint(sd: dict) -> dict:
    """A reference-format training checkpoint (``train.py:250-259``)."""
    return {"epoch": 7,
            "model_state_dict": {f"module.{k}": torch.from_numpy(
                np.ascontiguousarray(v)) for k, v in sd.items()},
            "val_loss": np.float64(0.125)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for i, (name, (jcls, _, kw, n)) in enumerate(VARIANTS.items()):
        rng = np.random.RandomState(20 + i)
        x = rng.rand(B, n, kw["space_dim"]).astype(np.float32)
        fx = rng.randn(B, n, 1).astype(np.float32)
        jm = jcls(**kw)
        template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx)
        variables = init_like(template, rng, kw["n_hidden"])
        path = str(root / f"{name}.pt")
        torch.save(reference_checkpoint(jti.to_torch_state_dict(variables)),
                   path)
        out[name] = dict(jm=jm, template=template, variables=variables,
                         x=x, fx=fx, path=path)
    return out


def port_model(name, seed=5):
    _, tcls, kw, _ = VARIANTS[name]
    return tcls(**kw, device="cpu", seed=seed).eval()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_checkpoint_forward_matches_jax_import(built, name):
    b = built[name]
    jvars = jti.load_torch_checkpoint(b["path"], b["variables"])
    ref = np.asarray(jax.jit(b["jm"].apply)(jvars, b["x"], b["fx"]))
    m = port_model(name)
    m.load_state_dict(tti.load_torch_checkpoint(b["path"], m), strict=True)
    with torch.inference_mode():
        out = m(torch.from_numpy(b["x"]), torch.from_numpy(b["fx"])).numpy()
    scale = np.abs(ref).max()
    err = np.abs(out - ref).max()
    print(f"PARITY {name} reference checkpoint, port vs JAX import: "
          f"max_abs_err {err:.3e} max|ref| {scale:.3e}")
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_to_torch_state_dict_matches_jax(built, name):
    b = built[name]
    m = port_model(name)
    load_jax_variables(m, b["variables"])
    got = tti.to_torch_state_dict(m)
    want = jti.to_torch_state_dict(b["variables"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _edit(sd: dict, case: str) -> dict:
    sd = dict(sd)
    if case in ("missing", "both"):
        sd.pop(sorted(sd)[3])
    if case in ("unused", "both"):
        sd["blocks.0.Attn.not_a_param.weight"] = np.zeros(3, np.float32)
    return sd


@pytest.mark.parametrize("case", ["missing", "unused", "both", "shape"])
def test_strict_errors_match_jax(built, case):
    b = built["irregular"]
    ref = jti.to_torch_state_dict(b["variables"])
    if case == "shape":
        sd = dict(ref)
        k = "blocks.0.Attn.in_project_slice.weight"
        sd[k] = np.zeros((3, 3), np.float32)
        with pytest.raises(ValueError, match="shape mismatches") as je:
            jti.convert_state_dict(sd, b["variables"], strict=False)
        with pytest.raises(ValueError, match="shape mismatches") as te:
            tti.convert_state_dict(sd, port_model("irregular"),
                                   strict=False)
        assert k in str(je.value) and k in str(te.value)
        return
    sd = _edit(ref, case)
    with pytest.raises(ValueError) as je:
        jti.convert_state_dict(sd, b["variables"])
    m = port_model("irregular")
    with pytest.raises(ValueError) as te:
        tti.convert_state_dict(sd, m)
    for section in ("template leaves not found in checkpoint",
                    "checkpoint keys not mapped"):
        assert (section in str(je.value)) == (section in str(te.value)), (
            section, str(je.value), str(te.value))
    if case != "missing":
        assert "blocks.0.Attn.not_a_param.weight" in str(te.value)
    jti.convert_state_dict(sd, b["variables"], strict=False)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    loaded = tti.convert_state_dict(sd, m, strict=False)
    m.load_state_dict(loaded, strict=True)
    for k, v in m.state_dict().items():
        if k in sd:
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
        else:
            assert torch.equal(v, before[k]), k


def test_rename_loads_the_erwin_baseline():
    """The reference 02.1 wrapper names (``model.`` for the Erwin stage,
    ``pred_head.0.``/``.2.`` for the head's Linears), bare and with a
    ``_orig_mod.`` prefix, load strictly through ``rename``."""
    src = ErwinCarModel(hidden_dim=16, mp_steps=1, device="cpu", seed=1)
    names = {"erwin.": "model.", "head1.": "pred_head.0.",
             "head2.": "pred_head.2."}
    sd = {}
    for k, v in tti.to_torch_state_dict(src).items():
        for ours, theirs in names.items():
            if k.startswith(ours):
                k = theirs + k[len(ours):]
        sd[f"_orig_mod.{k}"] = v
    assert any(".mpnn." in k for k in sd)
    dst = ErwinCarModel(hidden_dim=16, mp_steps=1, device="cpu", seed=2)
    with pytest.raises(ValueError, match="checkpoint keys not mapped"):
        tti.convert_state_dict(sd, dst)
    dst.load_state_dict(tti.convert_state_dict(
        sd, dst, rename={v: k for k, v in names.items()}), strict=True)
    for (k, a), b in zip(src.state_dict().items(),
                         dst.state_dict().values()):
        assert torch.equal(a, b), k
