"""PyTorch port, the weight bridge and the config vs the JAX package.

``haet_torch.utils.weights.from_jax_variables`` is a copy of the mapping in
``haet_tpu.utils.torch_import`` (the port never imports ``haet_tpu``); here
the two are held against each other key for key and value for value on the
car preset's variables, and the result loads strictly into the port's car
model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from haet_torch.models import HAETransolverIrregularMesh
from haet_torch.utils import config as tcfg
from haet_torch.utils.config import PALLAS_AUTO_THRESHOLD
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.utils import config as jcfg
from haet_tpu.utils.torch_import import to_torch_state_dict

CAR_PARAMS = 1_757_190


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def car_variables():
    jm = jcfg.shapenet_car_config().model.build()
    x = np.zeros((1, 64, 7), np.float32)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), template)


def test_keys_and_values_match_torch_import(car_variables):
    sd = from_jax_variables(car_variables)
    ref = to_torch_state_dict(car_variables)
    tracked = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - tracked == set(ref)
    assert tracked == {k[:-len("running_mean")] + "num_batches_tracked"
                       for k in ref if k.endswith("running_mean")}
    assert len(tracked) == 4  # pool + unpool BatchNorm in each of 2 layers
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_strict_load_into_car_model(car_variables):
    m = tcfg.shapenet_car_config().build(device="cpu")
    assert sum(p.numel() for p in m.parameters()) == CAR_PARAMS
    ref = to_torch_state_dict(car_variables)
    own = set(m.state_dict())
    assert {k for k in own if not k.endswith("num_batches_tracked")} == set(
        ref)
    load_jax_variables(m, car_variables)  # strict=True
    w = m.blocks[0].Attn.in_project_slice.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        car_variables["params"]["blocks_0"]["Attn"][
            "in_project_slice_kernel"].T)


def test_param_count_matches_jax(car_variables):
    n_jax = sum(np.size(v) for v in
                jax.tree_util.tree_leaves(car_variables["params"]))
    assert n_jax == CAR_PARAMS


def test_model_config_field_for_field():
    """Field for field, defaults included, but ``pallas_auto_threshold``,
    whose default is the card's measured threshold, not the TPU's."""
    card = {"pallas_auto_threshold": PALLAS_AUTO_THRESHOLD}
    names = lambda c, own={}: [(f.name, own.get(f.name, f.default))  # noqa: E731
                               for f in dataclasses.fields(c)]
    assert names(tcfg.ModelConfig) == names(jcfg.ModelConfig, card)
    assert dataclasses.asdict(tcfg.shapenet_car_config()) == {
        **dataclasses.asdict(jcfg.shapenet_car_config().model), **card}


def test_seeded_init_is_deterministic():
    a = tcfg.shapenet_car_config().build(device="cpu", seed=3)
    b = tcfg.shapenet_car_config().build(device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb), ka
    sig = a.blocks[0].Attn.erwin.encoder[0].blocks[0].BMSA.sigma_att
    assert abs(float(sig.detach().mean()) + 1.0) < 0.05
    w = a.blocks[0].Attn.in_project_slice.weight
    np.testing.assert_allclose((w @ w.T).detach().numpy(), np.eye(32),
                               atol=1e-5)  # orthogonal slice init


@pytest.mark.parametrize("change,match", [
    (dict(grouping="morton"), "morton"),
    (dict(use_pallas="auto"), "auto"),
    (dict(mp_steps=3, embed=True), "MPNN"),
    (dict(shard_axes=("dp", "tp")), "parallel"),
])
def test_unported_options_raise(change, match):
    """Morton grouping, MPNN embedding, ``use_pallas="auto"`` and
    ``shard_axes`` are ported: the car preset with any of them builds, and
    JAX's variables of the same config cross over key for key
    (``to_torch_state_dict``) and load strictly. ``shard_axes`` names mesh
    axes and leaves the parameters alone, so its JAX model is built
    without it (JAX's sharding constraints need a mesh to trace under)."""
    cfg = dataclasses.replace(tcfg.shapenet_car_config(), **change)
    m = cfg.build(device="cpu")
    if match == "parallel":
        assert all(b.Attn.shard_axes == ("dp", "tp") for b in m.blocks)
        change = {}
    jm = dataclasses.replace(jcfg.shapenet_car_config().model,
                             **change).build()
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              np.zeros((1, 64, 7), np.float32))
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda t: rng.randn(*t.shape).astype(np.float32), template)
    ref = to_torch_state_dict(variables)
    assert {k for k in m.state_dict()
            if not k.endswith("num_batches_tracked")} == set(ref)
    assert any(".mpnn." in k for k in ref) == (match == "MPNN")
    load_jax_variables(m, variables)  # strict=True
    for k, v in ref.items():
        np.testing.assert_array_equal(m.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_bf16_car_model_loads_float32_params(car_variables):
    """``ModelConfig(bf16=True)`` builds the car model in the bf16 compute
    dtype over float32 parameters and buffers, as the JAX bf16 model keeps
    its parameter tree float32, and the JAX variables load into it key for
    key."""
    cfg = dataclasses.replace(tcfg.shapenet_car_config(), bf16=True)
    assert cfg.model_kwargs()["dtype"] is torch.bfloat16
    m = cfg.build(device="cpu")
    assert sum(p.numel() for p in m.parameters()) == CAR_PARAMS
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert {v.dtype for k, v in m.state_dict().items()
            if not k.endswith("num_batches_tracked")} == {torch.float32}
    jm = dataclasses.replace(jcfg.shapenet_car_config().model,
                             bf16=True).build()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 7), np.float32))
    assert {str(s.dtype) for s in jax.tree_util.tree_leaves(shapes)} == \
        {"float32"}
    assert jax.tree_util.tree_map(lambda s: s.shape, shapes) == \
        jax.tree_util.tree_map(lambda v: v.shape, car_variables)
    with torch.inference_mode():   # the seeded init's weights
        out = m.eval()(torch.zeros(1, 64, 7))
    assert out.dtype == torch.bfloat16 and bool(out.float().isfinite().all())
    load_jax_variables(m, car_variables)  # strict=True


def test_decode_false_raises():
    """Physics attention needs the decoded per-slice-token states."""
    cfg = dataclasses.replace(tcfg.shapenet_car_config(), decode=False)
    with pytest.raises(ValueError, match="decode=False"):
        cfg.build(device="cpu")


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HAETransolverIrregularMesh(space_dim=3, n_layers=1, n_hidden=16,
                                   n_head=2, slice_num=8)
