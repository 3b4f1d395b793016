"""AOT serving artifacts: ``torch.export`` programs of the eval forward.

Counterpart of ``haet_tpu/export.py`` (``jax.export`` / StableHLO there). A
trained model is exported ONCE to an artifact directory that a later process
loads and runs without the model's code: ``apply.pt2``, a
``torch.export.ExportedProgram`` saved with ``torch.export.save``, and
``manifest.json``. The program calls the port's kernels as the operators
``haet::slice_states``, ``haet::deslice`` and ``haet::erwin_block``, which
``import haet_torch.ops.kernels`` registers (as :func:`load_artifact`
does); on the card each runs its CUDA kernel, on the CPU its plain
version.

Design notes, as in the JAX module:

- **Fully static shapes, including batch.** The Erwin pooling depth follows
  the flat leaf count ``B*N`` (``ops/ball_groups.build_erwin_perms``), so
  batch size is part of the PROGRAM. The artifact pins the whole input
  signature; export one artifact per serving signature
  (:class:`ServingBundle`, ``haet_torch.serve.export_batch_family``).
- **No silent shape adaptation.** A shape or dtype mismatch raises with the
  exported signature; padding is the server's explicit opt-in
  (``BatchingServer(pad_to_points=True)``).
- **Weights come from the caller.** ``ExportedModel(variables, *args)``
  runs the program over the caller's state (``torch.func.functional_call``)
  and :meth:`ExportedModel.bind` puts it into the program's module once, for
  a server that holds one checkpoint. Variables are a model ``state_dict``
  (parameters and buffers by name, tensors or numpy arrays, e.g. the
  ``"model"`` entry of ``Checkpointer.restore_raw``); their names, shapes
  and dtypes are checked against the manifest's ``variables`` before
  anything runs, and the first mismatch is named. The weights saved inside
  ``apply.pt2`` (the model's at export time) are never served.
- **Devices.** The manifest records the device type the program was
  exported on; a program is loaded for that type only (a CUDA program holds
  CUDA constants). :func:`load_artifact` defaults to the card, as every
  entry point of the port does.

Rollout programs (:func:`export_rollout`, :func:`save_rollout_artifact`)
run K autoregressive eval forwards in one program, each prediction
appended to the sliding input window (:func:`rollout`), K unrolled in the
graph where JAX scans; they load, bind and serve as the forward's programs
do.

Multi-chip programs (``mesh=``, JAX ``:194-260, 401-593``): the model is
bound to a :class:`~haet_torch.parallel.Mesh` for the trace, each rank's
part of the forward runs at its local shapes (the kernels included), and
the mesh's collectives and each rank's part trace as ``haet::mesh_*``
operators that name mesh axes (:mod:`haet_torch.parallel.mesh_ops`), so the
program holds no process group and no rank's coordinates. ``data_axis``
``"dp"`` splits the batch over dp (every array input's batch must divide
it); None keeps the inputs whole on every rank, the parallelism being the
model's own head split (``shard_axes``). The manifest records
``nr_devices``, ``data_axis`` and the mesh's shape. Under a process group
every rank calls the export: rank 0 traces and writes, the others wait.
:func:`load_artifact` takes a mesh of the program's size, and every rank
loads the one directory; the operators resolve against that mesh at call
time, so all ranks call the program together, with the same inputs.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import parallel
from .ops import kernels as _kernels  # noqa: F401  (registers haet:: ops)
from .parallel import mesh_ops
from .utils.env import default_device

__all__ = [
    "export_apply",
    "export_rollout",
    "rollout",
    "save_artifact",
    "save_rollout_artifact",
    "load_artifact",
    "ExportedModel",
    "ServingBundle",
    "BoundBundle",
]

_MANIFEST = "manifest.json"
_BLOB = "apply.pt2"
#: the exported wrapper's attribute holding the model: the program's own
#: parameter names carry it, the manifest's and the caller's do not
_PREFIX = "model."

# jax.export traces with canonical dtypes (64-bit types become 32-bit under
# JAX's default config), and the JAX manifest records those; the port
# exports and records the same.
_CANONICAL = {"float64": "float32", "int64": "int32",
              "complex128": "complex64", "uint64": "uint32"}


class _Apply(torch.nn.Module):
    """The model's eval forward over its array inputs only: the ``None``
    inputs of the example are put back at their positions."""

    def __init__(self, model: torch.nn.Module, none_mask: tuple):
        super().__init__()
        self.model = model
        self.none_mask = none_mask

    def forward(self, *arrays):
        it = iter(arrays)
        return self.model(*(None if none else next(it)
                            for none in self.none_mask))


def rollout(model: torch.nn.Module, pos, fx0, steps: int,
            step_width: int):
    """``steps`` autoregressive forwards of ``model(pos, fx)`` from the
    ``[B, N, T_in]`` window ``fx0``: each ``[B, N, step_width]`` prediction
    is appended to the window, cast to its dtype, as the oldest
    ``step_width`` frames drop off. Returns ``[B, N, steps * step_width]``
    in time-major frame order (``haet_tpu/export.py:115-148``)."""
    fx, preds = fx0, []
    for _ in range(steps):
        im = model(pos, fx)
        preds.append(im)
        fx = torch.cat([fx[..., step_width:], im.to(fx.dtype)], dim=-1)
    return torch.cat(preds, dim=-1)


class _Rollout(torch.nn.Module):
    """:func:`rollout` of the model as a module of ``(pos, fx0)``."""

    def __init__(self, model: torch.nn.Module, steps: int, step_width: int):
        super().__init__()
        self.model = model
        self.steps = steps
        self.step_width = step_width

    def forward(self, pos, fx0):
        return rollout(self.model, pos, fx0, self.steps, self.step_width)


def _dtype_name(a) -> str:
    """numpy's name for the dtype of an array or tensor (``float32``,
    ``bfloat16``, ``int64``)."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.dtype(getattr(a, "dtype", None) or np.asarray(a).dtype).name


def _canonical_input_dtypes(example_args) -> list[str]:
    """What the exported program takes (``haet_tpu/export.py:292-304``):
    64-bit example data exports a 32-bit program."""
    return [_CANONICAL.get(_dtype_name(a), _dtype_name(a))
            for a in example_args if a is not None]


def _input_shapes(example_args) -> list[list[int]]:
    return [list(np.shape(a)) for a in example_args if a is not None]


def _input_dtypes(args) -> list[str]:
    # the array's ACTUAL dtype: a float64 request must meet the check, not
    # a silent cast
    return [_dtype_name(a) for a in args if a is not None]


def _to_device(a, device, dtype_name=None) -> torch.Tensor:
    """An array or tensor as a tensor on ``device`` (optionally cast to
    ``dtype_name``). numpy has no bf16: a bf16 input comes as a tensor."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if dtype_name is not None and _dtype_name(t) != dtype_name:
        t = t.to(getattr(torch, dtype_name))
    return t.to(device)


def _variables_spec(variables: Mapping) -> dict:
    """``{name: [shape, dtype]}`` of a state dict: the counterpart of the
    JAX manifest's ``variables_treedef``."""
    return {k: [list(np.shape(v)), _dtype_name(v)]
            for k, v in variables.items()}


def _spec_mismatch(want: dict, variables) -> str | None:
    """The first difference between ``variables`` and the spec, or None."""
    if not isinstance(variables, Mapping):
        return f"variables must be a state dict, got {type(variables)}"
    got = _variables_spec(variables)
    for name in want:
        if name not in got:
            return f"{name!r} is missing"
    for name in got:
        if name not in want:
            return f"{name!r} is not a variable of the program"
    for name, (shape, dtype) in want.items():
        if got[name] != [shape, dtype]:
            return (f"{name!r} has shape {got[name][0]} and dtype "
                    f"{got[name][1]}, the program takes {shape} {dtype}")
    return None


def _raise_variables_mismatch(want: dict, variables) -> None:
    why = _spec_mismatch(want, variables)
    if why is not None and isinstance(variables, Mapping) and any(
            k.startswith("layers.") for k in variables):
        raise ValueError(
            f"variables tree mismatch: {why}. These variables are a --pp "
            "run's stacked pipeline layout; convert them with "
            "haet_torch.parallel.pipeline.merge_raw_variables first.")
    if why is not None:
        raise ValueError(
            f"variables tree mismatch: {why}. The artifact was exported "
            f"with {len(want)} parameters and buffers (manifest "
            "'variables'); serve the model's state_dict (for a training "
            "checkpoint, its 'model' entry) of the exported configuration.")


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def _check_mesh(model, example_args, mesh, data_axis, platforms) -> None:
    """JAX's checks of a multi-chip export (``:209-234``)."""
    if platforms is not None:
        raise ValueError(
            "mesh= and platforms= are mutually exclusive: a sharded "
            "lowering pins the backend the mesh lives on")
    if not parallel.mesh_models(model):
        raise ValueError(f"{type(model).__name__} holds no HAET model to "
                         "export over a mesh")
    if data_axis is None:
        return
    if data_axis != "dp" or data_axis not in mesh.shape:
        raise ValueError(f"data_axis is 'dp' or None, got {data_axis!r}")
    n_dp = int(mesh.shape[data_axis])
    for a in example_args:
        if a is None or np.ndim(a) == 0:
            continue
        if np.shape(a)[0] % n_dp:
            raise ValueError(
                f"batch {np.shape(a)[0]} does not divide the "
                f"'{data_axis}' mesh axis ({n_dp}); export batch sizes "
                "that are multiples of the data-parallel degree, or pass "
                "data_axis=None for replicated inputs (model-internal "
                "sharding)")


def _export(wrapper, model, variables, example_args, mesh, data_axis="dp",
            platforms=None):
    """``torch.export`` of ``wrapper`` (a module holding ``model``) over the
    array inputs of ``example_args``, in eval mode under ``no_grad``; over
    ``mesh`` (bound for the trace, its calls traced as ``haet::mesh_*``)
    when one is given."""
    device = _model_device(model)
    if mesh is not None:
        _check_mesh(model, example_args, mesh, data_axis, platforms)
    elif platforms is not None and list(platforms) != [device.type]:
        raise ValueError(
            f"platforms={list(platforms)}: a program is exported for the "
            f"device its model lies on ({device.type}); move the model")
    state = model.state_dict()
    if variables is not None:
        _raise_variables_mismatch(_variables_spec(state), variables)
    dts = _canonical_input_dtypes(example_args)
    arrays = tuple(_to_device(a, device, dt) for a, dt in zip(
        [a for a in example_args if a is not None], dts))
    was_training = model.training
    bound = [(m, m.mesh, m.mesh_split_batch)
             for m in parallel.mesh_models(model)] if mesh else []
    model.eval()
    try:
        for m, _, _ in bound:
            m.bind_mesh(mesh, split_batch=data_axis is not None)
        with torch.no_grad(), (mesh_ops.exporting(mesh) if mesh
                               else contextlib.nullcontext()):
            return torch.export.export(wrapper, arrays, strict=False)
    finally:
        for m, prev, split in bound:
            m.bind_mesh(prev, split_batch=split)
        model.train(was_training)


def export_apply(model: torch.nn.Module, variables, example_args:
                 Sequence[Any], *, platforms=None, mesh=None,
                 data_axis: str | None = "dp"):
    """Export the model's eval forward to a ``torch.export.ExportedProgram``.

    Args:
        model: a HAET model (any module called as ``model(*args)``), on the
            device the program is for.
        variables: its state dict, or None for the model's own; checked
            against the model's names, shapes and dtypes and otherwise
            unused (the program does not depend on the weights' values).
        example_args: positional model inputs with the serving shapes, batch
            included; numpy arrays or tensors. ``None`` entries (``fx=None``)
            are dropped from the program's inputs. 64-bit floats export a
            float32 program, as ``jax.export`` canonicalises them.
        platforms: the device types to export for: the model's own only
            (a program holds constants of its device); None for it.
        mesh: a :class:`~haet_torch.parallel.Mesh` to export the program
            over (module docstring); exclusive with ``platforms``.
        data_axis: ``"dp"`` (the batch split over dp) or None (replicated
            inputs, the model's own head split).

    The trace runs in eval mode under ``torch.no_grad()`` (the model's mode
    is restored after), so the kernels appear as the ``haet::`` operators.
    An export that fails raises; nothing falls back to the eager model.
    """
    return _export(_Apply(model, tuple(a is None for a in example_args)),
                   model, variables, example_args, mesh, data_axis,
                   platforms)


def export_rollout(model: torch.nn.Module, variables,
                   example_args: Sequence[Any], *, steps: int,
                   step_width: int | None = None, platforms=None, mesh=None,
                   data_axis: str | None = "dp"):
    """Export a ``steps``-step autoregressive rollout (:func:`rollout`) as
    one program of ``(pos, fx0)`` (``haet_tpu/export.py:151-191``).

    Args:
        example_args: ``(pos, fx0)``, ``fx0`` the ``[B, N, T_in]`` window
            of input frames.
        steps: autoregressive steps in the program (unrolled).
        step_width: frames predicted per step; the model's ``out_dim`` by
            default, and it must equal it. ``T_in`` must be at least
            ``step_width``, so that the window can slide.

    Raises ``ValueError`` naming ``out_dim``, the ``window`` or ``steps``
    where JAX does.
    """
    args = tuple(a for a in example_args if a is not None)
    if len(args) != 2:
        raise ValueError(
            f"rollout export takes exactly (pos, fx0), got {len(args)} "
            "array inputs")
    out_dim = getattr(model, "out_dim", None)
    if step_width is None:
        if out_dim is None:
            raise ValueError("pass step_width= (model has no out_dim)")
        step_width = out_dim
    step_width = int(step_width)
    if out_dim is not None and int(out_dim) != step_width:
        raise ValueError(
            f"step_width ({step_width}) must equal the model's out_dim "
            f"({out_dim}): each step's prediction IS the appended frames")
    t_in = int(np.shape(args[1])[-1])
    if t_in < step_width:
        raise ValueError(
            f"the input window (fx0 last dim = {t_in}) must hold at least "
            f"step_width ({step_width}) frames to slide")
    if int(steps) < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return _export(_Rollout(model, int(steps), step_width), model,
                   variables, args, mesh, data_axis, platforms)


def _by_writer(mesh, write, model, example_args, data_axis, platforms):
    """``write()`` on the writer rank of a mesh export (every rank calls
    it, and every rank checks the request first), the others waiting for
    it; ``write()`` alone without a mesh."""
    if mesh is None:
        return write()
    _check_mesh(model, example_args, mesh, data_axis, platforms)
    try:
        if parallel.is_writer():
            write()
    finally:
        parallel.barrier()


def save_artifact(path: str, model: torch.nn.Module, variables,
                  example_args: Sequence[Any], *,
                  extra_manifest: dict | None = None, platforms=None,
                  mesh=None, data_axis: str | None = "dp") -> str:
    """Export and write a self-contained artifact directory: ``path/
    apply.pt2`` (the program) and ``path/manifest.json`` (input shapes and
    dtypes, the device type, the variables' names, shapes and dtypes, the
    mesh's size, shape and ``data_axis``, and ``extra_manifest``, which
    cannot override those). With ``mesh`` every rank calls it and rank 0
    exports and writes. Returns ``path``."""
    def write():
        program = export_apply(model, variables, example_args,
                               platforms=platforms, mesh=mesh,
                               data_axis=data_axis)
        _write_artifact(path, program, model, variables, example_args,
                        extra_manifest, mesh, data_axis)

    _by_writer(mesh, write, model, example_args, data_axis, platforms)
    return path


def save_rollout_artifact(path: str, model: torch.nn.Module, variables,
                          example_args: Sequence[Any], *, steps: int,
                          step_width: int | None = None,
                          extra_manifest: dict | None = None,
                          platforms=None, mesh=None,
                          data_axis: str | None = "dp") -> str:
    """Export and write a ``steps``-step rollout artifact
    (:func:`export_rollout`; ``haet_tpu/export.py:332-363``): the layout of
    :func:`save_artifact`, the manifest recording ``rollout_steps`` and
    ``step_width`` after the caller's extras. It serves through
    :func:`load_artifact`, :class:`ServingBundle`, :class:`BoundBundle` and
    ``haet_torch.serve.BatchingServer`` as a forward's program does; its
    output is ``[B, N, steps * step_width]``."""
    if step_width is None:
        step_width = getattr(model, "out_dim", None)

    def write():
        program = export_rollout(model, variables, example_args,
                                 steps=steps, step_width=step_width,
                                 platforms=platforms, mesh=mesh,
                                 data_axis=data_axis)
        _write_artifact(
            path, program, model, variables, example_args,
            # after the caller's extras: facts about the exported program
            {**(extra_manifest or {}), "rollout_steps": int(steps),
             "step_width": int(step_width)}, mesh, data_axis)

    _by_writer(mesh, write, model, example_args, data_axis, platforms)
    return path


def _write_artifact(path, program, model, variables, example_args,
                    extra_manifest, mesh=None, data_axis=None) -> str:
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _BLOB))
    state = model.state_dict() if variables is None else variables
    manifest = {
        # caller extras FIRST: the measured fields below are the serving
        # guards' ground truth and must not be overridable
        **(extra_manifest or {}),
        "input_shapes": _input_shapes(example_args),
        "input_dtypes": _canonical_input_dtypes(example_args),
        "device": _model_device(model).type,
        "model": type(model).__name__,
        "n_arrays_variables": len(state),
        "variables": _variables_spec(state),
        "nr_devices": 1 if mesh is None else _mesh_size(mesh),
        **({"data_axis": data_axis, "mesh_shape": dict(mesh.shape)}
           if mesh is not None else {}),
        "torch": torch.__version__,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class ExportedModel:
    """A loaded artifact: ``model(variables, *args)`` runs the program over
    the caller's state dict; :meth:`bind` gives a function of the inputs
    alone. Inputs are numpy arrays or tensors, checked against the
    exported shapes and dtypes first; the output is a tensor on the
    program's device (the CUDA launches are asynchronous), made under
    ``torch.inference_mode()``."""

    def __init__(self, program, manifest: dict, device, mesh=None):
        self.program = program
        self.manifest = manifest
        self.device = torch.device(device)
        #: the mesh a multi-chip program runs over (None for one device)
        self.mesh = mesh

    @property
    def nr_devices(self) -> int:
        return int(self.manifest.get("nr_devices", 1))

    def _over_mesh(self):
        """The context its calls run in: the mesh its ``haet::mesh_*``
        operators resolve against."""
        return (mesh_ops.using(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    @functools.cached_property
    def module(self) -> torch.nn.Module:
        """The program as a module holding its saved weights, which
        ``__call__`` replaces with the caller's (made on first use)."""
        return self.program.module()

    @property
    def input_shapes(self) -> list[list[int]]:
        return self.manifest["input_shapes"]

    def _check(self, args):
        want = self.input_shapes
        got = [list(np.shape(a)) for a in args if a is not None]
        if got != want:
            raise ValueError(
                f"shape mismatch: artifact was exported for inputs {want}, "
                f"got {got}. Padding is NOT applied implicitly — duplicate "
                "points would change the rep-slice statistics, and batch "
                "size is part of the program (module docstring); export an "
                "artifact per serving signature (ServingBundle).")
        want_dt = self.manifest["input_dtypes"]
        got_dt = _input_dtypes(args)
        if got_dt != want_dt:
            raise ValueError(
                f"dtype mismatch: artifact was exported for input dtypes "
                f"{want_dt}, got {got_dt}. Cast the inputs explicitly (no "
                "implicit casts at the serving boundary).")

    def _check_variables(self, variables) -> None:
        """Names, shapes and dtypes of ``variables`` against the manifest;
        raises naming the first mismatch."""
        _raise_variables_mismatch(self.manifest["variables"], variables)

    def _inputs(self, args):
        args = tuple(a for a in args if a is not None)
        self._check(args)
        return tuple(_to_device(a, self.device) for a in args)

    def __call__(self, variables, *args):
        self._check_variables(variables)
        inputs = self._inputs(args)
        state = {_PREFIX + k: _to_device(v, self.device)
                 for k, v in variables.items()}
        with torch.inference_mode(), self._over_mesh():
            return torch.func.functional_call(self.module, state, inputs)

    def bind(self, variables):
        """``fn(*args)`` with ``variables`` loaded into a module of its own
        (:func:`_bind_state`; the program's saved weights are not touched)."""
        return self._bind_tensors(_bind_state(self, variables))

    def _bind_tensors(self, tensors: dict):
        """``fn(*args)`` over a fresh module holding ``tensors`` themselves
        (no copy): modules bound to one dict share its storage, so an
        in-place update of the dict reaches all of them."""
        module = self.program.module()
        module.load_state_dict({_PREFIX + k: v for k, v in tensors.items()},
                               assign=True)

        def fn(*args):
            inputs = self._inputs(args)
            with torch.inference_mode(), self._over_mesh():
                return module(*inputs)

        return fn


def _bind_state(model: ExportedModel, variables) -> dict:
    """``variables`` checked against ``model``'s manifest and copied onto
    its device as fresh tensors (the storage bound programs share)."""
    model._check_variables(variables)
    return {k: _to_device(v, model.device).clone()
            for k, v in variables.items()}


def load_artifact(path: str, mesh=None, device=None) -> ExportedModel:
    """Load an artifact directory for ``device`` (default: the card; it
    must be the device type the program was exported on). A multi-chip
    program needs ``mesh``, a :class:`~haet_torch.parallel.Mesh` of its
    size, over which every rank then calls it (``:409-420``)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    dev = default_device(device)
    if dev.type != manifest["device"]:
        raise ValueError(
            f"{path} holds a program exported on {manifest['device']}; it "
            f"runs there only, not on {dev} (export it again on {dev.type})")
    n = int(manifest.get("nr_devices", 1))
    if n > 1:
        if mesh is None:
            raise ValueError(
                f"this artifact is a multi-chip program ({n} devices, data "
                f"axis {manifest.get('data_axis')!r}); pass a mesh of that "
                "size to load_artifact(path, mesh=...)")
        if _mesh_size(mesh) != n:
            raise ValueError(
                f"mesh has {_mesh_size(mesh)} devices but the artifact was "
                f"exported for {n}")
    program = torch.export.load(os.path.join(path, _BLOB))
    return ExportedModel(program, manifest, dev, mesh if n > 1 else None)


class ServingBundle:
    """Several exported shapes behind one ``predict``: each input signature
    (batch x points x channels) has its own program and a request
    dispatches by exact shape; ``shapes()`` lists them, a miss raises."""

    def __init__(self, models: Sequence[ExportedModel]):
        self._by_key = {}
        for m in models:
            key = tuple(tuple(s) for s in m.input_shapes)
            prev = self._by_key.get(key)
            if prev is not None:
                # dispatch is by SHAPE: two programs with one signature would
                # shadow one another, the directory order picking the winner
                def _what(x):
                    man = getattr(x, "manifest", {}) or {}
                    return {k: man.get(k) for k in
                            ("input_dtypes", "rollout_steps", "batch_size",
                             "model")
                            if man.get(k) is not None}

                raise ValueError(
                    f"ambiguous bundle: two artifacts share the input "
                    f"signature {key} ({_what(prev)} vs {_what(m)}); "
                    "dispatch is by shape, so one would silently shadow "
                    "the other — use a separate bundle root per program "
                    "family")
            self._by_key[key] = m

    @property
    def device(self):
        devs = {getattr(m, "device", None) for m in self._by_key.values()}
        return devs.pop() if len(devs) == 1 else None

    @property
    def mesh(self):
        """The mesh its multi-chip programs run over, or None."""
        meshes = {id(m.mesh): m.mesh for m in self._by_key.values()
                  if getattr(m, "mesh", None) is not None}
        return next(iter(meshes.values())) if meshes else None

    @classmethod
    def load(cls, root: str, mesh=None, device=None) -> "ServingBundle":
        """Load every artifact directory directly under ``root`` for
        ``device`` (default: the card); ``mesh`` for multi-chip
        programs."""
        subdirs = sorted(os.path.join(root, d) for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        return cls([load_artifact(d, mesh=mesh, device=device)
                    for d in subdirs
                    if os.path.exists(os.path.join(d, _MANIFEST))])

    def shapes(self):
        return sorted(self._by_key)

    def _model(self, args) -> ExportedModel:
        key = tuple(tuple(np.shape(a)) for a in args if a is not None)
        m = self._by_key.get(key)
        if m is None:
            raise ValueError(f"no artifact for input shapes {key}; "
                             f"available: {self.shapes()}")
        return m

    def predict(self, variables, *args):
        return self._model(args)(variables, *args)

    def bind(self, variables) -> "BoundBundle":
        """Every program of the bundle over one checkpoint
        (:class:`BoundBundle`), which ``haet_torch.serve.BatchingServer``
        serves."""
        return BoundBundle(self, variables)


class BoundBundle:
    """A :class:`ServingBundle` with one checkpoint: the state is checked
    and copied onto the device once, here, and shared by every program,
    each bound on its first dispatch. :meth:`update` copies another
    checkpoint into that shared state in place."""

    def __init__(self, bundle: ServingBundle, variables):
        self._bundle = bundle
        self._bound = {}
        models = list(bundle._by_key.values())
        self._tensors = _bind_state(models[0], variables) if models else {}

    @property
    def _by_key(self):
        # the artifact map with its manifests: the server's dtype, bucket
        # and structure guards read it from a bound bundle too
        return self._bundle._by_key

    @property
    def device(self):
        return self._bundle.device

    @property
    def mesh(self):
        return self._bundle.mesh

    def shapes(self):
        return self._bundle.shapes()

    def _check_variables(self, variables) -> None:
        for m in self._by_key.values():
            m._check_variables(variables)

    def update(self, variables) -> None:
        """Copy ``variables`` into the bound state in place, on the current
        stream: work queued before it reads the old weights, work queued
        after it the new ones. Checks every program's manifest first, so a
        wrong tree raises before anything changes."""
        self._check_variables(variables)
        with torch.no_grad():
            for k, t in self._tensors.items():
                v = variables[k]
                t.copy_(v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(v)))

    def predict(self, *args):
        key = tuple(tuple(np.shape(a)) for a in args if a is not None)
        fn = self._bound.get(key)
        if fn is None:
            fn = self._bound[key] = self._bundle._model(args)._bind_tensors(
                self._tensors)
        return fn(*args)
