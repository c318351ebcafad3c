"""Carry the JAX package's DMSP variables into the port's modules.

The JAX package keeps a flax module's variables as two nested dicts,
``params`` and ``constants`` (each ``RFF``'s ``N``).  Given them as numpy
arrays, :func:`state_dict_from_jax` builds the ``state_dict()`` of the
port's counterpart, a whole ``Synthesizer`` or one of its blocks: flax
``Dense`` kernels ``(in, out)`` become ``Linear`` weights ``(out, in)``, an
``MLP``'s ``prelu_a_<i>`` scalars its ``prelu`` vector, and every other
leaf (``e``, ``gain_in``, ``gain_out``, ``noise_gate``, ``noise_env_gain``,
``N``) keeps its shape.  Every flax leaf is consumed exactly once: a leaf
the port has no place for, or a port entry no leaf fills, raises
``ValueError``.

:func:`load_orbax` reads those two dicts from a checkpoint directory the
JAX package's ``tasks/trainer.py::save_checkpoint`` writes with orbax
(``step_<n>/``: ``_METADATA`` and an OCDBT key-value store of zarr
arrays), through tensorstore alone (:func:`read_orbax`); it imports
neither jax nor orbax.  :func:`optimizer_state_from_jax` carries the optax
state of the sibling ``optstate_<n>/`` into the ``state_dict()`` of the
port's optimizer (``models/optim.py``), so that the port resumes a JAX
run.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .blocks import MLP, RFF, RFF2, AMBlock, FMBlock, ModeEstimator
from .physmodes import PhysicsModeEstimator
from .synthesizer import DDSPCore, Synthesizer


def _flatten(tree, prefix, out):
    for key, val in tree.items():
        path = f"{prefix}/{key}"
        if hasattr(val, "items"):
            _flatten(val, path, out)
        else:
            out[path] = np.array(val)
    return out


class _Leaves:
    """The flax leaves by path (``params/...``, ``constants/...``), each
    handed out once."""

    def __init__(self, variables):
        self.flat = {}
        for col in ("params", "constants"):
            _flatten(variables.get(col, {}), col, self.flat)

    def pop(self, path):
        if path not in self.flat:
            raise ValueError(f"the JAX variables have no leaf {path}")
        return self.flat.pop(path)


def _join(*parts):
    return ".".join(p for p in parts if p)


def _sub(path, name):
    """A flax sub-path below a module path relative to the collection."""
    return f"{path}/{name}" if path else name


def _dense(leaves, fp, tp, sd):
    sd[_join(tp, "weight")] = leaves.pop(f"params/{fp}/kernel").T
    sd[_join(tp, "bias")] = leaves.pop(f"params/{fp}/bias")


def _mlp(mlp: MLP, leaves, fp, tp, sd):
    n = len(mlp.layers)
    for i in range(n):
        _dense(leaves, _sub(fp, f"Dense_{i}"), _join(tp, f"layers.{i}"), sd)
    sd[_join(tp, "prelu")] = np.stack(
        [leaves.pop("params/" + _sub(fp, f"prelu_a_{i}")) for i in range(n)])


def _rff(leaves, fp, tp, sd):
    sd[_join(tp, "e")] = leaves.pop("params/" + _sub(fp, "e"))
    sd[_join(tp, "N")] = leaves.pop("constants/" + _sub(fp, "N"))


def _block(block, leaves, fp, tp, sd):
    """FMBlock / AMBlock."""
    sd[_join(tp, "rff2.e")] = leaves.pop("params/" + _sub(fp, "RFF2_0/e"))
    sd[_join(tp, "gain_in")] = leaves.pop("params/" + _sub(fp, "gain_in"))
    if isinstance(block, FMBlock):
        sd[_join(tp, "gain_out")] = leaves.pop("params/" + _sub(fp, "gain_out"))
    _mlp(block.mlp, leaves, _sub(fp, "MLP_0"), _join(tp, "mlp"), sd)
    _dense(leaves, _sub(fp, "Dense_0"), _join(tp, "out"), sd)


def _estimator(est: ModeEstimator, leaves, fp, tp, sd):
    _rff(leaves, _sub(fp, "RFF_0"), _join(tp, "rff"), sd)
    _mlp(est.amp_mlp, leaves, _sub(fp, "MLP_0"), _join(tp, "amp_mlp"), sd)
    _dense(leaves, _sub(fp, "Dense_0"), _join(tp, "amp_out"), sd)
    if est.inharmonic:
        _mlp(est.freq_mlp, leaves, _sub(fp, "MLP_1"), _join(tp, "freq_mlp"), sd)
        _dense(leaves, _sub(fp, "Dense_1"), _join(tp, "freq_out"), sd)


def _synthesizer(model: Synthesizer, leaves, sd):
    if not isinstance(model.estimator, PhysicsModeEstimator):  # physics: no variables
        _estimator(model.estimator, leaves, "ModeEstimator_0", "estimator", sd)
    _rff(leaves, "RFF_0", "rff", sd)
    core = model.core
    fp = "DDSPCore_0" if isinstance(core, DDSPCore) else "DMSPCore_0"
    if core.fm is not None:
        _block(core.fm, leaves, f"{fp}/FMBlock_0", "core.fm", sd)
    _block(core.am, leaves, f"{fp}/AMBlock_0", "core.am", sd)
    _dense(leaves, f"{fp}/Dense_0", "core.noise_dense", sd)
    for name in ("noise_env_gain", "noise_gate"):
        if hasattr(core, name):
            sd[f"core.{name}"] = leaves.pop(f"params/{fp}/{name}")


def state_dict_from_jax(module, variables):
    """The port's ``module.state_dict()`` from the JAX package's
    ``{"params": ..., "constants": ...}`` of the same configuration;
    ``module`` is a ``Synthesizer`` or one of its blocks."""
    leaves = _Leaves(variables)
    sd = {}
    if isinstance(module, Synthesizer):
        _synthesizer(module, leaves, sd)
    elif isinstance(module, ModeEstimator):
        _estimator(module, leaves, "", "", sd)
    elif isinstance(module, (FMBlock, AMBlock)):
        _block(module, leaves, "", "", sd)
    elif isinstance(module, MLP):
        _mlp(module, leaves, "", "", sd)
    elif isinstance(module, RFF):
        _rff(leaves, "", "", sd)
    elif isinstance(module, RFF2):
        sd["e"] = leaves.pop("params/e")
    elif not isinstance(module, PhysicsModeEstimator):
        raise TypeError(f"no conversion for {type(module).__name__}")
    if leaves.flat:
        raise ValueError(f"JAX leaves with no place in the port: {sorted(leaves.flat)}")
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"port entries no JAX leaf fills: {missing}")
    out = {}
    for key, val in sd.items():
        ref = own[key]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {val.shape}, port shape {tuple(ref.shape)}")
        out[key] = torch.as_tensor(val, dtype=ref.dtype)
    return out


def load_jax_variables(module, variables):
    """Load the JAX package's variables into ``module``, strictly."""
    module.load_state_dict(state_dict_from_jax(module, variables), strict=True)
    return module


CONVERT_TOOL = "python -m torch_fdtd_string_tpu_torch.tools.convert_orbax"


def read_orbax(ckpt_dir):
    """The tree an orbax checkpoint directory of the JAX package holds
    (``step_<n>/`` or ``optstate_<n>/``), as nested dicts of numpy arrays:
    a tuple's items under ``"0"``, ``"1"``, ..., a named tuple's under its
    field names.  Leaves orbax stores no value for (an empty optax state)
    are left out.  The keys come from ``_METADATA``'s ``tree_metadata``;
    each array is read from the checkpoint's OCDBT store by tensorstore,
    as ``zarr3`` arrays when ``use_zarr3`` is set, else ``zarr``.  Without
    tensorstore it raises an ``ImportError`` naming the tool that converts
    such a run on a host that has it."""
    try:
        import tensorstore as ts
    except ImportError as err:
        raise ImportError(
            f"{ckpt_dir} is a JAX (orbax) checkpoint, and reading it needs tensorstore, "
            f"which this host lacks; convert the run on a host that has it with "
            f"`{CONVERT_TOOL} <jax run dir> <out run dir> [overrides]` "
            "(tools/convert_orbax.py) and use the converted run") from err
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{ckpt_dir}: only OCDBT checkpoints are read (the JAX package's)")
    array_format = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": "file://" + os.path.abspath(ckpt_dir)}
    tree = {}
    for entry in meta["tree_metadata"].values():
        if (entry.get("value_metadata") or {}).get("skip_deserialize"):
            continue
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        spec = {"driver": array_format, "kvstore": kvstore, "path": ".".join(keys)}
        arr = np.asarray(ts.open(spec, open=True).result().read().result())
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def load_orbax(step_dir):
    """The flax variables (``{"params": ..., "constants": ...}``, numpy) of
    the JAX package's orbax checkpoint ``step_dir``, which holds the
    ``params`` tree and, under ``constants``, every other collection (JAX
    ``TrainState.constants``); read by :func:`read_orbax`."""
    tree = read_orbax(step_dir)
    return {"params": tree.get("params", {}), **tree.get("constants", {})}


_PLATEAU = ("scale", "best_value", "plateau_count")


def _optax_parts(node, out):
    """The states of an optax chain's transformations, by kind: the
    moments (``mu`` / ``nu`` of Adam's family, ``trace`` of SGD), every
    update ``count`` and the plateau rule's state."""
    if not isinstance(node, dict):
        return out
    if all(k in node for k in _PLATEAU):
        out["plateau"] = {k: node[k] for k in _PLATEAU}
        return out
    if "count" in node and not isinstance(node["count"], dict):
        out["counts"].append(int(node["count"]))
    for key in ("mu", "nu", "trace"):
        if key in node:
            out["moments"][key] = node[key]
    for key, val in node.items():
        if key not in ("mu", "nu", "trace") and isinstance(val, dict):
            _optax_parts(val, out)
    return out


def optimizer_state_from_jax(model, optimizer, opt_state, variables):
    """The ``state_dict()`` of ``optimizer`` (a ``models/optim.py``
    optimizer over ``model.parameters()``) that holds the JAX package's
    optax state ``opt_state`` (the ``opt_state`` tree of an
    ``optstate_<n>/`` checkpoint, :func:`read_orbax`) of the chain the port
    mirrors, ``clip -> scaling -> schedule -> plateau``: each parameter's
    moments (``mu`` and ``nu``, or SGD's ``trace``), carried like the
    parameters (:func:`state_dict_from_jax`, which takes the run's
    ``constants`` from ``variables``), the update count, and the plateau
    rule's ``scale``, ``best_value`` and ``plateau_count`` (at the JAX
    package's accumulation size of 1, its ``count`` and ``avg_value`` are
    0 after every update).  A NovoGrad state (one second moment per flax
    leaf, and no config offers NovoGrad) is refused."""
    from .optim import NovoGrad

    if isinstance(optimizer, NovoGrad):
        raise ValueError("carrying a NovoGrad state is not ported: its second moments are one "
                         "scalar per flax leaf, and no config offers NovoGrad")
    parts = _optax_parts(opt_state, {"moments": {}, "counts": [], "plateau": None})
    if len(set(parts["counts"])) > 1:
        raise ValueError(f"the optax state's counts disagree: {parts['counts']}")
    if (parts["plateau"] is None) != (optimizer.plateau is None):
        raise ValueError("the optax state and the optimizer disagree on the plateau rule")
    constants = {k: v for k, v in variables.items() if k != "params"}
    moments = {key: state_dict_from_jax(model, {"params": tree, **constants})
               for key, tree in parts["moments"].items()}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sd = optimizer.state_dict()
    sd["state"] = {i: {key: m[names[id(p)]] for key, m in moments.items()}
                   for i, p in enumerate(params)}
    count = parts["counts"][0] if parts["counts"] else 0
    for group in sd["param_groups"]:
        group["count"] = count
    if parts["plateau"] is not None:
        sd["plateau"] = {k: torch.as_tensor(v) for k, v in parts["plateau"].items()}
    return sd
