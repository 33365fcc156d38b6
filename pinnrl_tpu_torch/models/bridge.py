"""Parameter bridge between the flax parameter tree and the port's state_dict.

- ``Dense_i/kernel`` (in, out)        <-> ``Dense_i.weight`` (out, in)
- ``Dense_i/bias``                     <-> ``Dense_i.bias``
- ``LayerNorm_i/{scale, bias}``        <-> ``LayerNorm_i.{weight, bias}``
- ``constants/FourierFeatures_0/B``    <-> the ``FourierFeatures_0.B`` buffer
- ``SIRENLayer_i/{kernel, bias}``      <-> ``SIRENLayer_i.{kernel, bias}`` (flax's
  (in, out) layout kept: it is the SIREN kernel's W); SIREN's final layer is
  ``Dense_0`` under the Dense rule
- nested modules (ResNet's ``ResNetBlock_i/Dense_0/kernel``) <-> dotted
  paths (``ResNetBlock_i.Dense_0.weight``), each leaf under the rule of its
  innermost module

The same rules carry the DQN agent's tree (``dqn_params_from_flax`` /
``dqn_params_to_flax``): ``Dense_{0,1,2}`` and ``LayerNorm_{0,1}``.

Both sides are plain numpy here, so the module imports neither JAX nor
flax: callers hand over ``jax.tree_util.tree_map(np.asarray, ...)``.
``flat_flax_arrays`` / ``state_from_flat_flax`` flatten the two flax trees
into ``"params/Dense_0/kernel"``-style keys (a saved model's ``.npz``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_LN_NAMES = {"scale": "weight", "bias": "bias"}


def params_from_flax(
    params_np: Mapping[str, Any], constants_np: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``constants`` collections) -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _leaves_from_flax(params_np, "", out)
    for collection, modules in (constants_np or {}).items():
        if collection != "constants":
            raise KeyError(f"no bridge rule for flax collection {collection!r}")
        for module, leaves in modules.items():
            for name, value in leaves.items():
                arr = np.asarray(value, dtype=np.float32)
                out[f"{module}.{name}"] = torch.from_numpy(arr.copy())
    return out


def _leaves_from_flax(tree: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """The leaves of one level of a flax ``params`` tree into ``out``; a
    module holding modules is walked with its name as a path prefix."""
    for module, leaves in tree.items():
        if any(isinstance(v, Mapping) for v in leaves.values()):
            _leaves_from_flax(leaves, f"{prefix}{module}.", out)
            continue
        for name, value in leaves.items():
            arr = np.asarray(value, dtype=np.float32)
            path = f"{prefix}{module}"
            if module.startswith("Dense_") and name == "kernel":
                out[f"{path}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
            elif module.startswith("LayerNorm_"):
                out[f"{path}.{_LN_NAMES[name]}"] = torch.from_numpy(arr.copy())
            elif module.startswith("Dense_") and name == "bias":
                out[f"{path}.bias"] = torch.from_numpy(arr.copy())
            elif module.startswith("SIRENLayer_") and name in ("kernel", "bias"):
                out[f"{path}.{name}"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no bridge rule for flax leaf {path.replace('.', '/')}/{name}")


def params_to_flax(state: Mapping[str, torch.Tensor]):
    """torch state_dict -> (flax ``params`` tree, ``constants`` tree) of numpy."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    constants: Dict[str, Dict[str, np.ndarray]] = {}
    inv_ln = {v: k for k, v in _LN_NAMES.items()}
    for key, value in state.items():
        *outer, module, name = key.split(".")
        arr = value.detach().cpu().numpy()
        node = params
        for parent in outer:  # a nested module (ResNetBlock_i.Dense_0.weight)
            node = node.setdefault(parent, {})
        if module.startswith("Dense_"):
            leaf = "kernel" if name == "weight" else name
            node.setdefault(module, {})[leaf] = np.ascontiguousarray(arr.T) if name == "weight" else arr
        elif module.startswith("LayerNorm_"):
            node.setdefault(module, {})[inv_ln[name]] = arr
        elif module.startswith("SIRENLayer_") and name in ("kernel", "bias"):
            node.setdefault(module, {})[name] = arr
        elif module.startswith("FourierFeatures_") and not outer:
            constants.setdefault(module, {})[name] = arr
        else:
            raise KeyError(f"no bridge rule for state_dict entry {key!r}")
    return params, ({"constants": constants} if constants else {})


_DQN_TREE = {
    "Dense_0": {"kernel", "bias"}, "LayerNorm_0": {"scale", "bias"},
    "Dense_1": {"kernel", "bias"}, "LayerNorm_1": {"scale", "bias"},
    "Dense_2": {"kernel", "bias"},
}


def dqn_params_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``DQNNetwork``'s flax ``params`` -> the port's DQN parameter dict."""
    tree = {module: set(leaves) for module, leaves in params_np.items()}
    if tree != _DQN_TREE:
        raise KeyError(f"not a DQNNetwork parameter tree: {tree}")
    return params_from_flax(params_np)


def dqn_params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's DQN parameter dict -> ``DQNNetwork``'s flax ``params``."""
    params, constants = params_to_flax(state)
    if constants or {m: set(v) for m, v in params.items()} != _DQN_TREE:
        raise KeyError(f"not a DQN parameter dict: {sorted(state)}")
    return params


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def flat_flax_arrays(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """torch state_dict -> {"params/<flax path>": array, "constants/<...>": array}."""
    params, constants = params_to_flax(state)
    out: Dict[str, np.ndarray] = {}
    _flatten({"params": params, **constants}, "", out)
    return out


def state_from_flat_flax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of ``flat_flax_arrays``."""
    trees: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = trees
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    constants = {k: v for k, v in trees.items() if k != "params"}
    return params_from_flax(trees.get("params", {}), constants)
