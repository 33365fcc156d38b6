"""Parameter bridge between the flax parameter tree and the port's state_dict.

- ``Dense_i/kernel`` (in, out)        <-> ``Dense_i.weight`` (out, in), and so
  for every Dense under another name: the autoencoder's ``encoder_layers_i``,
  ``decoder_layers_i``, ``to_latent``, ``to_output``, the modified trunk's
  ``enc_u``, ``enc_v``, ``gate_i``
- ``Dense_i/bias``                     <-> ``Dense_i.bias``
- ``LayerNorm_i/{scale, bias}``        <-> ``LayerNorm_i.{weight, bias}``, and
  the autoencoder's ``encoder_norms_i``, ``decoder_norms_i``
- ``constants/FourierFeatures_0/B``    <-> the ``FourierFeatures_0.B`` buffer;
  ``params/FourierFeatures_0/B`` (a trainable basis) <-> the parameter of
  that name (``params_to_flax`` takes the parameters' names to tell them
  apart)
- a deep ensemble's stacked leaves (a leading member axis) under the same
  rules: kernels swap their last two axes
- ``SIRENLayer_i/{kernel, bias}``      <-> ``SIRENLayer_i.{kernel, bias}`` (flax's
  (in, out) layout kept: it is the SIREN kernel's W); SIREN's final layer is
  ``Dense_0`` under the Dense rule
- ``SpectralConv_i/{w_re, w_im}`` and ``SpectralConv2d_i/{w_real, w_imag}``
  (the FNOs' spectral weights) <-> the same names, the same layout
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

from typing import Any, Collection, Dict, Mapping, Optional

import numpy as np
import torch

_LN_NAMES = {"scale": "weight", "bias": "bias"}
# Leaves kept by name and layout: the SIREN kernel's W, the FNOs' spectral
# weights and a trainable Fourier basis.
_AS_IS = {"SIRENLayer_": ("kernel", "bias"), "SpectralConv2d_": ("w_real", "w_imag"),
          "SpectralConv_": ("w_re", "w_im"), "FourierFeatures_": ("B",)}
_DENSE_PREFIXES = ("Dense_", "encoder_layers_", "decoder_layers_", "gate_")
_DENSE_NAMES = ("to_latent", "to_output", "enc_u", "enc_v")
_LN_PREFIXES = ("LayerNorm_", "encoder_norms_", "decoder_norms_")


def _is_dense(module: str) -> bool:
    return module.startswith(_DENSE_PREFIXES) or module in _DENSE_NAMES


def _is_ln(module: str) -> bool:
    return module.startswith(_LN_PREFIXES)


def _swap(arr: np.ndarray) -> np.ndarray:
    """A kernel's (in, out) <-> a weight's (out, in), member axis kept."""
    return np.array(np.swapaxes(arr, -1, -2), order="C")


def _as_is(module: str, name: str) -> bool:
    return any(module.startswith(prefix) and name in names for prefix, names in _AS_IS.items())


def _float_array(value) -> np.ndarray:
    """A leaf as float32, or float64 where it is float64 (a float64
    phase's checkpoint)."""
    arr = np.asarray(value)
    return arr if arr.dtype == np.float64 else arr.astype(np.float32)


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
                arr = _float_array(value)
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
            arr = _float_array(value)
            path = f"{prefix}{module}"
            if _is_dense(module) and name == "kernel":
                out[f"{path}.weight"] = torch.from_numpy(_swap(arr))
            elif _is_ln(module):
                out[f"{path}.{_LN_NAMES[name]}"] = torch.from_numpy(arr.copy())
            elif _is_dense(module) and name == "bias":
                out[f"{path}.bias"] = torch.from_numpy(arr.copy())
            elif _as_is(module, name):
                out[f"{path}.{name}"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no bridge rule for flax leaf {path.replace('.', '/')}/{name}")


def params_to_flax(state: Mapping[str, torch.Tensor], param_names: Collection[str] = ()):
    """torch state_dict -> (flax ``params`` tree, ``constants`` tree) of
    numpy. A Fourier basis goes to ``params`` when its name is in
    ``param_names`` (trainable), else to ``constants``."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    constants: Dict[str, Dict[str, np.ndarray]] = {}
    inv_ln = {v: k for k, v in _LN_NAMES.items()}
    for key, value in state.items():
        *outer, module, name = key.split(".")
        arr = value.detach().cpu().numpy()
        node = params
        for parent in outer:  # a nested module (ResNetBlock_i.Dense_0.weight)
            node = node.setdefault(parent, {})
        if _is_dense(module):
            leaf = "kernel" if name == "weight" else name
            node.setdefault(module, {})[leaf] = _swap(arr) if name == "weight" else arr
        elif _is_ln(module):
            node.setdefault(module, {})[inv_ln[name]] = arr
        elif module.startswith("FourierFeatures_") and not outer and key not in param_names:
            constants.setdefault(module, {})[name] = arr
        elif _as_is(module, name):
            node.setdefault(module, {})[name] = arr
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


def flat_flax_arrays(state: Mapping[str, torch.Tensor],
                     param_names: Collection[str] = ()) -> Dict[str, np.ndarray]:
    """torch state_dict -> {"params/<flax path>": array, "constants/<...>": array}
    (``param_names`` as ``params_to_flax``)."""
    params, constants = params_to_flax(state, param_names)
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
