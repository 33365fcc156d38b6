"""Parameter bridge between the flax parameter tree and the port's state_dict.

- ``Dense_i/kernel`` (in, out)        <-> ``Dense_i.weight`` (out, in)
- ``Dense_i/bias``                     <-> ``Dense_i.bias``
- ``LayerNorm_i/{scale, bias}``        <-> ``LayerNorm_i.{weight, bias}``
- ``constants/FourierFeatures_0/B``    <-> the ``FourierFeatures_0.B`` buffer

Both sides are plain numpy here, so the module imports neither JAX nor
flax: callers hand over ``jax.tree_util.tree_map(np.asarray, ...)``.
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
    for module, leaves in params_np.items():
        for name, value in leaves.items():
            arr = np.asarray(value, dtype=np.float32)
            if module.startswith("Dense_") and name == "kernel":
                out[f"{module}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
            elif module.startswith("LayerNorm_"):
                out[f"{module}.{_LN_NAMES[name]}"] = torch.from_numpy(arr.copy())
            elif module.startswith("Dense_") and name == "bias":
                out[f"{module}.bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no bridge rule for flax leaf {module}/{name}")
    for collection, modules in (constants_np or {}).items():
        if collection != "constants":
            raise KeyError(f"no bridge rule for flax collection {collection!r}")
        for module, leaves in modules.items():
            for name, value in leaves.items():
                arr = np.asarray(value, dtype=np.float32)
                out[f"{module}.{name}"] = torch.from_numpy(arr.copy())
    return out


def params_to_flax(state: Mapping[str, torch.Tensor]):
    """torch state_dict -> (flax ``params`` tree, ``constants`` tree) of numpy."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    constants: Dict[str, Dict[str, np.ndarray]] = {}
    inv_ln = {v: k for k, v in _LN_NAMES.items()}
    for key, value in state.items():
        module, name = key.rsplit(".", 1)
        arr = value.detach().cpu().numpy()
        if module.startswith("Dense_"):
            leaf = "kernel" if name == "weight" else name
            params.setdefault(module, {})[leaf] = np.ascontiguousarray(arr.T) if name == "weight" else arr
        elif module.startswith("LayerNorm_"):
            params.setdefault(module, {})[inv_ln[name]] = arr
        elif module.startswith("FourierFeatures_"):
            constants.setdefault(module, {})[name] = arr
        else:
            raise KeyError(f"no bridge rule for state_dict entry {key!r}")
    return params, ({"constants": constants} if constants else {})
