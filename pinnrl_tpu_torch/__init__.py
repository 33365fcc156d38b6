"""pinnrl_tpu_torch — the PyTorch + CUDA port of ``pinnrl_tpu``.

The same modules, public names and entry points as the JAX package
(``load_config`` -> ``create_pde`` -> ``PINNModel`` -> ``PDETrainer``), on
PyTorch, with the TPU's Pallas kernels rewritten by hand for Hopper
(``pinnrl_tpu_torch/csrc``). The port imports no JAX; the JAX package is the
reference its tests hold it against.

Float32 matmuls run in full precision ("highest"; TF32 off), as the JAX
package forces at import: PINN training is precision-critical — with
Fourier features the phases reach tens of radians, and reduced-precision
products change the function the optimizer converges to.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from pinnrl_tpu_torch.config import Config  # noqa: E402,F401
