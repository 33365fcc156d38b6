"""Hand-written Hopper kernels (CUDA C++ in ``pinnrl_tpu_torch/csrc``).

Each wrapper launches its kernel for CUDA tensors (or raises), runs its
plain PyTorch version for CPU tensors, and counts its launches in a plain
integer attribute (``fourier_features.launches``,
``fused_residual_loss.launches``, ``fused_mlp_score.launches``), registered
in ``counts``; a launch inside a captured training step is counted on the
device at each replay (``counts.tallying``). Kernels are built at first
use, before any capture; nothing is compiled or loaded at import.
"""
