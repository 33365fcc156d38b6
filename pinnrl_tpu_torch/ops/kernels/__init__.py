"""Hand-written Hopper kernels (CUDA C++ in ``pinnrl_tpu_torch/csrc``).

Each wrapper launches its kernel for CUDA tensors (or raises), runs its
plain PyTorch version for CPU tensors, and counts its launches in a plain
integer attribute (``fourier_features.launches``,
``fused_residual_loss.launches``, ``fused_mlp_score.launches``). Kernels
are built at first use; nothing is compiled or loaded at import.
"""
