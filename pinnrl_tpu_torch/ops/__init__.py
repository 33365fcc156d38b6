"""Residual machinery: stacked-jet bundle, derivative entry points, losses,
and the hand-written CUDA kernels (``ops/kernels``)."""
