"""Integrators and the fused-rollout CUDA kernels with their plain PyTorch
versions."""
