"""Integrators and the CUDA kernels (fused rollout, fused plant, Newton pH
solve) with their plain PyTorch versions."""
