"""Fused CUDA kernels (GPU only); see level2d.py."""
