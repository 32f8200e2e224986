"""Framing, windows, FFT tiers and the CUDA kernels with their plain
PyTorch versions."""
