"""Tensor ops of the PyTorch port: image preprocessing, init, attention (with its CUDA kernel)."""
