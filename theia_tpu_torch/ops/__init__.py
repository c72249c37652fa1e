"""Tensor ops of the PyTorch port: image preprocessing, init, attention and the LayerNormSpatial backward (with their CUDA kernels)."""
