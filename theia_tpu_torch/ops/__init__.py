"""Tensor ops of the PyTorch port: image preprocessing, init, attention and the LayerNormSpatial backward (with their CUDA kernels).

The public names are the JAX package's (``theia_tpu/ops/__init__.py``) but
for two groups the port has no use for: ``conv_transpose_2d`` (the JAX
package's TPU lowering of a transposed convolution; the port's
``models/layers.py`` calls ``torch.nn.functional.conv_transpose2d``) and
``torch_*_init`` / ``trunc_normal_init`` (the JAX emulation of
``torch.nn.init``; the port calls ``torch.nn.init`` and ``ops/init.py``).
"""

from theia_tpu_torch.ops.image import bicubic_resize, center_crop, interpolate_bilinear, preprocess_images

__all__ = [
    "bicubic_resize",
    "center_crop",
    "interpolate_bilinear",
    "preprocess_images",
]
