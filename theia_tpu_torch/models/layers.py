"""Translator-head layers with torch-default semantics, init from an explicit generator.

Port of theia_tpu/models/layers.py:30-36,55-256. The JAX package wraps NHWC
convolutions and a (C,H,W) LayerNorm so that reference torch weights map
1:1; here the layers are the torch ones, run on NCHW tensors (channels_last
in the head ladders), and the weights are stored as torch stores them:
Linear (out,in), Conv2d (O,I,kh,kw), ConvTranspose2d (I,O,kh,kw),
LayerNormSpatial (C,H,W). The convolutions are cuDNN's (XLA computed them
outside any Pallas kernel too).

Mixed precision as in the JAX modules: each layer has a ``compute_dtype``
(the JAX ``dtype``), casts its input and its parameters to it at use, and
returns that dtype; the parameters keep the dtype they are stored in
(float32 for training), and their gradients flow back through the cast.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.ops.init import uniform_fan_in_
from theia_tpu_torch.ops.ln_pallas import LNSpatialFunction, ln_spatial_plain

# LayerNormSpatial's backward (the JAX module constant of the same name):
#   "pallas" — ops.ln_pallas.LNSpatialFunction: the CUDA kernels K3, K4 on
#              CUDA tensors (the port's default, as attention's is);
#   "vpu"    — plain autodiff of the same forward.
# The forward values are identical either way.
LN_STATS_IMPL = "pallas"


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class DenseTorch(nn.Linear):
    """nn.Linear; torch default init U(±1/√in) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        uniform_fan_in_(self.weight, self.in_features, generator)
        if self.bias is not None:
            uniform_fan_in_(self.bias, self.in_features, generator)


class Conv2dTorch(nn.Conv2d):
    """nn.Conv2d; torch default init with fan_in = I·kh·kw."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight[0].numel()
        uniform_fan_in_(self.weight, fan_in, generator)
        uniform_fan_in_(self.bias, fan_in, generator)


class ConvTranspose2dTorch(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with torch's output shape
    (in-1)·stride - 2·padding + k + output_padding, for any output_padding.

    torch's init computes fan_in on the (I,O,kh,kw) weight as O·kh·kw (an
    oddity of ``_calculate_fan_in_and_fan_out``); kept, as the JAX port keeps it.
    """

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight[0].numel()
        uniform_fan_in_(self.weight, fan_in, generator)
        uniform_fan_in_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, weight, bias = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        stride, pad, op = self.stride[0], self.padding[0], self.output_padding[0]
        if op < stride:
            return F.conv_transpose2d(x, weight, bias, stride, pad, op)
        # torch refuses output_padding >= stride (the pad-to-16 of a 12x12 or
        # 13x13 map): the extra rows and columns get no input, only the bias
        y = F.conv_transpose2d(x, weight, None, stride)
        y = F.pad(y, (0, op, 0, op))
        if pad:
            y = y[..., pad:-pad, pad:-pad]
        return y + bias.view(-1, 1, 1)


class LayerNormTorch(nn.LayerNorm):
    """nn.LayerNorm over the trailing channel dim (eps 1e-5): stats,
    normalise and affine in float32, output in the compute dtype (the JAX
    ``LayerNormTorch``)."""

    def __init__(self, features: int, eps: float = 1e-5, *, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__(features, eps=eps)
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class LayerNormSpatial(nn.Module):
    """torch nn.LayerNorm((C,H,W)) on an NCHW map: normalizes over all of
    (C,H,W) per sample, with a per-element affine of shape (C,H,W).

    The JAX numerics: float32 stats as mean(x²) − mean², the elementwise
    normalize and affine in the compute dtype. ``LN_STATS_IMPL`` picks the
    backward.
    """

    def __init__(self, shape_chw: tuple[int, int, int], eps: float = 1e-5, *,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.shape_chw = tuple(shape_chw)
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(self.shape_chw))
        self.bias = nn.Parameter(torch.empty(self.shape_chw))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if LN_STATS_IMPL == "pallas":
            return LNSpatialFunction.apply(x, self.weight, self.bias, self.eps)
        if LN_STATS_IMPL == "vpu":
            return ln_spatial_plain(x, self.weight, self.bias, self.eps)
        raise ValueError(f"unknown LN_STATS_IMPL {LN_STATS_IMPL!r}")
