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

Tensor parallelism (``parallel/tp.py``): ``shard_module`` gives a split
Linear or convolution ``tp`` (its grid) and ``tp_role``. A column-parallel
layer takes its input through ``copy_to_model``; a row-parallel one runs
without its bias, sums the partial output over the model group, then adds
the bias. A split LayerNormSpatial all-reduces its per-sample sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.ops.init import uniform_fan_in_
from theia_tpu_torch.ops.ln_pallas import LNSpatialFunction, ln_spatial_plain
from theia_tpu_torch.parallel.tp import copy_to_model, row_parallel_out

# LayerNormSpatial's backward (the JAX module constant of the same name):
#   "pallas" — ops.ln_pallas.LNSpatialFunction: the CUDA kernels K3, K4 on
#              CUDA tensors (the port's default, as attention's is);
#   "vpu"    — plain autodiff of the same forward.
# The forward values are identical either way.
LN_STATS_IMPL = "pallas"


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class _ModelParallel:
    """A layer's tensor-parallel role, set by ``parallel.tp.shard_module``
    (None: the layer is whole)."""

    tp = None
    tp_role: Optional[str] = None

    def _tp_forward(self, x: torch.Tensor, run, channel_dim: int) -> torch.Tensor:
        """``run(x, bias)`` as the role wants it: the input through
        ``copy_to_model`` (column), or the bias after the model group's sum
        of the partial outputs (row)."""
        dt = self.compute_dtype
        if self.tp_role == "row":
            return row_parallel_out(run(x, None), self.bias, self.tp, dt, channel_dim)
        if self.tp_role == "col":
            x = copy_to_model(x, self.tp)
        return run(x, _cast(self.bias, dt))


class DenseTorch(_ModelParallel, nn.Linear):
    """nn.Linear; torch default init U(±1/√in) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._tp_forward(x.to(dt), lambda x, b: F.linear(x, self.weight.to(dt), b), -1)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        uniform_fan_in_(self.weight, self.in_features, generator)
        if self.bias is not None:
            uniform_fan_in_(self.bias, self.in_features, generator)


class Conv2dTorch(_ModelParallel, nn.Conv2d):
    """nn.Conv2d; torch default init with fan_in = I·kh·kw."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._tp_forward(x.to(dt), lambda x, b: self._conv_forward(x, self.weight.to(dt), b), 1)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight[0].numel()
        uniform_fan_in_(self.weight, fan_in, generator)
        uniform_fan_in_(self.bias, fan_in, generator)


class ConvTranspose2dTorch(_ModelParallel, nn.ConvTranspose2d):
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
        return self._tp_forward(x.to(dt), lambda x, b: self._deconv(x, self.weight.to(dt), b), 1)

    def _deconv(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        stride, pad, op = self.stride[0], self.padding[0], self.output_padding[0]
        if op < stride:
            return F.conv_transpose2d(x, weight, bias, stride, pad, op)
        # torch refuses output_padding >= stride (the pad-to-16 of a 12x12 or
        # 13x13 map): the extra rows and columns get no input, only the bias
        y = F.conv_transpose2d(x, weight, None, stride)
        y = F.pad(y, (0, op, 0, op))
        if pad:
            y = y[..., pad:-pad, pad:-pad]
        return y if bias is None else y + bias.view(-1, 1, 1)


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
    backward. With ``tp`` (a grid, set by ``shard_module``) the map and the
    affine hold this rank's slice of the channels, and the statistics are
    the whole sample's, from per-sample sums all-reduced over the model group.
    """

    tp = None

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
            return LNSpatialFunction.apply(x, self.weight, self.bias, self.eps, self.tp)
        if LN_STATS_IMPL == "vpu":
            return ln_spatial_plain(x, self.weight, self.bias, self.eps, self.tp)
        raise ValueError(f"unknown LN_STATS_IMPL {LN_STATS_IMPL!r}")
