"""Adapter heads: map student tokens to each teacher's feature geometry.

Port of theia_tpu/models/adapter_heads.py:115-322 (``LinearAdapterHead``,
``MLPAdapterHead``, ``_PadTo16``, ``ConvAdapterHead``, ``LightConvAdapterHead``), with the JAX defaults
``LADDER_PAD="none"`` and ``HEAD_DENSE_IMPL="tokens"``. The ladders keep the
reference's shape arithmetic (14 -pad-> 16 -> 31 -> 64, 64 -> 32 -> 16,
14 -> 7) and run on NCHW maps in channels_last memory. Module indices are
the reference ``nn.Sequential`` indices, so the parameter names are the
reference state-dict names (``adapter.1.weight``, ``pad.1.bias``, ...).
``dtype`` is the compute dtype, handed to every layer as in the JAX heads.
"""

from __future__ import annotations

import torch
from torch import nn

from theia_tpu_torch.models.layers import (
    Conv2dTorch,
    ConvTranspose2dTorch,
    DenseTorch,
    LayerNormSpatial,
)
from theia_tpu_torch.ops.image import interpolate_nearest

Size = tuple[int, ...]


class _Tokens(nn.Module):
    """[B, C, H, W] -> [B, H*W, C]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class LinearAdapterHead(nn.Module):
    """CLS token -> Linear; used for ``<teacher>_cls`` targets."""

    def __init__(self, source_size: Size, target_size: Size, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.adapter = nn.Sequential(DenseTorch(source_size[0], target_size[0], compute_dtype=dtype))

    def forward(self, x: torch.Tensor, backbone_no_cls: bool = False) -> torch.Tensor:
        if backbone_no_cls:
            raise ValueError("LinearAdapterHead requires a CLS token")
        return self.adapter(x[:, 0])


def _to_map(x: torch.Tensor, side: int) -> torch.Tensor:
    """[B, side*side, C] tokens -> an NCHW map in channels_last memory."""
    b, _, c = x.shape
    return x.reshape(b, side, side, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class MLPAdapterHead(nn.Module):
    """A nearest resize of the token grid to the target's (``ops.image``'s
    floor rule), then a ReLU MLP over channels with hidden width 2·C_s.
    The Linears sit at the reference ``nn.Sequential``'s even indices
    (``adapter.0``, ``adapter.2``, ...), the ReLUs between them."""

    def __init__(self, source_size: Size, target_size: Size, num_layer: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if num_layer < 1:
            raise ValueError(f"MLPAdapterHead needs num_layer >= 1, got {num_layer}")
        self.source_size, self.target_size = tuple(source_size), tuple(target_size)
        c_s, c_t = source_size[0], target_size[0]
        kw = dict(compute_dtype=dtype)
        if num_layer == 1:
            layers: list[nn.Module] = [DenseTorch(c_s, c_t, **kw)]
        else:
            hidden = c_s * 2
            layers = [DenseTorch(c_s, hidden, **kw)]
            for _ in range(num_layer - 2):
                layers += [nn.ReLU(), DenseTorch(hidden, hidden, **kw)]
            layers += [nn.ReLU(), DenseTorch(hidden, c_t, **kw)]
        self.adapter = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, backbone_no_cls: bool = False) -> torch.Tensor:
        if not backbone_no_cls:
            x = x[:, 1:]
        (_, h_s, w_s), (_, h_t, w_t) = self.source_size, self.target_size
        if h_s != h_t:
            b, _, c = x.shape
            x = interpolate_nearest(x.reshape(b, h_s, w_s, c), h_t, w_t).reshape(b, h_t * w_t, c)
        return self.adapter(x)


class _PadTo16(nn.Sequential):
    """ConvTranspose2d(k=3, s=1) from a (<=14)² map to 16² (reference index 1)."""

    def __init__(self, channels: int, source_spatial: int, dtype: torch.dtype) -> None:
        super().__init__(
            nn.Identity(),
            ConvTranspose2dTorch(channels, channels, 3, stride=1, output_padding=14 - source_spatial,
                                 compute_dtype=dtype),
        )


class ConvAdapterHead(nn.Module):
    """Conv ladder ending in a conv (hidden width 2·C_s): 16 -> 64 through
    two ConvTranspose steps (16 -> 31 -> 64) and a ConvTranspose k3 s1 p1,
    16 -> 16 through convs, 64 -> 16 through strided convs; a source under
    16 is padded to 16 first. Input [B, T, C] tokens, output [B, H_t*W_t,
    C_t]. An unsupported geometry raises at construction (the JAX head
    raises for sources under 12 and over 16 other than 64, and fails later
    on the other ones)."""

    def __init__(self, source_size: Size, target_size: Size, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.source_size = tuple(source_size)
        c_s, s_s = source_size[0], source_size[1]
        c_t, s_t = target_size[0], target_size[1]
        hidden = c_s * 2

        self.pad = None
        if s_s < 12:
            raise NotImplementedError("feature spatial size smaller than 12x12 is not supported.")
        elif s_s < 16:
            self.pad = _PadTo16(c_s, s_s, dtype)
            s_s = 16
        elif s_s not in (16, 64):
            raise NotImplementedError(
                "feature spatial size (>=16x16) other than 16x16 and 64x64 is not supported."
            )

        relu = nn.ReLU
        kw = dict(compute_dtype=dtype)
        if (s_s, s_t) == (16, 64):
            layers = [
                LayerNormSpatial((c_s, 16, 16), **kw),
                ConvTranspose2dTorch(c_s, hidden, 3, stride=2, padding=1, **kw),  # 31
                relu(),
                LayerNormSpatial((hidden, 31, 31), **kw),
                ConvTranspose2dTorch(hidden, hidden, 3, stride=2, output_padding=1, **kw),  # 64
                relu(),
                LayerNormSpatial((hidden, 64, 64), **kw),
                ConvTranspose2dTorch(hidden, c_t, 3, stride=1, padding=1, **kw),  # 64
            ]
        elif s_s == s_t:
            layers = [
                LayerNormSpatial((c_s, s_s, s_s), **kw),
                Conv2dTorch(c_s, hidden, 3, padding=1, **kw),
                relu(),
                LayerNormSpatial((hidden, s_s, s_s), **kw),
                Conv2dTorch(hidden, hidden, 3, padding=1, **kw),
                relu(),
                LayerNormSpatial((hidden, s_s, s_s), **kw),
                Conv2dTorch(hidden, c_t, 3, padding=1, **kw),
            ]
        elif (s_s, s_t) == (64, 16):
            layers = [
                LayerNormSpatial((c_s, 64, 64), **kw),
                Conv2dTorch(c_s, hidden, 3, stride=2, padding=1, **kw),  # 32
                relu(),
                LayerNormSpatial((hidden, 32, 32), **kw),
                Conv2dTorch(hidden, hidden, 3, stride=2, padding=1, **kw),  # 16
                relu(),
                LayerNormSpatial((hidden, 16, 16), **kw),
                Conv2dTorch(hidden, c_t, 3, padding=1, **kw),
            ]
        else:
            raise NotImplementedError(f"{source_size} to {target_size} is not supported.")
        self.adapter = nn.Sequential(*layers, _Tokens())

    def forward(self, x: torch.Tensor, backbone_no_cls: bool = False) -> torch.Tensor:
        if not backbone_no_cls:
            x = x[:, 1:]
        x = _to_map(x, self.source_size[1])
        if self.pad is not None:
            x = self.pad(x)
        return self.adapter(x)


class LightConvAdapterHead(nn.Module):
    """Production head: a conv/deconv ladder ending in a Linear.

    Input [B, T, C] tokens (CLS first unless ``backbone_no_cls``), output
    [B, H_t*W_t, C_t]. An unsupported geometry raises at construction.
    """

    def __init__(self, source_size: Size, target_size: Size, hidden_size_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if source_size[1] != source_size[2] or target_size[1] != target_size[2]:
            raise NotImplementedError("non-square feature maps are not supported.")
        self.source_size = tuple(source_size)
        c_s, s_s = source_size[0], source_size[1]
        c_t, s_t = target_size[0], target_size[1]
        hidden = int(c_s * hidden_size_factor)

        self.pad = None
        if s_s < 12:
            raise NotImplementedError("feature spatial size smaller than 12x12 is not supported.")
        elif s_s < 16 and s_t >= 16:
            self.pad = _PadTo16(c_s, s_s, dtype)
            s_s = 16
        elif not ((s_s in (16, 64)) or (s_s == 14 and s_t == 14) or s_t < 14):
            raise NotImplementedError(
                "feature spatial size larger than 16x16 (other than 64x64) is not supported."
            )

        relu = nn.ReLU
        kw = dict(compute_dtype=dtype)
        if s_s == 16 and s_t == 64:
            layers = [
                LayerNormSpatial((c_s, 16, 16), **kw),
                ConvTranspose2dTorch(c_s, hidden, 3, stride=2, padding=1, **kw),  # 31
                relu(),
                LayerNormSpatial((hidden, 31, 31), **kw),
                ConvTranspose2dTorch(hidden, hidden, 3, stride=2, output_padding=1, **kw),  # 64
                relu(),
                LayerNormSpatial((hidden, 64, 64), **kw),
                _Tokens(),
                DenseTorch(hidden, c_t, **kw),
            ]
        elif s_s == s_t:
            layers = [
                LayerNormSpatial((c_s, s_s, s_s), **kw),
                Conv2dTorch(c_s, hidden, 3, padding=1, **kw),
                relu(),
                LayerNormSpatial((hidden, s_s, s_s), **kw),
                Conv2dTorch(hidden, hidden, 3, padding=1, **kw),
                relu(),
                LayerNormSpatial((hidden, s_s, s_s), **kw),
                _Tokens(),
                DenseTorch(hidden, c_t, **kw),
            ]
        elif s_s == 64 and s_t == 16:
            layers = [
                LayerNormSpatial((c_s, 64, 64), **kw),
                Conv2dTorch(c_s, hidden, 3, stride=2, padding=1, **kw),  # 32
                relu(),
                LayerNormSpatial((hidden, 32, 32), **kw),
                Conv2dTorch(hidden, hidden, 3, stride=2, padding=1, **kw),  # 16
                relu(),
                LayerNormSpatial((hidden, 16, 16), **kw),
                _Tokens(),
                DenseTorch(hidden, c_t, **kw),
            ]
        elif s_t == 7:
            layers = [
                LayerNormSpatial((c_s, s_s, s_s), **kw),
                Conv2dTorch(c_s, hidden, 4, stride=2, padding=1, **kw),  # 14 -> 7
                relu(),
                LayerNormSpatial((hidden, 7, 7), **kw),
                _Tokens(),
                DenseTorch(hidden, c_t, **kw),
            ]
        else:
            raise NotImplementedError(f"{source_size} to {target_size} is not supported.")
        self.adapter = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, backbone_no_cls: bool = False) -> torch.Tensor:
        if not backbone_no_cls:
            x = x[:, 1:]
        x = _to_map(x, self.source_size[1])
        if self.pad is not None:
            x = self.pad(x)
        return self.adapter(x)
