"""Adapter heads: map student tokens to each teacher's feature geometry.

Port of theia_tpu/models/adapter_heads.py:115-183,242-322 (``LinearAdapterHead``,
``_PadTo16``, ``LightConvAdapterHead``), with the JAX defaults
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


class _PadTo16(nn.Sequential):
    """ConvTranspose2d(k=3, s=1) from a (<=14)² map to 16² (reference index 1)."""

    def __init__(self, channels: int, source_spatial: int, dtype: torch.dtype) -> None:
        super().__init__(
            nn.Identity(),
            ConvTranspose2dTorch(channels, channels, 3, stride=1, output_padding=14 - source_spatial,
                                 compute_dtype=dtype),
        )


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
        b, _, c = x.shape
        s = self.source_size[1]
        x = x.reshape(b, s, s, c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.pad is not None:
            x = self.pad(x)
        return self.adapter(x)
