"""Feature translators: per-teacher adapter heads over the student tokens.

Port of theia_tpu/models/translators.py: the four translators of the
reference (src/theia/models/feature_translators.py), with its parameter
names, so a reference state dict loads as it is:
  - "mlp": LayerNorm + Linear backbone adapter (``backbone_adapter.0/1``),
    an ``MLPAdapterHead`` per teacher;
  - "conv": the same adapter, a ``ConvAdapterHead`` per teacher;
  - "lconv" (production): no adapter; ``LightConvAdapterHead``s, or a
    ``LinearAdapterHead`` for ``<teacher>_cls`` targets;
  - "transformer": the adapter, a stem of ``nn.TransformerDecoderLayer``s
    (``translator_stem.layers.{i}``, pre-norm, batch first) decoding
    learned ``decode_tokens`` and a per-teacher ``target_model_emb`` against
    the adapted tokens, then an ``MLPAdapterHead(num_layer=2)`` per teacher.
Heads live in ``translator_heads``, keyed like the reference ``nn.ModuleDict``
(teacher name with "." -> "_").
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.models.adapter_heads import (
    ConvAdapterHead,
    LightConvAdapterHead,
    LinearAdapterHead,
    MLPAdapterHead,
)
from theia_tpu_torch.models.layers import DenseTorch, LayerNormTorch

Size = tuple[int, ...]


def legit_name(target_model: str) -> str:
    """Teacher name as the JAX param tree spells it ("/" and "." -> "_")."""
    return target_model.replace(".", "_").replace("/", "_")


def head_key(target_model: str) -> str:
    """Teacher name as the reference state dict spells it ("." -> "_")."""
    return target_model.replace(".", "_")


class _BackboneAdapter(nn.Sequential):
    """LayerNorm(C) then Linear(C -> hidden), indices 0 and 1."""

    def __init__(self, in_features: int, hidden_size: int, dtype: torch.dtype) -> None:
        super().__init__(LayerNormTorch(in_features, compute_dtype=dtype),
                         DenseTorch(in_features, hidden_size, compute_dtype=dtype))


class _Translator(nn.Module):
    """Heads in ``translator_heads``; ``forward`` runs the backbone adapter,
    where the translator has one, then the named teachers' heads."""

    def _heads(self, make, target_feature_sizes: dict[str, Size]) -> None:
        self.target_feature_sizes = dict(target_feature_sizes)
        self.translator_heads = nn.ModuleDict({head_key(t): make(t, s) for t, s in self.target_feature_sizes.items()})

    def _names(self, target_model_names: Optional[list[str]]) -> list[str]:
        return target_model_names if target_model_names is not None else list(self.target_feature_sizes)

    def forward(
        self,
        x: torch.Tensor,
        target_model_names: Optional[list[str]] = None,
        backbone_no_cls: bool = False,
    ) -> dict[str, torch.Tensor]:
        if self.backbone_adapter is not None:
            x = self.backbone_adapter(x)
        return {t: self.translator_heads[head_key(t)](x, backbone_no_cls=backbone_no_cls)
                for t in self._names(target_model_names)}


class LightConvFeatureTranslator(_Translator):
    """No pre-adapter; a LightConvAdapterHead per teacher, or a
    LinearAdapterHead for ``<teacher>_cls`` targets."""

    def __init__(
        self,
        backbone_feature_size: Size,
        target_feature_sizes: dict[str, Size],
        hidden_size_factor: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.backbone_adapter = None

        def make(t: str, size: Size) -> nn.Module:
            if "_cls" in t:
                return LinearAdapterHead(backbone_feature_size, size, dtype)
            return LightConvAdapterHead(backbone_feature_size, size, hidden_size_factor, dtype)

        self._heads(make, target_feature_sizes)


class MLPFeatureTranslator(_Translator):
    """The backbone adapter, then an MLPAdapterHead of ``translator_n_layer`` Linears per teacher."""

    def __init__(
        self,
        backbone_feature_size: Size,
        target_feature_sizes: dict[str, Size],
        translator_hidden_size: int = 1024,
        translator_n_layer: int = 3,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.backbone_adapter = _BackboneAdapter(backbone_feature_size[0], translator_hidden_size, dtype)
        source = (translator_hidden_size, *backbone_feature_size[1:])
        self._heads(lambda t, size: MLPAdapterHead(source, size, translator_n_layer, dtype), target_feature_sizes)


class ConvFeatureTranslator(_Translator):
    """The backbone adapter, then a ConvAdapterHead per teacher."""

    def __init__(
        self,
        backbone_feature_size: Size,
        target_feature_sizes: dict[str, Size],
        translator_hidden_size: int = 1024,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.backbone_adapter = _BackboneAdapter(backbone_feature_size[0], translator_hidden_size, dtype)
        source = (translator_hidden_size, *backbone_feature_size[1:])
        self._heads(lambda t, size: ConvAdapterHead(source, size, dtype), target_feature_sizes)


class _MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first) with its packed
    ``in_proj_weight``/``in_proj_bias`` and ``out_proj``, computed as the JAX
    module computes it: projections in the compute dtype with the float32
    biases added (which promotes them to float32), float32 scores and
    softmax, probabilities rounded to the compute dtype. Plain matmuls: the
    JAX package runs this attention outside any Pallas kernel."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.embed_dim, self.num_heads, self.compute_dtype = embed_dim, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = DenseTorch(embed_dim, embed_dim, compute_dtype=dtype)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX init: in_proj_weight U(±√(1/e)), in_proj_bias zeros."""
        bound = math.sqrt(1.0 / self.embed_dim)
        self.in_proj_weight.uniform_(-bound, bound, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        e, nh, dt = self.embed_dim, self.num_heads, self.compute_dtype
        hd = e // nh
        wq, wk, wv = self.in_proj_weight.to(dt).split(e)
        bq, bk, bv = self.in_proj_bias.split(e)
        b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
        qh = (F.linear(q.to(dt), wq) + bq).reshape(b, tq, nh, hd).transpose(1, 2)
        kh = (F.linear(k.to(dt), wk) + bk).reshape(b, tk, nh, hd).transpose(1, 2)
        vh = (F.linear(v.to(dt), wv) + bv).reshape(b, tk, nh, hd).transpose(1, 2)
        scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        probs = torch.softmax(scores / math.sqrt(hd), dim=-1).to(dt)
        ctx_dtype = torch.promote_types(dt, vh.dtype)
        ctx = torch.matmul(probs.to(ctx_dtype), vh.to(ctx_dtype)).transpose(1, 2).reshape(b, tq, e)
        return self.out_proj(ctx)


class _TransformerDecoderLayer(nn.Module):
    """``nn.TransformerDecoderLayer(norm_first=True, batch_first=True)`` with
    exact GELU, in the compute dtype."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dtype: torch.dtype) -> None:
        super().__init__()
        kw = dict(compute_dtype=dtype)
        self.self_attn = _MultiheadAttention(d_model, nhead, dtype)
        self.multihead_attn = _MultiheadAttention(d_model, nhead, dtype)
        self.linear1 = DenseTorch(d_model, dim_feedforward, **kw)
        self.linear2 = DenseTorch(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNormTorch(d_model, **kw)
        self.norm2 = LayerNormTorch(d_model, **kw)
        self.norm3 = LayerNormTorch(d_model, **kw)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = tgt
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h)
        h = self.norm2(x)
        x = x + self.multihead_attn(h, memory, memory)
        h = self.linear2(F.gelu(self.linear1(self.norm3(x)), approximate="none"))
        return x + h


class TransformerFeatureTranslator(_Translator):
    """The backbone adapter over the patch tokens (CLS dropped), then for
    each teacher a stem of decoder layers over ``decode_tokens`` (one a
    patch) and the teacher's ``target_model_emb``, then an
    ``MLPAdapterHead(num_layer=2)``.

    The JAX package's divergence from the reference is kept: the stem's
    first output token is dropped once and the other H·W (the decode tokens
    after the first, and the teacher embedding) go to the head as they are;
    the reference drops a token again in the head, which breaks every head
    that resizes (TODO.md, "Known deliberate divergences").
    """

    def __init__(
        self,
        backbone_feature_size: Size,
        target_feature_sizes: dict[str, Size],
        translator_hidden_size: int = 1024,
        translator_n_layers: int = 2,
        translator_n_heads: int = 8,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        hidden = translator_hidden_size
        self.compute_dtype = dtype
        self.backbone_adapter = _BackboneAdapter(backbone_feature_size[0], hidden, dtype)
        n_tokens = int(backbone_feature_size[1] * backbone_feature_size[2])
        self.decode_tokens = nn.Parameter(torch.empty(1, n_tokens, hidden))
        self.target_model_emb = nn.ParameterDict(
            {head_key(t): nn.Parameter(torch.empty(1, 1, hidden)) for t in target_feature_sizes})
        self.translator_stem = nn.Module()
        self.translator_stem.layers = nn.ModuleList(
            _TransformerDecoderLayer(hidden, translator_n_heads, hidden * 2, dtype) for _ in range(translator_n_layers))
        source = (hidden, *backbone_feature_size[1:])
        self._heads(lambda t, size: MLPAdapterHead(source, size, 2, dtype), target_feature_sizes)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX init of the free parameters: ``decode_tokens`` and each
        ``target_model_emb`` normal(0, 1). The layers draw their own."""
        self.decode_tokens.normal_(0.0, 1.0, generator=generator)
        for emb in self.target_model_emb.values():
            emb.normal_(0.0, 1.0, generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        target_model_names: Optional[list[str]] = None,
        backbone_no_cls: bool = False,
    ) -> dict[str, torch.Tensor]:
        if not backbone_no_cls:
            x = x[:, 1:]
        memory = self.backbone_adapter(x)
        b = memory.shape[0]
        out = {}
        for t in self._names(target_model_names):
            key = head_key(t)
            tokens = self.decode_tokens.expand(b, -1, -1)
            emb = self.target_model_emb[key].expand(b, -1, -1)
            h = torch.cat([tokens, emb], dim=1).to(self.compute_dtype)
            for layer in self.translator_stem.layers:
                h = layer(h, memory)
            out[t] = self.translator_heads[key](h[:, 1:], backbone_no_cls=True)
        return out


def build_feature_translator(translator_type: str, **kwargs: Any) -> nn.Module:
    """The JAX factory (theia_tpu/models/translators.py:308-320): ``hidden_size``
    (the mlp config's alias) and the transformer's ``translator_activation``
    are dropped, as there."""
    kwargs.pop("hidden_size", None)
    if translator_type == "mlp":
        return MLPFeatureTranslator(**kwargs)
    if translator_type == "conv":
        return ConvFeatureTranslator(**kwargs)
    if translator_type == "lconv":
        return LightConvFeatureTranslator(**kwargs)
    if translator_type in ("transformer", "trans"):
        kwargs.pop("translator_activation", None)
        return TransformerFeatureTranslator(**kwargs)
    raise NotImplementedError(f"Requested {translator_type} is not implemented yet.")
