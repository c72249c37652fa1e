"""SAM prompt encoder and two-way-transformer mask decoder (port of
theia_tpu/foundation/sam_decoder.py:27-256).

With ``foundation/sam.py`` (the vision encoder) this completes the SAM
stack the decoding path needs: predicted (B, 256, 64, 64) embeddings go
straight into the mask decoder (reference: src/theia/decoding/sam.py:15-106,
which injects them into HF's mask-generation pipeline at :80-85).

Parameter names are HF ``SamModel``'s (``prompt_encoder.*``,
``mask_decoder.*``, ``shared_image_embedding.*``, and the prompt encoder's
mask embedding, which the no-mask path never runs), so an HF state dict,
less its ``vision_encoder.`` entries, loads with ``strict=True``. The
numerics are the JAX module's: float32 throughout, attention as plain
matmuls with float32 scores, the upscaling's LayerNorm over channels and
exact GELU. The JAX upscaling runs ``ops/convt.py::conv_transpose_2d``, a
TPU lowering of the ConvTranspose2d computed here by cuDNN.

Prompts are batched [B, P, N]: the image embedding and its positional
encoding enter as [B, 1, H·W, C] and are broadcast against the P prompts'
tokens until the first image-to-token attention makes the keys per prompt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.foundation.towers import ChannelLayerNorm


@dataclasses.dataclass(frozen=True)
class SamDecoderConfig:
    hidden_size: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    num_mask_tokens: int = 4  # 1 + num_multimask_outputs(3)
    num_layers: int = 2
    attention_downsample_rate: int = 2
    iou_head_hidden_dim: int = 256
    iou_head_depth: int = 3
    image_embedding_size: int = 64
    input_image_size: int = 1024
    num_pos_feats: int = 128
    layer_norm_eps: float = 1e-6
    # HF's prompt-encoder mask embedding (unused on the no-mask path)
    mask_input_channels: int = 16


SAM_DECODER = SamDecoderConfig()


def positional_encode(coords: torch.Tensor, pe_matrix: torch.Tensor) -> torch.Tensor:
    """SamPositionalEmbedding.forward for [0,1]-normalised coords [..., 2]."""
    c = 2.0 * coords - 1.0
    c = c @ pe_matrix
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def image_wide_positional_embedding(pe_matrix: torch.Tensor, size: int) -> torch.Tensor:
    """SamModel.get_image_wide_positional_embeddings -> [1, C, size, size]."""
    grid = torch.ones(size, size, dtype=torch.float32, device=pe_matrix.device)
    y = (grid.cumsum(0) - 0.5) / size
    x = (grid.cumsum(1) - 0.5) / size
    pe = positional_encode(torch.stack([x, y], dim=-1), pe_matrix)  # (h, w, C)
    return pe.permute(2, 0, 1)[None]


class _SamAttention(nn.Module):
    """Attention with q/k/v projected down by ``downsample_rate``; inputs
    [B, P, T, C], where a size-1 P broadcasts against the others'."""

    def __init__(self, cfg: SamDecoderConfig, downsample_rate: int = 1) -> None:
        super().__init__()
        internal = cfg.hidden_size // downsample_rate
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, internal)
        self.k_proj = nn.Linear(cfg.hidden_size, internal)
        self.v_proj = nn.Linear(cfg.hidden_size, internal)
        self.out_proj = nn.Linear(internal, cfg.hidden_size)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, p, t, c = x.shape
        return x.reshape(b, p, t, self.num_heads, c // self.num_heads).transpose(2, 3)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        q, k, v = self._heads(self.q_proj(query)), self._heads(self.k_proj(key)), self._heads(self.v_proj(value))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(2, 3)
        return self.out_proj(out.reshape(*out.shape[:3], -1))


class _MLP(nn.Module):
    """HF ``SamFeedForward``: proj_in, ``layers``, proj_out, ReLU between."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, depth: int) -> None:
        super().__init__()
        self.proj_in = nn.Linear(d_in, d_hidden)
        self.layers = nn.ModuleList(nn.Linear(d_hidden, d_hidden) for _ in range(depth - 2))
        self.proj_out = nn.Linear(d_hidden, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        return self.proj_out(x)


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, skip_first_layer_pe: bool) -> None:
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        c, rate = cfg.hidden_size, cfg.attention_downsample_rate
        self.self_attn = _SamAttention(cfg, 1)
        self.layer_norm1 = nn.LayerNorm(c)
        self.cross_attn_token_to_image = _SamAttention(cfg, rate)
        self.layer_norm2 = nn.LayerNorm(c)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(c, cfg.mlp_dim)
        self.mlp.lin2 = nn.Linear(cfg.mlp_dim, c)
        self.layer_norm3 = nn.LayerNorm(c)
        self.layer_norm4 = nn.LayerNorm(c)
        self.cross_attn_image_to_token = _SamAttention(cfg, rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp.lin2(F.relu(self.mlp.lin1(queries))))
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class SamMaskDecoder(nn.Module):
    """Prompt encoding (points) and mask prediction, HF SamModel semantics on
    the no-mask-input path (the JAX ``SamMaskDecoder``)."""

    def __init__(self, cfg: SamDecoderConfig = SAM_DECODER) -> None:
        super().__init__()
        self.cfg = cfg
        c, m = cfg.hidden_size, cfg.mask_input_channels
        self.shared_image_embedding = nn.Module()
        self.shared_image_embedding.register_buffer("positional_embedding", torch.empty(2, cfg.num_pos_feats))

        pe = self.prompt_encoder = nn.Module()
        pe.shared_embedding = self.shared_image_embedding
        pe.mask_embed = nn.Module()
        pe.mask_embed.conv1 = nn.Conv2d(1, m // 4, 2, stride=2)
        pe.mask_embed.conv2 = nn.Conv2d(m // 4, m, 2, stride=2)
        pe.mask_embed.conv3 = nn.Conv2d(m, c, 1)
        pe.mask_embed.layer_norm1 = ChannelLayerNorm(m // 4, cfg.layer_norm_eps)
        pe.mask_embed.layer_norm2 = ChannelLayerNorm(m, cfg.layer_norm_eps)
        pe.no_mask_embed = nn.Embedding(1, c)
        pe.point_embed = nn.ModuleList(nn.Embedding(1, c) for _ in range(4))
        pe.not_a_point_embed = nn.Embedding(1, c)

        md = self.mask_decoder = nn.Module()
        md.iou_token = nn.Embedding(1, c)
        md.mask_tokens = nn.Embedding(cfg.num_mask_tokens, c)
        md.transformer = nn.Module()
        md.transformer.layers = nn.ModuleList(_TwoWayBlock(cfg, i == 0) for i in range(cfg.num_layers))
        md.transformer.final_attn_token_to_image = _SamAttention(cfg, cfg.attention_downsample_rate)
        md.transformer.layer_norm_final_attn = nn.LayerNorm(c)
        md.upscale_conv1 = nn.ConvTranspose2d(c, c // 4, 2, stride=2)
        md.upscale_conv2 = nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2)
        md.upscale_layer_norm = ChannelLayerNorm(c // 4, cfg.layer_norm_eps)
        md.output_hypernetworks_mlps = nn.ModuleList(_MLP(c, c, c // 8, 3) for _ in range(cfg.num_mask_tokens))
        md.iou_prediction_head = _MLP(c, cfg.iou_head_hidden_dim, cfg.num_mask_tokens, cfg.iou_head_depth)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's init distributions, drawn in a fixed order from
        ``generator`` (on the parameters' device): the positional matrix
        normal(0, 1); embeddings and the upscaling convolutions normal(0,
        0.02); Linear and convolution weights normal(0, 1/√fan_in);
        LayerNorms ones and zeros; biases zeros."""
        self.shared_image_embedding.positional_embedding.normal_(0.0, 1.0, generator=generator)
        for name, p in self.named_parameters():
            owner = self.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, (nn.LayerNorm, ChannelLayerNorm)):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif isinstance(owner, nn.Embedding) or "upscale_conv" in name:
                p.normal_(0.0, 0.02, generator=generator)
            else:  # a Linear's or Conv2d's weight
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool = True) -> torch.Tensor:
        """points [B, P, N, 2] in input-image pixel coords, labels [B, P, N]."""
        pe = self.prompt_encoder
        points = points + 0.5
        if pad:
            b, p = points.shape[:2]
            points = torch.cat([points, points.new_zeros(b, p, 1, 2)], dim=2)
            labels = torch.cat([labels, labels.new_full((b, p, 1), -1)], dim=2)
        emb = positional_encode(points / self.cfg.input_image_size, self.shared_image_embedding.positional_embedding)
        lab = labels[..., None]
        emb = torch.where(lab == -1, pe.not_a_point_embed.weight[0], emb)
        emb = torch.where(lab == 0, emb + pe.point_embed[0].weight[0], emb)
        return torch.where(lab == 1, emb + pe.point_embed[1].weight[0], emb)

    def forward(
        self,
        image_embeddings: torch.Tensor,  # [B, h, w, C] NHWC
        input_points: torch.Tensor,  # [B, P, N, 2]
        input_labels: torch.Tensor,  # [B, P, N]
        multimask_output: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(low-res masks [B, P, M, 4h, 4w], iou predictions [B, P, M]); M is 3
        with ``multimask_output``, else 1."""
        cfg, md = self.cfg, self.mask_decoder
        image_embeddings = image_embeddings.float()
        b, h, w, c = image_embeddings.shape
        p = input_points.shape[1]

        sparse = self.embed_points(input_points.float(), input_labels)
        img = image_embeddings + self.prompt_encoder.no_mask_embed.weight.reshape(1, 1, 1, c)
        img_pe = image_wide_positional_embedding(self.shared_image_embedding.positional_embedding,
                                                 cfg.image_embedding_size)
        out_tokens = torch.cat([md.iou_token.weight, md.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.expand(b, p, -1, -1), sparse], dim=2)

        keys = img.reshape(b, 1, h * w, c)  # broadcast over the prompts
        key_pe = img_pe.permute(0, 2, 3, 1).reshape(1, 1, h * w, c)
        queries = tokens
        for block in md.transformer.layers:
            queries, keys = block(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = md.transformer.layer_norm_final_attn(queries + md.transformer.final_attn_token_to_image(q, k, keys))

        iou_out = queries[:, :, 0]
        mask_tokens_out = queries[:, :, 1 : 1 + cfg.num_mask_tokens]

        img_out = keys.expand(b, p, h * w, c).reshape(b * p, h, w, c).permute(0, 3, 1, 2)
        up = F.conv_transpose2d(img_out, md.upscale_conv1.weight, md.upscale_conv1.bias, stride=2)
        up = F.gelu(md.upscale_layer_norm(up.permute(0, 2, 3, 1)), approximate="none").permute(0, 3, 1, 2)
        up = F.gelu(F.conv_transpose2d(up, md.upscale_conv2.weight, md.upscale_conv2.bias, stride=2),
                    approximate="none")  # [B*P, c//8, 4h, 4w]

        hyper_in = torch.stack([mlp(mask_tokens_out[:, :, i]) for i, mlp in enumerate(md.output_hypernetworks_mlps)],
                               dim=2)  # [B, P, M, c//8]
        uh, uw = up.shape[2], up.shape[3]
        masks = torch.matmul(hyper_in, up.reshape(b, p, -1, uh * uw)).reshape(b, p, -1, uh, uw)
        iou = md.iou_prediction_head(iou_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou[:, :, sl]


def build_sam_decoder(
    state_dict: Optional[dict] = None,
    cfg: SamDecoderConfig = SAM_DECODER,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> SamMaskDecoder:
    """The decoder on ``device`` in eval mode: an HF SamModel state dict (its
    ``vision_encoder.`` entries dropped) loaded strictly, else a seeded
    random init (``generator`` on ``device``)."""
    with torch.device(device):
        module = SamMaskDecoder(cfg)
    if state_dict is not None:
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items() if not k.startswith("vision_encoder.")}
        module.load_state_dict(sd, strict=True)
    else:
        module.reset_parameters(generator)
    return module.eval().requires_grad_(False)
