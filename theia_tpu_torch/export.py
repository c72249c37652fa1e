"""Deployment artifacts: a Theia forward saved as a ``torch.export`` program (port of theia_tpu/export.py:43-128).

``export_model`` traces ``forward_feature`` (or the teachers' predictions)
with ``torch.export`` over uint8 images [B, H, W, C] with a symbolic batch
dimension, the trained weights saved with the program, and writes one
file: a magic, a JSON header (method, image size, channels, output dtype,
the device it was exported for) and the serialized program.
``load_artifact`` runs it back with no model source and no checkpoint:

    save_artifact("theia.pt2", model)            # a Theia or models.hub.PretrainedTheia
    pred = load_artifact("theia.pt2")
    feats = pred(images)                          # uint8 [B,224,224,3] -> [B,T,C] float32

The honest difference from the JAX package's StableHLO artifact: that one
is a compiled program any JAX runtime executes; this one is a graph of
PyTorch operators that PyTorch interprets, and the attention kernels are
in it as the port's own operators (``theia::mha_attention`` for K1,
``theia::flash_attention`` for K7, registered by ``theia_tpu_torch.ops``).
So loading needs PyTorch and ``import theia_tpu_torch.ops`` (which this
module does), and on the card the kernels' build; it runs on the device
it was exported for. One program serves every batch size.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

import theia_tpu_torch.ops.attention  # noqa: F401  (registers the kernels' operators for tracing and loading)

_MAGIC = b"THEIA-TORCH-AOT-1\x00"
_MAX_BATCH = 4096


class _Forward(nn.Module):
    """``method`` of ``model`` with the output cast to ``out_dtype`` on the device."""

    def __init__(self, model: nn.Module, method: str, out_dtype: Optional[torch.dtype]) -> None:
        super().__init__()
        self.model, self.method, self.out_dtype = model, method, out_dtype

    def forward(self, x: torch.Tensor) -> Any:
        out = self.model.forward_feature(x) if self.method == "forward_feature" else self.model(x)
        if self.out_dtype is None:
            return out
        if isinstance(out, dict):
            return {k: v.to(self.out_dtype) for k, v in out.items()}
        return out.to(self.out_dtype)


def _clear_constant_caches() -> None:
    """Drop the device constants the model caches at first use: a trace
    that missed them cached the tracer's stand-ins, which an eager call
    must not meet."""
    from theia_tpu_torch.models import vit
    from theia_tpu_torch.ops import image

    for cached in (image._resize_matrix_on, image._channel_constant, vit._fused_constants):
        cached.cache_clear()


def export_model(
    model: nn.Module,
    *,
    method: str = "forward_feature",
    image_size: int = 224,
    channels: int = 3,
    out_dtype: Optional[torch.dtype] = None,
) -> bytes:
    """Serialize ``model``'s ``method`` with its weights to an artifact
    with a symbolic batch dimension, on the device the model lies on.

    Args:
        model: a ``Theia`` or ``models.hub.PretrainedTheia`` (its
            ``feature_reduce_method`` is the one exported).
        method: "forward_feature" (spatial tokens) or "predict" (dict of
            per-teacher features, the module's forward).
        out_dtype: optional on-device output cast (e.g. ``torch.bfloat16``)
            to halve readback bytes.
    """
    if method not in ("forward_feature", "predict"):
        raise ValueError(f"unknown method {method!r}")
    if not isinstance(model, nn.Module) or not hasattr(model, "forward_feature"):
        raise TypeError(f"export_model takes a Theia or PretrainedTheia, got {type(model).__name__}")
    device = next(model.parameters()).device
    wrapper = _Forward(model, method, out_dtype).eval()
    # two images: torch.export specializes a dimension whose example is 1
    example = torch.zeros((2, image_size, image_size, channels), dtype=torch.uint8, device=device)
    batch = torch.export.Dim("batch", min=1, max=_MAX_BATCH)
    try:
        with torch.no_grad():
            wrapper(example[:1])  # the cached device constants, made for real before the trace
            program = torch.export.export(wrapper, (example,), dynamic_shapes=({0: batch},), strict=False)
    finally:
        _clear_constant_caches()
    payload = io.BytesIO()
    torch.export.save(program, payload)
    header = json.dumps({
        "method": method,
        "image_size": image_size,
        "channels": channels,
        "out_dtype": None if out_dtype is None else str(out_dtype).removeprefix("torch."),
        "platforms": [device.type],
    }).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + payload.getvalue()


def save_artifact(path: str, model: nn.Module, **kw: Any) -> None:
    """``export_model`` straight to a file."""
    with open(path, "wb") as f:
        f.write(export_model(model, **kw))


class ExportedPredictor:
    """A loaded artifact, callable like ``serving.Predictor``: uint8 images
    in, float32 numpy features out. Needs no model source or checkpoint."""

    def __init__(self, blob: bytes) -> None:
        if not blob.startswith(_MAGIC):
            raise ValueError("not a theia_tpu_torch AOT artifact")
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        self.meta = json.loads(blob[off : off + hlen].decode())
        self.program = torch.export.load(io.BytesIO(blob[off + hlen :]))
        self.module = self.program.module()  # device tensors in, device tensors out
        self._device = torch.device(self.meta["platforms"][0])

    def __call__(self, images: np.ndarray) -> Any:
        """uint8 [B,H,W,C] -> features (float32 on the host)."""
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8)).to(self._device)
        with torch.inference_mode():
            out = self.module(x)
        if isinstance(out, dict):
            return {k: v.float().cpu().numpy() for k, v in out.items()}
        return out.float().cpu().numpy()


def load_artifact(path: str) -> ExportedPredictor:
    with open(path, "rb") as f:
        return ExportedPredictor(f.read())
