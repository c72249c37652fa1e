"""Checkpoint loading for Theia models (port of theia_tpu/models/pretrained.py:27-92).

``load_theia_checkpoint(path, model)`` loads, into a built ``Theia``:
  - a **directory**: the port's own checkpoint directory
    (``train/checkpoint.py``; the JAX package's is an orbax train-state
    directory): the ``params`` of the newest committed ``<step>.pt``, past
    an unreadable step with a warning;
  - a **``.pt`` file holding a train state** (``step``, ``params``, ``mu``,
    ...): its ``params``;
  - a **reference ``.pth``/``.pt`` state dict** (RobotVisionFM's
    ``state_dict()``, reference: src/theia/models/rvfm.py:77-87), read with
    ``torch.load(weights_only=True)``;
  - a **``.safetensors`` file** of such a state dict.

The port's ``Theia`` uses the reference names, so a state dict needs no
conversion; its semantics are the JAX loader's, whose converter
(``convert_theia_checkpoint``) reads the backbone and every teacher head of
the model: a name of the model that the file lacks raises ``KeyError``
(except the conv and lconv heads' optional ``pad`` layer, which the
converter reads only where the file has it), a file's extra names (other teachers) are
ignored, a tensor whose shape differs from the model's keeps the model's
value (``_merge_loose``), and values are cast to the parameter's dtype.
A conv or lconv head whose ``pad`` the file lacks keeps the model's
``pad`` and is read as the JAX converter reads it, on the backbone's
unpadded 14x14 grid (hf_convert.py:103-146): where that takes
``adapter.{1,4,7}`` for the other kind of convolution than the model's
(the conv head's 16x16 ladder for ConvTranspose2d, the lconv head's
16 -> 64 ladder for Conv2d), the converter's layout puts the file's
(I, O) as the model's (O, I), so a weight loads with its first two
dimensions swapped where its shape then matches, and keeps the model's
value where it does not (``_as_jax_reads``). Parity with the JAX loader is
the rule here, not the reference's reading (ROADMAP, "Watch list").
A train state's ``params`` load as they are, as the JAX restore takes its
params. Every load goes through ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch
from torch import nn

from theia_tpu_torch.data.webdataset import load_safetensors
from theia_tpu_torch.models.convert import ladder_is_transposed
from theia_tpu_torch.models.translators import ConvFeatureTranslator, LightConvFeatureTranslator, head_key
from theia_tpu_torch.train.checkpoint import read_params

_TRAIN_STATE_KEYS = {"step", "params"}
# the backbone grid the JAX loader hands its converter (convert_theia_checkpoint's default)
_CONVERTER_GRID = 14


def _optional(name: str) -> bool:
    """Whether the JAX converter reads ``name`` only where the file has it:
    a conv or lconv head's pad ConvTranspose (hf_convert.py:107,136,
    convert_light_conv_head and convert_conv_head)."""
    return name.startswith("translator.translator_heads.") and ".pad.1." in name


def _merge_loose(init: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Overlay loaded tensors onto the model's where names and shapes match,
    cast to the model's dtype; every other name keeps the model's value."""
    out = {}
    for name, t in init.items():
        src = loaded.get(name)
        out[name] = src.to(t.dtype) if src is not None and tuple(src.shape) == tuple(t.shape) else t
    return out


def _as_jax_reads(tensors: Mapping[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    """``tensors`` with each conv or lconv head's ``adapter.{1,4,7}.weight``
    as the JAX converter reads it, in the port's layout: swapped on its
    first two dimensions where the converter takes it for the other kind
    of convolution than the model's (a head whose ``pad`` the file lacks)."""
    translator = getattr(model, "translator", None)
    kinds = {ConvFeatureTranslator: "conv", LightConvFeatureTranslator: "lconv"}
    kind = kinds.get(type(translator))
    if kind is None:
        return dict(tensors)
    out = dict(tensors)
    for t, size in translator.target_feature_sizes.items():
        hp = f"translator.translator_heads.{head_key(t)}."
        side = 16 if f"{hp}pad.1.weight" in tensors else _CONVERTER_GRID
        read_transposed = ladder_is_transposed(kind, side, size[1])
        adapter = translator.translator_heads[head_key(t)].adapter
        for idx in (1, 4, 7):
            m = adapter[idx] if idx < len(adapter) else None
            name = f"{hp}adapter.{idx}.weight"
            if (isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and name in out
                    and read_transposed != isinstance(m, nn.ConvTranspose2d)):
                out[name] = out[name].transpose(0, 1)
    return out


def _read_file(path: str) -> tuple[dict[str, torch.Tensor], bool]:
    """(tensors, whether they are a train state's params) of a file."""
    if path.endswith(".safetensors"):
        with open(path, "rb") as f:
            return load_safetensors(f.read()), False
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(saved, dict) and _TRAIN_STATE_KEYS <= set(saved) and isinstance(saved["params"], dict):
        return saved["params"], True
    return saved, False


def load_theia_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load the checkpoint at ``path`` into ``model`` (a ``Theia``) in place; returns ``model``."""
    if os.path.isdir(path):
        _, params = read_params(path)
        model.load_state_dict(params, strict=True)
        return model
    tensors, train_state = _read_file(path)
    if train_state:
        model.load_state_dict(tensors, strict=True)
        return model
    init = model.state_dict()
    missing = [n for n in init if n not in tensors and not _optional(n)]
    if missing:
        raise KeyError(f"checkpoint at {path} does not look like a reference RobotVisionFM state dict "
                       f"(missing {missing[0]!r})")
    model.load_state_dict(_merge_loose(init, _as_jax_reads(tensors, model)), strict=True)
    return model
