"""Decoding orchestrator: predicted features -> teacher-native visualisations
(port of theia_tpu/decoding/decode.py:20-164; reference:
src/theia/decoding/decode.py:25-198)."""

from __future__ import annotations

import os
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from theia_tpu_torch.decoding.depth_anything import decode_depth_anything
from theia_tpu_torch.decoding.dinov2 import decode_dinov2
from theia_tpu_torch.decoding.sam import decode_sam

DINO = "facebook/dinov2-large"
SAM = "facebook/sam-vit-huge"
DEPTH = "LiheYoung/depth-anything-large-hf"


def denormalize_feature(x: Any, mean: Any = None, std: Any = None) -> Any:
    """x * std + mean (reference decode.py:25-44)."""
    if mean is None and std is None:
        return x
    if mean is None:
        return x * std
    if std is None:
        return x + mean
    return x * std + mean


def load_feature_stats(
    feature_models: list[str], stat_file_root: str
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """float32 per-channel mean and std ("var" in the file names) vectors
    (reference decode.py:47-67)."""
    means, stds = {}, {}
    for model in feature_models:
        name = model.replace("/", "_")
        means[model] = np.load(os.path.join(stat_file_root, f"imagenet_mean_{name}.npy"))
        stds[model] = np.load(os.path.join(stat_file_root, f"imagenet_var_{name}.npy"))
    return means, stds


@torch.inference_mode()
def run_gt_teachers(
    images: Any,
    state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
    modules: Optional[Mapping[str, nn.Module]] = None,
    batch_size: int = 8,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """The port's DINOv2-L, SAM-H and Depth-Anything-L on the uint8 frames
    [B, H, W, 3]: ground-truth features in the decoder layout [B, H·W, C],
    float32, on the teachers' device (the reference runs the torch teachers
    inline in decode_everything(gt=True), decode.py:126-176).

    Each teacher is a built module from ``modules`` (as
    ``foundation.extraction.get_model`` returns it), else built on
    ``device`` by ``get_model`` from its HF state dict in ``state_dicts``.
    The Depth-Anything feature [B, 32, 518, 518] is nearest-resized to 64²
    (the extraction's layout).
    """
    from theia_tpu_torch.foundation.extraction import _lookup, get_model
    from theia_tpu_torch.ops.image import interpolate_nearest

    state_dicts, modules = state_dicts or {}, modules or {}
    out: dict[str, torch.Tensor] = {}
    for name in (DINO, SAM, DEPTH):
        if name in modules:
            module, feature_fn = modules[name], _lookup(name)[1]
        elif name in state_dicts:
            module, feature_fn = get_model(name, state_dict=state_dicts[name], device=device)
        else:
            raise ValueError(f"no weights for GT teacher {name}: pass state_dicts={{name: HF state dict}} "
                             "or modules={name: the port's module}")
        x = torch.as_tensor(images, device=next(module.parameters()).device)
        feats = []
        for i in range(0, len(x), batch_size):
            r = feature_fn(module, x[i: i + batch_size])
            if name == DINO:
                f = r[1]  # [B, C, 16, 16]
            elif name == SAM:
                f = r[0]  # [B, 256, 64, 64]
            else:  # depth head feature [B, 32, 518, 518] -> 64x64 (extraction layout)
                f = interpolate_nearest(r.permute(0, 2, 3, 1), 64, 64).permute(0, 3, 1, 2)
            feats.append(f.reshape(*f.shape[:2], -1).transpose(1, 2).float())
        out[name] = torch.cat(feats)
    return out


def _panels(images: np.ndarray, dino: np.ndarray, sam: np.ndarray, depth: np.ndarray) -> list[np.ndarray]:
    return [np.hstack([images[i].astype(np.float32) / 255.0, dino[i], sam[i], depth[i]]) for i in range(len(images))]


def decode_everything(
    theia_forward: Callable[[Any], Mapping[str, Any]],
    feature_means: Mapping[str, Any],
    feature_vars: Mapping[str, Any],
    images: Any,
    mask_generator,
    depth_anything_decoder: nn.Conv2d,
    pred_iou_thresh: float = 0.9,
    stability_score_thresh: float = 0.9,
    gt_features: Optional[Mapping[str, Any]] = None,
    gt: bool = False,
    gt_teacher_state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
    gt_teacher_modules: Optional[Mapping[str, nn.Module]] = None,
    pca: Any = None,
    device: str | torch.device = "cuda",
    rng: Optional[np.random.RandomState] = None,
    **kwargs: Any,
) -> tuple[list[np.ndarray], Optional[list[np.ndarray]]]:
    """Run the student over the images, de-normalise its predictions, decode
    each teacher's column and stack [input | dinov2-pca | sam-masks | depth]
    panels a image (reference decode.py:70-198), on ``device``.

    Args:
        theia_forward: uint8 [B, H, W, 3] -> {teacher: [B, H·W, C] features}
            (arrays or tensors).
        images: uint8 [B, 224, 224, 3].
        gt_features: real teachers' features in the same layout, for a
            ground-truth row.
        gt: run the port's teachers on ``images`` for the ground-truth row
            (``run_gt_teachers``; weights from ``gt_teacher_modules`` or
            ``gt_teacher_state_dicts``). Ignored when ``gt_features`` is given.
        rng: the masks' random colours (numpy's global generator by default).
    Returns (the predicted rows, the ground-truth rows or None): [224, 896, 3]
    float32 panels.
    """
    images_np = np.asarray(images.cpu() if isinstance(images, torch.Tensor) else images)
    if gt and gt_features is None:
        gt_features = run_gt_teachers(images_np, state_dicts=gt_teacher_state_dicts, modules=gt_teacher_modules,
                                      device=device)
    features = {}
    for m, v in theia_forward(images_np).items():
        stats = [None if s is None else torch.as_tensor(np.asarray(s), device=device).float()
                 for s in (feature_means[m], feature_vars[m])]
        features[m] = denormalize_feature(torch.as_tensor(v, device=device).float(), *stats)

    gt_rows = None
    if gt_features is not None:
        gt_dino, pca = decode_dinov2(gt_features[DINO], pca=pca, device=device)
        gt_sam = decode_sam(gt_features[SAM], list(images_np), mask_generator,
                            pred_iou_thresh=0.9, stability_score_thresh=0.9, rng=rng)
        gt_depth = decode_depth_anything(gt_features[DEPTH], depth_anything_decoder)
        gt_rows = _panels(images_np, gt_dino, gt_sam, gt_depth)

    dino, _ = decode_dinov2(features[DINO], pca=pca, device=device)
    try:
        sam = decode_sam(features[SAM], list(images_np), mask_generator, pred_iou_thresh=pred_iou_thresh,
                         stability_score_thresh=stability_score_thresh, rng=rng)
    except IndexError:
        sam = np.zeros_like(dino)
    depth = decode_depth_anything(features[DEPTH], depth_anything_decoder)
    return _panels(images_np, dino, sam, depth), gt_rows
