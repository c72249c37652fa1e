"""Automatic-mask-generation primitives (port of theia_tpu/decoding/amg.py:29-247).

The HF MaskGenerationPipeline / SamImageProcessor toolbox the reference
uses (src/theia/decoding/sam.py:15-106): point grids, crop boxes, stability
scores, mask -> box, uncompressed pycocotools-style RLE, crop-edge
filtering, greedy box NMS. The steps that are batched operations over a
set of masks (stability, binarisation, boxes, the edge filter, padding to
the image, the RLE's change points) run on the masks' device as torch
tensors; the grids, the RLE lists, ``rle_to_mask`` and the NMS stay numpy.

As in the JAX package, crop layers > 0 follow the original SAM AMG (per
crop decode, boxes offset to absolute coordinates, edge filter against
each crop box, cross-crop NMS), not the HF pipeline's single-crop filter.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Any

import numpy as np
import torch


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced [0,1]^2 grid, x-major rows (HF _build_point_grid)."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1.0 - offset, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def normalize_coordinates(target_size: int, coords: np.ndarray, original_size: tuple[int, int]) -> np.ndarray:
    """Scale (x, y) points from original-image coords to the processed
    longest-edge = target_size frame (HF _normalize_coordinates)."""
    old_h, old_w = original_size
    scale = target_size / max(old_h, old_w)
    new_h, new_w = int(old_h * scale + 0.5), int(old_w * scale + 0.5)
    out = coords.astype(np.float64).copy()
    out[..., 0] *= new_w / old_w
    out[..., 1] *= new_h / old_h
    return out


def generate_crop_boxes(
    original_size: tuple[int, int],
    crop_n_layers: int = 0,
    overlap_ratio: float = 512 / 1500,
    points_per_crop: int = 32,
    crop_n_points_downscale_factor: int = 1,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Crop boxes (absolute XYXY) and each crop's point grid in crop-frame
    pixel coords. Layer i contributes (2**(i+1))**2 crops; layer 0 is the
    full image."""
    im_h, im_w = original_size
    short_side = min(im_h, im_w)
    grids = [
        build_point_grid(int(points_per_crop / (crop_n_points_downscale_factor**i)))
        for i in range(crop_n_layers + 1)
    ]
    crop_boxes: list[list[int]] = [[0, 0, im_w, im_h]]
    layer_idxs: list[int] = [0]
    for i_layer in range(crop_n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = int(math.ceil((overlap * (n_per_side - 1) + im_w) / n_per_side))
        crop_h = int(math.ceil((overlap * (n_per_side - 1) + im_h) / n_per_side))
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for left, top in product(x0s, y0s):
            crop_boxes.append([left, top, min(left + crop_w, im_w), min(top + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    points = []
    for (left, top, right, bottom), layer in zip(crop_boxes, layer_idxs):
        points.append(grids[layer] * np.array([right - left, bottom - top], np.float64)[None, :])
    return np.asarray(crop_boxes, np.float32), points


def compute_stability_score(masks: torch.Tensor, mask_threshold: float, stability_score_offset: float) -> torch.Tensor:
    """IoU of the +offset and -offset binarisations of mask logits [..., H, W], float64."""
    inter = (masks > (mask_threshold + stability_score_offset)).sum((-1, -2), dtype=torch.int64)
    union = (masks > (mask_threshold - stability_score_offset)).sum((-1, -2), dtype=torch.int64)
    return inter.double() / union.clamp(min=1).double()


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """[..., H, W] binary masks -> int64 XYXY boxes, [0,0,0,0] for an empty
    mask (right and bottom are inclusive pixel indices)."""
    if masks.numel() == 0:
        return torch.zeros((*masks.shape[:-2], 4), dtype=torch.int64, device=masks.device)
    shape = masks.shape
    h, w = shape[-2:]
    m = masks.reshape(-1, h, w).bool()

    in_h = m.any(dim=-1)  # [N, H]
    hc = in_h * torch.arange(h, device=m.device)[None, :]
    bottom = hc.amax(dim=-1)
    top = (hc + h * ~in_h).amin(dim=-1)

    in_w = m.any(dim=-2)  # [N, W]
    wc = in_w * torch.arange(w, device=m.device)[None, :]
    right = wc.amax(dim=-1)
    left = (wc + w * ~in_w).amin(dim=-1)

    empty = (right < left) | (bottom < top)
    out = torch.stack([left, top, right, bottom], dim=-1) * ~empty[:, None]
    return out.reshape(*shape[:-2], 4)


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box: list[int], orig_box: list[int],
                          atol: float = 20.0) -> torch.Tensor:
    """True for boxes (crop-frame coords) near a crop edge that are not near
    the image edge."""
    crop = torch.as_tensor(crop_box, dtype=torch.float64, device=boxes.device)[None, :]
    orig = torch.as_tensor(orig_box, dtype=torch.float64, device=boxes.device)[None, :]
    abs_boxes = boxes.double() + crop[:, [0, 1, 0, 1]]
    near_crop = torch.isclose(abs_boxes, crop, rtol=0.0, atol=atol)
    near_image = torch.isclose(abs_boxes, orig, rtol=0.0, atol=atol)
    return (near_crop & ~near_image).any(dim=-1)


def mask_to_rle(masks: torch.Tensor) -> list[dict[str, Any]]:
    """[N, H, W] binary masks -> uncompressed column-major RLE (pycocotools
    format). The change points are found on the masks' device in one pass,
    then split into each mask's counts on the host."""
    n, h, w = masks.shape
    if n == 0:
        return []
    flat = masks.transpose(1, 2).reshape(n, -1).bool()
    rows, cols = (flat[:, 1:] ^ flat[:, :-1]).nonzero(as_tuple=True)
    rows, change = rows.cpu().numpy(), cols.cpu().numpy() + 1
    starts = np.searchsorted(rows, np.arange(n + 1))
    first = flat[:, 0].cpu().numpy()
    out = []
    for i in range(n):
        ch = change[starts[i]: starts[i + 1]]
        if len(ch) == 0:
            out.append({"size": [h, w], "counts": [h * w] if not first[i] else [0, h * w]})
            continue
        counts = [] if not first[i] else [0]
        counts += [int(ch[0])] + np.diff(ch).tolist() + [h * w - int(ch[-1])]
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> [H, W] binary mask."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx: idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def pad_mask_to_image(masks: torch.Tensor, crop_box: list[int], orig_h: int, orig_w: int) -> torch.Tensor:
    """Place crop-frame masks [..., h, w] into the full image frame."""
    left, top, right, bottom = (int(v) for v in crop_box)
    if left == 0 and top == 0 and right == orig_w and bottom == orig_h:
        return masks
    out = masks.new_zeros((*masks.shape[:-2], orig_h, orig_w))
    out[..., top: top + masks.shape[-2], left: left + masks.shape[-1]] = masks
    return out


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS in score-descending order with stable ties (torchvision.nms
    semantics): a box is dropped when its IoU with a box kept before it
    exceeds the threshold. Each kept box marks the boxes it suppresses in
    one vector operation; the IoU is the JAX loop's float64 arithmetic."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    boxes = boxes.astype(np.float64)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    suppressed = np.zeros(len(boxes), bool)
    keep: list[int] = []
    for i in np.argsort(-scores, kind="stable"):
        if suppressed[i]:
            continue
        keep.append(int(i))
        w = np.maximum(0.0, np.minimum(boxes[i, 2], boxes[:, 2]) - np.maximum(boxes[i, 0], boxes[:, 0]))
        h = np.maximum(0.0, np.minimum(boxes[i, 3], boxes[:, 3]) - np.maximum(boxes[i, 1], boxes[:, 1]))
        inter = w * h
        union = areas + areas[i] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            suppressed |= (union > 0) & (inter / union > iou_threshold)
    return np.asarray(keep, np.int64)


def filter_masks(
    masks: torch.Tensor,
    iou_scores: torch.Tensor,
    crop_box: list[int],
    orig_box: list[int],
    pred_iou_thresh: float = 0.88,
    stability_score_thresh: float = 0.95,
    mask_threshold: float = 0.0,
    stability_score_offset: float = 1.0,
) -> tuple[list[dict], np.ndarray, np.ndarray]:
    """HF's _filter_masks_pt flow on crop-frame mask logits [N, H, W] on the
    device: IoU threshold -> stability threshold -> binarise -> boxes ->
    crop-edge filter -> pad to the image frame -> RLE. Returns (rles, scores,
    boxes) with the boxes offset to absolute image coordinates (float64)."""
    orig_w, orig_h = int(orig_box[2]), int(orig_box[3])
    keep = torch.ones(len(masks), dtype=torch.bool, device=masks.device)
    if pred_iou_thresh > 0.0:
        keep &= iou_scores > pred_iou_thresh
    if stability_score_thresh > 0.0:
        keep &= compute_stability_score(masks, mask_threshold, stability_score_offset) > stability_score_thresh
    masks, scores = masks[keep], iou_scores[keep]

    binary = masks > mask_threshold
    boxes = batched_mask_to_box(binary)
    keep = ~is_box_near_crop_edge(boxes, crop_box, orig_box)
    binary, scores, boxes = binary[keep], scores[keep], boxes[keep]

    rles = mask_to_rle(pad_mask_to_image(binary, crop_box, orig_h, orig_w))
    offset = np.array([crop_box[0], crop_box[1], crop_box[0], crop_box[1]], np.float64)
    return rles, scores.cpu().numpy(), boxes.cpu().numpy().astype(np.float64) + offset
