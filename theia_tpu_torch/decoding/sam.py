"""SAM mask decoding from predicted embeddings (port of theia_tpu/decoding/sam.py:39-224).

An automatic mask generator over the port's ``SamMaskDecoder`` on the
decoder's device, following the HF pipeline's flow (reference:
src/theia/decoding/sam.py:15-106): per point batch, decode -> the two
bilinear upscalings (to the padded 1024² model frame, cropped to the
reshaped input, then to the output size) -> ``filter_masks`` -> cross-batch
box NMS. The masks stay on the device until their RLEs are split on the
host.

Crop layers with injected embeddings decode each crop against the
full-image embedding window, sliced in embedding space and resized back
to 64x64, as the JAX package does (the reference never runs
crops_n_layers > 0 in decode_sam).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from theia_tpu_torch.decoding.amg import box_nms, filter_masks, generate_crop_boxes, normalize_coordinates, rle_to_mask
from theia_tpu_torch.foundation.sam_decoder import SAM_DECODER, SamMaskDecoder, build_sam_decoder
from theia_tpu_torch.ops.image import bicubic_resize


class MaskGenerator:
    """Automatic mask generation from SAM image embeddings."""

    def __init__(
        self,
        decoder: SamMaskDecoder,
        points_per_side: int = 32,
        points_per_batch: int = 64,
        mask_threshold: float = 0.0,
        stability_score_offset: float = 1.0,
        crops_nms_thresh: float = 0.7,
    ) -> None:
        self.decoder = decoder
        self.cfg = decoder.cfg
        self.device = decoder.shared_image_embedding.positional_embedding.device
        self.points_per_side = points_per_side
        self.points_per_batch = points_per_batch
        self.mask_threshold = mask_threshold
        self.stability_score_offset = stability_score_offset
        self.crops_nms_thresh = crops_nms_thresh

    def _upscale(self, masks: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """HF post_process_masks: bilinear to the padded model size (1024),
        slice to the reshaped input, bilinear to the target size."""
        t = self.cfg.input_image_size
        oh, ow = out_hw
        scale = t / max(oh, ow)
        rh, rw = int(oh * scale + 0.5), int(ow * scale + 0.5)
        up = bicubic_resize(masks[..., None], t, t, kernel="linear", antialias=False)[:, :rh, :rw]
        return bicubic_resize(up, oh, ow, kernel="linear", antialias=False)[..., 0]

    def _crop_embedding(self, emb: torch.Tensor, crop_box: np.ndarray, hw: tuple[int, int]) -> torch.Tensor:
        """The [1, 64, 64, 256] embedding's window under the crop, resized back to 64x64."""
        h, w = hw
        left, top, right, bottom = (float(v) for v in crop_box)
        if left == 0 and top == 0 and right == w and bottom == h:
            return emb
        s = emb.shape[1]
        x0, x1 = int(left / w * s), max(int(np.ceil(right / w * s)), int(left / w * s) + 1)
        y0, y1 = int(top / h * s), max(int(np.ceil(bottom / h * s)), int(top / h * s) + 1)
        return bicubic_resize(emb[:, y0:y1, x0:x1, :], s, s, kernel="linear", antialias=False)

    @torch.inference_mode()
    def __call__(
        self,
        embeddings: Any,  # [1, 256, 64, 64] BCHW (reference layout), array or tensor
        output_size: tuple[int, int] = (224, 224),
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        crops_n_layers: int = 0,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        output_rle_mask: bool = False,
        output_bboxes_mask: bool = False,
        **kwargs: Any,
    ) -> dict[str, Any]:
        emb_full = torch.as_tensor(embeddings, device=self.device).float().permute(0, 2, 3, 1)
        oh, ow = output_size
        orig_box = [0, 0, ow, oh]
        crop_boxes, points_per_crop = generate_crop_boxes(
            (oh, ow), crop_n_layers=crops_n_layers, overlap_ratio=crop_overlap_ratio,
            points_per_crop=self.points_per_side, crop_n_points_downscale_factor=crop_n_points_downscale_factor,
        )
        all_rles: list[dict] = []
        all_scores: list[float] = []
        all_boxes: list[np.ndarray] = []
        for crop_box, crop_points in zip(crop_boxes, points_per_crop):
            left, top, right, bottom = (int(v) for v in crop_box)
            ch, cw = bottom - top, right - left
            emb = self._crop_embedding(emb_full, crop_box, (oh, ow))
            # points in the crop frame -> the processed (longest-edge) frame
            points = normalize_coordinates(self.cfg.input_image_size, crop_points, (ch, cw)).astype(np.float32)
            for i in range(0, len(points), self.points_per_batch):
                pts = torch.from_numpy(points[i: i + self.points_per_batch]).to(self.device)[None, :, None, :]
                lbl = torch.ones(pts.shape[:3], dtype=torch.int32, device=self.device)
                masks, iou = self.decoder(emb, pts, lbl, True)
                p, m, mh, mw = masks[0].shape
                flat = self._upscale(masks[0].reshape(p * m, mh, mw), (ch, cw))
                rles, scores, boxes = filter_masks(
                    flat, iou[0].reshape(-1), [left, top, right, bottom], orig_box,
                    pred_iou_thresh=pred_iou_thresh, stability_score_thresh=stability_score_thresh,
                    mask_threshold=self.mask_threshold, stability_score_offset=self.stability_score_offset,
                )
                all_rles.extend(rles)
                all_scores.extend(float(s) for s in scores)
                all_boxes.extend(boxes)

        if not all_rles:
            return {"masks": [], "scores": []}
        boxes_arr = np.stack(all_boxes)
        scores_arr = np.asarray(all_scores, np.float32)
        keep = box_nms(boxes_arr, scores_arr, self.crops_nms_thresh)
        out: dict[str, Any] = {
            "masks": [rle_to_mask(all_rles[i]) for i in keep],
            "scores": [float(scores_arr[i]) for i in keep],
        }
        if output_rle_mask:
            out["rle_mask"] = [all_rles[i] for i in keep]
        if output_bboxes_mask:
            out["bounding_boxes"] = boxes_arr[keep]
        return out


def prepare_mask_generator(
    state_dict: Optional[dict] = None,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
    **kwargs: Any,
) -> tuple[MaskGenerator, SamMaskDecoder]:
    """The mask generator and its decoder (reference prepare_mask_generator,
    decoding/sam.py:176-191) on ``device``: weights from an HF SamModel
    state dict, else a seeded random init (``generator`` on ``device``).
    Other keywords go to ``MaskGenerator``."""
    decoder = build_sam_decoder(state_dict, SAM_DECODER, device=device, generator=generator)
    return MaskGenerator(decoder, **kwargs), decoder


def draw_mask(mask: np.ndarray, random_color: bool = False, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """(reference decoding/sam.py:109-125) A random colour comes from ``rng``,
    by default numpy's global generator, as in the JAX package."""
    if random_color:
        color = (rng or np.random).random(3)
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255])
    h, w = mask.shape[-2:]
    return mask.reshape(h, w, 1) * color.reshape(1, 1, -1)


def decode_sam(
    features: Any,
    images: list,
    mask_generator: MaskGenerator,
    points_per_batch: int = 64,
    pred_iou_thresh: float = 0.5,
    stability_score_thresh: float = 0.6,
    random_color: bool = True,
    rng: Optional[np.random.RandomState] = None,
    **kwargs: Any,
) -> np.ndarray:
    """[B, num_tokens, 256] predicted SAM embeddings -> rendered mask images
    [B, 224, 224, 3] (reference decoding/sam.py:128-173)."""
    feats = torch.as_tensor(features, device=mask_generator.device).float()
    b, n, c = feats.shape
    s = int(n ** 0.5)
    feats = feats.transpose(1, 2).reshape(b, c, s, s)
    outs = []
    for i in range(b):
        result = mask_generator(feats[i: i + 1], pred_iou_thresh=pred_iou_thresh,
                                stability_score_thresh=stability_score_thresh)
        canvas = np.zeros((224, 224, 3), np.float32)
        for mask in result["masks"]:
            canvas += draw_mask(mask, random_color=random_color, rng=rng)
        outs.append(canvas)
    return np.stack(outs)
