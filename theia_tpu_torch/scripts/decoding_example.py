"""Decoding example CLI (port of theia_tpu/scripts/decoding_example.py; reference:
src/theia/scripts/decoding/decoding_example.py:26-103): run a trained Theia
over a video or an image, decode its predicted features into DINOv2-PCA,
SAM-mask and depth panels, and write an mp4 or a png.

Weights: the student from ``--checkpoint`` (``models.pretrained.load_theia_checkpoint``:
a reference ``.pth``/``.safetensors`` state dict or the port's checkpoint
directory); the SAM mask decoder, the depth head and, with ``--gt``, the
DINOv2-L, SAM-H and Depth-Anything-L teachers from a safetensors file given
on the command line, else from the local Hugging Face cache
(``scripts/feature_extraction.py``'s reader, no ``transformers``). Without
them the decoders take a seeded random init with a warning; ``--gt`` with
a teacher that has no weights is refused when the arguments are parsed
(a ground truth of random teachers shows nothing). Media are read and
written with OpenCV (``cv2``), imported only there.

Usage:
    python -m theia_tpu_torch.scripts.decoding_example \\
        --checkpoint /path/to/checkpoint.pth \\
        --media-to-vis-path input.mp4 --vis-output-dir ./vis \\
        [--backbone facebook/deit-base-patch16-224] [--stat-root feature_stats] [--gt] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional

import numpy as np
import torch

DINO = "facebook/dinov2-large"
SAM = "facebook/sam-vit-huge"
DEPTH = "LiheYoung/depth-anything-large-hf"


def load_media(path: str, target: int = 224) -> np.ndarray:
    """Read an image or video into uint8 [N, 224, 224, 3]."""
    import cv2

    if path.endswith((".mp4", ".avi", ".webm", ".mov")):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(cv2.resize(frame, (target, target)))
        cap.release()
        return np.stack(frames)
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (target, target))[None]


def write_media(results: list[np.ndarray], out_dir: str, base: str) -> str:
    """Write the panels as ``<base>_vis.mp4`` (several frames) or ``.png``; returns the path."""
    import cv2

    if len(results) > 1:
        h, w = results[0].shape[:2]
        path = os.path.join(out_dir, f"{base}_vis.mp4")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        for frame in results:
            out.write(cv2.cvtColor((np.clip(frame, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        out.release()
        return path
    path = os.path.join(out_dir, f"{base}_vis.png")
    cv2.imwrite(path, cv2.cvtColor((np.clip(results[0], 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    return path


def _weights(name: str, path: Optional[str], warn: bool = True) -> Optional[dict[str, torch.Tensor]]:
    """An HF state dict from a safetensors file (or a snapshot directory
    holding ``model.safetensors``), else from the local HF cache, else None."""
    from theia_tpu_torch.scripts.feature_extraction import load_cached_state_dict, read_safetensors_file

    if path:
        return read_safetensors_file(os.path.join(path, "model.safetensors") if os.path.isdir(path) else path)
    sd = load_cached_state_dict(name)
    if sd is None and warn:
        warnings.warn(f"no weights for {name} (no file given, none in the local HF cache): using random init")
    return sd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backbone", default="facebook/deit-base-patch16-224")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--media-to-vis-path", required=True)
    parser.add_argument("--vis-output-dir", default="./vis")
    parser.add_argument("--stat-root", default="feature_stats")
    parser.add_argument("--sam-checkpoint", default=None, help="SamModel safetensors for the mask decoder")
    parser.add_argument("--depth-checkpoint", default=None, help="DepthAnything safetensors for the depth head")
    parser.add_argument(
        "--gt", action="store_true",
        help="also run the teachers on the input frames and stack a ground-truth panel row under the "
        "predicted row (reference decode.py:126-196); DINOv2 weights from --dinov2-checkpoint",
    )
    parser.add_argument("--dinov2-checkpoint", default=None, help="Dinov2Model safetensors for the GT row")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    gt_weights = {}
    if args.gt:
        paths = {DINO: args.dinov2_checkpoint, SAM: args.sam_checkpoint, DEPTH: args.depth_checkpoint}
        gt_weights = {name: _weights(name, path, warn=False) for name, path in paths.items()}
        missing = [name for name, sd in gt_weights.items() if sd is None]
        if missing:
            parser.error(f"--gt needs the teachers' weights, none found for {missing} (give --dinov2-checkpoint, "
                         "--sam-checkpoint, --depth-checkpoint or put them in the local HF cache)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to decode on the CPU")

    from theia_tpu_torch.decoding import decode_everything, load_feature_stats, prepare_depth_decoder, prepare_mask_generator
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES, get_model_feature_size
    from theia_tpu_torch.foundation.extraction import get_model
    from theia_tpu_torch.models.pretrained import load_theia_checkpoint
    from theia_tpu_torch.models.rvfm import Theia

    target_models = [m for m in MODEL_FEATURE_SIZES if "llava" not in m]
    sizes = {t: get_model_feature_size(t, keep_spatial=True) for t in target_models}
    with torch.device("meta"):
        model = Theia(backbone=args.backbone, translator="lconv", target_feature_sizes=sizes)
    model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = load_theia_checkpoint(args.checkpoint, model.to(device)).eval()

    @torch.inference_mode()
    def theia_forward(images: np.ndarray) -> dict[str, torch.Tensor]:
        return model(images)

    means, stds = load_feature_stats(target_models, args.stat_root)
    gen = torch.Generator(device).manual_seed(0)
    sam_sd = gt_weights.get(SAM) or _weights(SAM, args.sam_checkpoint)
    depth_sd = gt_weights.get(DEPTH) or _weights(DEPTH, args.depth_checkpoint)
    mask_generator, _ = prepare_mask_generator(state_dict=sam_sd, device=device, generator=gen)
    depth_decoder, _ = prepare_depth_decoder(state_dict=depth_sd, device=device, generator=gen)

    # the SAM and Depth-Anything weights read for the decoders double as the
    # GT teachers'; DINOv2 has its own
    gt_modules = {name: get_model(name, state_dict=sd, device=device)[0] for name, sd in gt_weights.items()} or None

    media = load_media(args.media_to_vis_path)
    results, gt_results = decode_everything(
        theia_forward, means, stds, media, mask_generator, depth_decoder,
        pred_iou_thresh=0.5, stability_score_thresh=0.7, gt=args.gt, gt_teacher_modules=gt_modules, device=device,
    )
    if gt_results is not None:
        # the reference layout: the predicted row on top, the ground-truth row below
        results = [np.vstack([r, g]) for r, g in zip(results, gt_results)]
    os.makedirs(args.vis_output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.media_to_vis_path))[0]
    path = write_media(results, args.vis_output_dir, base)
    print(f"wrote visualization for {len(results)} frame(s) to {path}")
    return len(results)


if __name__ == "__main__":
    main()
