"""Decoding a student's predictions into teacher-native outputs (port of
theia_tpu/decoding/__init__.py): the DINOv2 PCA image, SAM masks and a depth map."""

from theia_tpu_torch.decoding.decode import (
    decode_everything,
    denormalize_feature,
    load_feature_stats,
    run_gt_teachers,
)
from theia_tpu_torch.decoding.dinov2 import decode_dinov2
from theia_tpu_torch.decoding.sam import decode_sam, prepare_mask_generator
from theia_tpu_torch.decoding.depth_anything import decode_depth_anything, prepare_depth_decoder

__all__ = [
    "decode_everything",
    "run_gt_teachers",
    "denormalize_feature",
    "load_feature_stats",
    "decode_dinov2",
    "decode_sam",
    "prepare_mask_generator",
    "decode_depth_anything",
    "prepare_depth_decoder",
]
