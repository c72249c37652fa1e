"""The port's input pipeline: webdataset tar shards, the frame-level mix and its batched loader.

The public names are the JAX package's (``theia_tpu/data/__init__.py``).
Two return tensors under another name: ``load_safetensors_np`` is
``load_safetensors`` and ``save_safetensors_np`` is ``save_safetensors``.
"""

from theia_tpu_torch.data.webdataset import (
    ShardWriter,
    check_existing_shard,
    decode_image_npy,
    encode_image_npy,
    iter_samples,
    load_safetensors,
    save_safetensors,
)
from theia_tpu_torch.data.stats import load_feature_stats, normalize_feature
from theia_tpu_torch.data.dataset import (
    RandomMix,
    get_frame_dataloader,
    get_frame_iterator,
    get_image_video_dataset,
    normalize_ds_weights_by_ds_len,
    pad_shard_paths,
)

__all__ = [
    "ShardWriter",
    "check_existing_shard",
    "decode_image_npy",
    "encode_image_npy",
    "iter_samples",
    "load_safetensors",
    "save_safetensors",
    "load_feature_stats",
    "normalize_feature",
    "RandomMix",
    "get_frame_dataloader",
    "get_frame_iterator",
    "get_image_video_dataset",
    "normalize_ds_weights_by_ds_len",
    "pad_shard_paths",
]
