"""Dataset registries: per-dataset frame counts used for steps/epoch math (copy of theia_tpu/data/registries.py).

Facts mirrored from the reference registries
(reference: src/theia/dataset/image/image_common.py:5;
src/theia/dataset/video/video_common.py:5-11).
"""

ALL_IMAGE_DATASETS: dict[str, dict] = {
    "imagenet": {"steps": 1_281_167},
}

ALL_VIDEO_DATASETS: dict[str, dict] = {
    "ego4d": {"steps": 2_800_871},
    "ssv2": {"steps": 312_772},
    "epic_kitchen": {"steps": 333_117},
}
