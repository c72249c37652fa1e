"""Subsample video datasets into frame shards (port of theia_tpu/scripts/subsampling_videos.py; reference:
src/theia/scripts/preprocessing/video_datasets/subsampling_videos.py:32-182):
ego4d 1/150 (mp4), ssv2 1/32 (webm), epic_kitchen 1/60 (jpg tars), frames
resized to 224x224, written as npy-in-tar shards with resume checking.
OpenCV (``cv2``) decodes and resizes; it is imported only by the three
functions that use it.

Usage:
    python -m theia_tpu_torch.scripts.subsampling_videos --dataset ego4d \
        --dataset-path /raw/ego4d --output-path /data/theia
"""

from __future__ import annotations

import argparse
import os
import tarfile

import numpy as np

DEFAULT_RATES = {"ego4d": 150, "ssv2": 32, "epic_kitchen": 60}
VIDEO_EXT = {"ego4d": ".mp4", "ssv2": ".webm", "epic_kitchen": ".tar"}


def _resize(frame: np.ndarray, size: int = 224) -> np.ndarray:
    import cv2

    return cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)


def iter_video_frames(path: str, rate: int):
    """Yield every `rate`-th RGB frame from a video file."""
    import cv2

    cap = cv2.VideoCapture(path)
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if idx % rate == 0:
            yield idx, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        idx += 1
    cap.release()


def iter_jpg_tar_frames(path: str, rate: int):
    """Yield every `rate`-th frame from a tar of jpgs (epic_kitchen layout)."""
    import cv2

    with tarfile.open(path) as tarf:
        members = sorted((m for m in tarf.getmembers() if m.isfile()), key=lambda m: m.name)
        for idx, m in enumerate(members):
            if idx % rate != 0:
                continue
            f = tarf.extractfile(m)
            if f is None:
                continue
            buf = np.frombuffer(f.read(), np.uint8)
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            yield idx, cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None) -> None:
    from theia_tpu_torch.data.webdataset import ShardWriter, encode_image_npy
    from theia_tpu_torch.scripts.organize_imagenet_webdataset import check_existing_shard

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=list(DEFAULT_RATES))
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--subsampling-rate", type=int, default=-1)
    parser.add_argument("--samples-per-shard", type=int, default=1000)
    args = parser.parse_args(argv)

    rate = args.subsampling_rate if args.subsampling_rate > 0 else DEFAULT_RATES[args.dataset]
    ext = VIDEO_EXT[args.dataset]
    out_dir = os.path.join(args.output_path, f"{args.dataset}_1in{rate}_images")
    os.makedirs(out_dir, exist_ok=True)
    print(f"subsampling {args.dataset} by 1/{rate}")

    video_fns = sorted(fn for fn in os.listdir(args.dataset_path) if fn.endswith(ext))

    shard_idx = 0
    buffer: list[tuple[np.ndarray, str]] = []

    def flush() -> None:
        nonlocal shard_idx, buffer
        if not buffer:
            return
        fn = f"{args.dataset}_1in{rate}-{shard_idx:06d}.tar"
        path = os.path.join(out_dir, fn)
        if not check_existing_shard(path):
            with ShardWriter(path) as w:
                for image, basename in buffer:
                    w.write(f"{basename}.image", encode_image_npy(image))
        buffer = []
        shard_idx += 1

    for vid_i, fn in enumerate(video_fns):
        path = os.path.join(args.dataset_path, fn)
        frames = iter_jpg_tar_frames(path, rate) if ext == ".tar" else iter_video_frames(path, rate)
        stem = os.path.splitext(fn)[0]
        for frame_idx, frame in frames:
            buffer.append((_resize(frame), f"{stem}_{frame_idx:08d}"))
            if len(buffer) == args.samples_per_shard:
                flush()
        if (vid_i + 1) % 10 == 0:
            print(f"{args.dataset}: processed {vid_i + 1}/{len(video_fns)} videos")
    flush()
    print(f"wrote {shard_idx} shards to {out_dir}")


if __name__ == "__main__":
    main()
