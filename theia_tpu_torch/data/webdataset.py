"""webdataset-compatible tar shard IO (port of theia_tpu/data/webdataset.py; no webdataset dependency).

Shard format follows the reference spec (reference: doc/dataset_format.md):
  - image shards: ``<key>.image`` members holding npy uint8 HWC arrays;
  - feature shards: ``<key>.<model_name>.safetensors`` members holding
    {"embedding": [C,H,W] bf16, "cls_token": [C], ...};
  - 1000 samples/shard, ``splits.json`` per dataset.

The webdataset convention splits member names at the FIRST dot: everything
before is the sample key, everything after is the field name.

Decoded arrays are CPU tensors. Members read through ``ShardIndex`` are
views into a copy-on-write mmap of the shard, so decoding copies nothing;
the batch collation is the only copy. Shards written here are byte for
byte the JAX package's for the same arrays.
"""

from __future__ import annotations

import ast
import io
import json
import mmap
import os
import tarfile
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

# safetensors dtype names; BF16 is torch's own (the stock safetensors.numpy codec has none,
# but the reference stores features in bf16: feature_extraction_core/models.py:56)
_ST_FROM_NAME: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_TO_NAME = {v: k for k, v in _ST_FROM_NAME.items()}


def _writable(data: Any) -> Any:
    """``data`` as a buffer torch may view without a warning: a read-only one is copied."""
    return bytearray(data) if memoryview(data).readonly else data


def _from_buffer(data: Any, dtype: torch.dtype, shape: list[int], offset: int) -> torch.Tensor:
    count = int(np.prod(shape, dtype=np.int64))
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(data, dtype=dtype, count=count, offset=offset).reshape(shape)


def encode_image_npy(image: np.ndarray | torch.Tensor) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(image))
    return buf.getvalue()


def decode_npy_view(data: Any) -> torch.Tensor:
    """npy bytes/memoryview -> tensor VIEW into the buffer (zero copy for a writable one).

    Hand-parses the npy v1/v2 header; falls back to np.load (a copy) for
    Fortran-ordered arrays."""
    data = _writable(data)
    buf = memoryview(data)
    if bytes(buf[:6]) != b"\x93NUMPY":
        raise ValueError("not an npy buffer")
    if buf[6] == 1:
        start = 10 + int.from_bytes(bytes(buf[8:10]), "little")
        header = bytes(buf[10:start])
    else:
        start = 12 + int.from_bytes(bytes(buf[8:12]), "little")
        header = bytes(buf[12:start])
    meta = ast.literal_eval(header.decode("latin1"))
    dtype = np.dtype(meta["descr"])
    if meta.get("fortran_order") or not dtype.isnative:
        return torch.from_numpy(np.ascontiguousarray(np.load(io.BytesIO(bytes(buf)))))
    return _from_buffer(data, torch.from_numpy(np.empty(0, dtype)).dtype, list(meta["shape"]), start)


def decode_image_npy(data: Any) -> torch.Tensor:
    """npy bytes/view -> RGB uint8 HWC (gray/RGBA converted like reference
    decode_sample; src/theia/dataset/data_utils.py:162-168)."""
    image = decode_npy_view(data)
    if image.ndim == 2:
        image = torch.stack([image] * 3, dim=-1)
    elif image.ndim == 3 and image.shape[-1] == 4:
        # RGBA -> RGB (cv2.COLOR_RGBA2RGB drops alpha)
        image = image[..., :3]
    return image


def save_safetensors(tensors: dict[str, torch.Tensor]) -> bytes:
    """Serialize to safetensors format (8-byte LE header length + JSON header
    + packed buffers), as theia_tpu.data.webdataset.save_safetensors_np does."""
    header: dict[str, Any] = {}
    buffers: list[bytes] = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {
            "dtype": _ST_TO_NAME[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        buffers.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    return len(hjson).to_bytes(8, "little") + hjson + b"".join(buffers)


def load_safetensors(data: Any) -> dict[str, torch.Tensor]:
    """bytes/memoryview -> dict of tensor VIEWS into the buffer (zero copy for a writable one)."""
    data = _writable(data)
    hlen = int.from_bytes(bytes(data[:8]), "little")
    header = json.loads(bytes(data[8 : 8 + hlen]))
    base = 8 + hlen
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, _ = meta["data_offsets"]
        out[name] = _from_buffer(data, _ST_FROM_NAME[meta["dtype"]], meta["shape"], base + lo)
    return out


class ShardWriter:
    """Write one tar shard of (key, field) -> bytes members."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tar = tarfile.open(path, "w")

    def write(self, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name=name)
        info.size = len(data)
        self._tar.addfile(info, io.BytesIO(data))

    def write_sample(self, key: str, fields: dict[str, bytes]) -> None:
        for field, data in fields.items():
            self.write(f"{key}.{field}", data)

    def close(self) -> None:
        self._tar.close()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def split_member_name(name: str) -> tuple[str, str]:
    """webdataset convention: split at the first dot of the basename."""
    base = os.path.basename(name)
    key, _, field = base.partition(".")
    return key, field


def iter_members(path: str) -> Iterator[tuple[str, bytes]]:
    """Stream (member_name, bytes) in archive order."""
    with tarfile.open(path, "r") as tar:
        for member in tar:
            if not member.isfile():
                continue
            f = tar.extractfile(member)
            if f is not None:
                yield member.name, f.read()


class ShardIndex:
    """mmap-backed zero-copy shard access.

    The shard is mapped once, copy-on-write (so torch may view its pages
    without a warning; nothing is ever written back), tarfile walks the
    member headers, and members are memoryview slices: decoded tensors are
    views into the OS page cache. Views keep the map alive; nothing to
    close by hand. (The JAX package walks the headers with a native helper,
    ``theia_tpu/data/fastpack.py``; here it is pure Python.)
    """

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        with tarfile.open(path, "r") as tar:
            self.members: list[tuple[str, int, int]] = [
                (m.name, m.offset_data, m.size) for m in tar if m.isfile()
            ]

    def view(self, data_off: int, size: int) -> memoryview:
        return memoryview(self._mm)[data_off : data_off + size]

    def samples(self) -> Iterator[tuple[str, dict[str, memoryview]]]:
        """Group consecutive members by sample key (webdataset convention)."""
        current_key: Optional[str] = None
        fields: dict[str, memoryview] = {}
        for name, off, size in self.members:
            key, field = split_member_name(name)
            if current_key is not None and key != current_key:
                yield current_key, fields
                fields = {}
            current_key = key
            fields[field] = self.view(off, size)
        if current_key is not None and fields:
            yield current_key, fields


def iter_samples(
    path: str, decode: Optional[Callable[[str, bytes], Any]] = None
) -> Iterator[tuple[str, dict[str, Any]]]:
    """Group consecutive members by sample key: yields (key, {field: value})."""
    current_key: Optional[str] = None
    fields: dict[str, Any] = {}
    for name, data in iter_members(path):
        key, field = split_member_name(name)
        if current_key is not None and key != current_key:
            yield current_key, fields
            fields = {}
        current_key = key
        fields[field] = decode(field, data) if decode is not None else data
    if current_key is not None and fields:
        yield current_key, fields


def read_splits(dataset_dir: str) -> dict[str, int]:
    with open(os.path.join(dataset_dir, "splits.json")) as f:
        return json.load(f)


def write_splits(dataset_dir: str, splits: dict[str, int]) -> None:
    os.makedirs(dataset_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, "splits.json"), "w") as f:
        json.dump(splits, f)
