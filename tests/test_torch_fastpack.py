"""The port's native tar indexer (theia_tpu_torch/data/fastpack.py) against
the JAX package's (theia_tpu/data/fastpack.py) and against tarfile's walk,
on shards both packages write and on hand-built tars; the shard index's
walk, its build and its refusal of a failed build."""

import io
import os
import re
import stat
import tarfile
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from theia_tpu.data import fastpack as jfastpack
from theia_tpu.data import webdataset as jwds
from theia_tpu_torch.data import fastpack as tfastpack
from theia_tpu_torch.data import webdataset as twds


def _tarfile_walk(path):
    """(data_off, size) of the regular members, as tarfile lists them (its
    header offset is that of a member's first header, a pax or GNU one
    where the member has one; the indexer's is the member's own)."""
    with tarfile.open(path, "r") as tar:
        return np.asarray([(m.offset_data, m.size) for m in tar if m.isfile()], np.int64).reshape(-1, 2)


def _assert_walks_agree(path, walk="native"):
    raw = open(path, "rb").read()
    got = tfastpack.tar_index(raw)
    want = jfastpack.tar_index(raw)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    tidx, jidx = twds.ShardIndex(path), jwds.ShardIndex(path)
    assert tidx.walk == walk
    assert tidx.members == jidx.members
    with tarfile.open(path, "r") as tar:
        assert tidx.members == [(m.name, m.offset_data, m.size) for m in tar if m.isfile()]
    if walk == "native":
        np.testing.assert_array_equal(got[:, 1:], _tarfile_walk(path))
    return tidx


def _write_tar(path, members, fmt=tarfile.DEFAULT_FORMAT):
    """members: (name, bytes | None for a directory, mtime)."""
    with tarfile.open(path, "w", format=fmt) as tar:
        for name, data, mtime in members:
            info = tarfile.TarInfo(name)
            info.mtime = mtime
            if data is None:
                info.type = tarfile.DIRTYPE
                tar.addfile(info)
            else:
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    return str(path)


def _samples(rng, n):
    return [(f"{i:06d}", rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
             rng.standard_normal((4, 2, 2)).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_of_shards_both_packages_write(tmp_path, writer):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "shard-000000.tar")
    if writer == "port":
        with twds.ShardWriter(path) as w:
            for key, image, feat in _samples(rng, 7):
                w.write_sample(key, {"image": twds.encode_image_npy(image),
                                     "dinov2.safetensors": twds.save_safetensors({"embedding": torch.from_numpy(feat)})})
    else:
        with jwds.ShardWriter(path) as w:
            for key, image, feat in _samples(rng, 7):
                w.write_sample(key, {"image": jwds.encode_image_npy(image),
                                     "dinov2.safetensors": jwds.save_safetensors_np({"embedding": feat})})
    tidx = _assert_walks_agree(path)
    assert len(tidx.members) == 14
    # the members read the same through both indexes
    for (key, tfields), (jkey, jfields) in zip(tidx.samples(), jwds.ShardIndex(path).samples()):
        assert key == jkey and set(tfields) == set(jfields)
        np.testing.assert_array_equal(twds.decode_image_npy(tfields["image"]).numpy(),
                                      jwds.decode_image_npy(jfields["image"]))


HAND_BUILT = {
    "directory": [("d", None, 0), ("d/a.x", b"abc", 0)],
    "zero_size": [("a.x", b"", 0), ("b.x", b"1", 0)],
    "exactly_512": [("a.x", bytes(range(256)) * 2, 0), ("b.x", b"z" * 513, 0)],
    "name_99": [("k" * 95 + ".xyz", b"payload", 0)],
    "pax_float_mtimes": [("a.x", b"q" * 700, 1.5), ("b.y", b"", 2.25)],
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_index_of_hand_built_tars(tmp_path, case):
    fmt = tarfile.PAX_FORMAT if case.startswith("pax") else tarfile.GNU_FORMAT
    _assert_walks_agree(_write_tar(tmp_path / "t.tar", HAND_BUILT[case], fmt))


@pytest.mark.parametrize("fmt", [tarfile.GNU_FORMAT, tarfile.PAX_FORMAT], ids=["gnu", "pax"])
def test_long_name_takes_the_tarfile_walk_in_both(tmp_path, fmt):
    path = _write_tar(tmp_path / "t.tar", [("a.x", b"1", 0), ("k" * 120 + ".x", b"22", 0)], fmt)
    tidx = _assert_walks_agree(path, walk="tarfile")
    assert tidx.members[1][0] == "k" * 120 + ".x"


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=0, max_size=12))
def test_index_of_random_member_sizes(sizes):
    rng = np.random.default_rng(len(sizes))
    with tempfile.TemporaryDirectory() as d:
        members = [(f"{i:04d}.bin", rng.integers(0, 256, n, dtype=np.uint8).tobytes(), 0) for i, n in enumerate(sizes)]
        tidx = _assert_walks_agree(_write_tar(os.path.join(d, "t.tar"), members))
        assert [size for _, _, size in tidx.members] == sizes


def _read_all(index, decode_image, load_st):
    """What a loader does with a shard: every sample's fields decoded."""
    for _, fields in index.samples():
        decode_image(fields["image"])
        load_st(fields["x.safetensors"])


@pytest.mark.parametrize("cut", [100, 600, 1100, 1700, 2600, 3100])
def test_truncated_shard_fails_alike(tmp_path, cut):
    """A shard cut short: both packages list the same members and raise
    the same exception class (or none) when its samples are read."""
    path = str(tmp_path / "s.tar")
    with twds.ShardWriter(path) as w:
        for i in range(3):
            w.write_sample(f"s{i}", {"image": twds.encode_image_npy(np.full((8, 8, 3), i, np.uint8)),
                                     "x.safetensors": twds.save_safetensors({"e": torch.ones(4, 4)})})
    cut_path = str(tmp_path / "cut.tar")
    with open(path, "rb") as f, open(cut_path, "wb") as g:
        g.write(f.read()[:cut])
    tidx, jidx = twds.ShardIndex(cut_path), jwds.ShardIndex(cut_path)
    assert tidx.walk == "native" and tidx.members == jidx.members
    errors = []
    for index, decode, load in ((tidx, twds.decode_image_npy, twds.load_safetensors),
                                (jidx, jwds.decode_image_npy, jwds.load_safetensors_np)):
        try:
            _read_all(index, decode, load)
            errors.append(None)
        except Exception as e:  # the class is what is compared
            errors.append(type(e))
    assert errors[0] == errors[1]


def test_malformed_size_field_raises_read_error_in_both(tmp_path):
    path = _write_tar(tmp_path / "t.tar", [("a.x", b"abc", 0), ("b.x", b"d", 0)])
    raw = bytearray(open(path, "rb").read())
    raw[124] = ord("9")  # not an octal digit
    bad = tmp_path / "bad.tar"
    bad.write_bytes(bytes(raw))
    assert tfastpack.tar_index(bytes(raw)) is None and jfastpack.tar_index(bytes(raw)) is None
    for index in (twds.ShardIndex, jwds.ShardIndex):
        with pytest.raises(tarfile.ReadError):
            index(str(bad))


def test_shorter_than_a_block_lists_nothing():
    assert tfastpack.tar_index(b"\x01" * 100).shape == (0, 3)
    assert tfastpack.tar_index(b"").shape == (0, 3)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The indexer unloaded and its build directory empty."""
    monkeypatch.setattr(tfastpack, "_lib", None)
    monkeypatch.setattr(tfastpack, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_no_compiler_walks_with_tarfile(fresh_build, monkeypatch):
    empty = fresh_build / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    path = _write_tar(fresh_build / "t.tar", [("a.x", b"abc", 0)])
    assert tfastpack.tar_index(b"") is None
    idx = twds.ShardIndex(path)
    assert idx.walk == "tarfile" and idx.members == [("a.x", 512, 3)]
    assert not (fresh_build / "_build").exists()


def test_failed_build_raises(fresh_build, monkeypatch):
    bindir = fresh_build / "bin"
    bindir.mkdir()
    fake = bindir / tfastpack.CXX
    fake.write_text("#!/bin/sh\necho 'fatal error: no such toolchain' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir))
    path = _write_tar(fresh_build / "t.tar", [("a.x", b"abc", 0)])
    with pytest.raises(RuntimeError, match="no such toolchain"):
        twds.ShardIndex(path)
    assert list((fresh_build / "_build").iterdir()) == []  # no temporary file left behind


def test_library_lands_in_build_under_a_hashed_name(fresh_build):
    assert tfastpack.load() is not None
    lib = tfastpack.library_path()
    assert lib.parent == fresh_build / "_build" and lib.exists()
    assert re.fullmatch(r"libfastpack_[0-9a-f]{16}\.so", lib.name)
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]


def test_build_directory_is_the_packages_build():
    """The package's gitignored ``_build/``, beside the CUDA library."""
    import theia_tpu_torch
    from theia_tpu_torch.kernels import build

    assert tfastpack.BUILD_DIR == build.BUILD_DIR == Path(theia_tpu_torch.__file__).resolve().parent / "_build"
