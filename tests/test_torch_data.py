"""The port's input pipeline (theia_tpu_torch/data/) against the JAX package's
theia_tpu/data/ on the same shards: the same batches in the same order,
bit for bit (uint8 images; bf16 features compared as their uint16 bits),
and shards that each package reads back from the other."""

import glob
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from theia_tpu.data import dataset as jds
from theia_tpu.data import oxe as joxe
from theia_tpu.data import synthetic as jsyn
from theia_tpu.data import webdataset as jwds
from theia_tpu_torch.data import dataset as tds
from theia_tpu_torch.data import oxe as toxe
from theia_tpu_torch.data import stats as tstats
from theia_tpu_torch.data import synthetic as tsyn
from theia_tpu_torch.data import webdataset as twds

TEACHERS = {"teacher/a": (8, 4, 4), "teacher/b": (4, 8, 8)}
JBF16 = np.dtype(ml_dtypes.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == JBF16 else x


def _assert_same(jtree, ttree, where="batch"):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), where
        for k in jtree:
            _assert_same(jtree[k], ttree[k], f"{where}.{k}")
        return
    assert isinstance(ttree, torch.Tensor), where
    want, got = _bits(jtree), _bits(ttree)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Two datasets of JAX-written shards (5 train shards each: uneven over 2
    ranks), and non-trivial feature stats."""
    root = str(tmp_path_factory.mktemp("shards"))
    for seed, name in enumerate(("imagenet", "ego4d")):
        jsyn.generate_synthetic_dataset(root, dataset=name, feature_models=TEACHERS, n_train=18, n_val=7,
                                        samples_per_shard=4, image_size=32, seed=seed)
    rng = np.random.RandomState(5)
    for model, (c, _, _) in TEACHERS.items():
        name = model.replace("/", "_")
        np.save(os.path.join(root, f"imagenet_mean_{name}.npy"), rng.randn(c).astype(np.float32))
        np.save(os.path.join(root, f"imagenet_var_{name}.npy"), rng.uniform(0.5, 2.0, c).astype(np.float32))
    return root


def _batches(pkg, root, split, feature_norm, rank, world):
    ds, expected = pkg.get_image_video_dataset(
        dataset_root=root, feature_models=list(TEACHERS), dataset_mix=["imagenet", "ego4d"], split=split,
        dataset_ratio=1.0, feature_norm=feature_norm, seed=3, shuffle=split == "train", rank=rank, world_size=world,
    )
    train = split == "train"
    loader = pkg.get_frame_dataloader(ds, batch_size=3 if train else 4, shuffle=train, shuffle_buffer_size=5,
                                      seed=7, drop_last=train)
    return list(loader), expected


@pytest.mark.parametrize("feature_norm", ["device", True])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2)])
def test_loader_batches_equal_jax(root, feature_norm, split, rank, world):
    want, jlen = _batches(jds, root, split, feature_norm, rank, world)
    got, tlen = _batches(tds, root, split, feature_norm, rank, world)
    assert tlen == jlen
    assert len(got) == len(want) > 0
    for i, (jb, tb) in enumerate(zip(want, got)):
        _assert_same(jb, tb, f"batch {i}")
    field = "embedding_chw" if feature_norm == "device" else "embedding"
    assert got[0]["teacher/b"][field].dtype == torch.bfloat16
    assert got[0]["image"].dtype == torch.uint8 and got[0]["image"].shape[1:] == (32, 32, 3)
    if split == "val":  # every sample, the eval tail batch kept: 7 = 4 + 3 a dataset, one shard a rank
        assert sum(b["image"].shape[0] for b in got) == {1: 14, 2: 8 - 2 * rank}[world]


@pytest.mark.parametrize("split,world,n", [("val", 2, 7), ("train", 5, 18)])
def test_ranks_are_disjoint(root, split, world, n):
    """As many ranks as shards (no padding): the ranks' samples are disjoint and cover the split."""
    def images(rank):
        ds, _ = tds.get_image_video_dataset(dataset_root=root, feature_models=list(TEACHERS),
                                            dataset_mix=["imagenet"], split=split, seed=0, rank=rank,
                                            world_size=world)
        return {bytes(s["image"].numpy()) for s in ds}

    parts = [images(r) for r in range(world)]
    assert all(parts) and sum(map(len, parts)) == len(set().union(*parts)) == n


def test_synthetic_shards_are_the_jax_shards_byte_for_byte(tmp_path):
    kw = dict(feature_models=TEACHERS, n_train=9, n_val=3, samples_per_shard=4, image_size=16, seed=11)
    jsyn.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    tsyn.generate_synthetic_dataset(str(tmp_path / "t"), **kw)
    jfiles = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert jfiles == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert len(jfiles) == (3 + 1) * 3 + 1 + 4  # (3 train + 1 val shards) x 3 columns, splits.json, 4 stats
    for rel in jfiles:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel


def test_shards_read_back_across_packages(tmp_path):
    """The port's shards through the JAX reader, and the JAX shards through the port's."""
    for writer, reader in ((tsyn, "jax"), (jsyn, "port")):
        root = str(tmp_path / reader)
        writer.generate_synthetic_dataset(root, feature_models=TEACHERS, n_train=5, n_val=1, samples_per_shard=4,
                                          image_size=16, seed=2)
        for path in sorted(glob.glob(os.path.join(root, "imagenet", "*", "*.tar"))):
            jsamples = list(jwds.iter_samples(path))
            tsamples = list(twds.ShardIndex(path).samples())
            assert [k for k, _ in jsamples] == [k for k, _ in tsamples]
            for (_, jf), (_, tf) in zip(jsamples, tsamples):
                assert set(jf) == set(tf)
                for field in jf:
                    if field == "image":
                        _assert_same(jwds.decode_image_npy(jf[field]), twds.decode_image_npy(tf[field]), path)
                    else:
                        _assert_same(jwds.load_safetensors_np(jf[field]), twds.load_safetensors(tf[field]), path)


def test_bf16_safetensors_codec_round_trips():
    g = torch.Generator().manual_seed(0)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -3.5, 65504.0])
    tensors = {
        "embedding": torch.randn(8, 4, 4, generator=g).to(torch.bfloat16),
        "cls_token": torch.cat([special, torch.randn(8, generator=g)]).to(torch.bfloat16),
        "f32": torch.randn(3, 5, generator=g),
        "u8": torch.randint(0, 256, (7,), generator=g, dtype=torch.uint8),
        "i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
    }
    assert twds.load_safetensors(twds.save_safetensors({"s": torch.tensor(3.0)}))["s"].shape == ()
    blob = twds.save_safetensors(tensors)
    for view in (blob, memoryview(bytearray(blob))):
        back = twds.load_safetensors(view)
        assert set(back) == set(tensors)
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype and back[k].shape == t.shape
            assert torch.equal(back[k].view(torch.int16) if t.dtype == torch.bfloat16 else back[k],
                               t.view(torch.int16) if t.dtype == torch.bfloat16 else t), k
    # the JAX codec reads it, and writes the same bytes
    jarrays = jwds.load_safetensors_np(blob)
    _assert_same(jarrays, tensors)
    assert jwds.save_safetensors_np({k: np.asarray(v) for k, v in jarrays.items()}) == blob
    # and the official library agrees
    from safetensors.torch import load as st_load

    official = st_load(blob)
    for k, t in tensors.items():
        assert torch.equal(official[k].view(torch.int16) if t.dtype == torch.bfloat16 else official[k],
                           t.view(torch.int16) if t.dtype == torch.bfloat16 else t), k


@pytest.mark.parametrize("shape", [(8, 8), (8, 8, 4), (8, 8, 3), (5, 7, 3)])
def test_decode_image_gray_and_rgba(shape):
    img = np.random.RandomState(len(shape)).randint(0, 256, shape, np.uint8)
    if shape == (5, 7, 3):
        img = np.asfortranarray(img)
    blob = twds.encode_image_npy(img)
    assert blob == jwds.encode_image_npy(img)
    got = twds.decode_image_npy(blob)
    assert got.shape == (*shape[:2], 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), jwds.decode_image_npy(blob))


def test_feature_stats_normalize_like_jax(tmp_path):
    rng = np.random.RandomState(0)
    np.save(tmp_path / "imagenet_mean_m_a.npy", rng.randn(16).astype(np.float32))
    np.save(tmp_path / "imagenet_var_m_a.npy", rng.uniform(0.1, 3, 16).astype(np.float32))
    jm, js = __import__("theia_tpu.data.stats", fromlist=["x"]).load_feature_stats(str(tmp_path), ["m/a"])
    tm, ts = tstats.load_feature_stats(str(tmp_path), ["m/a"])
    _assert_same(jm, tm)
    x = rng.randn(64, 16).astype(np.float32)
    want = (x.astype(JBF16) - jm["m/a"]) / js["m/a"]
    got = tstats.normalize_feature(torch.from_numpy(x).to(torch.bfloat16), tm["m/a"], ts["m/a"])
    _assert_same(want.astype(JBF16), got)


def test_misaligned_columns_raise(tmp_path):
    root = str(tmp_path)
    tsyn.generate_synthetic_dataset(root, feature_models={"m/a": (8, 4, 4)}, n_train=8, n_val=2,
                                    samples_per_shard=8, image_size=16)
    (fshard,) = glob.glob(str(tmp_path / "imagenet" / "m_a" / "*-train.tar"))
    with twds.ShardWriter(fshard) as w:
        for i in range(8):
            w.write(f"WRONG_{i}.m_a.safetensors", twds.save_safetensors({"embedding": torch.zeros(8, 4, 4)}))
    ds, _ = tds.get_image_video_dataset(dataset_root=root, feature_models=["m/a"], dataset_mix=["imagenet"],
                                        split="train", seed=0)
    with pytest.raises(ValueError, match="misalignment"):
        next(iter(ds))
    # a column with another shard count fails when the dataset is built
    os.remove(fshard)
    with pytest.raises(FileNotFoundError, match="m/a"):
        tds.get_image_video_dataset(dataset_root=root, feature_models=["m/a"], dataset_mix=["imagenet"],
                                    split="train", seed=0)


def test_decode_feature_missing_member_raises():
    feat = torch.zeros(4, 2, 2)
    fields = {"other_model.safetensors": twds.save_safetensors({"embedding": feat}),
              "image": twds.encode_image_npy(np.zeros((4, 4, 3), np.uint8))}
    with pytest.raises(KeyError, match="wanted_model"):
        tds._decode_feature(fields, None, None, model="wanted/model")
    fields["wanted_model.safetensors"] = twds.save_safetensors({"embedding": feat})
    assert tds._decode_feature(fields, None, None, model="wanted/model")["embedding"].shape == (4, 4)


def test_loader_is_reiterable_and_refuses_workers(root):
    ds, _ = tds.get_image_video_dataset(dataset_root=root, feature_models=list(TEACHERS), dataset_mix=["imagenet"],
                                        split="train", seed=0)
    loader = tds.get_frame_dataloader(ds, batch_size=4, drop_last=True)
    assert len(list(loader)) == len(list(loader)) == 4
    it, got = iter(loader), 0
    for _ in range(6):  # the train loop's epoch-boundary pattern
        try:
            next(it)
        except StopIteration:
            it = iter(loader)
            next(it)
        got += 1
    assert got == 6
    # worker processes take a dataset that splits over them (tests/test_torch_parallel_loader.py), and refuse
    # one that does not
    with pytest.raises(TypeError, match="does not support worker splitting"):
        tds.get_frame_dataloader(list(ds), batch_size=4, num_workers=2)


def _packed_oxe(root, dataset="berkeley_cable_routing", vo_key="image"):
    """Packed OXE layout (image and teacher features in one view shard), as
    tests/test_train_loop.py builds it, at small sizes."""
    vdir = os.path.join(root, dataset, vo_key)
    os.makedirs(vdir)
    rng = np.random.RandomState(0)
    for split, n in (("train", 10), ("val", 4)):
        with jwds.ShardWriter(os.path.join(vdir, f"{dataset}-000000-{split}.tar")) as sw:
            for i in range(n):
                key = f"{dataset}_seq{i:06d}_000000"
                sw.write(f"{key}.image", jwds.encode_image_npy(rng.randint(0, 256, (16, 16, 3), np.uint8)))
                for model in ("facebook/dinov2-large", "facebook/sam-vit-huge"):
                    feats = {"embedding": rng.randn(8, 4, 4).astype(np.float32).astype(JBF16)}
                    sw.write(f"{key}.{model.replace('/', '_')}.safetensors", jwds.save_safetensors_np(feats))
    with open(os.path.join(root, dataset, "splits.json"), "w") as f:
        json.dump({"train": 10, "val": 4, "test": 0}, f)


@pytest.mark.parametrize("split", ["train", "val"])
def test_oxe_frame_dataset_equals_jax(tmp_path, split):
    _packed_oxe(str(tmp_path))
    assert toxe.OXE_NAMED_MIXES == joxe.OXE_NAMED_MIXES and toxe.ALL_OXE_DATASETS == joxe.ALL_OXE_DATASETS
    kw = dict(dataset_root=str(tmp_path), dataset_mix=["berkeley_cable_routing"],
              feature_models=["facebook/dinov2-large"], split=split, dataset_ratio=1.0, seed=0)
    jset, jlen = joxe.get_oxe_frame_dataset(**kw)
    tset, tlen = toxe.get_oxe_frame_dataset(**kw)
    assert tlen == jlen
    want = list(joxe.get_oxe_frame_dataloader(jset, batch_size=3, shuffle=True, shuffle_buffer_size=4,
                                              drop_last=False))
    got = list(tds.get_frame_dataloader(tset, batch_size=3, shuffle=True, shuffle_buffer_size=4, drop_last=False))
    assert len(got) == len(want) > 1
    for i, (jb, tb) in enumerate(zip(want, got)):
        _assert_same(jb, tb, f"batch {i}")
