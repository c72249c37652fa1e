"""The port's worker-process loader (theia_tpu_torch/data/parallel_loader.py)
against the JAX package's theia_tpu/data/parallel_loader.py on the same
shards: the same worker splits, bit-equal samples and batches when ordered,
the same sample set when not; both transports, the statvfs fallback, dying
workers, and the unordered merge's repaired fault.

Workers run in the "fork" context (small synthetic shards; a fork costs
~0.1 s where a forkserver child imports torch), except one case that runs
the default "forkserver".
"""

import json
import os
import queue
import sys
import time
from multiprocessing import shared_memory

import ml_dtypes
import numpy as np
import pytest
import torch

from theia_tpu.data import dataset as jds
from theia_tpu.data import parallel_loader as jpl
from theia_tpu.data import synthetic as jsyn
from theia_tpu.data import webdataset as jwds
from theia_tpu_torch.data import dataset as tds
from theia_tpu_torch.data import oxe as toxe
from theia_tpu_torch.data import parallel_loader as tpl

TEACHERS = {"teacher/a": (8, 4, 4), "teacher/b": (4, 8, 8)}
JBF16 = np.dtype(ml_dtypes.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == JBF16 else x


def _assert_same(jtree, ttree, where="sample"):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), where
        for k in jtree:
            _assert_same(jtree[k], ttree[k], f"{where}.{k}")
        return
    assert isinstance(ttree, torch.Tensor), where
    want, got = _bits(jtree), _bits(ttree)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _key(sample):
    """A sample's identity: its image bytes."""
    image = sample["image"]
    return bytes(image.numpy() if isinstance(image, torch.Tensor) else np.asarray(image))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Two datasets of JAX-written shards: 5 and 4 train shards (uneven over 2 and 3 workers)."""
    root = str(tmp_path_factory.mktemp("shards"))
    for seed, (name, n) in enumerate((("imagenet", 18), ("ego4d", 13))):
        jsyn.generate_synthetic_dataset(root, dataset=name, feature_models=TEACHERS, n_train=n, n_val=3,
                                        samples_per_shard=4, image_size=16, seed=seed)
    return root


def _dataset(pkg, root, feature_norm="device"):
    ds, _ = pkg.get_image_video_dataset(dataset_root=root, feature_models=list(TEACHERS),
                                        dataset_mix=["imagenet", "ego4d"], split="train", seed=3,
                                        feature_norm=feature_norm)
    return ds


def _round_robin(parts):
    """The ordered merge's order, iterated in this process: one sample from
    each part in turn, a part dropping out when it ends."""
    iters, out = [iter(p) for p in parts], []
    while iters:
        live = []
        for it in iters:
            try:
                out.append(next(it))
                live.append(it)
            except StopIteration:
                pass
        iters = live
    return out


@pytest.fixture
def fork_main(monkeypatch):
    """No ``__main__`` file: both packages' loaders fall back to "fork"
    (their stdin rule), whatever runs the tests."""
    monkeypatch.setattr(sys.modules["__main__"], "__file__", None, raising=False)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_split_partitions_equal_jax(root, n):
    jparts, tparts = _dataset(jds, root).split(n), _dataset(tds, root).split(n)
    assert len(jparts) == len(tparts) == n
    for w, (jmix, tmix) in enumerate(zip(jparts, tparts)):
        assert tmix.seed == jmix.seed == 3 * 1000003 + w
        assert tmix.probs == jmix.probs and tmix.stopping_strategy == jmix.stopping_strategy
        for jm, tm in zip(jmix.datasets, tmix.datasets, strict=True):
            assert tm.image_shards == jm.image_shards
            assert tm.feature_shards == jm.feature_shards
            assert tm.raw_features == jm.raw_features
    every = [s for part in tparts for m in part.datasets for s in m.image_shards]
    assert sorted(every) == sorted(s for m in _dataset(tds, root).datasets for s in m.image_shards)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("workers", [1, 2, 3])
def test_worker_samples_equal_jax(root, workers, ordered):
    want = list(jpl.ParallelSampleSource(_dataset(jds, root), workers, mp_context="fork", ordered=ordered))
    got = list(tpl.ParallelSampleSource(_dataset(tds, root), workers, mp_context="fork", ordered=ordered))
    assert len(got) == len(want) == 31
    if not ordered:  # the same set of samples, in no fixed order
        want = sorted(want, key=_key)
        got = sorted(got, key=_key)
    for i, (j, t) in enumerate(zip(want, got)):
        _assert_same(j, t, f"sample {i}")


@pytest.mark.parametrize("feature_norm", ["device", True])
def test_shm_transport_equals_queue_transport(root, feature_norm):
    ds = _dataset(tds, root, feature_norm)
    shm = tpl.ParallelSampleSource(ds, 2, mp_context="fork", transport="shm", queue_depth=2)
    got = list(shm)
    assert shm.transport_used == "shm"
    want = list(tpl.ParallelSampleSource(ds, 2, mp_context="fork", transport="queue"))
    inproc = _round_robin(ds.split(2))
    assert len(got) == len(want) == len(inproc) == 31
    for i, (a, b, c) in enumerate(zip(got, want, inproc)):
        _assert_same(b, a, f"sample {i}")
        _assert_same(c, a, f"sample {i}")


def test_forkserver_default_context(root, tmp_path, monkeypatch):
    """The default context with a ``__main__`` file: the parts pickle and the workers rebuild them."""
    main = tmp_path / "main.py"
    main.write_text("")
    monkeypatch.setattr(sys.modules["__main__"], "__file__", str(main), raising=False)
    ds = _dataset(tds, root)
    src = tpl.ParallelSampleSource(ds, 2)
    assert src.mp_context == "forkserver"
    got = list(src)
    want = list(tpl.ParallelSampleSource(ds, 2, mp_context="fork"))
    assert len(got) == 31
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_same(b, a, f"sample {i}")


class _Samples:
    """A splittable dataset of given samples (round-robin over workers),
    each worker sleeping ``delays[w]`` seconds first and exiting with
    ``exit_codes[w]`` (by ``os._exit``, so without its sentinel) after its samples."""

    def __init__(self, samples, delays=None, exit_codes=None, worker=None):
        self.samples, self.delays, self.exit_codes, self.worker = samples, delays or {}, exit_codes or {}, worker

    def split(self, n):
        return [type(self)(self.samples[w::n], self.delays, self.exit_codes, w) for w in range(n)]

    def __iter__(self):
        time.sleep(self.delays.get(self.worker, 0))
        yield from self.samples
        if self.worker in self.exit_codes:
            os._exit(self.exit_codes[self.worker])


def _odd_samples():
    return [{"image": torch.full((2, 3), i, dtype=torch.uint8), "scalar": torch.tensor(i + 0.5),
             "nested": {"count": torch.tensor(i, dtype=torch.int32), "bf": torch.randn(3).to(torch.bfloat16),
                        "empty": torch.zeros(0, 4)},
             "name": f"sample-{i}", "index": i} for i in range(5)]


@pytest.mark.parametrize("transport", ["shm", "queue"])
def test_zero_d_and_non_tensor_leaves_survive(transport):
    samples = _odd_samples()
    got = list(tpl.ParallelSampleSource(_Samples(samples), 2, mp_context="fork", transport=transport))
    assert len(got) == 5
    for want, s in zip(samples, got):
        assert s["scalar"].shape == () and s["nested"]["count"].shape == () and s["nested"]["count"].dtype == torch.int32
        assert s["nested"]["empty"].shape == (0, 4)
        assert s["name"] == want["name"] and s["index"] == want["index"]
        for a, b in ((s["image"], want["image"]), (s["scalar"], want["scalar"]),
                     (s["nested"]["bf"], want["nested"]["bf"]), (s["nested"]["count"], want["nested"]["count"])):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_oversized_sample_takes_the_pickle_path():
    """A sample past ``slot_bytes`` goes through the queue; one that fits takes a slot."""
    small = {"image": torch.arange(16, dtype=torch.uint8), "x": torch.tensor(2.0)}
    large = {"image": torch.arange(2000).to(torch.uint8), "x": torch.tensor(3.0)}
    shm = shared_memory.SharedMemory(create=True, size=2 * 1024)
    try:
        q, free_q = queue.Queue(), queue.Queue()
        for s in range(2):
            free_q.put(s)
        tpl._worker_main([small, large, small], q, 4, shm.name, 1024, free_q)
        msgs = [q.get_nowait() for _ in range(4)]
        assert [m[0] for m in msgs] == ["shm", "sample", "shm", "__done__"] and msgs[3][1] == 4
        assert torch.equal(tpl._unpack_inline(msgs[1][1])["image"], large["image"])
        assert msgs[0][1][0] == 4 and {msgs[0][1][1], msgs[2][1][1]} == {0, 1}  # worker index, both slots used
    finally:
        shm.close()
        shm.unlink()
    got = list(tpl.ParallelSampleSource(_Samples([small, large, small, large]), 2, mp_context="fork",
                                        slot_bytes=1024, queue_depth=1))
    assert [torch.equal(g["image"], w["image"]) for g, w in zip(got, [small, large, small, large])] == [True] * 4


def test_statvfs_guard_falls_back_to_the_queue(root, monkeypatch):
    monkeypatch.setattr(tpl, "_shm_free_bytes", lambda: 1 << 20)
    src = tpl.ParallelSampleSource(_dataset(tds, root), 2, mp_context="fork")
    with pytest.warns(UserWarning, match="fall back to the pickle/queue transport"):
        got = list(src)
    assert src.transport_used == "queue" and len(got) == 31


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("code", [3, 0])
def test_dead_worker_raises(monkeypatch, ordered, code):
    """A worker that exits without its sentinel (crashed, or exit code 0) raises, never hangs."""
    monkeypatch.setattr(tpl, "WORKER_POLL_S", 0.2)
    samples = [{"image": torch.full((2,), i, dtype=torch.uint8)} for i in range(6)]
    src = tpl.ParallelSampleSource(_Samples(samples, exit_codes={1: code}), 2, mp_context="fork", ordered=ordered)
    with pytest.raises(RuntimeError, match=rf"loader worker\(s\) \[1\] died \(exit codes \[{code}\]\)"):
        list(src)


def test_worker_error_is_reported():
    class Boom(_Samples):
        def __iter__(self):
            raise ValueError("bad shard")
            yield

    with pytest.raises(RuntimeError, match="(?s)loader worker 0 failed:.*bad shard"):
        list(tpl.ParallelSampleSource(Boom([]), 1, mp_context="fork"))


@pytest.mark.parametrize("transport", ["shm", "queue"])
def test_unordered_merge_outlives_a_finished_worker(monkeypatch, transport):
    """The repaired fault: worker 0 sends its sentinel and exits 0 at once,
    worker 1 is silent for 15 polls before its samples. The JAX merge polls
    worker 0 too and calls it dead; the port yields every sample."""
    monkeypatch.setattr(tpl, "WORKER_POLL_S", 0.1)
    samples = [{"image": torch.full((2,), i, dtype=torch.uint8)} for i in range(5)]
    src = tpl.ParallelSampleSource(_Samples(samples, delays={1: 1.5}), 2, mp_context="fork", ordered=False,
                                   transport=transport)
    got = sorted(int(s["image"][0]) for s in src)
    assert got == [0, 1, 2, 3, 4]


def _batches(pkg, ds, workers):
    loader = pkg.get_frame_dataloader(ds, batch_size=3, shuffle=True, shuffle_buffer_size=5, seed=7,
                                      num_workers=workers)
    return list(loader)


@pytest.mark.usefixtures("fork_main")
@pytest.mark.parametrize("feature_norm", ["device", True])
def test_frame_dataloader_with_workers_equals_jax(root, feature_norm):
    want = _batches(jds, _dataset(jds, root, feature_norm), 2)
    got = _batches(tds, _dataset(tds, root, feature_norm), 2)
    assert len(got) == len(want) == 10
    for i, (jb, tb) in enumerate(zip(want, got)):
        _assert_same(jb, tb, f"batch {i}")
    assert got[0]["image"].dtype == torch.uint8 and got[0]["image"].shape == (3, 16, 16, 3)


def _packed_oxe(root, dataset="berkeley_cable_routing", vo_key="image"):
    """Packed OXE layout (image and teacher features in one view shard) at
    small sizes, 3 train shards so that each of 2 workers reads one or two."""
    vdir = os.path.join(root, dataset, vo_key)
    os.makedirs(vdir)
    rng = np.random.RandomState(0)
    for split, shards in (("train", 3), ("val", 1)):
        for s in range(shards):
            with jwds.ShardWriter(os.path.join(vdir, f"{dataset}-{s:06d}-{split}.tar")) as sw:
                for i in range(4):
                    key = f"{dataset}_seq{s:03d}{i:03d}_000000"
                    sw.write(f"{key}.image", jwds.encode_image_npy(rng.randint(0, 256, (16, 16, 3), np.uint8)))
                    feats = {"embedding": rng.randn(8, 4, 4).astype(np.float32).astype(JBF16)}
                    sw.write(f"{key}.facebook_dinov2-large.safetensors", jwds.save_safetensors_np(feats))
    with open(os.path.join(root, dataset, "splits.json"), "w") as f:
        json.dump({"train": 12, "val": 4, "test": 0}, f)


@pytest.mark.usefixtures("fork_main")
def test_oxe_dataloader_with_workers_equals_jax(tmp_path):
    from theia_tpu.data import oxe as joxe

    _packed_oxe(str(tmp_path))
    kw = dict(dataset_root=str(tmp_path), dataset_mix=["berkeley_cable_routing"],
              feature_models=["facebook/dinov2-large"], split="train", dataset_ratio=1.0, seed=0)
    want = _batches(jds, joxe.get_oxe_frame_dataset(**kw)[0], 2)
    got = _batches(tds, toxe.get_oxe_frame_dataset(**kw)[0], 2)
    assert len(got) == len(want) == 4
    for i, (jb, tb) in enumerate(zip(want, got)):
        _assert_same(jb, tb, f"batch {i}")


def test_measure_loader_throughput(root):
    loader = tds.get_frame_dataloader(_dataset(tds, root), batch_size=4)
    got = tpl.measure_loader_throughput(loader, max_batches=3)
    assert got["batches"] == 3 and got["images_per_sec"] > 0 and got["mb_per_sec"] > 0
