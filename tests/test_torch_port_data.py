"""The port's data path (``dfot_tpu_torch/data``) against the JAX package's.

- ``clips``: every ``idx_remap`` mode and ``stack_external_cond``, equal;
- ``index_shuffle``: grain's compiled permutation (the one its
  ``IndexSampler`` uses) over a range of sizes and seeds, equal; a control
  (grain's pure-Python MD5 variant) differs;
- every on-disk layout on a temporary directory made from a seed: the same
  metadata cache, length, keys, dtypes and values, sample for sample, as
  ``dfot_tpu.data`` (npz, npy, pre-sampled latents, RE10K's ``.pt`` poses
  with its flip augmentation, mp4 through ``cv2``), exact;
- the worker loader against ``GrainDataLoader``: shuffle on and off, two
  seeds, two epochs, ``drop_last`` on and off, 1 and 3 workers, exact.

What the port does not carry raises: the EDM ``AugmentPipe`` (A12) and a
video read without ``cv2``.
"""

import json
import os
import random
import shutil
import sys

import numpy as np
import pytest
import torch

from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu.data import clips as JC
from dfot_tpu.data import loader as JL
from dfot_tpu.data import video_dataset as JVD
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.data import clips as TC
from dfot_tpu_torch.data import index_shuffle as TIS
from dfot_tpu_torch.data import loader as TL
from dfot_tpu_torch.data import video_dataset as TVD
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


RES = 16


# ---------------------------------------------------------------------------
# clip indexing
# ---------------------------------------------------------------------------


def test_clips_match_jax():
    lengths = [20, 3, 17, 40, 8]
    for n in (1, 8, 16):
        assert TC.cumulative_clip_sizes(lengths, n) == JC.cumulative_clip_sizes(lengths, n)
    cum = JC.cumulative_clip_sizes(lengths, 8)
    total = cum[-1]
    modes = [dict(), dict(num_eval_videos=3), dict(num_eval_videos=99),
             dict(subdataset_size=10, current_subepoch=0),
             dict(subdataset_size=10, current_subepoch=5),  # across an epoch boundary
             dict(subdataset_size=total, current_subepoch=2)]
    for kw in modes:
        got, want = TC.build_idx_remap(cum, **kw), JC.build_idx_remap(cum, **kw)
        assert got == want, kw
        for i in range(len(want)):
            assert TC.clip_location(cum, got, i) == JC.clip_location(cum, want, i)
    with pytest.raises(ValueError):
        TC.build_idx_remap(cum, subdataset_size=2 * total + 1, current_subepoch=0)
    cond = np.random.default_rng(0).standard_normal((13, 3)).astype(np.float32)
    for fs in (1, 2, 3):
        np.testing.assert_array_equal(TC.stack_external_cond(cond, fs),
                                      JC.stack_external_cond(cond, fs))
    # control: the default shuffle under another seed
    random.seed(1)
    other = list(range(total))
    random.shuffle(other)
    assert other != TC.build_idx_remap(cum)


# ---------------------------------------------------------------------------
# grain's permutation
# ---------------------------------------------------------------------------


def test_index_shuffle_matches_grain():
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module as G
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_python as GP
    import grain.python as grain

    rng = np.random.default_rng(0)
    # a small max_index cycle-walks through the 16-bit minimum block: few
    # indices there
    sizes = [0, 1, 2, 5, 9, 38, 255, 256, 1000, 65535, 65536, 70001, 2 ** 20 + 3, 2 ** 33 + 5]
    for max_index in sizes:
        for seed in (0, 7, 12345, 2 ** 32 - 1):
            n_idx = 2 if max_index < 256 else 10
            idx = {0, max_index} | {int(i) for i in rng.integers(0, max_index + 1, n_idx)}
            for i in sorted(idx):
                want = G.index_shuffle(i, max_index=max_index, seed=seed, rounds=4)
                assert TIS.index_shuffle(i, max_index, seed) == want, (i, max_index, seed)
    for n in (1, 2, 9, 100, 777):
        for seed in (0, 3):
            for shuffle in (False, True):
                sampler = grain.IndexSampler(num_records=n, shard_options=grain.NoSharding(),
                                             shuffle=shuffle, num_epochs=1, seed=seed)
                want = [sampler[i].record_key for i in range(n)]
                assert list(TIS.EpochOrder(n, shuffle, seed)) == want, (n, seed, shuffle)
    # control: grain's pure-Python variant is another permutation
    assert [GP.index_shuffle(i, 99, 3, 4) for i in range(100)] != \
        [TIS.index_shuffle(i, 99, 3) for i in range(100)]


# ---------------------------------------------------------------------------
# the worker loader against grain's
# ---------------------------------------------------------------------------


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_worker_loader_matches_grain(shuffle, seed):
    """Two epochs of 23 samples in batches of 4 from grain's loader, and
    the port's with 1 and 3 workers, ``drop_last`` on and off: the same
    batches; the workers are processes of their own."""
    ds = TVD.SyntheticVideoDataset(num_videos=23, n_frames=2, resolution=4, cond_dim=3)
    grain_workers = 1 if seed == 0 else 3
    lj = JL.make_loader(ds, 4, shuffle=shuffle, drop_last=False, seed=seed,
                        num_workers=grain_workers)
    assert isinstance(lj, JL.GrainDataLoader)
    want = [list(lj) for _ in range(2)]
    assert len(want[0]) == 6 and want[0][-1]["videos"].shape[0] == 3
    if shuffle:  # a new order every epoch
        assert not np.array_equal(want[0][0]["videos"], want[1][0]["videos"])
    for workers in (1, 3):
        for drop_last in (False, True):
            lt = TL.make_loader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=seed,
                                num_workers=workers)
            try:
                assert isinstance(lt, TL.WorkerDataLoader) and lt.workers == workers
                assert len(lt) == (5 if drop_last else 6)
                for epoch in range(2):
                    got = list(lt)
                    _same_batches(got, want[epoch][:5] if drop_last else want[epoch])
                    if epoch == 0 and workers == 3:
                        pids = {w.pid for w in lt._pool._iterator._workers}
                        assert len(pids) == 3 and os.getpid() not in pids
                assert lt.epoch == 2
            finally:
                lt.close()
    # control: the in-process loader's shuffle is another order
    if shuffle:
        other = list(TL.DataLoader(ds, 4, shuffle=True, seed=seed))
        assert not np.array_equal(other[0]["videos"], want[0][0]["videos"])
    # a process's share: grain's first of two consecutive pieces, shuffled
    # within (tests/test_torch_port_parallel.py holds it to grain's sampler)
    half = TL.make_loader(ds, 4, shuffle=shuffle, seed=seed, num_workers=2, process_shard=(0, 2))
    assert len(half) == len(JL.make_loader(ds, 4, num_workers=2, process_shard=(0, 2)))
    assert sorted(half.epoch_order()) == list(range(len(ds) // 2))


# ---------------------------------------------------------------------------
# on-disk layouts
# ---------------------------------------------------------------------------


def _frames(rng, T, res=RES):
    return rng.integers(0, 256, (T, res, res, 3), dtype=np.uint8)


def _write_mp4(path, video):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    T, H, W, _ = video.shape
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for f in video:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()


def _npz(path, **arrays):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)


LENGTHS = (9, 6, 12)


def make_layout(kind: str, root: str, seed: int = 0):
    """A seeded dataset directory of ``kind``; returns the dataset name and
    the config overrides."""
    rng = np.random.default_rng(seed)
    over = [f"dataset.resolution={RES}", "dataset.max_frames=4",
            "++dataset.num_eval_videos=2"]
    if kind in ("dmlab", "dmlab_latents"):
        for split in ("training", "validation"):
            for i, T in enumerate(LENGTHS):
                _npz(os.path.join(root, split, f"ep{i}", f"v{i}.npz"), video=_frames(rng, T),
                     actions=rng.integers(0, 3, T))
                if kind == "dmlab_latents":
                    lat = os.path.join(f"{root}_latent_{RES}", split, f"v{i}.npy")
                    os.makedirs(os.path.dirname(lat), exist_ok=True)
                    np.save(lat, rng.standard_normal((T, 2, 2, 8)).astype(np.float16))
        if kind == "dmlab_latents":
            over += ["dataset.latent.type=pre_sample", "dataset.latent.num_channels=8"]
        return "dmlab", over
    if kind == "realestate10k":
        for split in ("training", "test"):
            for i, T in enumerate(LENGTHS):
                stem = f"clip{i}"
                _npz(os.path.join(root, f"{split}_{RES}", stem + ".npz"),
                     video=np.moveaxis(_frames(rng, T), -1, 1))
                poses = rng.standard_normal((T, 18)).astype(np.float32)
                os.makedirs(os.path.join(root, f"{split}_poses"), exist_ok=True)
                torch.save(torch.from_numpy(poses),
                           os.path.join(root, f"{split}_poses", stem + ".pt"))
        return "realestate10k", over + ["dataset.max_frames=3", "dataset.frame_skip=2"]
    if kind == "kinetics_600":
        for split in ("training", "validation"):
            for i, T in enumerate(LENGTHS):
                _write_mp4(os.path.join(root, split, f"v{i}.mp4"), _frames(rng, T, 24))
                _write_mp4(os.path.join(root, f"{split}_preprocessed_{RES}_mp4", f"v{i}.mp4"),
                           _frames(rng, T))
        return "kinetics_600", over + ["dataset.max_frames=5"]
    if kind == "minecraft":
        for split in ("training", "validation"):
            for i, T in enumerate(LENGTHS):
                _write_mp4(os.path.join(root, split, f"v{i}.mp4"), _frames(rng, T))
                _npz(os.path.join(root, split, f"v{i}.npz"), actions=rng.integers(0, 4, T))
        return "minecraft", over
    if kind == "cond_ucf_101":
        for split in ("training", "validation"):
            index = []
            for i, T in enumerate(LENGTHS):
                cls = f"Class{i % 2}"
                rel = f"{split}/{cls}/v_{i}.avi"
                index.append({"video_path": "datasets/ucf101/" + rel, "label": i % 2})
                _npz(os.path.join(root, split, f"{cls}_preprocessed_{RES}_npz", f"v_{i}.npz"),
                     video=np.moveaxis(_frames(rng, T), -1, 1))
            with open(os.path.join(root, f"{split}03.json"), "w") as f:
                json.dump(index, f)
        return "cond_ucf_101", over
    if kind == "bair":
        for name in ("train", "test"):
            for i, T in enumerate(LENGTHS):
                _write_mp4(os.path.join(root, "softmotion30_44k", name, "video_aux1", f"traj{i}",
                                        "v.mp4"), _frames(rng, T))
        # the recipes train BAIR and Taichi on pre-sampled latents: pixels here
        return "bair", over + ["dataset.external_cond_dim=0", "dataset.latent.enabled=false"]
    if kind == "taichi_npy":
        for split in ("training", "validation"):
            os.makedirs(os.path.join(root, split), exist_ok=True)
            for i, T in enumerate(LENGTHS):
                np.save(os.path.join(root, split, f"v{i}.npy"), _frames(rng, T))
        return "taichi", over + ["dataset.latent.enabled=false"]
    if kind == "taichi":
        for split in ("training", "validation"):
            for i, T in enumerate(LENGTHS):
                _write_mp4(os.path.join(root, split, f"v{i}.mp4"), _frames(rng, T, 20))
        return "taichi", over + ["dataset.latent.enabled=false"]
    raise ValueError(kind)


def _dataset_cfgs(name, root, over):
    argv = ["+name=t", f"dataset={name}", "algorithm=dfot_video",
            "experiment=video_generation", f"dataset.save_dir={root}"] + over
    return load_config(argv).dataset, jax_load_config(argv).dataset


LAYOUT_KINDS = ["dmlab", "dmlab_latents", "realestate10k", "kinetics_600", "minecraft",
                "cond_ucf_101", "bair", "taichi_npy", "taichi"]


@pytest.mark.parametrize("kind", LAYOUT_KINDS)
def test_layouts_match_jax(tmp_path, kind):
    root = str(tmp_path / "data")
    name, over = make_layout(kind, root)
    tcfg, jcfg = _dataset_cfgs(name, root, over)
    for split in ("training", "validation"):
        if kind == "cond_ucf_101" and split == "training":
            # the recipe's training set augments with the EDM AugmentPipe
            ds = TVD.build_dataset(tcfg, split)
            with pytest.raises(NotImplementedError, match="A12"):
                ds[0]
            continue
        meta_dir = os.path.join(root, "metadata")
        shutil.rmtree(meta_dir, ignore_errors=True)
        port = TVD.build_dataset(tcfg, split)
        caches = sorted(os.listdir(meta_dir)) if os.path.isdir(meta_dir) else []
        port_cache = [dict(np.load(os.path.join(meta_dir, c))) for c in caches]
        shutil.rmtree(meta_dir, ignore_errors=True)  # the JAX package scans anew
        jax_ds = JVD.build_dataset(jcfg, split)
        assert type(port).__name__ == type(jax_ds).__name__ != "SyntheticVideoDataset"
        for c, got in zip(caches, port_cache):  # UCF-101's json index writes none
            want = dict(np.load(os.path.join(meta_dir, c)))
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert len(port) == len(jax_ds) > 0
        assert port.idx_remap == jax_ds.idx_remap
        assert [(m["path"], m["length"]) for m in port.metadata] == \
            [(m["path"], m["length"]) for m in jax_ds.metadata]
        for i in range(len(port)):
            got, want = port[i], jax_ds[i]
            assert sorted(got) == sorted(want), i
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (i, k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{i} {k}")
        sample = port[0]
        if kind == "dmlab_latents" and split == "training":
            assert sorted(sample) == ["conds", "latents", "nonterminal"]
        elif kind == "dmlab":
            assert sample["conds"].shape == (4, 3) and sample["videos"].shape == (4, RES, RES, 3)
        elif kind == "realestate10k":
            assert sample["conds"].shape == (3, 16)
        elif kind == "cond_ucf_101":
            assert sample["conds"].shape == () and sample["conds"].dtype == np.int32
        if kind == "realestate10k" and split == "training":
            # the recipe's flip, reversal and back-and-forth changed some
            # clips' poses and left others as stored
            changed = [not np.array_equal(port[i]["conds"][:, 2], _stored_cx(port, i))
                       for i in range(len(port))]
            assert any(changed) and not all(changed)


def _stored_cx(ds, i):
    """The principal point cx of clip ``i`` as stored (before augmentation)."""
    video_idx, start = TC.clip_location(ds.cumulative_sizes, ds.idx_remap, i)
    meta = ds.metadata[video_idx]
    end = min(start + ds.n_frames, meta["length"])
    raw = ds._load_cond(meta, start, end)
    pad = ds.n_frames - len(raw)
    raw = np.pad(raw, [(0, pad), (0, 0)])
    return raw[:: ds.frame_skip][:, 2]


def test_video_read_without_cv2_raises(tmp_path, monkeypatch):
    """A video file read where ``cv2`` is missing raises ``ImportError``
    naming it; ``.npz`` reads need no ``cv2``."""
    root = str(tmp_path / "data")
    name, over = make_layout("taichi", root)
    tcfg, _ = _dataset_cfgs(name, root, over + ["++dataset.metadata_timestamps=false"])
    ds = TVD.build_dataset(tcfg, "training")  # the metadata scan, with cv2
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        ds[0]
    root2 = str(tmp_path / "npz")
    name2, over2 = make_layout("dmlab", root2)
    tcfg2, _ = _dataset_cfgs(name2, root2, over2)
    assert TVD.build_dataset(tcfg2, "training")[0]["videos"].shape == (4, RES, RES, 3)
