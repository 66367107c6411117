"""The latent path through the port's entry point against the JAX package's.

``run(argv, device="cpu")`` on the DMLab recipe (``dataset=dmlab
algorithm=dfot_video experiment=video_generation``: online DC-AE tokens,
sigmoid loss weighting) at a reduced depth and width (a DiT3D of hidden 64,
depth 2; a DC-AE of widths 16-32 and one block a level; 32 px videos, 4
frames a clip) on a seeded DMLab-layout directory, against ``main.run``:

- training, 2 steps at batch 2 with 2 loader workers (the JAX side loads
  in process: its grain workers cannot unpickle its ``Config``), warm-started from the
  same upstream ``.ckpt`` and the same DC-AE ``.pth``, the noise levels and
  noise pinned on both sides (as ``tests/test_torch_port_train_cli.py``
  does), fp32: the first batch's tokens (the online encoding) within 1e-4
  relative (L2) and each logged loss within 1e-4 relative; a mid-run
  validation decoding through the DC-AE; the port's run validated after
  (``tasks=[training,validation]``), its metrics in ``metrics.jsonl``;
- ``experiment=video_latent_preprocessing algorithm=dc_ae_preprocessor``:
  every ``.npy`` latent and both statistics files equal to the JAX
  experiment's within 1e-4 relative (fp16 files; the two encoders' fp32
  sums round apart on a few elements), the files a second run finds
  skipped;
- a ``dataset.latent.type=pre_sample`` step from those latents: its first
  batch equal to the online encoding of the same clips within the fp16
  rounding (2^-10 relative per element).

Controls: the port's own noise levels miss the first loss; ``pre_sample``
without latents on disk raises ``FileNotFoundError``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.experiments import video_generation as JVG
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.experiments import video_generation as TVG
from dfot_tpu_torch.utils.weights import dcae_state_dict_from_flax, init_random_weights
from dfot_tpu.vae import dc_ae as JDC

from test_torch_port_train_cli import _fp32, _lines, _pin_draws, _step_metrics
from test_torch_port_vae import randomize, rel_err

RES, FRAMES, LENGTHS = 32, 4, (7, 9, 6)
TOKEN_RTOL = LOSS_RTOL = FILE_RTOL = 1e-4
FP16_REL = 2.0 ** -10
DCAE_WIDTHS = dict(encoder_block_out_channels=[16, 32, 32, 32],
                   decoder_block_out_channels=[16, 32, 32, 32],
                   encoder_layers_per_block=[0, 1, 1, 1], decoder_layers_per_block=[0, 1, 1, 1],
                   attention_head_dim=8)


def _list(v):
    return "[" + ",".join(str(x) for x in v) + "]"


def dcae_args(prefix: str, pth: str):
    return [f"++{prefix}.{k}={_list(v) if isinstance(v, list) else v}"
            for k, v in DCAE_WIDTHS.items()] + [f"{prefix}.pretrained_path={pth}"]


def base_argv(root: str, pth: str):
    return [
        "+name=dmlab", "dataset=dmlab", "algorithm=dfot_video", "experiment=video_generation",
        f"dataset.save_dir={root}", f"dataset.resolution={RES}",
        f"dataset.max_frames={FRAMES}", "dataset.context_length=1",
        "++algorithm.backbone.hidden_size=64", "++algorithm.backbone.depth=2",
        "++algorithm.backbone.num_heads=2", "++algorithm.backbone.external_cond_dropout=0.0",
        "algorithm.diffusion.sampling_timesteps=3",
        # the composed list's frozen networks and its 2048-wide matrix square
        # root would cost both packages' runs about 20 s more each; the
        # composed list runs in test_torch_port_cli.py
        "++algorithm.logging.metrics=[mse,ssim,psnr]", "++algorithm.logging.max_num_videos=2",
    ] + dcae_args("algorithm.vae", pth)


def train_argv(root, pth, ckpt):
    return base_argv(root, pth) + [
        "experiment.tasks=[training]", "experiment.training.batch_size=2",
        "experiment.training.max_steps=2", "experiment.training.lr=1e-3",
        "algorithm.lr_scheduler.num_warmup_steps=1", "experiment.ema.decay=0.5",
        "++algorithm.logging.loss_freq=1", "experiment.training.data.num_workers=2",
        "experiment.validation.batch_size=2", "experiment.validation.limit_batch=1",
        "experiment.validation.val_every_n_step=2", f"load={ckpt}",
    ]


def make_dmlab(root: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    for split in ("training", "validation"):
        for i, T in enumerate(LENGTHS):
            d = os.path.join(root, split, f"ep{i}")
            os.makedirs(d, exist_ok=True)
            t = np.arange(T)[:, None, None, None]
            base = rng.integers(0, 256, (1, RES, RES, 3))
            video = ((base + 16 * t) % 256).astype(np.uint8)  # a drifting frame
            np.savez(os.path.join(d, f"v{i}.npz"), video=video, actions=rng.integers(0, 3, T))


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """A DMLab-layout directory, the DC-AE ``.pth`` (seeded random JAX
    parameters in the port's diffusers names) and the DiT's ``.ckpt``."""
    tmp = tmp_path_factory.mktemp("latent")
    root = str(tmp / "dmlab")
    make_dmlab(root)
    cfg = JDC.DCAEConfig.from_config({**DCAE_WIDTHS, "latent_channels": 32})
    jm = JDC.DCAE(cfg)
    params = randomize(jm.init(jax.random.PRNGKey(0), np.zeros((1, RES, RES, 3), np.float32))[
        "params"], 11)
    pth = str(tmp / "dcae.pth")
    torch.save(dcae_state_dict_from_flax(params), pth)
    algo = build_algorithm(load_config(base_argv(root, pth)), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(1))
    ckpt = str(tmp / "dit.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    return tmp, root, pth, ckpt


def _capture_tokens(monkeypatch, cls, store):
    real = cls._tokenize_batch

    def capture(self, batch):
        out = real(self, batch)
        if not store:
            store.append(np.asarray(out["xs"].cpu() if hasattr(out["xs"], "cpu") else out["xs"]))
        return out

    monkeypatch.setattr(cls, "_tokenize_batch", capture)


def test_latent_training_matches_main(monkeypatch, fixture_files):
    tmp, root, pth, ckpt = fixture_files
    _pin_draws(monkeypatch)
    _fp32(monkeypatch)
    got_xs, want_xs = [], []
    _capture_tokens(monkeypatch, TVG.VideoGenerationExperiment, got_xs)
    _capture_tokens(monkeypatch, JVG.VideoGenerationExperiment, want_xs)
    argv = train_argv(root, pth, ckpt)
    exp = run(argv + [f"output_dir={tmp / 'port'}", "experiment.tasks=[training,validation]"],
              device="cpu")
    # the JAX package's grain workers cannot unpickle its Config (they
    # recurse in ``Config.__getattr__``): its loader runs in process there,
    # in the same (unshuffled) order
    jax_main.run(argv + [f"output_dir={tmp / 'jax'}", "experiment.training.data.num_workers=0"])
    assert got_xs[0].shape == (2, FRAMES, RES // 8, RES // 8, 32)
    assert rel_err(got_xs[0], want_xs[0]) < TOKEN_RTOL
    got, want = _step_metrics(tmp / "port"), _step_metrics(tmp / "jax")
    assert sorted(got) == sorted(want) == [1, 2]
    for step in want:
        assert np.isfinite(got[step][0]) and got[step][0] == pytest.approx(want[step][0],
                                                                           rel=LOSS_RTOL), step
    assert exp.algo.is_latent and exp._codec.pretrained and exp.state.step == 2
    lines = _lines(tmp / "port")
    assert any("validation/loss" in x for x in lines)  # the mid-run validation
    metrics = {k: v for x in lines for k, v in x.items() if k.startswith("validation/prediction")}
    assert sorted(metrics) == [f"validation/prediction/{m}" for m in ("mse", "psnr", "ssim")]
    assert all(np.isfinite(v) for v in metrics.values())
    videos = exp.last_videos  # decoded to pixels, the ground truth the batch's
    assert videos["prediction"].shape == (2, FRAMES, RES, RES, 3)
    assert float(videos["prediction"].min()) >= 0 and float(videos["prediction"].max()) <= 1
    gifs = os.listdir(os.path.join(exp.output_dir, "videos"))
    assert "denoising_vis_step2.gif" in gifs or not gifs  # GIFs need PIL

    # control: the port's own noise levels miss the first loss
    monkeypatch.undo()
    _pin_draws(monkeypatch, port=False)
    _fp32(monkeypatch)
    run(argv + [f"output_dir={tmp / 'control'}", "experiment.training.max_steps=1",
                "experiment.training.data.num_workers=0"], device="cpu")
    control = _step_metrics(tmp / "control")
    assert abs(control[1][0] / want[1][0] - 1) > LOSS_RTOL * 10


def _preprocess_argv(root, pth, out):
    return ["+name=pre", "dataset=dmlab", "algorithm=dc_ae_preprocessor",
            "experiment=video_latent_preprocessing", f"dataset.save_dir={root}",
            f"dataset.resolution={RES}", f"dataset.max_frames={FRAMES}",
            f"output_dir={out}"] + dcae_args("algorithm", pth)


def test_preprocessing_then_pre_sample(monkeypatch, fixture_files):
    tmp, root, pth, ckpt = fixture_files
    jroot = str(tmp / "dmlab_jax")
    shutil.copytree(root, jroot, ignore=shutil.ignore_patterns("metadata"))
    run(_preprocess_argv(root, pth, tmp / "pre_port"), device="cpu")
    jax_main.run(_preprocess_argv(jroot, pth, tmp / "pre_jax"))
    for split in ("training", "validation"):
        tdir, jdir = f"{root}_latent_{RES}/{split}", f"{jroot}_latent_{RES}/{split}"
        files = sorted(os.listdir(jdir))
        assert sorted(os.listdir(tdir)) == files
        assert files == sorted([f"v{i}.npy" for i in range(3)] + ["data_mean.npy",
                                                                    "data_std.npy"])
        for f in files:
            a, b = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert rel_err(a, b) < FILE_RTOL, f
        assert np.load(os.path.join(tdir, "v1.npy")).shape == (LENGTHS[1], RES // 8, RES // 8, 32)
    # a second run skips the files it finds
    stamp = os.path.getmtime(f"{root}_latent_{RES}/training/v0.npy")
    again = run(_preprocess_argv(root, pth, tmp / "pre_again"), device="cpu")
    assert os.path.getmtime(f"{root}_latent_{RES}/training/v0.npy") == stamp
    assert again.pretrained

    # the recipe trained from the latents on disk
    seen = {}
    _pin_draws(monkeypatch)
    for kind in ("online", "pre_sample"):
        store = seen.setdefault(kind, [])
        with monkeypatch.context() as mp:
            _capture_tokens(mp, TVG.VideoGenerationExperiment, store)
            argv = train_argv(root, pth, ckpt) + [
                f"dataset.latent.type={kind}", "experiment.training.max_steps=1",
                "experiment.validation.val_every_n_step=0", f"output_dir={tmp / kind}"]
            exp = run(argv, device="cpu")
        assert exp.state.step == 1 and np.isfinite(_step_metrics(tmp / kind)[1][0])
    online, pre = seen["online"][0], seen["pre_sample"][0]
    np.testing.assert_allclose(pre, online, rtol=FP16_REL, atol=FP16_REL * np.abs(online).max())
    assert not np.array_equal(pre, online)  # it read the fp16 files

    # control: pre_sample without latents on disk
    empty = str(tmp / "no_latents")
    shutil.copytree(root, empty, ignore=shutil.ignore_patterns("metadata"))
    argv = train_argv(empty, pth, ckpt) + ["dataset.latent.type=pre_sample",
                                           "experiment.training.max_steps=1",
                                           "experiment.training.data.num_workers=0",
                                           f"output_dir={tmp / 'missing'}"]
    with pytest.raises(FileNotFoundError):
        run(argv, device="cpu")
