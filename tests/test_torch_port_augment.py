"""The EDM ``AugmentPipe`` of the port (``dfot_tpu_torch/data/augmentation.py``,
A12) against the JAX package's (``dfot_tpu/data/augmentation.py``).

Held to the JAX pipe only: the upstream pipe's parity tests
(``tests/test_edm_augment.py::test_parity_*``) fail in setup on every host
without the upstream checkout (ROADMAP.md C3), so the port reaches upstream
only where the JAX pipe does.

- ``sample``: the same ``AugmentParams`` as JAX's from the same
  ``np.random.RandomState``, for the UCF-101 recipe's multipliers, every op
  on, and ``p`` = 0 (the draws in JAX's order).
- ``apply``: within 1e-5 absolute of JAX's for each transform family of
  ``tests/test_edm_augment.py:68-161`` (blits, reflect-wrapped integer
  translation, isotropic scale, fractional rotation, anisotropy, fractional
  translation, the colour matrix, the UCF-101 recipe at once, one channel),
  and ``__call__`` on clips.
- The UCF-101 recipe (``dataset=ucf_101 algorithm=dfot_video
  experiment=video_generation``: online DC-AE tokens, the EDM pipe on every
  training clip) through ``run(argv)`` against ``main.run`` on a seeded
  UCF-101-layout directory, cut to 32 px, 4 frames, batch 2, a DiT3D of
  hidden 64 and a narrow DC-AE: the first batch's tokens within 1e-4
  relative and each logged loss within 1e-4 relative (fp32, draws pinned as
  ``tests/test_torch_port_latent_cli.py`` pins them); a control run without
  ``augmentation`` trains on other tokens.
"""

import json
import os

import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.data.augmentation import AugmentParams as JParams
from dfot_tpu.data.augmentation import AugmentPipe as JPipe
from dfot_tpu.experiments import video_generation as JVG
from dfot_tpu.vae import dc_ae as JDC
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.data.augmentation import AugmentParams, AugmentPipe
from dfot_tpu_torch.experiments import video_generation as TVG
from dfot_tpu_torch.utils.weights import dcae_state_dict_from_flax, init_random_weights

from test_torch_port_latent_cli import DCAE_WIDTHS, _capture_tokens, dcae_args
from test_torch_port_train_cli import _fp32, _pin_draws, _step_metrics
from test_torch_port_vae import init_shapes, randomize, rel_err
from torch_port_helpers import one_thread

APPLY_ATOL = 1e-5
LOSS_RTOL = TOKEN_RTOL = 1e-4

UCF = dict(xflip=0.5, yflip=0.5, rotate_int=0.5, translate_int=0.5, scale=0.3, contrast=0.125,
           brightness=0.3, lumaflip=0.5, hue=0.3, saturation=0.3)
EVERY_OP = dict(xflip=1, yflip=1, rotate_int=1, translate_int=1, scale=1, rotate_frac=1,
                aniso=1, translate_frac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                saturation=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("kwargs", [dict(p=1.0, **UCF), dict(p=0.6, **EVERY_OP),
                                    dict(p=0.0, **EVERY_OP)], ids=["ucf_101", "every_op", "off"])
def test_sample_matches_jax(kwargs):
    """The same draws in the same order: equal parameter sets over many
    clips, and the generator left in the same state."""
    got_rng, want_rng = np.random.RandomState(7), np.random.RandomState(7)
    port, jax_pipe = AugmentPipe(**kwargs), JPipe(**kwargs)
    for _ in range(50):
        got, want = port.sample(got_rng), jax_pipe.sample(want_rng)
        assert got.__dict__ == want.__dict__
    assert got_rng.randint(2 ** 31) == want_rng.randint(2 ** 31)


FAMILIES = {
    "blits": (dict(xflip=1, yflip=1, rotate_int=1, translate_int=1),
              dict(xflip=1, yflip=1, rotate_int=3, translate_int=(1, 1))),
    "int_translation_reflection": (dict(translate_int=1, translate_int_max=0.25),
                                   dict(translate_int=(1, 0))),
    "isotropic_scale": (dict(scale=1), dict(scale=0.7)),
    "fractional_rotation": (dict(rotate_frac=1), dict(rotate_frac=(0.3 * 2 - 1) * np.pi)),
    "aniso": (dict(aniso=1), dict(aniso=0.5, aniso_angle=(0.8 * 2 - 1) * np.pi)),
    "fractional_translation": (dict(translate_frac=1), dict(translate_frac=(0.3, -0.6))),
    "color": (dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
              dict(brightness=1.2, contrast=-0.8, lumaflip=1, hue=(0.25 * 2 - 1) * np.pi,
                   saturation=0.9)),
    "combined_ucf_recipe": (UCF, dict(xflip=1, yflip=1, rotate_int=2, translate_int=(1, 1),
                                      scale=-0.4, brightness=0.6, contrast=0.5, lumaflip=1,
                                      hue=(0.9 * 2 - 1) * np.pi, saturation=-1.1)),
    "grayscale_color_path": (dict(brightness=1, saturation=1),
                             dict(brightness=0.8, saturation=1.3)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_apply_matches_jax(family):
    kwargs, params = FAMILIES[family]
    channels = 1 if family == "grayscale_color_path" else 3
    images = np.random.default_rng(0).random((3, channels, 32, 32)).astype(np.float32)
    got = AugmentPipe(p=1.0, **kwargs).apply(images, AugmentParams(**params))
    want = JPipe(p=1.0, **kwargs).apply(images, JParams(**params))
    assert got.shape == want.shape == images.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=APPLY_ATOL)
    assert np.abs(got - images).max() > 1e-2  # the transform did something


@pytest.mark.parametrize("kwargs", [dict(p=1.0, **UCF), dict(p=1.0, **EVERY_OP), dict(p=1.0)],
                         ids=["ucf_101", "every_op", "identity"])
def test_call_matches_jax(kwargs):
    """A channel-last (T, H, W, C) clip: one parameter set for all frames."""
    for seed in range(4):
        video = np.random.default_rng(seed).random((4, 24, 24, 3)).astype(np.float32)
        got = AugmentPipe(**kwargs)(video, np.random.RandomState(seed))
        want = JPipe(**kwargs)(video, np.random.RandomState(seed))
        assert got.shape == video.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=APPLY_ATOL)


# ---------------------------------------------------------------------------
# the UCF-101 recipe through python -m dfot_tpu_torch
# ---------------------------------------------------------------------------

RES, FRAMES, LENGTHS = 32, 4, (7, 9, 6)


def make_ucf101(root: str, seed: int = 0) -> None:
    """A seeded UCF-101-layout directory: ``<split>03.json`` indexes and the
    ``<class>_preprocessed_<res>_npz`` clips ((T, C, H, W) uint8)."""
    rng = np.random.default_rng(seed)
    for split in ("training", "validation"):
        index = []
        for i, T in enumerate(LENGTHS):
            cls = f"Class{i % 2}"
            index.append({"video_path": f"datasets/ucf101/{split}/{cls}/v_{i}.avi",
                          "label": i % 2})
            d = os.path.join(root, split, f"{cls}_preprocessed_{RES}_npz")
            os.makedirs(d, exist_ok=True)
            t = np.arange(T)[:, None, None, None]
            base = rng.integers(0, 256, (1, RES, RES, 3))
            video = ((base + 16 * t) % 256).astype(np.uint8)
            np.savez(os.path.join(d, f"v_{i}.npz"), video=np.moveaxis(video, -1, 1))
        with open(os.path.join(root, f"{split}03.json"), "w") as f:
            json.dump(index, f)


def ucf_argv(root, pth, ckpt):
    return [
        "+name=ucf", "dataset=ucf_101", "algorithm=dfot_video", "experiment=video_generation",
        f"dataset.save_dir={root}", f"dataset.resolution={RES}", f"dataset.max_frames={FRAMES}",
        "++algorithm.backbone.hidden_size=64", "++algorithm.backbone.depth=2",
        "++algorithm.backbone.num_heads=2", "experiment.tasks=[training]",
        "experiment.training.batch_size=2", "experiment.training.max_steps=2",
        "experiment.training.lr=1e-3", "algorithm.lr_scheduler.num_warmup_steps=1",
        "experiment.ema.decay=0.5", "++algorithm.logging.loss_freq=1",
        "experiment.training.data.num_workers=0", "wandb.mode=disabled", f"load={ckpt}",
    ] + dcae_args("algorithm.vae", pth)


@pytest.fixture(scope="module")
def ucf_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ucf")
    root = str(tmp / "ucf-101")
    make_ucf101(root)
    jm = JDC.DCAE(JDC.DCAEConfig.from_config({**DCAE_WIDTHS, "latent_channels": 32}))
    params = randomize(init_shapes(jm, np.zeros((1, RES, RES, 3), np.float32))["params"], 11)
    pth = str(tmp / "dcae.pth")
    torch.save(dcae_state_dict_from_flax(params), pth)
    algo = build_algorithm(load_config(ucf_argv(root, pth, "x.ckpt")), torch.float32,
                           device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(1))
    ckpt = str(tmp / "dit.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    return tmp, root, pth, ckpt


def test_ucf101_recipe_trains_like_main(monkeypatch, ucf_files):
    tmp, root, pth, ckpt = ucf_files
    _pin_draws(monkeypatch)
    _fp32(monkeypatch)
    got_xs, want_xs, control_xs = [], [], []
    _capture_tokens(monkeypatch, TVG.VideoGenerationExperiment, got_xs)
    _capture_tokens(monkeypatch, JVG.VideoGenerationExperiment, want_xs)
    argv = ucf_argv(root, pth, ckpt)
    cfg = load_config(argv)
    assert dict(cfg.dataset.augmentation.to_dict()) == dict(p=1.0, **UCF)
    assert cfg.dataset.latent.enabled and cfg.dataset.latent.type == "online"
    exp = run(argv + [f"output_dir={tmp / 'port'}"], device="cpu")
    jax_main.run(argv + [f"output_dir={tmp / 'jax'}"])
    assert got_xs[0].shape == (2, FRAMES, RES // 8, RES // 8, 32)
    assert rel_err(got_xs[0], want_xs[0]) < TOKEN_RTOL
    got, want = _step_metrics(tmp / "port"), _step_metrics(tmp / "jax")
    assert sorted(got) == sorted(want) == [1, 2]
    for step in want:
        assert np.isfinite(got[step][0]) and got[step][0] == pytest.approx(
            want[step][0], rel=LOSS_RTOL), step
    assert exp.algo.is_latent and exp.state.step == 2

    # control: the recipe without its augmentation encodes other clips
    monkeypatch.setattr(TVG.VideoGenerationExperiment, "_tokenize_batch",
                        TVG.VideoGenerationExperiment._tokenize_batch)
    _capture_tokens(monkeypatch, TVG.VideoGenerationExperiment, control_xs)
    run(argv + [f"output_dir={tmp / 'control'}", "experiment.training.max_steps=1",
                "dataset.augmentation=null"], device="cpu")
    assert rel_err(control_xs[0], want_xs[0]) > 100 * TOKEN_RTOL
