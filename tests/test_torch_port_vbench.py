"""The port's VBench and FVMD path (``dfot_tpu_torch/metrics/encoders.py``,
``motion.py``, ``vbench.py``) against the JAX package's, on the CPU.

CLIP and DINO run at a small config through the JAX package's own
importers (``import_clip_vision_params``, ``import_dino_params``) of the
port's state dict; in the registry they load ``.npz`` files of seeded JAX
trees at one narrow block (the CLIP-L/14 stand-in keeps its 768-wide
output for the LAION head). The Lucas-Kanade tracker and the histograms
are numpy copies, held bit for bit on the same inputs; ``motion_features``
and the VBench dimensions go through the port's resize and networks.

Tolerances: encoders 1e-5 relative L2 (fp32, one or two blocks; the control
attends with one head where the config has two), the resize 2e-5 of the
unit range, ``motion_features`` 1e-6 absolute (its LK trajectories move by
the resize's 1e-7 differences), the VBench dimensions 1e-5 relative, FVMD
1e-4 relative (a matrix square root of the features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.metrics import encoders as JE
from dfot_tpu.metrics import motion as JM
from dfot_tpu.metrics import registry as JR
from dfot_tpu.metrics import vbench as JV
from dfot_tpu.metrics.video_metric import VideoMetric as JVideoMetric
from dfot_tpu_torch.metrics import encoders as TE
from dfot_tpu_torch.metrics import motion as TM
from dfot_tpu_torch.metrics import vbench as TV
from dfot_tpu_torch.metrics.registry import SharedMetricModelRegistry, seeded_init
from dfot_tpu_torch.metrics.video_metric import VideoMetric

from test_torch_port_metrics import (  # noqa: F401 (_one_thread is an autouse fixture)
    CONTROL_MIN,
    _one_thread,
    fast_jax_init,
    init_shapes,
    rel_err,
    seeded_tree,
    write_npz,
)

ENCODER_RTOL = 1e-5
RESIZE_ATOL = 2e-5
MOTION_ATOL = 1e-6
VBENCH_RTOL = 1e-5
FVMD_RTOL = 1e-4
SMALL_CLIP = dict(image_size=64, patch_size=16, width=32, layers=2, heads=2, output_dim=8)
SMALL_DINO = dict(image_size=64, patch_size=16, width=32, layers=2, heads=2)


def _seeded_port(net, seed: int):
    g = torch.Generator().manual_seed(seed)
    seeded_init(net, g)
    with torch.no_grad():  # no norm at one, no bias at zero
        for name, p in net.named_parameters():
            if p.ndim == 1 and "bias" not in name:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
            elif "bias" in name or name == "cls_token":
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return net.eval()


@pytest.mark.parametrize("kind", ["clip", "dino"])
def test_encoder_matches_jax_through_its_importer(kind):
    if kind == "clip":
        net = _seeded_port(TE.CLIPVisionEncoder(TE.CLIPVisionConfig(**SMALL_CLIP)), 1)
        state = {"visual." + k: v.numpy() for k, v in net.state_dict().items()}
        model, params = JE.CLIPVisionEncoder(JE.CLIPVisionConfig(**SMALL_CLIP)), \
            JE.import_clip_vision_params(state)
    else:
        net = _seeded_port(TE.DINOEncoder(TE.DINOConfig(**SMALL_DINO)), 2)
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        model, params = JE.DINOEncoder(JE.DINOConfig(**SMALL_DINO)), JE.import_dino_params(state)
    shapes = init_shapes(model, jnp.zeros((1, 64, 64, 3)))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        blocks = net.transformer.resblocks if kind == "clip" else net.blocks
        blocks[0].attn.heads = 1  # control: one head where the config has two
        control = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8 if kind == "clip" else 32)
    assert rel_err(got, want) < ENCODER_RTOL
    assert rel_err(control, want) > CONTROL_MIN


@pytest.mark.parametrize("kind", ["clip", "dino"])
def test_preprocess_matches_jax(kind):
    x = np.random.default_rng(4).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    jfn, tfn = {"clip": (JE.clip_preprocess, TE.clip_preprocess),
                "dino": (JE.dino_preprocess, TE.dino_preprocess)}[kind]
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 224, 224, 3)
    assert np.abs(got - want).max() < RESIZE_ATOL / 0.22  # the normalization divides by ~0.22


def moving_video(T: int = 17, H: int = 32, speed: float = 2.0, phase: float = 0.0, B: int = 1):
    """A drifting sinusoid (the JAX package's FVMD test pattern), 3 channels."""
    yy, xx = np.mgrid[0:H, 0:H].astype(np.float32)
    frames = [0.5 + 0.2 * np.sin((xx - speed * t + phase) * 0.3) * np.cos(yy * 0.22)
              + 0.1 * np.sin((xx - speed * t) * 0.11 + yy * 0.17) for t in range(T)]
    v = np.repeat(np.stack(frames)[None, ..., None], 3, axis=-1).astype(np.float32)
    return np.repeat(v, B, axis=0)


def test_lk_tracker_and_histograms_match_jax_bit_for_bit():
    seg = moving_video(16, 64)[0]
    side = np.linspace(8, 56, 20, dtype=np.float32)
    gy, gx = np.meshgrid(side, side, indexing="ij")
    pts0 = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    want = JM.lk_track(seg, pts0)
    got = TM.lk_track(seg, pts0)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want[-1] - want[0]).max() > 1.0  # the points moved
    vel = TM._calc_velocity(got)[None]
    np.testing.assert_array_equal(TM.calc_hist(vel), JM.calc_hist(JM._calc_velocity(want)[None]))


def test_motion_features_match_jax():
    v = np.concatenate([moving_video(17, 32), moving_video(17, 32, 1.0, 2.0)])
    want = JM.motion_features(v)
    got = TM.motion_features(torch.from_numpy(v), device="cpu")
    assert got.shape == want.shape == (2, 1024)
    assert np.abs(got - want).max() < MOTION_ATOL


@pytest.fixture
def small_registries(tmp_path, monkeypatch):
    """(port registry, JAX registry) on one directory of seeded ``.npz``
    files: CLIP-B/32, CLIP-L/14 and DINO at one narrow block, LAION."""
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "CLIP_B32", mod.CLIPVisionConfig(
            patch_size=32, width=32, layers=1, heads=2, output_dim=8))
        monkeypatch.setattr(mod, "CLIP_L14", mod.CLIPVisionConfig(
            patch_size=32, width=32, layers=1, heads=2, output_dim=768))
        monkeypatch.setattr(mod, "DINO_B16", mod.DINOConfig(patch_size=32, width=32, layers=1,
                                                             heads=2))
    x = jnp.zeros((1, 224, 224, 3))
    for i, (name, model) in enumerate((("clip_b32", JE.CLIPVisionEncoder(JE.CLIP_B32)),
                                       ("clip_l14", JE.CLIPVisionEncoder(JE.CLIP_L14)),
                                       ("dino", JE.DINOEncoder(JE.DINO_B16)))):
        write_npz(tmp_path, name, seeded_tree(init_shapes(model, x), 20 + i)["params"])
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "laion.npz", weight=rng.standard_normal((1, 768)).astype(np.float32),
             bias=np.asarray([5.0], np.float32))
    fast_jax_init(monkeypatch, JE.CLIPVisionEncoder, JE.DINOEncoder)
    return (SharedMetricModelRegistry(str(tmp_path), device="cpu"),
            JR.SharedMetricModelRegistry(str(tmp_path)))


ALL_DIMS = ("subject_consistency", "background_consistency", "temporal_flickering",
            "motion_smoothness", "dynamic_degree", "aesthetic_quality", "imaging_quality")


def test_vbench_quality_matches_jax(small_registries):
    treg, jreg = small_registries
    rng = np.random.default_rng(6)
    moving = moving_video(8, 32, B=2)
    noisy = np.clip(moving + 0.2 * rng.standard_normal(moving.shape), 0, 1).astype(np.float32)
    got, want = TV.VBenchQuality(ALL_DIMS, treg), JV.VBenchQuality(ALL_DIMS, jreg)
    for v in (moving, noisy):
        got.update(torch.from_numpy(v))
        want.update(v)
    g, w = got.log(), want.log()
    assert list(g) == list(w)
    assert "vbench/subject_consistency" in w and "vbench/motion_smoothness_uncalibrated" in w
    for k, v in w.items():
        assert g[k] == pytest.approx(v, rel=VBENCH_RTOL), k
    assert treg.comparable == jreg.comparable


def test_video_metric_vbench_and_fvmd_match_jax(small_registries):
    """``[vbench, real_vbench, fvmd]`` (K600 and BAIR add ``vbench`` to the
    composed list) over 17-frame videos: keys, names and values."""
    treg, jreg = small_registries
    types = ("vbench", "real_vbench", "fvmd")
    vt, vj = VideoMetric(types, treg), JVideoMetric(types, jreg)
    gt = np.concatenate([moving_video(17, 32), moving_video(17, 32, 1.0, 3.0)])
    pred = np.concatenate([moving_video(17, 32, 2.0, 1.0), moving_video(17, 32, 0.0)])
    ctx = np.zeros((2, 17), bool)
    ctx[:, 0] = True
    vt.update(torch.from_numpy(pred), torch.from_numpy(gt), ctx)
    vj.update(pred, gt, ctx)
    got, want = vt.log("validation/prediction"), vj.log("validation/prediction")
    assert list(got) == list(want)
    assert "validation/prediction/fvmd_uncalibrated" in want
    assert "validation/prediction/real_vbench/quality_score" in want
    for k, v in want.items():
        rtol = FVMD_RTOL if "fvmd" in k else VBENCH_RTOL
        assert got[k] == pytest.approx(v, rel=rtol), k
    assert treg.comparable["fvmd"] is False
