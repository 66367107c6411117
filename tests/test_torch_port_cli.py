"""The validation entry point of the port against the JAX package, on the CPU.

A U-ViT of two narrow levels (ResBlocks at 8 x 8, one transformer level of
2 heads over 4 x 4 x 8 tokens), 16 px RealEstate10K-shaped synthetic videos
with camera poses, 3 DDIM steps, vanilla HG at 4: the README's RE10K
command at a small size. Its checkpoint is an upstream-layout ``.ckpt``
with ``_orig_mod.`` segments, keys of other modules, and EMA weights in
``optimizer_states`` that differ from the live ones.

Tolerances: the host pose math, the checkpoint surgery, the datasets and
the loader are copies, held equal (geometry within 1e-6); mse, psnr and
ssim within 1e-5 relative; ``sample_videos`` in fp32 with pinned noise
within 1e-4 relative L2 a frame (the EMA control must miss by more than
1e-2); the whole CLI in its default bf16 on both sides: the videos each
side scores within 2e-2 relative L2 over the generated frames, mse and
psnr within 2e-2 relative. SSIM of a random-weight model's sample sits
near 0 (about 0.006), where a relative bound between the two runs measures
bf16 rounding, not the port: it is held within 2e-2 of SSIM's unit range
there, and every metric the port's CLI logs is held to the JAX package's
metric suite scoring the videos the port scored (context overwrite,
masking and averaging included): mse and psnr within 1e-5 relative, SSIM
within 1e-5 of its unit range (near 0 its fp32 rounding is about 1e-4 of
the value).

The JAX package's ``_import_torch_checkpoint`` hands the Fourier buffers
(``noise_level_pos_embedding.timesteps.freqs``/``phases``), which it has
just installed, on to ``import_uvit3d_params``, which has no rule for them
and raises: its tests here drop the two keys at that call.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.algorithms import dfot_video as JA
from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu.data import loader as JL
from dfot_tpu.data import video_dataset as JVD
from dfot_tpu.experiments.video_generation import VideoGenerationExperiment as JExperiment
from dfot_tpu.metrics import frechet as JFr
from dfot_tpu.metrics import functional as JF
from dfot_tpu.metrics.video_metric import VideoMetric as JVideoMetric
from dfot_tpu.utils import geometry as JG
from dfot_tpu.utils import torch_ckpt as JTC
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.data import loader as TL
from dfot_tpu_torch.data import video_dataset as TVD
from dfot_tpu_torch.metrics import functional as TF
from dfot_tpu_torch.metrics.video_metric import VideoMetric
from dfot_tpu_torch.utils import geometry as TG
from dfot_tpu_torch.utils import torch_ckpt as TTC
from dfot_tpu_torch.utils.weights import init_random_weights

from dfot_tpu.metrics import registry as JR
from dfot_tpu.metrics.i3d import I3D as JI3D
from dfot_tpu.metrics.inception import InceptionV3 as JInception
from dfot_tpu.vae.losses import LPIPS as JLPIPS
from test_torch_port_metrics import (  # noqa: F401 (trees is a fixture)
    FEATURE_RTOL,
    FRAME_RTOL,
    fast_jax_init,
    trees,
    write_npz,
)
from test_torch_port_sampling import WINDOW_RTOL, _pin_noise, rel_err
from torch_port_helpers import one_thread

SMALL = [
    "+name=tiny", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
    "experiment=video_generation", "@diffusion/continuous", "experiment.tasks=[validation]",
    "++algorithm.tasks.prediction.history_guidance.name=vanilla",
    "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
    "dataset.resolution=16",
    "++algorithm.backbone.channels=[32,64]",
    "++algorithm.backbone.block_types=[ResBlock,TransformerBlock]",
    "++algorithm.backbone.block_dropouts=[0.0,0.0]",
    "++algorithm.backbone.num_updown_blocks=[1]",
    "++algorithm.backbone.num_mid_blocks=1",
    "++algorithm.backbone.num_heads=2",
    "++algorithm.backbone.emb_channels=32",
    "++algorithm.backbone.use_checkpointing=[false,false]",
    "algorithm.diffusion.sampling_timesteps=3",
    "experiment.validation.batch_size=2",
    "experiment.validation.limit_batch=1",
    # the composed list's I3D, LPIPS and Inception passes and its 2048-wide
    # matrix square root (about 11 s a pass on an 8-core CPU) would multiply these
    # tests' time: test_cli_composed_metrics_* run the composed list
    "++algorithm.logging.metrics=[mse,ssim,psnr]",
    "++algorithm.logging.max_num_videos=0",
]
METRICS_CUT = "++algorithm.logging.metrics=[mse,ssim,psnr]"
CLI_RTOL = 2e-2
EMA_CONTROL_MIN = 1e-2
MODEL_PREFIX = "diffusion_model.model._orig_mod."


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def fixture_ckpt(tmp_path_factory):
    """(path, live state dict, EMA state dict) of the small model's
    upstream-layout checkpoint."""
    algo = build_algorithm(load_config(SMALL), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(0))
    live = {k: v.clone() for k, v in algo.model.state_dict().items()}
    init_random_weights(algo.model, torch.Generator().manual_seed(1))
    ema = {k: v.clone() for k, v in algo.model.state_dict().items()}
    state = {MODEL_PREFIX + k: v for k, v in live.items()}
    state["vae.encoder.weight"] = torch.ones(3)
    state["metrics.lpips.scale"] = torch.ones(2)
    path = str(tmp_path_factory.mktemp("ckpt") / "fixture.ckpt")
    torch.save({"state_dict": state, "optimizer_states": [{"ema": list(ema.values())}],
                "global_step": 7}, path)
    return path, live, ema


@pytest.fixture
def jax_imports_fourier_buffers(monkeypatch):
    imp = JTC.import_uvit3d_params

    def without_buffers(state, **kw):
        return imp({k: v for k, v in state.items() if not k.endswith((".freqs", ".phases"))}, **kw)

    monkeypatch.setattr(JTC, "import_uvit3d_params", without_buffers)


# ---------------------------------------------------------------------------
# host pose math (A4)
# ---------------------------------------------------------------------------


def _random_rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _raw_poses(kind):
    """(B, T, 16) camera vectors: the synthetic dataset's orbits, or random
    rotations with random translations."""
    if kind == "orbit":
        ds = JVD.SyntheticVideoDataset(num_videos=2, n_frames=8, resolution=16, cond_dim=16)
        return np.stack([ds[i]["conds"] for i in range(2)])
    rng = np.random.default_rng(4)
    R = _random_rotations(rng, 16).reshape(2, 8, 3, 3)
    T = rng.standard_normal((2, 8, 3, 1))
    K = np.broadcast_to(np.asarray([0.9, 0.8, 0.5, 0.45]), (2, 8, 4))
    return np.concatenate([K, np.concatenate([R, T], -1).reshape(2, 8, 12)], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["orbit", "random"])
def test_quaternions_match_jax(kind):
    R = JG.CameraPose.from_vectors(_raw_poses(kind)).R
    q_t, q_j = TG.rotmat_to_quat(R), JG.rotmat_to_quat(R)
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)
    np.testing.assert_allclose(TG.quat_to_rotmat(q_t), JG.quat_to_rotmat(q_j), atol=1e-6)
    steps = np.linspace(0, 1, 5, dtype=np.float32)
    np.testing.assert_allclose(TG.quat_slerp(q_t[0, 0], q_t[1, 3], steps),
                               JG.quat_slerp(q_j[0, 0], q_j[1, 3], steps), atol=1e-6)


@pytest.mark.parametrize("kind", ["orbit", "random"])
@pytest.mark.parametrize("normalize_by", ["first", "mean"])
@pytest.mark.parametrize("bound", [None, 1.0])
@pytest.mark.parametrize("interp", [False, True])
def test_pose_normalization_matches_jax(kind, normalize_by, bound, interp):
    raw = _raw_poses(kind)
    mask = np.zeros((2, 8), bool)
    if interp:  # the temporal-HG infill: unknown frames between known ones
        mask[:, [2, 3, 6]] = True
    kw = dict(normalize_by=normalize_by, bound=bound, interpolation_mask=mask if interp else None)
    np.testing.assert_allclose(TG.normalize_camera_conditions(raw, **kw),
                               JG.normalize_camera_conditions(raw, **kw), atol=1e-6)


@pytest.mark.parametrize("ctype", ["global", "ray", "plucker", "ray_encoding"])
def test_process_camera_conditions_matches_jax(ctype):
    raw = _raw_poses("random")
    kw = dict(conditioning_type=ctype, normalize_by="mean", bound=2.0, resolution=8)
    np.testing.assert_allclose(TG.process_camera_conditions(raw, **kw),
                               JG.process_camera_conditions(raw, **kw), atol=1e-6)
    assert TG.conditioning_dim(ctype) == JG.conditioning_dim(ctype)


# ---------------------------------------------------------------------------
# checkpoint surgery, data, metrics
# ---------------------------------------------------------------------------


def test_strip_checkpoint_matches_jax(fixture_ckpt):
    path, live, ema = fixture_ckpt
    got = TTC.strip_checkpoint(TTC.load_state_dict(path))
    want = JTC.strip_checkpoint(JTC.load_state_dict(path))
    assert list(got) == list(want) == list(live)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        np.testing.assert_array_equal(got[k].numpy(), ema[k].numpy())
    assert any(not torch.equal(live[k], ema[k]) for k in live)


def test_checkpoint_files_the_port_refuses(tmp_path):
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        TTC.load_state_dict(str(tmp_path / "weights.npz"))
    bad = {"state_dict": {MODEL_PREFIX + "a": torch.ones(1)},
           "optimizer_states": [{"ema": [torch.ones(1), torch.ones(1)]}]}
    with pytest.raises(ValueError, match="EMA weight count"):
        TTC.strip_checkpoint(bad)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_synthetic_dataset_matches_jax(split):
    cfg_t, cfg_j = load_config(SMALL).dataset, jax_load_config(SMALL).dataset
    dt, dj = TVD.build_dataset(cfg_t, split), JVD.build_dataset(cfg_j, split)
    assert len(dt) == len(dj)
    for i in (0, 5):
        a, b = dt[i], dj[i]
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("num_videos,batch_size", [(7, 3), (6, 3), (2, 4)])
def test_loader_matches_jax(num_videos, batch_size):
    """As validation loads: in order, the short last batch kept."""
    ds = JVD.SyntheticVideoDataset(num_videos=num_videos, n_frames=2, resolution=4, cond_dim=16)
    lt = TL.DataLoader(ds, batch_size)
    lj = JL.DataLoader(ds, batch_size, shuffle=False, drop_last=False)
    assert len(lt) == len(lj)
    got, want = list(lt), list(lj)
    assert len(got) == len(want) == len(lt)
    for a, b in zip(got, want):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _videos(seed, shape=(2, 6, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + 0.2 * rng.standard_normal(shape), -0.1, 1.1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name", ["mse", "psnr", "ssim"])
def test_frame_metrics_match_jax(name):
    pred, gt = _videos(0)
    got = getattr(TF, name)(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    want = np.asarray(getattr(JF, name)(jnp.asarray(pred), jnp.asarray(gt)))
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_metrics_frames", [None, 4])
def test_video_metric_log_matches_jax(n_metrics_frames):
    types_ = ("mse", "ssim", "psnr")
    vt = VideoMetric(types_, n_metrics_frames=n_metrics_frames)
    vj = JVideoMetric(types_, n_metrics_frames=n_metrics_frames)
    for seed in (1, 2):
        pred, gt = _videos(seed)
        ctx = np.zeros((2, 6), bool)
        ctx[:, :2] = True
        ctx[1, 3] = True
        vt.update(torch.as_tensor(pred), torch.as_tensor(gt), ctx)
        vj.update(pred, gt, ctx)
    got, want = vt.log("validation/prediction"), vj.log("validation/prediction")
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5)
    assert vt.log("x") == {}


# ---------------------------------------------------------------------------
# sampling and the whole CLI
# ---------------------------------------------------------------------------


def _first_batch(cfg):
    ds = JVD.build_dataset(cfg.dataset, "validation")
    return next(iter(JL.DataLoader(ds, 2, shuffle=False, drop_last=False)))


def test_sample_videos_matches_jax(monkeypatch, fixture_ckpt, jax_imports_fourier_buffers):
    """fp32 on both sides, noise pinned; the port loads the checkpoint
    through its own surgery, the JAX algorithm through its experiment's
    ``_import_torch_checkpoint``. The control: the live weights (no EMA
    promotion) sample far from JAX's."""
    _pin_noise(monkeypatch)
    path, live, _ = fixture_ckpt
    jcfg, tcfg = jax_load_config(SMALL), load_config(SMALL)
    jalgo = JA.build_algorithm(jcfg, jnp.float32)
    params = JExperiment._import_torch_checkpoint(
        types.SimpleNamespace(algo=jalgo, cfg=jcfg), path)
    talgo = build_algorithm(tcfg, torch.float32, device="cpu")
    talgo.model.load_state_dict(TTC.strip_checkpoint(TTC.load_state_dict(path)), strict=True)

    batch = _first_batch(jcfg)
    want = jalgo.sample_videos(params, jax.random.PRNGKey(0), jalgo.normalize(
        jnp.asarray(batch["videos"])), conditions=batch["conds"])
    xs = talgo.normalize(torch.as_tensor(batch["videos"]))
    got = talgo.sample_videos(torch.Generator().manual_seed(0), xs, conditions=batch["conds"])
    assert list(got) == list(want) == ["gt", "prediction"]
    pred_t, pred_j = got["prediction"].numpy(), np.asarray(want["prediction"])
    assert pred_t.shape == (2, 8, 16, 16, 3) and np.isfinite(pred_t).all()
    np.testing.assert_array_equal(pred_t[:, :4], xs[:, :4].numpy())  # context kept
    for f in range(8):
        assert rel_err(pred_t[:, f], pred_j[:, f]) < WINDOW_RTOL, f
    assert talgo.rollout.stats["denoiser_evals_b1"] == 3 * 2 * 2  # steps x batch x NFE

    talgo.model.load_state_dict(live, strict=True)
    control = talgo.sample_videos(torch.Generator().manual_seed(0), xs,
                                  conditions=batch["conds"])["prediction"].numpy()
    assert rel_err(control[:, 4:], pred_j[:, 4:]) > EMA_CONTROL_MIN


def _recording(update, into):
    """``VideoMetric.update`` that also keeps what it scores, as fp32 numpy."""
    def record(self, preds, targets, context_mask=None):
        into.append([x.float().cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x, np.float32) for x in (preds, targets)]
                    + [np.asarray(context_mask, bool)])
        return update(self, preds, targets, context_mask)
    return record


def _metrics(run_dir):
    """The keys and values of the run's metrics.jsonl, line after line."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(run_dir) for f in fs
             if f == "metrics.jsonl"]
    assert len(files) == 1, files
    out = {}
    with open(files[0]) as f:
        for line in f:
            out.update({k: v for k, v in json.loads(line).items() if k not in ("step", "time")})
    return out


@pytest.mark.parametrize("extra,passes", [
    ([], ["validation"]),
    (["++experiment.validation.validate_history_free=true",
      "++experiment.validation.validate_training_set=true"],
     ["validation", "validation_history_free", "val_on_training",
      "val_on_training_history_free"]),
], ids=["validation", "history_free_and_training_set"])
def test_cli_matches_main(monkeypatch, tmp_path, fixture_ckpt, jax_imports_fourier_buffers,
                          extra, passes):
    """``run(argv)`` against ``main.run(argv)``: the same argv and
    checkpoint, bf16 on both sides, noise pinned; with the extra passes
    (no context, the training split) as well."""
    _pin_noise(monkeypatch)
    scored = {"port": [], "jax": []}
    for side, cls in (("port", VideoMetric), ("jax", JVideoMetric)):
        monkeypatch.setattr(cls, "update", _recording(cls.update, scored[side]))
    path = fixture_ckpt[0]
    argv = SMALL + [f"load={path}"] + extra
    exp = run(argv + [f"output_dir={tmp_path / 'port'}"], device="cpu")
    jax_main.run(argv + [f"output_dir={tmp_path / 'jax'}"])
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert list(got) == list(want) == [
        f"{p}/prediction/{m}" for p in passes for m in ("mse", "psnr", "ssim")]
    for k, v in want.items():
        assert np.isfinite(got[k])
        if k.endswith("ssim"):
            assert abs(got[k] - v) < CLI_RTOL, k
        else:
            assert got[k] == pytest.approx(v, rel=CLI_RTOL), k
    # one batch a pass: the videos each side scored, and the port's logged
    # metrics against the JAX suite on the port's own videos
    assert len(scored["port"]) == len(scored["jax"]) == len(passes)
    for p, (pred_t, gt_t, ctx_t), (pred_j, gt_j, ctx_j) in zip(passes, scored["port"],
                                                              scored["jax"]):
        np.testing.assert_array_equal(ctx_t, ctx_j)
        assert pred_t.shape == pred_j.shape == (2, 8, 16, 16, 3)
        assert rel_err(gt_t, gt_j) < CLI_RTOL, p
        assert rel_err(pred_t[~ctx_t], pred_j[~ctx_j]) < CLI_RTOL, p
        suite = JVideoMetric(("mse", "ssim", "psnr"))
        suite.update(pred_t, gt_t, ctx_t)
        for k, v in suite.log(f"{p}/prediction").items():
            tol = {"abs": 1e-5} if k.endswith("ssim") else {"rel": 1e-5}
            assert got[k] == pytest.approx(v, **tol), k
    assert exp.algo.model.embed_input.proj.weight.dtype == torch.float32
    if passes[-1] == "validation":  # the last pass had the 4 context frames
        videos = exp.last_videos
        np.testing.assert_array_equal(videos["prediction"][:, :4].numpy(),
                                      videos["gt"][:, :4].numpy())
    run_dir = os.path.relpath(exp.output_dir, tmp_path / "port").split(os.sep)[:4]
    assert run_dir == ["video_generation", "validation", "realestate10k_mini", "dfot_video_pose"]


# ---------------------------------------------------------------------------
# the flagship's composed metric list
# ---------------------------------------------------------------------------

COMPOSED = [a for a in SMALL if a != METRICS_CUT]  # [fvd, is, fid, lpips, mse, ssim, psnr]
COMPOSED_NAMES = ("mse", "psnr", "ssim", "lpips", "fvd", "fid", "is")


@pytest.fixture(scope="module")
def metric_weights(trees, tmp_path_factory):
    """A ``metrics_weights_dir`` of I3D, LPIPS and InceptionV3 ``.npz``
    files written from seeded JAX trees."""
    wd = tmp_path_factory.mktemp("metric_weights")
    for name in ("i3d", "lpips", "inception"):
        write_npz(wd, name, trees[name]["params"])
    return str(wd)


def test_cli_composed_metrics_match_main(monkeypatch, tmp_path, fixture_ckpt,
                                         jax_imports_fourier_buffers, metric_weights):
    """``run(argv)`` against ``main.run(argv)`` with the README's metric list
    as composed and every network's weights in ``metrics_weights_dir``: the
    same keys, each a plain name; the port's values equal to the JAX suite
    (its registry on the same files) scoring the videos the port scored; the
    two CLIs' frame-wise values within the bf16 bound of
    ``test_cli_matches_main``. The suite reuses the JAX run's registry (its
    jitted networks on the same files)."""
    _pin_noise(monkeypatch)
    fast_jax_init(monkeypatch, JI3D, JLPIPS, JInception)
    scored = {"port": [], "jax": []}
    for side, cls in (("port", VideoMetric), ("jax", JVideoMetric)):
        monkeypatch.setattr(cls, "update", _recording(cls.update, scored[side]))
    jax_registries = []  # the JAX run's registry, whose jitted networks the suite reuses
    init = JVideoMetric.__init__
    monkeypatch.setattr(JVideoMetric, "__init__", lambda self, *a, **kw: (
        init(self, *a, **kw), jax_registries.append(self.registry))[0])
    argv = COMPOSED + [f"load={fixture_ckpt[0]}",
                       f"++algorithm.logging.metrics_weights_dir={metric_weights}"]
    exp = run(argv + [f"output_dir={tmp_path / 'port'}"], device="cpu")
    with monkeypatch.context() as mp:
        # the JAX CLI's Frechet distances score other videos (bf16 apart) and
        # are not compared: their 2048-wide square root (23 s on one thread)
        # is left out of that run; the suite below computes JAX's on the
        # port's videos
        mp.setattr(JFr.FrechetDistance, "compute", lambda self: float("nan"))
        jax_main.run(argv + [f"output_dir={tmp_path / 'jax'}"])
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    keys = [f"validation/prediction/{m}" for m in COMPOSED_NAMES]
    assert list(got) == list(want) == keys
    assert exp._registry.comparable == {"lpips": True, "i3d": True, "inception": True}
    # the I3D pass counts under fvd, IS's host math under is_host
    assert set(exp.timings["metrics_split_s"]) == set(COMPOSED_NAMES) - {"is"} | {
        "fvd_host", "fid_host", "is_host"}
    for k in keys[:2]:
        assert got[k] == pytest.approx(want[k], rel=CLI_RTOL), k
    assert abs(got[keys[2]] - want[keys[2]]) < CLI_RTOL
    (pred, gt, ctx), = scored["port"]
    assert jax_registries[0].weights_dir == metric_weights
    suite = JVideoMetric(tuple(exp.cfg.algorithm.logging.metrics), jax_registries[0])
    suite.update(pred, gt, ctx)
    for k, v in suite.log("validation/prediction").items():
        tol = FRAME_RTOL if k.rsplit("/", 1)[1] in ("mse", "psnr", "lpips") else FEATURE_RTOL
        assert got[k] == pytest.approx(v, rel=tol, abs=1e-5 if k.endswith("ssim") else 0), k


def test_cli_composed_metrics_uncalibrated_without_weights(tmp_path, fixture_ckpt):
    """Without ``metrics_weights_dir`` the composed list runs on the
    registry's seeded fallback networks, each network metric named
    ``_uncalibrated``."""
    exp = run(COMPOSED + [f"load={fixture_ckpt[0]}", f"output_dir={tmp_path}"], device="cpu")
    got = _metrics(tmp_path)
    calibrated = ("mse", "psnr", "ssim")
    assert list(got) == [f"validation/prediction/{m}" if m in calibrated
                         else f"validation/prediction/{m}_uncalibrated" for m in COMPOSED_NAMES]
    assert np.isfinite(list(got.values())).all()
    reg = exp._registry
    assert reg.comparable == {"lpips": False, "i3d": False, "inception": False}
    assert all(p.device.type == "cpu" for n in ("i3d", "lpips")
               for p in reg.networks[n].parameters())


# ---------------------------------------------------------------------------
# what is not ported raises, naming its queue item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra,item", [
    (["experiment.tasks=[training]", "experiment.training.mesh.tensor=2"], "A16"),
    (["++algorithm.logging.metrics=[vbench]", "++algorithm.logging.metrics_weights_dir={raft}"],
     "does not match the raft model"),
    (["algorithm.save_attn_map.enabled=true"], "A16"),
    (["experiment.validation.mesh.tensor=2"], "A16"),
    (["cluster=base_slurm"], "A16"),
], ids=["training_mesh", "vbench_raft", "attn_maps", "mesh", "cluster"])
def test_unported_cli_branches_raise(tmp_path, extra, item):
    """Each unported branch raises ``NotImplementedError`` naming its queue
    item. ``vbench_raft``: RAFT is ported (A15c), and a ``raft.npz`` that is
    not RAFT's tree is refused with ``ValueError`` naming the file when the
    metrics first ask for the network, as in JAX."""
    np.savez(tmp_path / "raft.npz", w=np.zeros(1))
    extra = [e.format(raft=tmp_path) for e in extra]
    error = ValueError if "raft" in item else NotImplementedError
    with pytest.raises(error, match=item):
        run(SMALL + extra + [f"output_dir={tmp_path / 'out'}"], device="cpu")


def test_unported_paths_raise(tmp_path, monkeypatch):
    out = f"output_dir={tmp_path}"
    (tmp_path / "checkpoint_5").mkdir()  # a checkpoint_<step> directory without its file
    with pytest.raises(FileNotFoundError, match="not a checkpoint directory"):
        run(SMALL + [f"load={tmp_path / 'checkpoint_5'}", out], device="cpu")
    # a dataset directory without the split's layout: no synthetic stand-in
    with pytest.raises(FileNotFoundError, match="split directory not found"):
        run(SMALL + [f"dataset.save_dir={tmp_path}", out], device="cpu")
    # a launch that says there are two processes but names neither this
    # one's rank nor the rendezvous: refused, not run as one process
    for var in ("RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        run(SMALL + [out], device="cpu")


@pytest.mark.parametrize("extra,item", [
    (["algorithm/backbone=u_net3d", "++algorithm.backbone.network_size=16",
      "++algorithm.backbone.dim_mults=[1,2]", "++algorithm.backbone.attn_heads=2",
      "++algorithm.backbone.attn_dim_head=8"], "UNet3D"),
    (["algorithm/backbone=far_dit", "++algorithm.backbone.hidden_size=64",
      "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2",
      "++algorithm.backbone.axes_dims_rope=[8,12,12]"], "FARDiT"),
    (["algorithm/backbone=dit1d", "++algorithm.backbone.hidden_size=64",
      "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2"], "DiT1D"),
    (["algorithm=difference_dfot_video", "++algorithm.backbone.hidden_size=64",
      "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2"], "DiT3D"),
])
def test_unported_algorithms_raise(extra, item):
    """The four compositions that raised until ROADMAP.md A14 was ported
    build (the model class named) and run one forward at 16 px."""
    argv = ["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video",
            "experiment=video_generation", "++dataset.latent.enabled=false",
            "dataset.resolution=16", "dataset.max_frames=4"] + extra
    algo = build_algorithm(load_config(argv), torch.float32, device="cpu")
    assert type(algo.model).__name__ == item
    h, w, c = algo.x_shape
    x = torch.zeros(1, algo.max_tokens, h, w, c)
    with torch.no_grad():
        out = algo.model(x, torch.zeros(1, algo.max_tokens))
    assert out.shape == x.shape[:2] + out.shape[2:] and torch.isfinite(out).all()


def test_main_runs_nothing_on_import():
    import importlib

    mod = importlib.import_module("dfot_tpu_torch.__main__")
    assert callable(mod.run) and mod.__name__ == "dfot_tpu_torch.__main__"
