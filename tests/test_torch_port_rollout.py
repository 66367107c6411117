"""The port's long-video rollout against the JAX package's, on the CPU.

Host planners (keyframes, interpolation chunks, sliding windows) and every
HG factory's tables must be EQUAL to the originals. Rollouts (sliding-window
prediction, interpolation, keyframes + interpolation, scan-length buckets)
run a tiny UViT3DPose or an analytic model in both packages with the random
draws pinned (``tests/test_torch_port_sampling.py``'s ``_pin_noise``) and
must agree frame for frame within ``WINDOW_RTOL`` (1e-4 relative L2), with
equal window and evaluation counts. Camera poses move along a seeded path,
so a window given another window's conditions shows; the control gives
every window the first window's conditions and must miss by more than 1e-2.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.diffusion import core as JDC
from dfot_tpu.guidance import history_guidance as JHG
from dfot_tpu.models import uvit as JU
from dfot_tpu.sampling import planner as JP
from dfot_tpu.sampling import rollout as JR
from dfot_tpu.utils.geometry import expand_pose_conditions_jax
from dfot_tpu_torch.algorithms.dfot_video import sampling_cond_transform
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.guidance import history_guidance as THG
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.sampling import planner as TP
from dfot_tpu_torch.sampling import rollout as TR

from test_torch_port_sampling import (
    MASKS as SAMPLING_MASKS,
    WINDOW_RTOL,
    _pin_noise,
    _tables_equal,
    jax_dcfg,
    rel_err,
    small_dcfg,
)
from torch_port_helpers import build_pair, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


R, T, P = 16, 8, 2
CONTROL_MIN = 1e-2
# what the port's stats share with the JAX rollout's (the rest are times)
COUNTS = ("denoiser_evals_b1", "windows", "keyframe_evals_b1")
# the JAX rollout's host-scatter times, which the port has no counterpart of
JAX_ONLY_STATS = {"interp_host_scatter_sec", "interp_fetch_scatter_sec"}


# ---------------------------------------------------------------------------
# planners: equal to the originals
# ---------------------------------------------------------------------------


def _same_outcome(port_fn, jax_fn):
    """Both calls give equal results, or both raise ValueError."""
    try:
        want = jax_fn()
    except ValueError:
        with pytest.raises(ValueError):
            port_fn()
        return None
    got = port_fn()
    return got, want


@pytest.mark.parametrize("density", [0.0625, 0.125, 0.3, 0.5, 1.0])
def test_keyframe_indices_equal(density):
    for n, ctx in itertools.product((8, 17, 72, 200), (0, 1, 2, 4)):
        got = TP.keyframe_indices(density, n, ctx)
        np.testing.assert_array_equal(got, JP.keyframe_indices(density, n, ctx))
        assert got.dtype == np.int64
    assert len(TP.keyframe_indices(0.0625, 200, 1)) == 12


def test_keyframe_indices_errors():
    for args in ((1.5, 10, 1), (0.5, 4, 5)):
        with pytest.raises(ValueError):
            JP.keyframe_indices(*args)
        with pytest.raises(ValueError):
            TP.keyframe_indices(*args)


@pytest.mark.parametrize("max_tokens", range(4, 11))
def test_interpolation_plan_equal(max_tokens):
    rng = np.random.default_rng(max_tokens)
    for _ in range(12):
        mask = rng.random(int(rng.integers(2, 80))) < rng.uniform(0.02, 0.5)
        mask[[0, -1]] = True
        got, want = TP.interpolation_plan(mask, max_tokens), JP.interpolation_plan(mask, max_tokens)
        assert len(got) == len(want)
        for rg, rw in zip(got, want):
            assert len(rg) == len(rw)
            for a, b in zip(rg, rw):
                np.testing.assert_array_equal(a, b)
    bad = np.ones(9, bool)
    bad[-1] = False
    with pytest.raises(ValueError):
        TP.interpolation_plan(bad, max_tokens)


@pytest.mark.parametrize("use_causal_mask,chunk_size", [(False, -1), (True, -1), (True, 2),
                                                        (True, 3), (False, 2)])
def test_sliding_window_plan_equal(use_causal_mask, chunk_size):
    for gt, length, sliding in itertools.product((0, 1, 2, 4), (4, 8, 12, 17, 33),
                                                 (None, -1, 2, 4, 7)):
        out = _same_outcome(
            lambda: TP.sliding_window_plan(gt, length, 8, sliding, chunk_size, use_causal_mask),
            lambda: JP.sliding_window_plan(gt, length, 8, sliding, chunk_size, use_causal_mask))
        if out is not None:
            got, want = out
            assert [dataclasses.astuple(w) for w in got] == [dataclasses.astuple(w) for w in want]
            assert [w.length for w in got] == [w.length for w in want]


def test_pad_to_length_equal():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for length, axis, value in itertools.product((2, 3, 5), (0, 1, 2), (0, -1)):
        got = TP.pad_to_length(x, length, axis, value)
        np.testing.assert_array_equal(got, JP.pad_to_length(x, length, axis, value))
        assert got.dtype == x.dtype


# ---------------------------------------------------------------------------
# every HG factory, through from_config
# ---------------------------------------------------------------------------

MASKS = SAMPLING_MASKS + [
    np.array([2, 2, 1, 0, 0, 0, 0, 0]),
    np.array([1, 2, 2, 2, 0, 0, 0, -1]),
    np.array([1, 1, 2, 2, 2, 2, 0, 0]),
]

HG_CONFIGS = [
    {"name": "conditional"},
    {"name": "stabilized_conditional", "stabilization_level": 0.02},
    {"name": "vanilla", "guidance_scale": 4.0},
    {"name": "vanilla", "guidance_scale": 1.5, "use_external_cond_guidance": False},
    {"name": "stabilized_vanilla", "guidance_scale": 4.0, "stabilization_level": 0.02},
    {"name": "fractional", "guidance_scale": 4.0, "freq_scale": 0.4},
    {"name": "stabilized_fractional", "guidance_scale": 3.0, "freq_scale": 0.4,
     "stabilization_level": 0.02},
    {"name": "temporal", "hist_subsequences": [[-1], "all"], "hist_weights": [2.0, 1.5],
     "gen_segments": [[0, 1], "all"]},
    {"name": "custom", "hist_weights": [2.0, -0.5, 1.0], "gen_segments": ["all"],
     "hist_segments": [
         {"time_indices": "all", "freq_ranges": [[0.1, 1.0]],
          "freq_ranges_if_generated": [[0.5, 1.0]]},
         {"time_indices": [-1], "freq_ranges": ["all"]},
         {"time_indices": "all", "freq_ranges": [[0.0, 0.5], [0.3, 1.0]],
          "freq_ranges_if_generated": [[0.2, 0.9], [0.6, 1.0]]},
     ]},
]


class _ToDict:
    """A config object exposing ``to_dict()``, as the JAX package's Config does."""

    def __init__(self, d):
        self._d = d

    def to_dict(self):
        return dict(self._d)


@pytest.mark.parametrize("cfg", HG_CONFIGS, ids=lambda c: c["name"])
def test_history_guidance_factories_equal(cfg):
    extra = dict(cfg, visualize=False)  # a recipe's extra key passes through
    jh = JHG.HistoryGuidance.from_config(extra, timesteps=1000)
    th = THG.HistoryGuidance.from_config(_ToDict(extra), timesteps=1000)
    assert dataclasses.astuple(th) == dataclasses.astuple(jh)
    assert th == THG.HistoryGuidance.from_config(cfg, timesteps=1000)
    for m in MASKS:
        _tables_equal(th.plan(m), jh.plan(m))
    for a, b in itertools.combinations(MASKS, 2):
        pair = np.stack([a, b])
        out = _same_outcome(lambda: th.plan_batched(pair), lambda: jh.plan_batched(pair))
        if out is not None:
            _tables_equal(*out)


def test_fractional_dedups_to_three_conditions():
    th = THG.HistoryGuidance.fractional(4.0, 0.4)
    assert th.plan(MASKS[0]).num_hist == 3
    # code 2 takes freq_ranges_if_generated: other levels than code 1
    st = THG.HistoryGuidance.stabilized_vanilla(4.0, 0.02)
    assert not np.array_equal(st.plan(np.array([1, 0, 0, 0])).override_levels,
                              st.plan(np.array([2, 0, 0, 0])).override_levels)


# ---------------------------------------------------------------------------
# rollouts on a tiny UViT3DPose
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_uvit():
    return build_pair(tiny_spec(), R, seed=3, token_io=True)


def moving_poses(B: int, n: int, seed: int) -> np.ndarray:
    """(B, n, 16) camera vectors along a seeded path: unit intrinsics, a
    rotation about the vertical axis and a translation that both move frame
    by frame."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((B, n, 16), np.float32)
    poses[..., :4] = [1.0, 1.0, 0.5, 0.5]
    for b in range(B):
        t = np.cumsum(0.3 * rng.standard_normal((n, 3)), 0)
        yaw = np.cumsum(0.2 * rng.standard_normal(n))
        for f in range(n):
            c, s = np.cos(yaw[f]), np.sin(yaw[f])
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            poses[b, f, 4:] = np.concatenate([rot, t[f][:, None]], 1).reshape(12)
    return poses


def uvit_rollouts(pair, steps: int = 3, **cfg_kw):
    """(jax rollout, jax variables, port rollout) for the tiny model with
    ray conditioning from pose vectors and the token-layout state."""
    jm, jv, pm = pair
    dcfg = small_dcfg(steps)

    def j_transform(c, v):
        return JU.precompute_pose_conditioning(jm, v, expand_pose_conditions_jax(c, "ray", R))

    jro = JR.DFoTRollout(
        JR.RolloutConfig(
            max_tokens=T, x_shape=(R, R, 3), cond_transform=j_transform,
            state_codec=(lambda x: JU.patchify_tokens(x, P),
                         lambda x: JU.unpatchify_tokens(x, P, R, R)),
            **cfg_kw),
        jax_dcfg(dcfg), JDC.make_schedule(jax_dcfg(dcfg)),
        lambda v, x, n, c, m: jm.apply(v, x, n, c, m),
    )
    tro = TR.DFoTRollout(
        TR.RolloutConfig(
            max_tokens=T, x_shape=(R, R, 3), cond_transform=sampling_cond_transform(pm, "ray"),
            state_codec=(lambda x: TU.patchify_tokens(x, P),
                         lambda x: TU.unpatchify_tokens(x, P, R, R)),
            **cfg_kw),
        dcfg, TDC.make_schedule(dcfg, device="cpu"), pm,
    )
    return jro, jv, tro


def frames_match(got, want, tol=WINDOW_RTOL) -> float:
    """Largest per-frame relative L2 error; asserts shape and finiteness."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    worst = max(rel_err(got[b, f], want[b, f])
                for b in range(got.shape[0]) for f in range(got.shape[1]))
    assert worst < tol, worst
    return worst


def stats_match(tro, jro):
    assert set(tro.stats) == set(jro.stats) - JAX_ONLY_STATS
    assert {k: tro.stats.get(k) for k in COUNTS} == {k: jro.stats.get(k) for k in COUNTS}


def video(B: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (B, n, R, R, 3)).astype(np.float32)


def _predict_sequence(pair, slice_first_window: bool = False, monkeypatch=None):
    jro, jv, tro = uvit_rollouts(pair, external_cond_type="action", sliding_context_len=4)
    hg = dict(guidance_scale=4.0, stabilization_level=0.02)
    ctx = video(1, 1, 10)
    poses = moving_poses(1, 16, 11)
    want = jro.predict_sequence(jv, jax.random.PRNGKey(0), jnp.asarray(ctx), length=16,
                                conditions=poses,
                                history_guidance=JHG.HistoryGuidance.stabilized_vanilla(**hg))
    if slice_first_window:
        real = TR.DFoTRollout._slice_conditions
        monkeypatch.setattr(TR.DFoTRollout, "_slice_conditions",
                            lambda self, c, start, n: real(self, c, 0, n))
    got = tro.predict_sequence(None, ctx, length=16, conditions=poses,
                               history_guidance=THG.HistoryGuidance.stabilized_vanilla(**hg))
    return jro, tro, got, want


def test_predict_sequence_matches_jax(monkeypatch, tiny_uvit):
    """Three sliding windows (1 + 7, 4 + 4, 4 + 4 frames); the second and
    third windows' context is generated, mask code 2, under stabilized HG."""
    windows = TP.sliding_window_plan(1, 16, T, 4)
    assert len(windows) == 3 and windows[1].generated_context_len == 4
    _pin_noise(monkeypatch)
    jro, tro, got, want = _predict_sequence(tiny_uvit)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    frames_match(got, want)
    np.testing.assert_array_equal(got[:, :1].numpy(), video(1, 1, 10))
    stats_match(tro, jro)
    assert tro.stats["windows"] == 3


def test_control_wrong_condition_slice_is_caught(monkeypatch, tiny_uvit):
    """Every window given the first window's poses: the bound rejects it."""
    _pin_noise(monkeypatch)
    _, _, got, want = _predict_sequence(tiny_uvit, slice_first_window=True,
                                        monkeypatch=monkeypatch)
    assert rel_err(got, want) > CONTROL_MIN


def test_predict_videos_matches_jax(monkeypatch, tiny_uvit):
    """72 frames from one: 9 keyframes in 2 sliding windows, then two
    interpolation rounds of 8 chunks, dispatched 4 chunks at a time."""
    _pin_noise(monkeypatch)
    cfg = dict(external_cond_type="action", keyframe_density=0.125, sliding_context_len=4,
               interpolation_max_batch_size=4)
    keys = TP.keyframe_indices(0.125, 72, 1)
    mask = np.zeros(72, bool)
    mask[keys] = True
    assert len(keys) == 9 and [len(r) for r in TP.interpolation_plan(mask, T)] == [8, 8]
    jro, jv, tro = uvit_rollouts(tiny_uvit, **cfg)
    xs = np.zeros((1, 72, R, R, 3), np.float32)
    xs[:, 0] = video(1, 1, 20)[:, 0]
    poses = moving_poses(1, 72, 21)
    hgs = [dict(guidance_scale=4.0, stabilization_level=0.02), dict(guidance_scale=1.5)]
    want = jro.predict_videos(jv, jax.random.PRNGKey(0), xs, 1, conditions=poses,
                              prediction_hg=JHG.HistoryGuidance.stabilized_vanilla(**hgs[0]),
                              interpolation_hg=JHG.HistoryGuidance.vanilla(**hgs[1]))
    got = tro.predict_videos(None, torch.as_tensor(xs), 1, conditions=torch.as_tensor(poses),
                             prediction_hg=THG.HistoryGuidance.stabilized_vanilla(**hgs[0]),
                             interpolation_hg=THG.HistoryGuidance.vanilla(**hgs[1]))
    frames_match(got, want)
    np.testing.assert_array_equal(got[:, 0].numpy(), xs[:, 0])
    stats_match(tro, jro)
    assert tro.stats["windows"] == 2 + 2 * 2
    assert tro.stats["keyframe_evals_b1"] == 2 * 3 * 2


def test_interpolate_videos_splits_chunks_across_groups(monkeypatch, tiny_uvit):
    """B = 2 with groups of 3 rows: the second round's 3 chunks make 6 rows,
    so a group boundary falls inside a chunk."""
    _pin_noise(monkeypatch)
    rounds = TP.interpolation_plan(np.eye(1, 16, 0, dtype=bool)[0] | np.eye(1, 16, 15,
                                                                            dtype=bool)[0], T)
    assert [len(r) for r in rounds] == [1, 3]
    jro, jv, tro = uvit_rollouts(tiny_uvit, external_cond_type="action",
                                 interpolation_max_batch_size=3)
    ctx = video(2, 16, 30)
    poses = moving_poses(2, 16, 31)
    hg = dict(guidance_scale=4.0)
    want = jro.interpolate_videos(jv, jax.random.PRNGKey(0), ctx, conditions=poses,
                                  history_guidance=JHG.HistoryGuidance.vanilla(**hg))
    got = tro.interpolate_videos(None, ctx, conditions=poses,
                                 history_guidance=THG.HistoryGuidance.vanilla(**hg))
    frames_match(got, want)
    np.testing.assert_array_equal(got[:, [0, 15]].numpy(), ctx[:, [0, 15]])
    stats_match(tro, jro)
    assert tro.stats["windows"] == 1 + 2


def test_interpolate_two_images_matches_jax(monkeypatch, tiny_uvit):
    """Config 2 at a tiny size: frames 0 and 7 known, the default mask,
    vanilla HG at 4.0, one window."""
    _pin_noise(monkeypatch)
    jro, jv, tro = uvit_rollouts(tiny_uvit, external_cond_type="action")
    ctx = video(1, T, 40)
    ctx[:, 1:-1] = 0.0
    poses = moving_poses(1, T, 41)
    want = jro.interpolate_videos(jv, jax.random.PRNGKey(0), ctx, conditions=poses,
                                  history_guidance=JHG.HistoryGuidance.vanilla(4.0))
    got = tro.interpolate_videos(None, ctx, conditions=poses,
                                 history_guidance=THG.HistoryGuidance.vanilla(4.0))
    frames_match(got, want)
    np.testing.assert_array_equal(got[:, [0, T - 1]].numpy(), ctx[:, [0, T - 1]])
    stats_match(tro, jro)
    assert tro.stats == {"denoiser_evals_b1": 6, "windows": 1, "interp_host_build_sec":
                         tro.stats["interp_host_build_sec"], "interp_device_wait_sec":
                         tro.stats["interp_device_wait_sec"]}


def test_scan_bucket_changes_nothing(monkeypatch, tiny_uvit):
    """Steps padded to a bucket of 16 (no-op rows the loop skips): the same
    samples and stats as no bucket, and as the JAX rollout's bucketed scan."""
    _pin_noise(monkeypatch)
    kw = dict(external_cond_type="action", sliding_context_len=4)
    jro, jv, bucketed = uvit_rollouts(tiny_uvit, scan_bucket=16, **kw)
    _, _, exact = uvit_rollouts(tiny_uvit, **kw)
    ctx, poses = video(1, 2, 50), moving_poses(1, 12, 51)
    hg = (4.0, 0.02)
    want = jro.predict_sequence(jv, jax.random.PRNGKey(0), jnp.asarray(ctx), length=12,
                                conditions=poses,
                                history_guidance=JHG.HistoryGuidance.stabilized_vanilla(*hg))
    outs = [ro.predict_sequence(None, ctx, length=12, conditions=poses,
                                history_guidance=THG.HistoryGuidance.stabilized_vanilla(*hg))
            for ro in (bucketed, exact)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert bucketed.stats == exact.stats == {"denoiser_evals_b1": 2 * 3 * 2, "windows": 2}
    frames_match(outs[0], want)
    stats_match(bucketed, jro)


# ---------------------------------------------------------------------------
# an analytic model: label conditions, causal windows, autoregressive matrix
# ---------------------------------------------------------------------------


def _j_model(v, x, noise_in, cond, cond_mask):
    out = jnp.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - 0.3 * cond_mask[:, None, None, None]
    if cond is not None:  # label (N, D) or action (N, T, D): its first channel
        out = out + 0.2 * cond[..., 0].reshape(x.shape[0], -1)[:, :, None, None]
    return out


def _t_model(x, noise_in, cond, cond_mask):
    out = torch.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - 0.3 * cond_mask[:, None, None, None]
    if cond is not None:
        out = out + 0.2 * cond[..., 0].reshape(x.shape[0], -1)[:, :, None, None]
    return out


def analytic_rollouts(**cfg_kw):
    dcfg = dataclasses.replace(small_dcfg(4), is_continuous=False)
    jro = JR.DFoTRollout(JR.RolloutConfig(max_tokens=T, x_shape=(4, 3), **cfg_kw),
                         jax_dcfg(dcfg), JDC.make_schedule(jax_dcfg(dcfg)), _j_model)
    tro = TR.DFoTRollout(TR.RolloutConfig(max_tokens=T, x_shape=(4, 3), **cfg_kw),
                         dcfg, TDC.make_schedule(dcfg, device="cpu"), _t_model)
    return jro, tro


def test_label_conditions_pass_whole(monkeypatch):
    """``label`` conditions (one vector a video) reach every keyframe and
    interpolation window whole."""
    _pin_noise(monkeypatch)
    jro, tro = analytic_rollouts(external_cond_type="label", keyframe_density=0.25,
                                 sliding_context_len=4, interpolation_max_batch_size=2)
    xs = np.zeros((2, 24, 4, 3), np.float32)
    xs[:, 0] = np.random.default_rng(60).standard_normal((2, 4, 3))
    labels = np.array([[1.0, 0.0, 2.0], [-1.0, 0.5, 0.0]], np.float32)
    hg = (JHG.HistoryGuidance.vanilla(2.0), THG.HistoryGuidance.vanilla(2.0))
    want = jro.predict_videos(None, jax.random.PRNGKey(0), xs, 1, conditions=labels,
                              prediction_hg=hg[0], interpolation_hg=hg[0])
    got = tro.predict_videos(None, xs, 1, conditions=labels, prediction_hg=hg[1],
                             interpolation_hg=hg[1])
    frames_match(got, want)
    stats_match(tro, jro)
    # the labels matter: other labels give other frames
    other = tro.predict_videos(None, xs, 1, conditions=-labels, prediction_hg=hg[1],
                               interpolation_hg=hg[1])
    assert rel_err(other, got) > CONTROL_MIN


def test_causal_autoregressive_predict_sequence(monkeypatch):
    """``use_causal_mask`` with ``chunk_size`` 2 and the ``autoregressive``
    (pyramid) matrix: windows of their own length, two new frames each."""
    _pin_noise(monkeypatch)
    jro, tro = analytic_rollouts(scheduling_matrix="autoregressive", use_causal_mask=True,
                                 chunk_size=2, external_cond_type="action",
                                 sliding_context_len=3)
    ctx = np.random.default_rng(70).standard_normal((1, 2, 4, 3)).astype(np.float32)
    conds = np.random.default_rng(71).standard_normal((1, 13, 2)).astype(np.float32)
    hg = (JHG.HistoryGuidance.stabilized_vanilla(3.0, 0.1),
          THG.HistoryGuidance.stabilized_vanilla(3.0, 0.1))
    want = jro.predict_sequence(None, jax.random.PRNGKey(0), jnp.asarray(ctx), length=13,
                                conditions=conds, history_guidance=hg[0])
    got = tro.predict_sequence(None, ctx, length=13, conditions=conds, history_guidance=hg[1])
    frames_match(got, want)
    stats_match(tro, jro)
    assert tro.stats["windows"] == len(TP.sliding_window_plan(2, 13, T, 3, 2, True)) == 6
