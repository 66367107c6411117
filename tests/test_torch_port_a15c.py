"""RAFT, AMT-S, PIPs2 and MUSIQ of the port (``dfot_tpu_torch/metrics/{raft,
amt,pips,musiq}.py``) against the JAX package's modules, on the CPU.

Upstream parity of RAFT, AMT-S and PIPs2 is not established: the JAX
package's checks against the upstream torch modules
(``tests/test_reference_parity.py``) need a reference checkout that the test
host lacks (ROADMAP.md C3), so these tests hold the port to the JAX modules
only, and MUSIQ's names to ``import_musiq_params``'s patterns.

Each network's JAX tree is ``jax.eval_shape`` of its init filled by
``seeded_tree`` (He-scaled kernels) and reaches the port through
``utils/weights.py:<net>_state_dict_from_flax``; the JAX side is one jitted
apply a network, shared by the tests of the module. Iterations and depth
are cut through the modules' own fields (``RAFT(iters=2)``, ``Pips(iters=5)``
so that ``beautify`` halves the last delta, ``MUSIQ(layers=2)``) at the
published widths, on small images. AMT-S's flow and image heads and PIPs2's
delta head are scaled down (0.1, 0.05) so that flows and tracks move a few
pixels, as trained networks' do: with the He-scaled heads the points run
30-60 pixels off a 64-pixel image, where the clamped samplers' steps turn
1e-6 differences into 5e-2 within five PIPs2 iterations.

Tolerances: every network in fp32 within 1e-4 relative L2 (convolutions
summed in other orders, carried through 2-5 iterations); the samplers and
resizes within 1e-5 absolute; the hash indices and masks bit for bit; the
VBench dimensions within 1e-5 relative; FVMD's tracks within 1e-4 and FVMD
within 1e-4 relative (a matrix square root of histograms of the tracks).
Each network has a control, a wrong variant of the port, that misses by far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfot_tpu.metrics import amt as JA
from dfot_tpu.metrics import musiq as JM
from dfot_tpu.metrics import pips as JP
from dfot_tpu.metrics import raft as JR
from dfot_tpu.metrics import registry as JReg
from dfot_tpu.metrics import vbench as JV
from dfot_tpu.metrics.video_metric import VideoMetric as JVideoMetric
from dfot_tpu_torch.metrics import amt as TA
from dfot_tpu_torch.metrics import musiq as TM
from dfot_tpu_torch.metrics import pips as TP
from dfot_tpu_torch.metrics import raft as TR
from dfot_tpu_torch.metrics import registry as TReg
from dfot_tpu_torch.metrics import vbench as TV
from dfot_tpu_torch.metrics.video_metric import VideoMetric
from dfot_tpu_torch.utils import weights as W

from test_torch_port_metrics import (  # noqa: F401 (_one_thread is an autouse fixture)
    CONTROL_MIN,
    NET_RTOL,
    _one_thread,
    fast_jax_init,
    flatten,
    init_shapes,
    rel_err,
    seeded_tree,
    write_npz,
)

SAMPLE_ATOL = 1e-5
VBENCH_RTOL = 1e-5
FVMD_RTOL = 1e-4
# heads scaled so that the flows and tracks move a few pixels (module docstring)
AMT_HEAD_SCALE = 0.1
PIPS_DELTA_SCALE = 0.05


def _scaled(tree, pattern: str, scale: float):
    """``tree`` with every kernel under a path containing ``pattern`` times ``scale``."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v * scale if p[-1].key == "kernel" and any(
            pattern in str(k.key) for k in p) else v, tree)


def _inputs(name: str):
    rng = np.random.default_rng({"raft": 1, "amt": 2, "pips": 3, "musiq": 4}[name])
    if name == "raft":  # two pairs at 128^2, the second image moved 3 px
        a = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
        return a, np.roll(a, 3, axis=2)
    if name == "amt":
        a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        return a, np.roll(a, 2, axis=1), np.full((2,), 0.5, np.float32)
    if name == "pips":  # 8 frames of 64^2, 16 query points
        pts = rng.uniform(4, 60, (16, 2)).astype(np.float32)
        return (np.broadcast_to(pts, (8, 16, 2)).copy(),
                rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32))
    return (rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32),)  # musiq: 3 scales, padded


_PORT = {"raft": (lambda: TR.RAFT(iters=2), W.raft_state_dict_from_flax),
         "amt": (TA.AMT_S, W.amt_state_dict_from_flax),
         "pips": (lambda: TP.Pips(iters=5), W.pips_state_dict_from_flax),
         "musiq": (lambda: TM.MUSIQ(layers=2), W.musiq_state_dict_from_flax)}
_JAX = {"raft": (lambda: JR.RAFT(iters=2), JR.import_raft_params),
        "amt": (JA.AMT_S, JA.import_amt_params),
        "pips": (lambda: JP.Pips(iters=5), JP.import_pips_params),
        "musiq": (lambda: JM.MUSIQ(layers=2), JM.import_musiq_params)}
NETS = tuple(_PORT)


class Case:
    """One network: the JAX module, its seeded params and jitted apply, the
    port's network on the same params, the inputs and JAX's output."""

    def __init__(self, name: str):
        self.name = name
        self.jax_model = _JAX[name][0]()
        args = _inputs(name)
        params = seeded_tree(init_shapes(self.jax_model, *map(jnp.asarray, args)), 5)["params"]
        if name == "amt":
            for head in ("block2", "flow_head_2", "comb_block_2"):
                params = _scaled(params, head, AMT_HEAD_SCALE)
        if name == "pips":
            params = _scaled(params, "dense", PIPS_DELTA_SCALE)
        self.params, self.args = params, args
        self.apply = jax.jit(self.jax_model.apply)
        self.want = np.asarray(self(*args))
        self.port = self.load(W.__dict__[f"{name}_state_dict_from_flax"](params))

    def __call__(self, *args):
        return self.apply({"params": self.params}, *map(jnp.asarray, args))

    def load(self, state):
        net = _PORT[self.name][0]()
        net.load_state_dict(state, strict=True)
        return net.eval().requires_grad_(False)

    def run(self, net=None, *args):
        with torch.no_grad():
            return (net or self.port)(*(torch.from_numpy(np.asarray(a)) for a in args or self.args))


@pytest.fixture(scope="module")
def cases():
    return {}


def case(cases, name: str) -> Case:
    if name not in cases:
        cases[name] = Case(name)
    return cases[name]


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------


def _swapped_offsets(radius, device):
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1)


def _unflipped_conv_transpose(c: Case):
    state = W.amt_state_dict_from_flax(c.params)
    for k in [k for k in state if k.endswith("convblock.2.weight")]:
        state[k] = state[k].flip(2, 3)
    return c.load(state)


def _symmetric_pads(sizes, kernel, strides):
    return tuple(p for k in reversed(kernel) for p in (k // 2, k // 2))


def _control(c: Case, monkeypatch) -> np.ndarray:
    """Each network's wrong variant: RAFT's and PIPs2's window offsets in
    (dx, dy) order, AMT-S's transposed convolutions without their flip,
    MUSIQ's stem padded (3, 3) and (1, 1) instead of flax's (2, 3) and (0, 1)."""
    if c.name == "raft":
        monkeypatch.setattr(TR, "window_offsets", _swapped_offsets)
        return c.run().numpy()
    if c.name == "amt":
        return c.run(_unflipped_conv_transpose(c)).numpy()
    if c.name == "pips":
        monkeypatch.setattr(TP, "window_offsets", _swapped_offsets)
        return c.run().numpy()
    monkeypatch.setattr(TM, "same_pads", _symmetric_pads)
    return c.run().numpy()


@pytest.mark.parametrize("name", NETS)
def test_network_matches_jax(name, cases, monkeypatch):
    """Upstream parity of RAFT, AMT-S and PIPs2 is not established (C3): the
    port is held to the JAX module on the same seeded tree."""
    c = case(cases, name)
    got = c.run().numpy()
    assert got.shape == c.want.shape and np.isfinite(got).all()
    assert rel_err(got, c.want) < NET_RTOL
    assert rel_err(_control(c, monkeypatch), c.want) > CONTROL_MIN


def test_pips_beautify_and_frame0(cases):
    """PIPs2's ``beautify`` halves the deltas after ``3 * iters // 4`` (the
    JAX module's, matched above, does): without it the tracks move off
    JAX's; frame 0 stays on the query points.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    c = case(cases, "pips")
    plain = TP.Pips(iters=5, beautify=False)
    plain.load_state_dict(c.port.state_dict())
    got = c.run(plain.eval()).numpy()
    moved = np.abs(c.want - c.args[0])[1:].mean()
    assert np.abs(got - c.want)[1:].mean() > 1e-2 * moved
    assert (c.run().numpy()[0] == c.args[0][0]).all()


@pytest.mark.parametrize("name", NETS)
def test_state_dict_round_trip(name, cases):
    """``import_<net>_params(port.state_dict())`` is the flax tree bit for bit,
    and so is the port's ``flax_tree_from_state_dict``; ``<net>_state_dict_
    from_flax`` of it is the port's state dict.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    c = case(cases, name)
    state = {k: v.numpy() for k, v in c.port.state_dict().items()}
    want = flatten(c.params)
    for back in (flatten(_JAX[name][1](state)),
                 flatten(W.flax_tree_from_state_dict(name, c.port.state_dict()))):
        assert sorted(back) == sorted(want)
        assert all(np.array_equal(back[k], want[k]) for k in want)
    again = _PORT[name][1](_JAX[name][1](state))
    assert sorted(again) == sorted(state)
    assert all(np.array_equal(again[k].numpy(), state[k]) for k in state)


# ---------------------------------------------------------------------------
# samplers, resizes and the tokenizer
# ---------------------------------------------------------------------------


def test_samplers_match_jax():
    """RAFT's sampler is ``grid_sample(align_corners=True, zeros)`` on a grid
    converted to [-1, 1]; PIPs2's clamps its indices and keeps raw weights,
    which differs from it past the edges; both equal JAX's.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((3, 9, 11, 4)).astype(np.float32)
    coords = rng.uniform(-3, 13, (3, 5, 6, 2)).astype(np.float32)
    got = TR.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    want = np.asarray(JR._bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    assert np.abs(got - want).max() < SAMPLE_ATOL
    grid = torch.from_numpy(coords) / torch.tensor([10.0, 8.0]) * 2 - 1
    gs = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), grid, align_corners=True,
                       padding_mode="zeros").permute(0, 2, 3, 1).numpy()
    assert np.abs(gs - want).max() < SAMPLE_ATOL
    x, y = coords[..., 0].reshape(3, -1), coords[..., 1].reshape(3, -1)
    got2 = TP.bilinear_sample2d(torch.from_numpy(img).permute(0, 3, 1, 2),
                                torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want2 = np.asarray(JP._bilinear_sample2d(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    assert np.abs(got2 - want2).max() < SAMPLE_ATOL
    assert np.abs(got2 - gs.reshape(3, -1, 4)).max() > 1.0  # not grid_sample outside the image
    small = rng.standard_normal((2, 4, 5, 7)).astype(np.float32)
    got3 = TP.resize_align_corners(torch.from_numpy(small), (3, 9)).numpy()
    want3 = np.asarray(JP._resize_align_corners(jnp.asarray(small).transpose(0, 2, 3, 1), (3, 9)))
    assert np.abs(got3.transpose(0, 2, 3, 1) - want3).max() < SAMPLE_ATOL


@pytest.mark.parametrize("scale", [2.0, 0.5, 0.25])
def test_amt_resize_matches_jax(scale):
    """AMT-S's ``linear`` resize without antialiasing, to ``round(H * scale)``.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    x = np.random.default_rng(8).standard_normal((2, 12, 20, 4)).astype(np.float32)
    want = np.asarray(JA._resize(jnp.asarray(x), scale))
    got = TA._resize(torch.from_numpy(x).permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < SAMPLE_ATOL
    if scale < 0.5:  # control: the antialiased resize widens the kernel when it shrinks
        aa = jax.image.resize(jnp.asarray(x), want.shape, "linear", antialias=True)
        assert np.abs(np.asarray(aa) - want).max() > 10 * SAMPLE_ATOL


@pytest.mark.parametrize("hw", [(64, 96), (200, 300), (256, 256)])
def test_multiscale_tokens_match_jax(hw):
    """MUSIQ's tokenizer: hash and scale indices and the mask bit for bit,
    the patches within 2 * 1e-5 (the resize's 1e-5 of the unit range, on
    [-1, 1]).
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    x = np.random.default_rng(9).uniform(-1, 1, (1,) + hw + (3,)).astype(np.float32)
    got = TM.multiscale_tokens(torch.from_numpy(x), 32, 10, (384, 224))
    want = JM.multiscale_tokens(jnp.asarray(x), 32, 10, (384, 224))
    assert got[0].shape == want[0].shape
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() < 2 * SAMPLE_ATOL
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the VBench dimensions and FVMD
# ---------------------------------------------------------------------------


def _amt_fns(c: Case):
    half = lambda a: np.full((a.shape[0],), 0.5, np.float32)  # noqa: E731
    return (lambda a, b: c.run(None, a, b, half(a)),
            lambda a, b: c(a, b, half(a)))


@pytest.mark.parametrize("dim", ["motion_smoothness", "dynamic_degree", "imaging_quality"])
def test_vbench_network_dims_match_jax(dim, cases):
    """The network-backed dimensions with each package's network injected,
    at the shapes of the network tests (so the jitted JAX applies are
    reused): AMT-S on one video of 5 frames at 64^2 (two even-frame pairs),
    RAFT on two 3-frame videos resized to 128^2 (``cv2.resize``), MUSIQ on
    one 2-frame video at 64 x 96.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    rng = np.random.default_rng(10)
    if dim == "motion_smoothness":
        c = case(cases, "amt")
        v = rng.uniform(0, 1, (1, 5, 64, 64, 3)).astype(np.float32)
        port_fn, jax_fn = _amt_fns(c)
        got, want = TV.motion_smoothness_amt(v, port_fn), JV.motion_smoothness_amt(v, jax_fn)
    elif dim == "dynamic_degree":
        c = case(cases, "raft")
        v = rng.uniform(0, 1, (2, 3, 40, 56, 3)).astype(np.float32)
        got = TV.dynamic_degree_raft(v, lambda a, b: c.run(None, a, b), resolution=128)
        want = JV.dynamic_degree_raft(v, c, resolution=128)
    else:
        c = case(cases, "musiq")
        v = rng.uniform(0, 1, (1, 2, 64, 96, 3)).astype(np.float32)
        got, want = TV.imaging_quality_musiq(v, lambda x: c.run(None, x)), \
            JV.imaging_quality_musiq(v, c)
    assert got == pytest.approx(want, rel=VBENCH_RTOL)


def _recording(reg, tracks: list):
    """``reg.pips()``'s tracker, recording the trajectories it returns."""
    track = reg.pips()

    def record(frames, pts0):
        out = np.asarray(track(frames, pts0))
        tracks.append(out)
        return out

    reg._models["pips"] = record


def test_video_metric_fvmd_with_pips_matches_jax(cases, tmp_path, monkeypatch):
    """``VideoMetric(["fvmd"])`` with ``pips.npz`` in both registries: two
    16-frame clips, PIPs2 at one iteration in both (the registries' 16 cut
    through the port's ``PIPS_ITERS`` and the JAX module's ``Pips``; the
    iterations are held above), at the tracker's 256^2 and 400 points (its
    histogram's 1024 features are laid out for them). The tracks within
    1e-4 relative L2; ``fvmd`` logged without ``_uncalibrated`` within 1e-4
    relative.
    Held to the JAX modules: upstream parity of RAFT, AMT-S and PIPs2 is
    not established (ROADMAP C3)."""
    c = case(cases, "pips")
    write_npz(tmp_path, "pips", c.params)
    monkeypatch.setattr(TReg, "PIPS_ITERS", 1)
    fast_jax_init(monkeypatch, JP.Pips)
    monkeypatch.setattr(JP, "Pips", lambda iters, _cls=JP.Pips: _cls(iters=1))
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    gt = np.concatenate([np.roll(base, t, axis=3) for t in range(16)], axis=1)
    pred = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    treg = TReg.SharedMetricModelRegistry(str(tmp_path), device="cpu")
    jreg = JReg.SharedMetricModelRegistry(str(tmp_path))
    got_tracks, want_tracks = [], []
    _recording(treg, got_tracks)
    _recording(jreg, want_tracks)
    vt, vj = VideoMetric(["fvmd"], treg), JVideoMetric(["fvmd"], jreg)
    vt.update(torch.from_numpy(pred), torch.from_numpy(gt))
    vj.update(pred, gt)
    got, want = vt.log("validation/prediction"), vj.log("validation/prediction")
    assert [t.shape for t in got_tracks] == [(16, 400, 2)] * 2
    assert rel_err(got_tracks, want_tracks) < NET_RTOL
    assert list(got) == list(want) == ["validation/prediction/fvmd"]
    assert got["validation/prediction/fvmd"] == pytest.approx(
        want["validation/prediction/fvmd"], rel=FVMD_RTOL)
    assert treg.comparable == jreg.comparable == {"pips": True, "fvmd": True}
