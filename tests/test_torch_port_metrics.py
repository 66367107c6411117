"""The port's metric suite (``dfot_tpu_torch/metrics``) against the JAX
package's (``dfot_tpu/metrics``), on the CPU.

The JAX networks' trees come from ``jax.eval_shape`` of their init, filled
with seeded random values (no norm scale at one, no statistic at zero), and
reach the port as the ``<name>.npz`` files the JAX registry reads
(``dfot_tpu/metrics/registry.py:33-43``) or through ``utils/weights.py``'s
converters; InceptionV3 goes the other way, through the JAX package's own
``import_inception_params(port.state_dict())``. The JAX registry's eager
``init`` (15-50 s a network on an 8-core CPU, only for the shape check of
a loaded file) is replaced by the shapes of that init with flax's initial
running statistics (``fast_jax_init``): the loaded file, the check and the
jitted apply are the JAX registry's own.

Tolerances: host copies in float64 (Frechet distance, Inception Score)
within 1e-10 relative; the resize within 1e-5 of the unit range; whole
networks in fp32 within 1e-4 relative L2 (convolutions chained 20-90 deep,
summed in other orders); ``VideoMetric.log`` within 1e-5 relative on the
frame-wise metrics and 1e-4 on the Frechet distances and the Inception
Score, whose features carry the networks' 1e-6 relative differences
through a matrix square root. Each network test has a control, a wrong
variant of the port, that must miss its bound by far.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfot_tpu.metrics import frechet as JFr
from dfot_tpu.metrics import registry as JR
from dfot_tpu.metrics.i3d import I3D as JI3D
from dfot_tpu.metrics.inception import InceptionV3 as JInception
from dfot_tpu.metrics.inception import import_inception_params
from dfot_tpu.metrics.inception import inception_preprocess as j_inception_preprocess
from dfot_tpu.metrics.video_metric import VideoMetric as JVideoMetric
from dfot_tpu.vae.losses import LPIPS as JLPIPS
from dfot_tpu_torch.metrics import frechet as TFr
from dfot_tpu_torch.metrics import i3d as TI3D
from dfot_tpu_torch.metrics.inception import InceptionV3, inception_preprocess
from dfot_tpu_torch.metrics.registry import SharedMetricModelRegistry, seeded_init
from dfot_tpu_torch.metrics.resize import resize
from dfot_tpu_torch.metrics.video_metric import VideoMetric
from dfot_tpu_torch.utils.weights import i3d_state_dict_from_flax

from torch_port_helpers import one_thread

HOST_RTOL = 1e-10
RESIZE_ATOL = 1e-5
NET_RTOL = 1e-4
FRAME_RTOL = 1e-5
FEATURE_RTOL = 1e-4
CONTROL_MIN = 1e-2
# the flagship's composed metric list
# (configurations/dataset_experiment/realestate10k_video_generation.yaml:35)
FLAGSHIP_METRICS = ("fvd", "is", "fid", "lpips", "mse", "ssim", "psnr")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seeded_tree(shapes, seed: int):
    """A flax tree of the given shapes, seeded random: kernels N(0, 2/fan_in)
    (He: a deep ReLU network's features then follow its input), norm scales
    1 + 0.2 N, variances U(0.5, 1.5), the rest 0.02 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name, shape = path[-1].key, tuple(v.shape)
        if name == "kernel":
            return (rng.standard_normal(shape) * np.sqrt(2 / np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "weight") and len(shape) == 1:
            return (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("var", "running_var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init_shapes(model, *args):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))


def flatten(tree, prefix=""):
    """A flax tree as the ``/``-joined ``.npz`` keys the JAX registry reads."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def fast_jax_init(mp, *classes):
    """Each class's ``init`` returns its init's shapes, zeros, with flax's
    initial running variances (ones): what the JAX registry keeps of an init
    when it loads a file."""
    for cls in classes:
        orig = cls.init

        def init(self, rng, *args, _orig=orig, **kw):
            shapes = jax.eval_shape(lambda: _orig(self, rng, *args, **kw))
            return jax.tree_util.tree_map_with_path(
                lambda p, s: jnp.ones(s.shape, s.dtype) if p[-1].key == "var"
                else jnp.zeros(s.shape, s.dtype), shapes)

        mp.setattr(cls, "init", init)


def videos(seed: int, shape):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + 0.15 * rng.standard_normal(shape), -0.1, 1.1).astype(np.float32)
    return pred, gt


@pytest.fixture(scope="module")
def trees():
    """name -> seeded JAX variables of the registry's networks."""
    x5 = jnp.zeros((1, 9, 64, 64, 3))
    x4 = jnp.zeros((1, 32, 32, 3))
    return {
        "i3d": seeded_tree(init_shapes(JI3D(), x5), 1),
        "lpips": seeded_tree(init_shapes(JLPIPS(), x4, x4), 2),
        "inception": seeded_tree(init_shapes(JInception(), jnp.zeros((1, 75, 75, 3))), 3),
    }


def write_npz(directory, name: str, params) -> str:
    path = os.path.join(directory, f"{name}.npz")
    np.savez(path, **flatten(params))
    return path


def jax_fallback_matrices(channels: int = 3):
    """The JAX registry's Inception-fallback draws (``registry.py:316-328``)."""
    key = jax.random.PRNGKey(42)
    w = jax.random.normal(key, (2 * channels, 2048)) / np.sqrt(2 * channels)
    w2 = jax.random.normal(jax.random.fold_in(key, 1), (16 * 16 * channels, 2048))
    return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(w2))


# ---------------------------------------------------------------------------
# host code and the resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", ["full", "deficient"])
def test_frechet_and_inception_score_match_jax(rank):
    rng = np.random.default_rng(5)
    n = 300 if rank == "full" else 12  # 12 samples of 64 dims: singular covariances
    got, want = TFr.FrechetDistance(64), JFr.FrechetDistance(64)
    for real, shift in ((True, 0.0), (False, 0.3), (True, 0.0), (False, 0.3)):
        f = rng.standard_normal((n // 2, 64)) * rng.uniform(0.5, 2.0, 64) + shift
        got.update(f, real)
        want.update(f, real)
    assert got.compute() == pytest.approx(want.compute(), rel=HOST_RTOL)
    s1, s2 = np.cov(rng.standard_normal((n, 64)).T), np.cov(rng.standard_normal((n, 64)).T)
    mu = rng.standard_normal(64)
    assert TFr.frechet_distance(mu, s1, 0 * mu, s2) == pytest.approx(
        JFr.frechet_distance(mu, s1, 0 * mu, s2), rel=HOST_RTOL)
    ti, ji = TFr.InceptionScore(), JFr.InceptionScore()
    for _ in range(2):
        logits = 3 * rng.standard_normal((n, 400))
        ti.update(logits)
        ji.update(logits)
    assert ti.compute() == pytest.approx(ji.compute(), rel=HOST_RTOL)


@pytest.mark.parametrize("method,n_in,n_out", [
    ("bilinear", 256, 299),  # inception_preprocess (inception.py:33)
    ("linear", 256, 16),     # the Inception fallback (registry.py:325)
    ("cubic", 256, 224),     # clip_preprocess / dino_preprocess (encoders.py:52)
    ("bilinear", 64, 256),   # the motion tracker's resolution (motion.py:205)
])
def test_resize_matches_jax_image_resize(method, n_in, n_out):
    x = np.random.default_rng(n_in + n_out).uniform(0, 1, (2, n_in, n_in, 3)).astype(np.float32)
    shape = (2, n_out, n_out, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, method))
    got = resize(torch.from_numpy(x), shape, method).numpy()
    assert np.abs(got - want).max() < RESIZE_ATOL
    # control: torch's own resize of the same name is another function
    mode = {"bilinear": "bilinear", "linear": "bilinear", "cubic": "bicubic"}[method]
    other = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), (n_out, n_out), mode=mode,
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    if n_out < n_in or method == "cubic":
        assert np.abs(other - want).max() > 10 * RESIZE_ATOL


# ---------------------------------------------------------------------------
# the frozen networks
# ---------------------------------------------------------------------------


def symmetric_pads(sizes, kernel, strides):
    """The control: ``padding=k // 2`` on both sides, as ``Conv3d(padding=3)``."""
    return tuple(p for k in reversed(kernel) for p in (k // 2, k // 2))


def test_i3d_matches_jax(trees, monkeypatch):
    variables = trees["i3d"]
    x = np.random.default_rng(6).uniform(0, 1, (2, 9, 64, 64, 3)).astype(np.float32)
    want_logits, want_feats = jax.jit(JI3D().apply)(variables, jnp.asarray(x))
    net = TI3D.I3D().eval()
    net.load_state_dict(i3d_state_dict_from_flax(variables["params"], variables["batch_stats"]),
                        strict=True)
    with torch.no_grad():
        logits, feats = net(torch.from_numpy(x))
    assert logits.shape == (2, 400) and feats.shape == (2, 1024)
    assert rel_err(logits, want_logits) < NET_RTOL
    assert rel_err(feats, want_feats) < NET_RTOL
    assert TI3D.same_pads((9, 64, 64), (7, 7, 7), (2, 2, 2)) == (2, 3, 2, 3, 3, 3)
    monkeypatch.setattr(TI3D, "same_pads", symmetric_pads)
    with torch.no_grad():
        control, _ = net(torch.from_numpy(x))
    assert rel_err(control, want_logits) > CONTROL_MIN


def test_inception_matches_jax_through_import_inception_params():
    net = InceptionV3().eval()
    g = torch.Generator().manual_seed(4)
    seeded_init(net, g)
    with torch.no_grad():  # He-scaled kernels, so that the features follow the input
        for name, p in net.named_parameters():
            if p.ndim == 4:
                p.mul_(2**0.5)
            elif name.endswith("bn.weight"):
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        for name, b in net.named_buffers():  # no statistic at its init value
            if name.endswith("running_mean"):
                b.copy_(0.02 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    params = import_inception_params({k: v.numpy() for k, v in net.state_dict().items()})
    x = np.random.default_rng(7).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want_pooled, want_logits = jax.jit(JInception().apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        pooled, logits = net(torch.from_numpy(x))
    assert pooled.shape == (2, 2048) and logits.shape == (2, 1008)
    assert rel_err(pooled, want_pooled) < NET_RTOL
    assert rel_err(logits, want_logits) < NET_RTOL
    assert rel_err(pooled[0], pooled[1]) > 2 * CONTROL_MIN  # the two frames' features differ
    # control: one BatchNorm statistic changed (the stem's running means)
    with torch.no_grad():
        net.Conv2d_1a_3x3.bn.running_mean.add_(0.5)
        control, _ = net(torch.from_numpy(x))
    assert rel_err(control, want_pooled) > CONTROL_MIN


def test_inception_preprocess_matches_jax():
    x = np.random.default_rng(8).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(j_inception_preprocess(jnp.asarray(x)))
    got = inception_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    assert np.abs(got - want).max() < 2 * RESIZE_ATOL


def test_inception_fallback_matches_jax_with_its_draws():
    """The registry's random-projection features without ``inception.npz``,
    with the JAX registry's two matrices put in; the port's own draws (a
    torch stream) are another map."""
    x = np.random.default_rng(9).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JR.SharedMetricModelRegistry().inception()(jnp.asarray(x)))
    reg = SharedMetricModelRegistry(device="cpu")
    fn = reg.inception()
    own = fn(torch.from_numpy(x)).numpy()
    assert reg.comparable == {"inception": False}
    reg.networks["inception"].matrices[3] = jax_fallback_matrices()
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 2048)
    assert rel_err(got, want) < FRAME_RTOL
    assert rel_err(own, want) > CONTROL_MIN


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _registry_case(name, trees, tmp_path):
    """(write the file, port input, JAX output) of one network."""
    rng = np.random.default_rng(10)
    if name == "i3d":
        v = trees["i3d"]
        write_npz(tmp_path, name, v["params"])
        x = rng.uniform(0, 1, (2, 9, 32, 32, 3)).astype(np.float32)
        # i3d.npz holds params only: the JAX registry applies flax's initial statistics
        stats = jax.tree_util.tree_map_with_path(
            lambda p, s: np.ones_like(s) if p[-1].key == "var" else np.zeros_like(s),
            v["batch_stats"])
        want = jax.jit(JI3D().apply)({"params": v["params"], "batch_stats": stats}, jnp.asarray(x))
        return (x,), want
    if name == "lpips":
        write_npz(tmp_path, name, trees["lpips"]["params"])
        a, b = (rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32) for _ in range(2))
        return (a, b), jax.jit(JLPIPS().apply)(trees["lpips"], jnp.asarray(a), jnp.asarray(b))
    if name == "inception":
        write_npz(tmp_path, name, trees["inception"]["params"])
        x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        want, _ = jax.jit(JInception().apply)(trees["inception"],
                                              j_inception_preprocess(jnp.asarray(x)))
        return (x,), want
    if name in ("clip_b32", "dino"):
        from dfot_tpu.metrics import encoders as JE

        model = JE.CLIPVisionEncoder(JE.CLIP_B32) if name == "clip_b32" else JE.DINOEncoder(JE.DINO_B16)
        x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        variables = seeded_tree(init_shapes(model, jnp.zeros((1, 224, 224, 3))), 11)
        write_npz(tmp_path, name, variables["params"])
        return (x,), jax.jit(model.apply)(variables, jnp.asarray(x))
    assert name == "laion"
    w = rng.standard_normal((1, 768)).astype(np.float32)
    b = rng.standard_normal((1,)).astype(np.float32)
    np.savez(os.path.join(tmp_path, "laion.npz"), weight=w, bias=b)
    feats = rng.standard_normal((3, 768)).astype(np.float32)
    return (feats,), feats @ w.T + b


REGISTRY_NETWORKS = ("i3d", "inception", "lpips", "clip_b32", "dino", "laion")


@pytest.fixture
def small_encoders(monkeypatch):
    """CLIP-B/32 and DINO at one narrow block in both packages (the registry
    path is the same at any width; CLIP and DINO at their widths are held in
    ``test_torch_port_vbench.py``)."""
    from dfot_tpu.metrics import encoders as JE
    from dfot_tpu_torch.metrics import encoders as TE

    for mod in (JE, TE):
        monkeypatch.setattr(mod, "CLIP_B32", mod.CLIPVisionConfig(
            patch_size=32, width=32, layers=1, heads=2, output_dim=8))
        monkeypatch.setattr(mod, "DINO_B16", mod.DINOConfig(patch_size=32, width=32, layers=1,
                                                             heads=2))


@pytest.mark.parametrize("name", REGISTRY_NETWORKS)
def test_registry_loads_the_jax_trees(name, trees, tmp_path, small_encoders):
    inputs, want = _registry_case(name, trees, tmp_path)
    reg = SharedMetricModelRegistry(str(tmp_path), device="cpu")
    got = getattr(reg, name)()(*(torch.from_numpy(x) for x in inputs))
    got = got[0] if name == "i3d" else got
    want = want[0] if name == "i3d" else want
    assert reg.comparable == {name: True}
    assert rel_err(got.numpy(), want) < NET_RTOL
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in reg.networks[name].parameters())


@pytest.mark.parametrize("name", REGISTRY_NETWORKS)
def test_registry_refuses_a_file_that_does_not_match(name, trees, tmp_path, small_encoders):
    _registry_case(name, trees, tmp_path)
    path = os.path.join(tmp_path, f"{name}.npz")
    flat = dict(np.load(path))
    first = sorted(flat)[0]
    flat[first] = np.zeros(flat[first].shape + (2,), np.float32)  # a wrong shape
    np.savez(path, **flat)
    reg = SharedMetricModelRegistry(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match=f"{path}.*does not match the {name} model"):
        getattr(reg, name)()


def _a15c_tree(name: str):
    """The JAX module's parameter tree (shapes by ``jax.eval_shape``, zeros)."""
    from dfot_tpu.metrics import amt, musiq, pips, raft

    x = jnp.zeros((1, 64, 64, 3))
    model, args = {"raft": (raft.RAFT(iters=1), (x, x)),
                   "amt": (amt.AMT_S(), (x, x, jnp.full((1,), 0.5))),
                   "pips": (pips.Pips(iters=1), (jnp.zeros((2, 4, 2)), jnp.zeros((2, 64, 64, 3)))),
                   "musiq": (musiq.MUSIQ(), (x,))}[name]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  init_shapes(model, *args)["params"])


@pytest.mark.parametrize("name", ["raft", "amt", "pips", "musiq"])
def test_a15c_networks_are_gated(name, tmp_path):
    """RAFT, AMT-S, PIPs2 and MUSIQ: None without their file, as in JAX (no
    random fallback); with the JAX tree's ``.npz`` they load, frozen on the
    registry's device; a file that does not match raises ``ValueError``.
    The networks are held to the JAX modules in ``test_torch_port_a15c.py``:
    upstream parity of RAFT, AMT-S and PIPs2 is not established (ROADMAP C3)."""
    reg = SharedMetricModelRegistry(str(tmp_path), device="cpu")
    assert getattr(reg, name)() is None and reg.comparable == {name: False}
    assert getattr(JR.SharedMetricModelRegistry(str(tmp_path)), name)() is None
    path = write_npz(tmp_path, name, _a15c_tree(name))
    reg = SharedMetricModelRegistry(str(tmp_path), device="cpu")
    assert callable(getattr(reg, name)()) and reg.comparable == {name: True}
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in reg.networks[name].parameters())
    flat = dict(np.load(path))
    first = sorted(flat)[0]
    flat[first] = np.zeros(flat[first].shape + (2,), np.float32)  # a wrong shape
    np.savez(path, **flat)
    with pytest.raises(ValueError, match=f"{path}.*does not match the {name} model"):
        getattr(SharedMetricModelRegistry(str(tmp_path), device="cpu"), name)()


# ---------------------------------------------------------------------------
# VideoMetric with the flagship's composed list
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def composed_logs(trees, tmp_path_factory):
    """``log()`` of the port's and the JAX package's VideoMetric over two
    batches of (2, 10, 32, 32, 3) videos, 4 context frames and one more,
    ``n_metrics_frames=8`` (8 frames, tiled to 9 for I3D); I3D and LPIPS from
    ``.npz`` files, Inception's fallback with JAX's draws."""
    wd = str(tmp_path_factory.mktemp("metric_weights"))
    write_npz(wd, "i3d", trees["i3d"]["params"])
    write_npz(wd, "lpips", trees["lpips"]["params"])
    treg = SharedMetricModelRegistry(wd, device="cpu")
    treg.inception()
    treg.networks["inception"].matrices[3] = jax_fallback_matrices()
    with pytest.MonkeyPatch.context() as mp:
        fast_jax_init(mp, JI3D, JLPIPS)
        jreg = JR.SharedMetricModelRegistry(wd)
        vt = VideoMetric(FLAGSHIP_METRICS, treg, n_metrics_frames=8)
        vj = JVideoMetric(FLAGSHIP_METRICS, jreg, n_metrics_frames=8)
        for seed in (12, 13):
            pred, gt = videos(seed, (2, 10, 32, 32, 3))
            ctx = np.zeros((2, 10), bool)
            ctx[:, :4] = True
            ctx[1, 6] = True
            vt.update(torch.from_numpy(pred), torch.from_numpy(gt), ctx)
            vj.update(pred, gt, ctx)
        return vt.log("validation/prediction"), vj.log("validation/prediction"), vt


def test_video_metric_composed_list_matches_jax(composed_logs):
    got, want, vt = composed_logs
    assert list(got) == list(want) == [f"validation/prediction/{m}" for m in (
        "mse", "psnr", "ssim", "lpips", "fvd", "fid_uncalibrated", "is_uncalibrated")]
    for k, v in want.items():
        rtol = FRAME_RTOL if k.rsplit("/", 1)[1] in ("mse", "psnr", "ssim", "lpips") else FEATURE_RTOL
        assert got[k] == pytest.approx(v, rel=rtol), k
    assert vt.log("x") == {}  # log() reset the accumulators
    assert set(vt.seconds) == {"mse", "psnr", "ssim", "lpips", "fvd", "fid", "fvd_host",
                               "fid_host", "is_host"}
