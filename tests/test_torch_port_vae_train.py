"""VAE training (``dfot_tpu_torch/vae/losses.py``,
``dfot_tpu_torch/experiments/video_latent_learning.py``) against the JAX
package's (``dfot_tpu/vae/losses.py``,
``dfot_tpu/experiments/video_latent_learning.py``).

- The losses, the adaptive weight, LPIPS and the PatchGAN discriminator on
  the same weights (``utils/weights.py``) and inputs, fp32 on the CPU,
  within 1e-5 relative (L2). The discriminator in training mode: its logits
  and the running statistics it keeps, which average flax's biased batch
  variance; a control with torch's ``BatchNorm2d`` (the unbiased variance)
  misses.
- The LPIPS loader against ``import_lpips_params`` on a state dict built
  here in torchvision's and ``lpips``'s names: bit for bit.
- ``run(argv, device="cpu")`` with ``experiment=video_latent_learning``, an
  ImageVAE and a VideoVAE at tiny widths on a seeded DMLab-layout directory,
  ``disc_start=1`` (the adversarial term from the second step on), three
  steps at batch 2, against ``main.run``: both start from the same weights
  (the JAX experiment's initial ones, carried over), the posterior noise is
  pinned on both sides. ``metrics.jsonl`` line by line within 1e-4
  relative, and the final autoencoder weights, all of them as one vector,
  within 1e-4 relative (L2). Leaf by leaf the decoder's biases are off by
  up to 2e-3 after the two adversarial steps: the adaptive weight divides by
  the norm of a gradient whose terms nearly cancel at these widths, and the
  two packages' fp32 sums round apart there (2.6e-4 relative on the second
  step, 1.5e-3 on the third), which Adam carries into every leaf the
  adversarial term reaches. Controls: ``disc_start`` moved by one, and the
  adaptive weight left out, each miss by more than ten times the bound.
- That drift is fp32 rounding: in float64 the first adversarial step agrees
  within 1e-10 (losses, ``d_weight``, every gradient leaf, the running
  statistics; read: 1.8e-15, 1.8e-16, 4.5e-14, 1.3e-16), and torch's
  ``BatchNorm2d`` or momentum 0.9 in the discriminator miss (6.0e-5, 0.15).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.experiments import video_latent_learning as JVL
from dfot_tpu.vae import distribution as JDist
from dfot_tpu.vae import image_vae as JIV
from dfot_tpu.vae import losses as JL
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.experiments import video_latent_learning as TVL
from dfot_tpu_torch.utils.weights import (
    discriminator_state_dict_from_flax,
    imagevae_state_dict_from_flax,
    lpips_state_dict_from_flax,
    videovae_state_dict_from_flax,
)
from dfot_tpu_torch.vae import distribution as TDist
from dfot_tpu_torch.vae import losses as TL

from test_torch_port_latent_cli import make_dmlab
from test_torch_port_train_cli import _lines
from test_torch_port_vae import randomize, rel_err
from torch_port_helpers import one_thread, pinned

RTOL = 1e-5
RUN_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


# ---------------------------------------------------------------------------
# losses and modules
# ---------------------------------------------------------------------------


def test_losses_match():
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal((4, 1, 3, 3)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        want = getattr(JL, name)(jnp.asarray(real), jnp.asarray(fake))
        assert rel_err(getattr(TL, name)(t(real), t(fake)), want) < RTOL
    for step, thr in ((4, 5), (5, 5), (6, 5)):
        assert TL.adopt_weight(0.5, step, thr) == float(JL.adopt_weight(0.5, step, thr))
    recon, target = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) for _ in range(2))
    kl = rng.uniform(0, 3, (2,)).astype(np.float32)
    aw = np.float32(0.7)
    for loss_type in ("l1", "l2"):
        want, wparts = JL.vae_generator_loss(
            jnp.asarray(recon), jnp.asarray(target), jnp.asarray(kl), jnp.asarray(fake),
            kl_weight=1e-3, disc_weight=0.5, loss_type=loss_type, adaptive_weight=jnp.asarray(aw))
        got, gparts = TL.vae_generator_loss(
            t(recon), t(target), t(kl), t(fake), kl_weight=1e-3, disc_weight=0.5,
            loss_type=loss_type, adaptive_weight=torch.tensor(aw))
        assert rel_err(got, want) < RTOL
        for k in wparts:
            assert rel_err(gparts[k], wparts[k]) < RTOL, k
    g1, g2 = (rng.standard_normal((3, 8, 3, 3)).astype(np.float32) for _ in range(2))
    want = JL.calculate_adaptive_weight(jnp.asarray(g1), jnp.asarray(g2))
    assert rel_err(TL.calculate_adaptive_weight(t(g1), t(g2)), want) < RTOL
    # clipped to 1e4
    assert float(TL.calculate_adaptive_weight(t(g1), t(g2) * 0)) == pytest.approx(1e4)
    for lt in ("hinge", "vanilla"):
        want = JL.vae_discriminator_loss(jnp.asarray(real), jnp.asarray(fake), 0.5, lt)
        assert rel_err(TL.vae_discriminator_loss(t(real), t(fake), 0.5, lt), want) < RTOL


def _disc_pair(seed=1):
    jd = JL.NLayerDiscriminator()
    x = np.zeros((2, 32, 32, 3), np.float32)
    v = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), x, True))  # every leaf drawn below
    params = randomize(v["params"], seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(seed).uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        v["batch_stats"])
    td = TL.NLayerDiscriminator()
    td.load_state_dict(discriminator_state_dict_from_flax(params, stats), strict=True)
    return jd, {"params": params, "batch_stats": stats}, td


def test_discriminator_and_its_running_statistics_match():
    jd, jv, td = _disc_pair()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    y = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    # as the JAX step: real, then fake on the updated statistics
    want_r, v1 = jd.apply(jv, jnp.asarray(x), True, mutable=["batch_stats"])
    want_f, v2 = jd.apply({"params": jv["params"], **v1}, jnp.asarray(y), True,
                          mutable=["batch_stats"])
    got_r, got_f = td(nchw(x), train=True), td(nchw(y), train=True)
    assert got_r.shape == nchw(want_r).shape == (3, 1, 4, 4)
    assert rel_err(got_r.detach(), nchw(want_r)) < RTOL
    assert rel_err(got_f.detach(), nchw(want_f)) < RTOL
    for n in (1, 2, 3):
        bn = getattr(td, f"bn{n}")
        for stat, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            assert rel_err(buf, v2["batch_stats"][f"bn{n}"][stat]) < RTOL, (n, stat)
    # the generator's pass: batch statistics, none kept
    before = {k: b.clone() for k, b in td.named_buffers()}
    td(nchw(x), train=True, update_stats=False)
    assert all(torch.equal(b, before[k]) for k, b in td.named_buffers())
    # eval mode: the running statistics
    want_e = jd.apply({"params": jv["params"], **v2}, jnp.asarray(x), False)
    assert rel_err(td(nchw(x)).detach(), nchw(want_e)) < RTOL
    # control: torch's BatchNorm2d keeps the unbiased variance (both keep
    # the last batch's statistics alone here: torch's momentum 1, flax's 0)
    bn = torch.nn.BatchNorm2d(4, momentum=1.0)
    h = torch.randn(3, 4, 2, 2)
    bn.train()(h)
    ours = TL.BatchNorm(4, momentum=0.0)
    ours(h, train=True)
    assert torch.allclose(bn.running_mean, ours.running_mean, atol=1e-6)
    torch.testing.assert_close(bn.running_var * 11 / 12, ours.running_var)
    assert rel_err(bn.running_var, ours.running_var) > 0.05


def test_lpips_matches():
    jm = JL.LPIPS()
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = randomize(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x))["params"], 3)
    tm = TL.LPIPS()
    tm.load_state_dict(lpips_state_dict_from_flax(params), strict=True)
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(a), jnp.asarray(b))
    got = tm(nchw(a), nchw(b))
    assert got.shape == (2,)
    assert rel_err(got.detach(), want) < RTOL


def test_lpips_loader_matches_import_lpips_params():
    rng = np.random.default_rng(5)
    vgg_state, cin = {}, 3
    for stage, j, idx in JL._VGG_TORCHVISION_IDX:
        cout = JL._VGG_SLICES[stage][1]
        vgg_state[f"features.{idx}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype(
            np.float32)
        vgg_state[f"features.{idx}.bias"] = rng.standard_normal(cout).astype(np.float32)
        cin = cout
    lin_state = {f"lin{i}.model.1.weight": rng.standard_normal((1, ch, 1, 1)).astype(np.float32)
                 for i, (_, ch) in enumerate(JL._VGG_SLICES)}
    want = lpips_state_dict_from_flax(JL.import_lpips_params(lin_state, vgg_state))
    got = TL.lpips_state_dict(lin_state, vgg_state)
    assert set(got) == set(want) == set(TL.LPIPS().state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the experiment through run(argv)
# ---------------------------------------------------------------------------

# two channels a GroupNorm group: with one, a conv bias before a norm has a
# gradient of zero and rounding alone, which Adam turns into steps of lr
IMAGE = ["algorithm=image_vae", "++algorithm.ddconfig.ch=64", "++algorithm.ddconfig.ch_mult=[1,2]",
         "++algorithm.ddconfig.num_res_blocks=1", "++algorithm.lossconfig.disc_start=1",
         "++algorithm.lossconfig.kl_weight=0.01"]
VIDEO = ["algorithm=video_vae", "++algorithm.model.hidden_size=64",
         "++algorithm.model.hidden_size_mult=[1,2]", "++algorithm.model.num_res_blocks=1",
         "++algorithm.model.z_channels=4", "++algorithm.loss.disc_start=1",
         "++algorithm.loss.kl_weight=0.01", "dataset.max_frames=5"]


def learning_argv(root, out, algo):
    return ["+name=vae", "dataset=dmlab", "experiment=video_latent_learning",
            f"dataset.save_dir={root}", "dataset.resolution=32", "dataset.max_frames=4",
            "++dataset.latent.enabled=false", "experiment.training.batch_size=2",
            "experiment.training.max_steps=3", "experiment.training.lr=1e-3",
            f"output_dir={out}"] + algo


def _pin_posterior(monkeypatch):
    """One fixed noise per shape on both sides (channel-last in JAX)."""
    monkeypatch.setattr(JDist.DiagonalGaussian, "sample",
                        lambda self, rng: self.mean
                        + self.std * jnp.asarray(pinned(self.mean.shape)))

    def port_sample(self, generator=None, eps=None):
        shape = (self.mean.shape[0], *self.mean.shape[2:], self.mean.shape[1])
        return self.mean + self.std * torch.from_numpy(pinned(shape)).movedim(-1, 1)

    monkeypatch.setattr(TDist.DiagonalGaussian, "sample", port_sample)


def _share_initial_weights(monkeypatch, is_video):
    """The JAX experiment's initial weights, kept to start the port's from."""
    store = {}
    real = JVL.VideoLatentLearningExperiment._init_states

    def init(self, rng, sample):
        ae, d, bn = real(self, rng, sample)
        store.update(ae=jax.device_get(ae.params), d=jax.device_get(d.params),
                     bn=jax.device_get(bn))
        return ae, d, bn

    monkeypatch.setattr(JVL.VideoLatentLearningExperiment, "_init_states", init)
    real_build = TVL.VideoLatentLearningExperiment._build_models

    def build(self):
        real_build(self)
        convert = videovae_state_dict_from_flax if is_video else imagevae_state_dict_from_flax
        self.vae.load_state_dict(convert(store["ae"]), strict=True)
        self.disc.load_state_dict(discriminator_state_dict_from_flax(store["d"], store["bn"]),
                                  strict=True)

    monkeypatch.setattr(TVL.VideoLatentLearningExperiment, "_build_models", build)
    return store


@pytest.fixture(scope="module")
def dmlab_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vae_train") / "dmlab")
    make_dmlab(root)
    return root


def _global_err(got, want):
    """Relative L2 error of all the weights as one vector."""
    return rel_err(torch.cat([got[k].flatten() for k in want]),
                   torch.cat([want[k].flatten() for k in want]))


def _metric_lines(run_dir):
    return [{k: v for k, v in line.items() if k != "time"} for line in _lines(run_dir)]


def _compare_runs(got_dir, want_dir, rtol):
    got, want = _metric_lines(got_dir), _metric_lines(want_dir)
    assert [x["step"] for x in got] == [x["step"] for x in want] == [1]
    bad = {}
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(
            ["step", "g_total", "d_total", "rec_loss", "kl_loss", "g_loss", "d_weight"])
        bad.update({k: (g[k], w[k]) for k in w if abs(g[k] - w[k]) > rtol * max(abs(w[k]), 1e-6)})
    return bad


@pytest.mark.parametrize("kind", ["image", "video"])
def test_training_matches_main(monkeypatch, tmp_path, dmlab_root, kind):
    is_video = kind == "video"
    algo = VIDEO if is_video else IMAGE
    _pin_posterior(monkeypatch)
    _share_initial_weights(monkeypatch, is_video)
    final = {}
    real_train = JVL.VideoLatentLearningExperiment.training

    def keep_final(self):
        real_train(self)
        final["ae"] = jax.device_get(self.ae_state.params)

    monkeypatch.setattr(JVL.VideoLatentLearningExperiment, "training", keep_final)
    jax_main.run(learning_argv(dmlab_root, tmp_path / "jax", algo))
    exp = run(learning_argv(dmlab_root, tmp_path / "port", algo), device="cpu")

    assert not _compare_runs(tmp_path / "port", tmp_path / "jax", RUN_RTOL)
    convert = videovae_state_dict_from_flax if is_video else imagevae_state_dict_from_flax
    want = convert(final["ae"])
    got = exp.vae.state_dict()
    assert set(got) == set(want)
    assert _global_err(got, want) < RUN_RTOL
    assert exp.ae_state.step == 3
    assert os.listdir(os.path.join(exp.output_dir, "checkpoints")) == ["checkpoint_3"]
    assert len(exp.timings["phases_s"]) == 3 and len(exp.timings["step_wall_s"]) == 3
    assert sorted(exp.timings["phases_s"][0]) == sorted(TVL.PHASES)

    # controls: disc_start one step later, and the adaptive weight left out
    def final_off(out, extra=()):
        exp = run(learning_argv(dmlab_root, out, algo + list(extra)), device="cpu")
        state = exp.vae.state_dict()
        return _global_err(state, want)

    key = "loss" if is_video else "lossconfig"
    assert final_off(tmp_path / "ctrl_start", [f"++algorithm.{key}.disc_start=2"]) > RUN_RTOL * 10
    monkeypatch.setattr(TVL, "calculate_adaptive_weight", lambda a, b: torch.ones(()))
    assert final_off(tmp_path / "ctrl_weight") > RUN_RTOL * 10


# ---------------------------------------------------------------------------
# the adaptive weight and the adversarial gradient in float64
# ---------------------------------------------------------------------------

F64_RTOL = 1e-10


def _f64_step_inputs(root):
    """The run test's first clip (the first two videos of its directory) and
    the IMAGE widths' models on seeded weights, for both packages."""
    from dfot_tpu.config import load_config as jax_load_config
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.data.loader import _collate
    from dfot_tpu_torch.data.video_dataset import build_dataset
    from dfot_tpu_torch.vae import image_vae as TIV

    argv = learning_argv(root, "unused", IMAGE)
    tcfg, jcfg = load_config(argv), jax_load_config(argv)
    videos = np.asarray(_collate([build_dataset(tcfg.dataset, "training")[i]
                                  for i in range(2)])["videos"], np.float64)
    frames = videos.reshape(-1, *videos.shape[2:])
    jvae_cfg = JIV.ImageVAEConfig.from_config(jcfg.algorithm)
    x0 = jnp.zeros((1,) + frames.shape[1:], jnp.float32)
    vparams = randomize(jax.eval_shape(lambda: JIV.ImageVAE(jvae_cfg).init(
        jax.random.PRNGKey(0), x0, jax.random.PRNGKey(1)))["params"], 21)
    jd, jv, _ = _disc_pair(22)
    tvae = TIV.ImageVAE(TIV.ImageVAEConfig.from_config(tcfg.algorithm))
    tvae.load_state_dict(imagevae_state_dict_from_flax(vparams), strict=True)
    tdisc = TL.NLayerDiscriminator()
    tdisc.load_state_dict(discriminator_state_dict_from_flax(jv["params"], jv["batch_stats"]),
                          strict=True)
    loss_cfg = dict(jcfg.algorithm.lossconfig.to_dict())
    return frames, jvae_cfg, vparams, jv, tvae.double(), tdisc.double(), loss_cfg


class TorchBatchNorm(torch.nn.BatchNorm2d):
    """torch's ``BatchNorm2d`` (it keeps the unbiased batch variance) at
    flax's momentum, called as the port's :class:`BatchNorm` is."""

    def __init__(self, channels: int):
        super().__init__(channels, momentum=0.01)

    def forward(self, x, train=False, update_stats=True):
        if train and not update_stats:
            return torch.nn.functional.batch_norm(x, None, None, self.weight, self.bias, True,
                                                  0.0, self.eps)
        self.train(train)
        return super().forward(x)


class _Float64Scores:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX ImageVAE's
    attention casts its scores to fp32 (``AttnBlock``), where the port's
    computes them at its input's width, fp32 and up."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_f64_step(frames, jvae_cfg, vparams, jv, loss_cfg, step):
    """The JAX experiment's own step in float64, SGD at rate 1 in place of
    Adam: the autoencoder's gradient is the parameters' change."""
    import optax

    from dfot_tpu.training.state import create_train_state

    f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
    exp = JVL.VideoLatentLearningExperiment.__new__(JVL.VideoLatentLearningExperiment)
    exp.vae = JIV.ImageVAE(jvae_cfg, dtype=jnp.float64)
    exp.disc = JL.NLayerDiscriminator(dtype=jnp.float64)
    exp.is_video, exp.loss_cfg = False, loss_cfg
    ae = create_train_state(f64(vparams), optax.sgd(1.0), use_ema=False)
    d = create_train_state(f64(jv["params"]), optax.sgd(1.0), use_ema=False)
    ae2, _, stats, metrics = exp._make_step()(ae, d, f64(jv["batch_stats"]),
                                             jnp.asarray(frames), jax.random.PRNGKey(3), step)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), ae.params, ae2.params)
    return {k: float(v) for k, v in metrics.items()}, grads, jax.device_get(stats)


def _port_f64_step(frames, tvae, tdisc, loss_cfg, step, disc=None):
    exp = TVL.VideoLatentLearningExperiment.__new__(TVL.VideoLatentLearningExperiment)
    exp.vae, exp.disc = tvae, disc or tdisc
    exp.is_video, exp.loss_cfg, exp.device = False, loss_cfg, torch.device("cpu")
    exp.ae_opt, exp.d_opt = (torch.optim.SGD(m.parameters(), lr=0.0) for m in (exp.vae, exp.disc))
    exp.generator = None
    videos = torch.from_numpy(frames).reshape(2, -1, *frames.shape[1:])
    metrics = exp.train_step(videos, step, [])
    grads = {n: p.grad.detach().clone() for n, p in exp.vae.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def test_adaptive_weight_and_adversarial_gradient_agree_in_float64(monkeypatch, dmlab_root):
    """ROADMAP.md C9: the drift between the packages' fp32 steps is fp32
    rounding, not a different computation. In float64 (JAX under
    ``jax.enable_x64``, the port in ``torch.float64``), on the run test's
    first clip and the IMAGE widths, the first adversarial step (the
    discriminator in training mode: batch-statistics BatchNorm in the
    autoencoder's loss) agrees within ``F64_RTOL``: every logged loss, the
    adaptive weight ``d_weight``, the autoencoder's gradient leaf by leaf,
    and the discriminator's running statistics after its update. The JAX
    ImageVAE's attention scores are taken at float64 too
    (:class:`_Float64Scores`). Controls,
    each off by more than a hundred times the bound: the port's BatchNorm
    with torch ``BatchNorm2d``'s unbiased running variance, and with
    momentum 0.9."""
    _pin_posterior(monkeypatch)
    monkeypatch.setattr(JIV, "jnp", _Float64Scores())
    frames, jvae_cfg, vparams, jv, tvae, tdisc, loss_cfg = _f64_step_inputs(dmlab_root)
    loss_cfg["disc_start"] = 1
    with jax.enable_x64(True):
        want, jgrads, jstats = _jax_f64_step(frames, jvae_cfg, vparams, jv, loss_cfg, 1)
    start = {k: v.clone() for k, v in tdisc.state_dict().items()}
    got, grads = _port_f64_step(frames, tvae, tdisc, loss_cfg, 1)
    assert want["d_weight"] > 0 and want["g_loss"] != 0
    assert sorted(got) == sorted(want)
    off = {k: (got[k], want[k]) for k in want
           if abs(got[k] - want[k]) > F64_RTOL * abs(want[k])}
    assert not off, off
    jg = imagevae_state_dict_from_flax(jgrads)
    assert set(jg) == set(grads)
    # the attention's key biases shift every score of a row alike: their
    # gradient is zero but for rounding, held against the whole gradient's norm
    scale = torch.cat([g.flatten() for g in jg.values()]).double().norm()
    leaves = {k: float((grads[k] - jg[k].double()).norm()
                       / (scale if k.endswith("k.bias") else jg[k].double().norm()))
              for k in jg}
    assert max(leaves.values()) < F64_RTOL, max(leaves.items(), key=lambda kv: kv[1])
    want_stats = discriminator_state_dict_from_flax(jv["params"], jstats)
    for k, v in tdisc.state_dict().items():
        if "running" in k:
            assert rel_err(v, want_stats[k].double()) < F64_RTOL, k

    # controls: the statistics the discriminator's update folds in
    def stats_off(make_bn):
        disc = TL.NLayerDiscriminator()
        for n in (1, 2, 3):
            setattr(disc, f"bn{n}", make_bn(getattr(disc, f"bn{n}").weight.numel()))
        disc.load_state_dict(start, strict=False)
        _port_f64_step(frames, tvae, tdisc, loss_cfg, 1, disc.double())
        return max(rel_err(v, want_stats[k].double()) for k, v in disc.state_dict().items()
                   if "running_var" in k)

    assert stats_off(TorchBatchNorm) > 100 * F64_RTOL
    assert stats_off(lambda c: TL.BatchNorm(c, momentum=0.9)) > 100 * F64_RTOL
