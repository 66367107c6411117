"""The port's VAEs (``dfot_tpu_torch/vae``) against the JAX package's.

Every module runs in fp32 on the CPU at a reduced width and depth, on the
same seeded numpy inputs. The JAX module's parameters are filled with seeded
random values (no norm left at one, no statistic at zero, so each one is
seen) and carried onto the port through ``utils/weights.py``'s converters;
the port's channel-first tensors are compared with the JAX channel-last
ones after a transpose.

Tolerances (relative L2): 1e-5 for the posterior's arithmetic and the
single blocks, 1e-4 for whole encoders and decoders, where convolutions and
norms chain and the two libraries sum in other orders (flax's GroupNorm
takes the variance as E[x^2] - mu^2, the port as E[(x - mu)^2]). Each test
has a control, a wrong variant of the port (a channel order, a pad on the
wrong side, an unclipped variance, ...), that must miss its bound by far.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.config import Config as JConfig
from dfot_tpu.vae import codec as JCodec
from dfot_tpu.vae import dc_ae as JDC
from dfot_tpu.vae import distribution as JDist
from dfot_tpu.vae import image_vae as JIV
from dfot_tpu.vae import stats as JS
from dfot_tpu.vae import video_vae as JVV
from dfot_tpu_torch.config import Config as TConfig
from dfot_tpu_torch.vae import codec as TCodec
from dfot_tpu_torch.vae import dc_ae as TDC
from dfot_tpu_torch.vae import distribution as TDist
from dfot_tpu_torch.vae import image_vae as TIV
from dfot_tpu_torch.vae import stats as TS
from dfot_tpu_torch.vae import video_vae as TVV
from dfot_tpu_torch.utils.weights import (
    dcae_state_dict_from_flax,
    imagevae_state_dict_from_flax,
    videovae_state_dict_from_flax,
)

from torch_port_helpers import pinned

EXACT_RTOL = 1e-5
MODEL_RTOL = 1e-4
CONTROL_MIN = 1e-2  # a control must miss by at least this (relative L2)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randomize(tree, seed: int):
    """Every leaf of a flax tree seeded random: kernels N(0, 1/fan_in),
    norm scales 1 + 0.2 N, running variances U(0.5, 1.5), the rest 0.2 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "weight"):
            return (1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name == "running_var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def ncthw(x):  # (B, T, H, W, C) -> (B, C, T, H, W)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 4, 1, 2, 3)))


def nthwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# DiagonalGaussian
# ---------------------------------------------------------------------------


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    params = rng.standard_normal((3, 4, 4, 8)).astype(np.float32) * 3
    params[0, 0, 0, 4:] = 40.0  # past the log-variance clip at 20
    params[1, 0, 0, 4:] = -40.0  # past the clip at -30
    other = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    jd = JDist.DiagonalGaussian.from_parameters(jnp.asarray(params))
    jo = JDist.DiagonalGaussian.from_parameters(jnp.asarray(other))
    td = TDist.DiagonalGaussian.from_parameters(torch.from_numpy(params), dim=-1)
    to = TDist.DiagonalGaussian.from_parameters(torch.from_numpy(other), dim=-1)
    pairs = {
        "mode": (td.mode(), jd.mode()),
        "kl": (td.kl(), jd.kl()),
        "kl other": (td.kl(to), jd.kl(jo)),
        "nll": (td.nll(torch.from_numpy(x)), jd.nll(jnp.asarray(x))),
        "sample": (td.sample(eps=torch.from_numpy(eps)), jd.mean + jd.std * eps),
    }
    for name, (got, want) in pairs.items():
        assert rel_err(got.numpy(), want) < EXACT_RTOL, name
    # the posterior in the port's channel-first layout: the same numbers
    tc = TDist.DiagonalGaussian.from_parameters(nchw(params), dim=1)
    assert rel_err(nhwc(tc.sample(eps=nchw(eps))), jd.mean + jd.std * eps) < EXACT_RTOL
    assert rel_err(tc.kl().numpy(), jd.kl()) < EXACT_RTOL
    # a drawn sample has the posterior's moments
    g = torch.Generator().manual_seed(0)
    wide = TDist.DiagonalGaussian(torch.zeros(200000), torch.full((200000,), np.log(4.0)))
    s = wide.sample(g)
    assert abs(float(s.mean())) < 0.02 and abs(float(s.std()) - 2.0) < 0.02
    # control: the log-variance left unclipped
    mean, logvar = torch.chunk(torch.from_numpy(params), 2, dim=-1)
    unclipped = TDist.DiagonalGaussian(mean, logvar)
    assert rel_err(unclipped.kl().numpy(), jd.kl()) > CONTROL_MIN


# ---------------------------------------------------------------------------
# DC-AE
# ---------------------------------------------------------------------------

SMALL_DCAE = JDC.DCAEConfig(
    latent_channels=8, attention_head_dim=8,
    encoder_block_out_channels=(16, 32, 32, 32), decoder_block_out_channels=(16, 32, 32, 32),
    encoder_layers_per_block=(0, 1, 2, 1), decoder_layers_per_block=(0, 1, 2, 1),
    encoder_qkv_multiscales=((), (), (), (5,)), decoder_qkv_multiscales=((), (), (), ()),
)


def dcae_pair(cfg=SMALL_DCAE, seed=0, res=32):
    jm = JDC.DCAE(cfg)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)))["params"],
                       seed)
    tm = TDC.DCAE(TDC.DCAEConfig(**vars(cfg)))
    tm.load_state_dict(dcae_state_dict_from_flax(params), strict=True)
    return jm, {"params": params}, tm.eval()


def test_dcae_encode_decode_match_jax():
    jm, jv, tm = dcae_pair()
    x = images((2, 32, 32, 3), 1)
    jz = jm.apply(jv, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        tz = tm.encode(nchw(x))
        ty = tm.decode(tz)
    assert tz.shape == (2, 8, 4, 4)
    assert rel_err(nhwc(tz), jz) < MODEL_RTOL
    jy = jm.apply(jv, jz, method=jm.decode)
    assert rel_err(nhwc(ty), jy) < MODEL_RTOL


def test_dcae_control_channel_order(monkeypatch):
    """The pixel shuffles in (r, r, C) channel order: encode misses."""
    jm, jv, tm = dcae_pair()
    x = images((2, 32, 32, 3), 1)
    jz = jm.apply(jv, jnp.asarray(x), method=jm.encode)

    def unshuffle_rrc(t, r=2):
        B, C, H, W = t.shape
        t = t.reshape(B, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4)
        return t.reshape(B, C * r * r, H // r, W // r)

    # the sound order is torch's own pixel_unshuffle
    ref = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    assert torch.equal(TDC.pixel_unshuffle(ref), torch.nn.functional.pixel_unshuffle(ref, 2))
    assert np.array_equal(nhwc(TDC.pixel_unshuffle(ref)),
                          np.asarray(JDC.pixel_unshuffle(jnp.asarray(nhwc(ref)))))
    monkeypatch.setattr(TDC, "pixel_unshuffle", unshuffle_rrc)
    with torch.no_grad():
        bad = tm.encode(nchw(x))
    assert rel_err(nhwc(bad), jz) > CONTROL_MIN


@pytest.mark.parametrize("norm_type", ["batch_norm", "rms_norm"])
@pytest.mark.parametrize("res", [2, 4])
def test_dcae_blocks_match_jax(norm_type, res):
    """SanaMultiscaleLinearAttention (the quadratic branch at 2 x 2, the
    linear one at 4 x 4, with a multiscale projection) and GLUMBConv under
    each norm type; control: the attention without its ReLU on q and k."""
    C, d = 32, 8
    x = images((2, res, res, C), 3)
    mods = {
        "attn": (JDC.SanaMultiscaleLinearAttention(C, C, attention_head_dim=d,
                                                   norm_type=norm_type, kernel_sizes=(3,)),
                 TDC.SanaMultiscaleLinearAttention(C, C, attention_head_dim=d,
                                                   norm_type=norm_type, kernel_sizes=(3,))),
        "glumb": (JDC.GLUMBConv(C, C, norm_type=norm_type),
                  TDC.GLUMBConv(C, C, norm_type=norm_type)),
    }
    for name, (jmod, tmod) in mods.items():
        params = randomize(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
        tmod.load_state_dict(dcae_state_dict_from_flax(params), strict=True)
        want = jmod.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = tmod(nchw(x))
        assert rel_err(nhwc(got), want) < EXACT_RTOL, name
    # control: q and k without their ReLU
    jattn, tattn = mods["attn"]
    params = randomize(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    want = jattn.apply({"params": params}, jnp.asarray(x))

    class NoReLU:
        relu = staticmethod(lambda t: t)

        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TDC, "F", NoReLU())
        bad = tattn(nchw(x))
    assert rel_err(nhwc(bad), want) > CONTROL_MIN


def test_dcae_state_dict_imports_into_flax_tree():
    """``import_dc_ae_params(port.state_dict())`` rebuilds the flax tree:
    every name and value held; control: a port name renamed is missed."""
    jm, jv, tm = dcae_pair()
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    tree = JDC.import_dc_ae_params(state)
    flat = lambda t: {"/".join(str(p.key) for p in path): np.asarray(v)  # noqa: E731
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    got, want = flat(tree), flat(jv["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    renamed = {k.replace("conv_inverted", "conv_expand"): v for k, v in state.items()}
    assert sorted(flat(JDC.import_dc_ae_params(renamed))) != sorted(want)


# ---------------------------------------------------------------------------
# ImageVAE and VideoVAE
# ---------------------------------------------------------------------------

SMALL_IMAGE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                   resolution=16, z_channels=4, embed_dim=4)


def image_pair(seed=0):
    cfg = JIV.ImageVAEConfig(**SMALL_IMAGE)
    jm = JIV.ImageVAE(cfg)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = randomize(jm.init(jax.random.PRNGKey(0), x0, jax.random.PRNGKey(1))["params"],
                       seed)
    tm = TIV.ImageVAE(TIV.ImageVAEConfig(**SMALL_IMAGE))
    tm.load_state_dict(imagevae_state_dict_from_flax(params), strict=True)
    return jm, {"params": params}, tm.eval()


def test_image_vae_matches_jax(monkeypatch):
    jm, jv, tm = image_pair()
    x = images((2, 16, 16, 3), 5)
    jpost = jm.apply(jv, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        tpost = tm.encode(nchw(x))
        ty = tm.decode(tpost.mode())
    assert rel_err(nhwc(tpost.mode()), jpost.mode()) < MODEL_RTOL
    assert rel_err(nhwc(tpost.logvar), jpost.logvar) < MODEL_RTOL
    jy = jm.apply(jv, jpost.mode(), method=jm.decode)
    assert rel_err(nhwc(ty), jy) < MODEL_RTOL

    # control: the downsample's pad on the top and left
    def pad_top_left(self, x):
        return self.conv(torch.nn.functional.pad(x, (1, 0, 1, 0)))

    monkeypatch.setattr(TIV.Downsample, "forward", pad_top_left)
    with torch.no_grad():
        bad = tm.encode(nchw(x)).mode()
    assert rel_err(nhwc(bad), jpost.mode()) > CONTROL_MIN


SMALL_VIDEO = dict(hidden_size=32, hidden_size_mult=(1, 2, 2), num_res_blocks=1,
                   z_channels=4, embed_dim=4, resolution=16)


def video_pair(seed=0):
    jm = JVV.VideoVAE(JVV.VideoVAEConfig(**SMALL_VIDEO))
    x0 = jnp.zeros((1, 5, 16, 16, 3))
    params = randomize(jm.init(jax.random.PRNGKey(0), x0, jax.random.PRNGKey(1))["params"],
                       seed)
    tm = TVV.VideoVAE(TVV.VideoVAEConfig(**SMALL_VIDEO))
    tm.load_state_dict(videovae_state_dict_from_flax(params), strict=True)
    return jm, {"params": params}, tm.eval()


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_video_vae_matches_jax(monkeypatch, frames):
    jm, jv, tm = video_pair()
    x = images((2, frames, 16, 16, 3), 6)
    jpost = jm.apply(jv, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        tpost = tm.encode(ncthw(x))
        ty = tm.decode(tpost.mode())
    assert tpost.mean.shape == (2, 4, 1 + (frames - 1) // 4, 4, 4)
    assert rel_err(nthwc(tpost.mode()), jpost.mode()) < MODEL_RTOL
    jy = jm.apply(jv, jpost.mode(), method=jm.decode)
    assert ty.shape == (2, 3, frames, 16, 16)
    assert rel_err(nthwc(ty), jy) < MODEL_RTOL
    if frames == 1:
        return

    # control: the causal pad on the wrong (right) side
    def pad_right(self, x):
        if self.pad_t:
            x = torch.cat([x, x[:, :, -1:].expand(-1, -1, self.pad_t, -1, -1)], dim=2)
        return self.conv(x)

    monkeypatch.setattr(TVV.CausalConv3d, "forward", pad_right)
    with torch.no_grad():
        bad = tm.encode(ncthw(x)).mode()
    assert rel_err(nthwc(bad), jpost.mode()) > CONTROL_MIN


# ---------------------------------------------------------------------------
# LatentCodec
# ---------------------------------------------------------------------------


def codec_cfgs(vae: dict, latent: dict, resolution: int):
    algo = {"vae": vae}
    data = {"latent": latent, "resolution": resolution}
    return (JConfig(algo), JConfig(data)), (TConfig(algo), TConfig(data))


def _pin_posterior(monkeypatch):
    """Both packages' posteriors sample the pinned noise of each shape."""
    monkeypatch.setattr(JDist.DiagonalGaussian, "sample",
                        lambda self, rng: self.mean + self.std * pinned(self.mean.shape))

    def port_sample(self, generator=None, eps=None):
        # channel-first in the port: the JAX channel-last draw, moved
        shape = (self.mean.shape[0],) + tuple(self.mean.shape[2:]) + (self.mean.shape[1],)
        eps = torch.from_numpy(np.ascontiguousarray(np.moveaxis(pinned(shape), -1, 1)))
        return self.mean + self.std * eps

    monkeypatch.setattr(TDist.DiagonalGaussian, "sample", port_sample)


def test_codec_dc_ae_matches_jax(tmp_path):
    """The DC-AE branch, both packages loading one ``.pth`` of the port's
    state-dict names; the port chunked (4 chunks of 8 frames) against
    unchunked; control: a named weight file that is absent raises."""
    _, jv, _ = dcae_pair()
    path = str(tmp_path / "dcae.pth")
    torch.save(dcae_state_dict_from_flax(jv["params"]), path)
    small = {k: list(v) if isinstance(v, tuple) else v for k, v in vars(SMALL_DCAE).items()}
    vae = {"name": "dc_ae_preprocessor", "pretrained_path": path, "batch_size": 1, **small}
    latent = {"downsampling_factor": [1, 8], "num_channels": 8}
    (ja, jd), (ta, td) = codec_cfgs(vae, latent, 32)
    jc = JCodec.LatentCodec(ja, jd)
    tc = TCodec.LatentCodec(ta, td, device="cpu")
    assert tc.pretrained and tc.deterministic
    videos = np.random.default_rng(7).uniform(0, 1, (2, 16, 32, 32, 3)).astype(np.float32)
    jz = jc.encode_video(videos, jax.random.PRNGKey(0))
    tz = tc.encode_video(videos)
    assert tz.shape == (2, 16, 4, 4, 8)
    assert rel_err(tz.numpy(), jz) < MODEL_RTOL
    whole = TCodec.LatentCodec(ta, td, batch_size=4, device="cpu")
    assert rel_err(whole.encode_video(videos).numpy(), tz.numpy()) < EXACT_RTOL
    ty = tc.decode_video(tz)
    assert rel_err(ty.numpy(), jc.decode_video(jnp.asarray(tz.numpy()))) < MODEL_RTOL
    assert rel_err(whole.decode_video(tz).numpy(), ty.numpy()) < EXACT_RTOL
    assert float(ty.min()) >= 0.0 and float(ty.max()) <= 1.0
    # a seeded random VAE without a path, the same on every build
    (_, _), (ta0, td0) = codec_cfgs({**vae, "pretrained_path": None}, latent, 32)
    r1 = TCodec.LatentCodec(ta0, td0, device="cpu")
    r2 = TCodec.LatentCodec(ta0, td0, device="cpu")
    assert not r1.pretrained
    assert torch.equal(r1.encode_video(videos[:1]), r2.encode_video(videos[:1]))
    (_, _), (tam, tdm) = codec_cfgs({**vae, "pretrained_path": str(tmp_path / "gone.pth")},
                                    latent, 32)
    with pytest.raises(FileNotFoundError, match="gone.pth"):
        TCodec.LatentCodec(tam, tdm, device="cpu")


@pytest.mark.parametrize("kind", ["image", "video"])
def test_codec_kl_vaes_match_jax(monkeypatch, kind):
    """The ImageVAE (per-frame, chunks of 8 frames) and VideoVAE (whole
    batch) branches with the posterior noise pinned on both sides; the JAX
    codec given the same parameters; control: the port without the pin
    (its own draws) misses."""
    if kind == "image":
        vae, latent, frames = {"name": "image_vae", "ch": 32, "batch_size": 1}, \
            {"downsampling_factor": [1, 4], "num_channels": 4}, 10
        jm = JIV.ImageVAE(JIV.ImageVAEConfig(ch=32, ch_mult=(1, 2, 4), z_channels=4,
                                             embed_dim=4, resolution=16))
        x0 = jnp.zeros((1, 16, 16, 3))
        convert = imagevae_state_dict_from_flax
    else:
        vae, latent, frames = {"name": "video_vae", "hidden_size": 32, "batch_size": 1}, \
            {"downsampling_factor": [4, 4], "num_channels": 4}, 9
        jm = JVV.VideoVAE(JVV.VideoVAEConfig(hidden_size=32, hidden_size_mult=(1, 2, 4),
                                             z_channels=4, embed_dim=4, resolution=16))
        x0 = jnp.zeros((1, 5, 16, 16, 3))
        convert = videovae_state_dict_from_flax
    params = randomize(jm.init(jax.random.PRNGKey(0), x0, jax.random.PRNGKey(1))["params"], 8)
    (ja, jd), (ta, td) = codec_cfgs(vae, latent, 16)
    jc = JCodec.LatentCodec(ja, jd)
    jc.variables = {"params": params}
    tc = TCodec.LatentCodec(ta, td, device="cpu")
    tc.vae.load_state_dict(convert(params), strict=True)
    videos = np.random.default_rng(9).uniform(0, 1, (2, frames, 16, 16, 3)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    unpinned = tc.encode_video(videos, g)
    with monkeypatch.context() as mp:
        _pin_posterior(mp)
        jz = np.asarray(jc.encode_video(videos, jax.random.PRNGKey(0)))
        tz = tc.encode_video(videos, g)
    assert tz.shape == jz.shape
    assert rel_err(tz.numpy(), jz) < MODEL_RTOL
    assert rel_err(tc.decode_video(tz).numpy(), jc.decode_video(jnp.asarray(jz))) < MODEL_RTOL
    assert rel_err(unpinned.numpy(), jz) > CONTROL_MIN


# ---------------------------------------------------------------------------
# latent statistics
# ---------------------------------------------------------------------------


def test_latent_stats_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    paths = []
    for i in range(3):
        arr = (rng.standard_normal((5 + i, 4, 4, 6)) * np.arange(1, 7) + np.arange(6)) \
            .astype(np.float16)
        paths.append(str(tmp_path / f"v{i}.npy"))
        np.save(paths[-1], arr)
    tm, tsd = TS.estimate_latent_stats(paths)
    jm, jsd = JS.estimate_latent_stats(paths)
    assert tm.dtype == np.float32 and tm.shape == (6,)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tsd, jsd)
    one_m, _ = TS.estimate_latent_stats(paths, max_files=1)
    assert rel_err(one_m, jm) > CONTROL_MIN  # control: the first file alone
