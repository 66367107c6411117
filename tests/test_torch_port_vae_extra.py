"""TiTok-KL, the diffusers kl-f8 AutoencoderKL and their preprocessors in the
port (``dfot_tpu_torch/vae/titok.py``, ``vae/autoencoder_kl.py``,
``experiments/video_latent_preprocessing.py``) against the JAX package.

- TiTokKL at tiny widths (a ViT of width 64, one or two layers, 32 px, 4
  latent tokens; a MaskGIT pixel decoder of 32 channels) on seeded random
  weights: the port's ``state_dict()`` through ``import_titok_params`` gives
  the JAX module its weights; the posterior and the decoded image within
  1e-5 relative (L2), fp32 on the CPU; ``titok_state_dict_from_flax`` is its
  inverse, bit for bit.
- The kl-f8 loader: a diffusers-named state dict (1x1-conv and linear
  attention projections alike) through the port's ``diffusers_state_dict``
  and through ``import_diffusers_vae_params`` + ``imagevae_state_dict_from_flax``:
  the same tensors, bit for bit; a name neither knows raises in both.
- Both preprocessors through ``run(argv, device="cpu")`` and ``main.run`` on
  a seeded DMLab-layout directory with the same weight files: every latent
  file and both statistics files within 1e-4 relative (fp16 files).
  TiTok's latents are its tokens in [0, 1] input; kl-f8's are posterior
  modes, (T, H/f, W/f, 4). The kl-f8 preprocessor with a hub name and no
  local file warns and keeps random weights, as the JAX package's; a
  ``pretrained_path`` the disk lacks raises.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.vae import autoencoder_kl as JAK
from dfot_tpu.vae import titok as JT
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.utils.weights import imagevae_state_dict_from_flax, titok_state_dict_from_flax
from dfot_tpu_torch.vae import autoencoder_kl as TAK
from dfot_tpu_torch.vae import image_vae as TIV
from dfot_tpu_torch.vae import titok as TT

from test_torch_port_latent_cli import make_dmlab
from test_torch_port_vae import rel_err
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


RTOL = 1e-5
FILE_RTOL = 1e-4
RES = 32
TITOK = dict(image_size=RES, token_size=4, vit_enc_patch_size=8, vit_dec_patch_size=8,
             num_latent_tokens=4, pixel_hidden_channels=32, pixel_channel_mult=(1, 1, 2, 2),
             pixel_num_res_blocks=1, pixel_z_channels=32, pixel_quantize_dim=64,
             vit_override=(64, 2, 2))
KL_DD = dict(double_z=True, z_channels=4, resolution=RES, in_channels=3, out_ch=3, ch=64,
             ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)


def randomized(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter seeded random: weights N(0, 1/fan_in), norm weights
    1 + 0.1 N, the rest 0.1 N."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim >= 2 and not name.endswith("embedding") and "token" not in name:
                p.copy_(r / np.sqrt(np.prod(p.shape[1:])))
            elif p.ndim == 1 and name.endswith("weight"):
                p.copy_(1 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return model.eval()


def _np_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# TiTok-KL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers", [1, 2])
def test_titok_matches(layers):
    kw = dict(TITOK, vit_override=(64, layers, 2))
    pm = randomized(TT.TiTokKL(TT.TiTokConfig(**kw)), seed=layers)
    params = JT.import_titok_params(_np_state(pm))
    jm = JT.TiTokKL(JT.TiTokConfig(**kw))
    x = np.random.default_rng(0).uniform(0, 1, (2, RES, RES, 3)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.mean.shape == want.mean.shape == (2, 4, 4)
    assert rel_err(got.mean, want.mean) < RTOL and rel_err(got.logvar, want.logvar) < RTOL
    z = np.random.default_rng(1).standard_normal((2, 4, 4)).astype(np.float32)
    want_img = jm.apply({"params": params}, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        got_img = pm.decode(torch.from_numpy(z))
    assert got_img.shape == (2, 3, RES, RES)
    assert rel_err(got_img.permute(0, 2, 3, 1), want_img) < RTOL
    # the flax -> port converter is the importer's inverse
    back = titok_state_dict_from_flax(jax.device_get(params))
    state = pm.state_dict()
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


# ---------------------------------------------------------------------------
# kl-f8 diffusers loader
# ---------------------------------------------------------------------------


def _diffusers_names(cfg: TIV.ImageVAEConfig, linear_attention: bool):
    """Random values under diffusers' AutoencoderKL names for a layout,
    shapes from the port's module."""
    shapes = {k: v.shape for k, v in TIV.ImageVAE(cfg).state_dict().items()}
    n = len(cfg.ch_mult)
    rng = np.random.default_rng(7)
    out = {}

    def put(name, port):
        shape = shapes[port]
        if not linear_attention and ".mid_attn." in port and port.endswith("weight") \
                and len(shape) == 2:
            shape = (*shape, 1, 1)
        out[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    res_leaves = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
                  "conv_shortcut": "nin_shortcut"}
    attn = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out", "group_norm": "norm"}
    for side in ("encoder", "decoder"):
        for leaf in ("weight", "bias"):
            put(f"{side}.conv_in.{leaf}", f"{side}.conv_in.{leaf}")
            put(f"{side}.conv_out.{leaf}", f"{side}.conv_out.{leaf}")
            put(f"{side}.conv_norm_out.{leaf}", f"{side}.norm_out.{leaf}")
            for j in (0, 1):
                for d, p in res_leaves.items():
                    if f"{side}.mid_block_{j + 1}.{p}.{leaf}" in shapes:
                        put(f"{side}.mid_block.resnets.{j}.{d}.{leaf}",
                            f"{side}.mid_block_{j + 1}.{p}.{leaf}")
            for d, p in attn.items():
                put(f"{side}.mid_block.attentions.0.{d}.{leaf}", f"{side}.mid_attn.{p}.{leaf}")
            for i in range(n):
                for j in range(cfg.num_res_blocks + 1):
                    for d, p in res_leaves.items():
                        if f"encoder.down_{i}_{j}.{p}.{leaf}" in shapes and side == "encoder":
                            put(f"encoder.down_blocks.{i}.resnets.{j}.{d}.{leaf}",
                                f"encoder.down_{i}_{j}.{p}.{leaf}")
                        if f"decoder.up_{i}_{j}.{p}.{leaf}" in shapes and side == "decoder":
                            put(f"decoder.up_blocks.{n - 1 - i}.resnets.{j}.{d}.{leaf}",
                                f"decoder.up_{i}_{j}.{p}.{leaf}")
                if side == "encoder" and i != n - 1:
                    put(f"encoder.down_blocks.{i}.downsamplers.0.conv.{leaf}",
                        f"encoder.downsample_{i}.conv.{leaf}")
                if side == "decoder" and i != 0:
                    put(f"decoder.up_blocks.{n - 1 - i}.upsamplers.0.conv.{leaf}",
                        f"decoder.upsample_{i}.conv.{leaf}")
    for leaf in ("weight", "bias"):
        put(f"quant_conv.{leaf}", f"quant_conv.{leaf}")
        put(f"post_quant_conv.{leaf}", f"post_quant_conv.{leaf}")
    assert len(out) == len(shapes)
    return out


def _kl_cfg():
    return TIV.ImageVAEConfig(**{**KL_DD, "ch_mult": (1, 2), "attn_resolutions": (),
                                 "embed_dim": 4})


@pytest.mark.parametrize("linear_attention", [True, False])
def test_kl_f8_loader_matches_import_diffusers_vae_params(linear_attention):
    state = _diffusers_names(_kl_cfg(), linear_attention)
    want = imagevae_state_dict_from_flax(
        JAK.import_diffusers_vae_params({k: v.numpy() for k, v in state.items()}))
    got = TAK.diffusers_state_dict(state)
    assert set(got) == set(want) == set(TIV.ImageVAE(_kl_cfg()).state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    TAK.AutoencoderKL(_kl_cfg()).load_state_dict(got, strict=True)
    bad = {**state, "encoder.no_such.weight": state["quant_conv.weight"]}
    with pytest.raises(KeyError):
        TAK.diffusers_state_dict(bad)
    with pytest.raises(KeyError):
        JAK.import_diffusers_vae_params({k: v.numpy() for k, v in bad.items()})


def test_kl_f8_config():
    c = TAK.KL_F8_CONFIG
    assert c == TIV.ImageVAEConfig(**{f: getattr(JAK.KL_F8_CONFIG, f) for f in
                                      TIV.ImageVAEConfig.__dataclass_fields__})
    assert c.downsampling_factor == 8 and c.embed_dim == 4
    assert TAK.AutoencoderKL().cfg == c


# ---------------------------------------------------------------------------
# the preprocessors through run(argv)
# ---------------------------------------------------------------------------


def _list(v):
    return "[" + ",".join(str(x) for x in v) + "]"


def _argv(root, out, algo):
    return ["+name=pre", "dataset=dmlab", "experiment=video_latent_preprocessing",
            f"dataset.save_dir={root}", f"dataset.resolution={RES}", "dataset.max_frames=4",
            f"output_dir={out}"] + algo


def _titok_args(pth):
    return ["algorithm=titok_kl_preprocessor", f"algorithm.pretrained_path={pth}"] + [
        f"++algorithm.{k}={_list(v) if isinstance(v, tuple) else v}" for k, v in TITOK.items()]


def _kl_args(pth=None):
    args = ["algorithm=kl_autoencoder_preprocessor", "++algorithm.embed_dim=4"] + [
        f"++algorithm.ddconfig.{k}={_list(v) if isinstance(v, list) else v}"
        for k, v in KL_DD.items()]
    return args + ([f"algorithm.pretrained_path={pth}"] if pth else [])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vae_extra")
    root = str(tmp / "dmlab")
    make_dmlab(root)
    titok = str(tmp / "titok.pth")
    torch.save(randomized(TT.TiTokKL(TT.TiTokConfig(**TITOK)), seed=3).state_dict(), titok)
    kl = str(tmp / "diffusion_pytorch_model.bin")
    # numpy values: the JAX importer transposes with numpy's signature
    torch.save({k: v.numpy() for k, v in _diffusers_names(_kl_cfg(), True).items()}, kl)
    return tmp, root, titok, kl


@pytest.mark.parametrize("kind", ["titok", "kl"])
def test_preprocessors_match_main(files, kind):
    tmp, root, titok, kl = files
    root_t, root_j = str(tmp / f"{kind}_port"), str(tmp / f"{kind}_jax")
    shutil.copytree(root, root_t)
    shutil.copytree(root, root_j)
    algo = _titok_args(titok) if kind == "titok" else _kl_args(kl)
    exp = run(_argv(root_t, tmp / f"out_{kind}_port", algo), device="cpu")
    jax_main.run(_argv(root_j, tmp / f"out_{kind}_jax", algo))
    assert exp.pretrained
    for split in ("training", "validation"):
        tdir, jdir = f"{root_t}_latent_{RES}/{split}", f"{root_j}_latent_{RES}/{split}"
        names = sorted(os.listdir(jdir))
        assert sorted(os.listdir(tdir)) == names
        assert names == sorted([f"v{i}.npy" for i in range(3)] + ["data_mean.npy", "data_std.npy"])
        for f in names:
            a, b = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert rel_err(a, b) < FILE_RTOL, f
        shape = np.load(os.path.join(tdir, "v1.npy")).shape
        assert shape == ((9, 4, 4) if kind == "titok" else (9, RES // 2, RES // 2, 4))


def test_kl_preprocessor_without_weights(files, tmp_path, capsys):
    tmp, root, _, _ = files
    data = str(tmp_path / "dmlab")
    shutil.copytree(root, data)
    exp = run(_argv(data, tmp_path / "out", _kl_args()), device="cpu")
    assert not exp.pretrained
    assert "WARNING: the kl_autoencoder preprocessor has no weights" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        run(_argv(data, tmp_path / "out2", _kl_args(str(tmp_path / "missing.bin"))), device="cpu")
    with pytest.raises(FileNotFoundError):
        run(_argv(data, tmp_path / "out3",
                  _titok_args(str(tmp_path / "missing.pth"))), device="cpu")
