"""The port's config layer against the JAX package's.

- The port's YAML reader gives exactly what ``dfot_tpu/config.py``'s
  ``_yaml_load`` (PyYAML with the YAML-1.2 float rule) gives, for every file
  under ``configurations/``, one case a file; text outside its subset
  raises with file and line.
- ``dfot_tpu_torch.config.load_config`` composes what
  ``dfot_tpu.config.load_config`` composes (``to_dict(resolve=True)``) for
  the README's commands, K600 ``@DiT/XL``, a backbone re-selection and the
  ``+``/``++`` overrides.
- ``build_algorithm`` builds from those compositions the recipes the port's
  chip path uses as code: ``flagship()``, ``uvit3d_pose_base()`` and
  ``k600_dit_xl()`` (models built on the meta device: no weights).
"""

import dataclasses
import glob
import math
import os

import pytest
import torch

from dfot_tpu.config import _yaml_load
from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu_torch.algorithms.dfot_video import (
    build_algorithm,
    flagship,
    k600_dit_xl,
    uvit3d_pose_base,
)
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.utils import yaml_reader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "configurations", "**", "*.yaml"), recursive=True)
)

README_RE10K = [
    "+name=re10k", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
    "experiment=video_generation", "@diffusion/continuous", "experiment.tasks=[validation]",
    "load=pretrained:DFoT_RE10K.ckpt",
    "++algorithm.tasks.prediction.history_guidance.name=vanilla",
    "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
]
README_UCF = [
    "+name=smoke", "dataset=ucf_101", "algorithm=dfot_video", "experiment=video_generation",
    "dataset.resolution=16", "dataset.max_frames=4", "++algorithm.backbone.hidden_size=64",
    "++algorithm.backbone.depth=2", "++algorithm.backbone.num_heads=2",
    "experiment.training.max_steps=20", "experiment.training.batch_size=2",
]
K600_XL = ["+name=k600", "dataset=kinetics_600", "algorithm=dfot_video",
           "experiment=video_generation", "@DiT/XL"]
# the base-width U-ViT: the backbone YAML's own widths over the RE10K overlay's
BASE_WIDTHS = [
    "++algorithm.backbone.channels=[128,256,512,1024]", "++algorithm.backbone.num_heads=4",
    "++algorithm.backbone.num_updown_blocks=[3,3,3]", "++algorithm.backbone.num_mid_blocks=16",
    "++algorithm.backbone.use_checkpointing=[false,false,false,false]",
]


def _same(a, b) -> bool:
    """Equal values and equal types, NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_the_tree_has_its_files():
    assert len(CONFIG_FILES) == 115


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_yaml_reader_matches_pyyaml(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert _same(yaml_reader.load(text, path), _yaml_load(text))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: !!str 5\n",
    "---\na: 1\n",
    "a: >\n  folded\n",
    "a: plain\n  continued\n",
    "a: [1,\n  2]\n",
    "a: 0x1f\n",
    "a: 1_000\n",
    "a: 12:30\n",
    "a: 2024-01-02\n",
    "? complex\n: key\n",
    "a: 'open\n",
])
def test_yaml_reader_refuses_what_it_does_not_read(tmp_path, text):
    path = tmp_path / "outside_the_subset.yaml"
    path.write_text(text)
    with pytest.raises(yaml_reader.UnsupportedYAML, match="outside_the_subset.yaml:[0-9]+"):
        yaml_reader.load_file(str(path))


@pytest.mark.parametrize("text", [
    "[validation]", "4.0", "5e-5", "null", "pretrained:DFoT_RE10K.ckpt", "[mse,ssim,psnr]",
    "[1, [2, 3], {}]", "'quoted: yes'", "-3", "True", "off", ".inf", "[", "a: b",
])
def test_command_line_scalars_match_pyyaml(text):
    from dfot_tpu.config import _parse_scalar

    assert _same(yaml_reader.parse_scalar(text), _parse_scalar(text))


@pytest.mark.parametrize("value", [
    None, True, 3, -2.5, 1e-5, float("inf"), "plain", "5", "true", "${a.b}", "a: b", "it's",
    [1, "x", [None, 0.125]], {"k": [1, 2]},
])
def test_flow_rendering_reads_back(value):
    assert _same(yaml_reader.parse_scalar(yaml_reader.dump_flow(value)), value)


@pytest.mark.parametrize("argv", [
    README_RE10K,
    README_UCF,
    K600_XL,
    README_RE10K + ["algorithm/backbone=u_vit3d_pose"],
    README_RE10K + ["+new.key=[1,2]", "++forced=5e-5"],
    README_RE10K + BASE_WIDTHS,
], ids=["readme_re10k", "readme_ucf", "k600_xl", "backbone_reselect", "plus_overrides",
        "base_widths"])
def test_composition_matches_jax(argv):
    assert _same(load_config(argv).to_dict(resolve=True),
                 jax_load_config(argv).to_dict(resolve=True))


def test_plain_override_of_a_missing_key_raises():
    with pytest.raises(KeyError):
        load_config(README_RE10K + ["no.such.key=1"])


@pytest.mark.parametrize("argv,recipe", [
    (README_RE10K, flagship),
    (README_RE10K + BASE_WIDTHS, uvit3d_pose_base),
], ids=["flagship", "base"])
def test_build_algorithm_gives_the_pose_recipes(argv, recipe):
    algo = build_algorithm(load_config(argv), device="meta")
    fs = recipe()
    model = algo.model
    assert model.spec == fs.spec
    assert algo.dcfg == fs.dcfg
    assert algo.prediction_hg == fs.history_guidance
    assert algo.x_shape == (fs.resolution, fs.resolution, fs.x_channels)
    assert model.resolution == fs.resolution and model.x_channels == fs.x_channels
    assert algo.cfg.camera_pose_conditioning.type == fs.conditioning_type
    assert model.external_cond_embedding.patch_embedder.proj.in_channels == fs.external_cond_dim
    assert (model.noise_level_pos_embedding.timesteps is not None) == fs.use_fourier_noise_emb
    assert model.external_cond_dropout == fs.external_cond_dropout
    assert model.token_io and algo.rollout_cfg.state_codec is not None
    assert algo.nl_cfg == fs.train.noise_levels
    assert algo.n_context_tokens == fs.train.noise_levels.n_context_tokens


def test_build_algorithm_gives_the_k600_recipe():
    algo = build_algorithm(load_config(K600_XL), device="meta")
    r = k600_dit_xl()
    assert algo.is_latent
    assert algo.model.spec == r.spec
    assert algo.dcfg == r.dcfg
    assert dataclasses.astuple(algo.prediction_hg) == dataclasses.astuple(r.history_guidance)
    assert algo.x_shape == r.resolution + (r.x_channels,)
    assert (algo.max_tokens, algo.n_context_tokens) == (r.max_tokens, r.n_context_tokens)
    assert algo.model.external_cond_type == r.external_cond_type
    assert algo.nl_cfg == r.train.noise_levels
    assert algo.model.dit_base.spec.depth == 28
    assert isinstance(algo.model.patch_embedder.proj.weight, torch.nn.Parameter)
