"""The port's auxiliaries (A16b) against the JAX package's.

- Attention capture (``utils/attn_capture.py``, ``ops.attention.
  attention_with_weights``): a DiT3D's (B, H, N, N) maps, on the same
  weights and the same noised input, equal ``dfot_tpu.utils.attn_capture.
  capture_attention_maps``'s under the same keys within 1e-5 (fp32), the
  forward output too; through ``python -m dfot_tpu_torch`` with
  ``algorithm.save_attn_map.enabled`` (the noise pinned on both sides) the
  PNG files are those ``main.run`` writes, by name, and ``attn_maps_saved``
  is logged alike.
- Cluster dispatch (``utils/cluster.py``): the launch script rendered and
  submitted through a stub ``submit_command``, as
  ``tests/test_aux_systems.py`` holds the JAX one.
- The HG visualizer (``guidance/visualizer.py``): the GIF frames of one
  plan, decoded with PIL, equal to ``visualize_plan``'s, pixel for pixel.
- The serving export (``tools/export_sampler.py``): the tiny window's
  artifact run by ``--load`` in a fresh process equals the in-process
  sampler bit for bit.
- The multi-process dry run (``tools/dryrun_multichip.py``) at N = 4: the
  (2, 2) mesh, every case within its bound.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.ops.attention import set_attention_capture as jax_set_capture
from dfot_tpu.utils import attn_capture as JAC
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.utils import attn_capture as TAC
from dfot_tpu_torch.utils.weights import init_random_weights

from test_torch_port_dit import dit_pair, inputs
from test_torch_port_latent_cli import make_dmlab
from test_torch_port_sampling import _pin_noise
from test_torch_port_train_cli import _fp32, _lines
from torch_port_helpers import one_thread

CAPTURE_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# attention capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(pos_emb_type="rope_3d"),
                                dict(variant="factorized_attention", mlp_ratio=2.0,
                                     pos_emb_type="sinusoidal_factorized")],
                         ids=["full", "factorized"])
def test_capture_matches_jax(kw):
    """The maps of a DiT3D forward on a noised input (levels and noise
    seeded, the same on both sides), key by key."""
    jm, variables, pm = dit_pair(seed=3, **kw)
    rng, x, k = inputs(5, 2, 4)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    x_t = (0.6 * x + 0.8 * noise).astype(np.float32)
    jax_set_capture(True)
    try:
        want_out, want = JAC.capture_attention_maps(jm, variables, jnp.asarray(x_t),
                                                    jnp.asarray(k))
    finally:
        jax_set_capture(False)
    got_out, got = TAC.capture_attention_maps(pm, torch.as_tensor(x_t), torch.as_tensor(k))
    assert got and sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and w.shape[-1] == w.shape[-2]
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=0, atol=CAPTURE_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0, atol=1e-4)
    assert not TAC.collect_attention_maps(pm)  # read once; capture off again
    with torch.no_grad():
        pm(torch.as_tensor(x_t), torch.as_tensor(k))
    assert not TAC.collect_attention_maps(pm)


def _attn_argv(root, ckpt, out):
    return ["+name=attn", "dataset=dmlab", "algorithm=dfot_video", "experiment=video_generation",
            f"dataset.save_dir={root}", "++dataset.latent.enabled=false", "dataset.resolution=32",
            "dataset.max_frames=4", "dataset.context_length=1",
            "++algorithm.backbone.hidden_size=64", "++algorithm.backbone.depth=2",
            "++algorithm.backbone.num_heads=2", "algorithm.diffusion.sampling_timesteps=2",
            "experiment.tasks=[validation]", "experiment.validation.batch_size=2",
            "experiment.validation.limit_batch=1", "++algorithm.logging.metrics=[mse]",
            "++algorithm.logging.max_num_videos=0", "algorithm.save_attn_map.enabled=true",
            "wandb.mode=disabled", f"load={ckpt}", f"output_dir={out}",
            f"algorithm.save_attn_map.attn_map_dir={out}/attn_maps"]


def test_save_attn_map_writes_jax_files(monkeypatch, tmp_path):
    """``algorithm.save_attn_map.enabled`` through both entry points on the
    same DiT weights and pinned noise: the same PNG names (one a map and
    level), ``attn_maps_saved`` logged alike."""
    root = str(tmp_path / "dmlab")
    make_dmlab(root)
    argv = _attn_argv(root, "x", tmp_path)
    algo = build_algorithm(load_config(argv), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "dit.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, ckpt)
    _pin_noise(monkeypatch)
    _fp32(monkeypatch)
    exp = run(_attn_argv(root, ckpt, tmp_path / "port"), device="cpu")
    jax_main.run(_attn_argv(root, ckpt, tmp_path / "jax"))

    def pngs(out):
        found = [f for d, _, fs in os.walk(out) for f in fs if f.endswith(".png")]
        return sorted(found)

    got, want = pngs(tmp_path / "port"), pngs(tmp_path / "jax")
    assert got and got == want
    assert any(n.endswith("_t100.png") for n in got) and any(n.endswith("_t700.png") for n in got)
    saved = [r["attn_maps_saved"] for r in _lines(tmp_path / "port") if "attn_maps_saved" in r]
    assert saved == [r["attn_maps_saved"] for r in _lines(tmp_path / "jax")
                     if "attn_maps_saved" in r] == [float(len(got) // 2)]
    assert exp.cfg.algorithm.save_attn_map.attn_map_dir == f"{tmp_path / 'port'}/attn_maps"


# ---------------------------------------------------------------------------
# cluster dispatch, the visualizer
# ---------------------------------------------------------------------------


def test_cluster_template_render(tmp_path):
    from dfot_tpu_torch.utils.cluster import is_compute_node, submit_cluster_job

    cfg = load_config(["cluster=base_slurm", "+name=job"])
    cfg.cluster["submit_command"] = "true"  # no slurm needed
    path = submit_cluster_job(cfg.cluster, "job", "python -m dfot_tpu_torch +name=job",
                              str(tmp_path))
    text = open(path).read()
    assert "#SBATCH --job-name=job" in text
    assert "python -m dfot_tpu_torch +name=job" in text
    assert os.path.islink(os.path.join(tmp_path, "slurm_logs", "latest"))
    assert is_compute_node() == bool(os.environ.get("SLURM_JOB_ID"))


def test_visualizer_frames_match_jax(tmp_path):
    from PIL import Image

    from dfot_tpu.guidance import HistoryGuidance as JHG
    from dfot_tpu.guidance import visualize_plan as jax_visualize
    from dfot_tpu.sampling.sampler import plan_sampling as jax_plan
    from dfot_tpu_torch.guidance.history_guidance import HistoryGuidance as THG
    from dfot_tpu_torch.guidance.visualizer import visualize_plan
    from dfot_tpu_torch.sampling.sampler import plan_sampling

    mask = np.zeros((1, 4), dtype=np.int64)
    mask[:, :2] = 1
    kw = dict(guidance_scale=4.0, stabilization_level=0.02, timesteps=1000)
    got = visualize_plan(plan_sampling(mask, THG.stabilized_vanilla(**kw), "full_sequence",
                                       1000, 4, 4, 0), 1000, str(tmp_path / "t.gif"),
                         max_steps=3)
    want = jax_visualize(jax_plan(mask, JHG.stabilized_vanilla(**kw), "full_sequence", 1000, 4,
                                  4, 0), 1000, str(tmp_path / "j.gif"), max_steps=3)

    def frames(path):
        img = Image.open(path)
        out = []
        for i in range(img.n_frames):
            img.seek(i)
            out.append(np.asarray(img.convert("RGB")))
        return out

    a, b = frames(got), frames(want)
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


# ---------------------------------------------------------------------------
# the serving export, the dry run
# ---------------------------------------------------------------------------


def test_tiny_export_loads_bit_equal(tmp_path):
    """Exported in this process, run by ``--load --check`` in a fresh one
    (which builds the model only to compare): bit-equal to the in-process
    window sampler."""
    from dfot_tpu_torch.tools import export_sampler as TE

    out = str(tmp_path / "artifact")
    report = TE.main(["--tiny", "--device", "cpu", "--out", out])
    assert sorted(os.listdir(out)) == ["prepare.pt2", "step.pt2", "window.npz"]
    assert report["artifact_bytes"] > 0
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "dfot_tpu_torch.tools.export_sampler", "--load",
                        out, "--check", "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    assert loaded["shape"] == [1, 4, 16, 16, 3]
    assert loaded["bit_equal"] and loaded["max_abs_diff"] == 0.0


def test_dryrun_multichip_four_processes():
    from dfot_tpu_torch.tools.dryrun_multichip import dryrun_multichip, mesh_for

    assert [mesh_for(n) for n in (1, 2, 4, 6, 8, 16)] == [
        (1, 1), (2, 1), (2, 2), (3, 2), (2, 2, 2), (4, 2, 2)]
    line = dryrun_multichip(4)
    assert line.startswith("dryrun_multichip(4): ok, mesh={'data': 2, 'fsdp': 2}"), line
    diffs = [float(part.split("=")[1].split(",")[0]) for part in line.split()
             if part.startswith("max_diff=")]
    assert len(diffs) == 4 and max(diffs) < 1e-5, line
