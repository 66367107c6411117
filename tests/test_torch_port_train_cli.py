"""The training entry point of the port against the JAX package's, on the CPU.

``run(argv, device="cpu")`` with ``experiment.tasks=[training]`` against
``main.run(argv)``: the README's RE10K command at the small size of
``tests/test_torch_port_cli.py`` (a U-ViT of two narrow levels, 16 px pose
videos), warm-started from the same upstream ``.ckpt``, 3 steps at batch 2,
a warm-up of one step at learning rate 1e-3, the EMA at decay 0.5 (so that
it moves), the pose dropout at 0. Torch and JAX draw different random
streams, so both sides get the same draws: ``clipped_normal`` pinned, the
noise levels those of a fixed JAX key. The JAX model holds its output
bias as p*p copies, each with its own gradient, where the port holds one
(``tests/test_torch_port_train_step.py``): the JAX side ties the copies.

Held: every logged loss and gradient norm, and every leaf of the final
checkpoint's EMA (the JAX tree through ``uvit3d_state_dict_from_flax``),
within 1e-4 relative in fp32 (both algorithms built in fp32) and 2e-2 in
the CLI's bf16, where a control (the port drawing its own noise levels)
must miss by more; the checkpoint directories kept alike. Then the
behaviours the training loop opens, on the port alone: a resume by run
name (``load=<+name>``, through the registry either package reads) that
restores the saved state bit for bit; ``val_all_ckpt`` over the run's
checkpoints, each equal to a validation with ``load=<that directory>``;
and ``tasks=[training,validation]`` validating the run's EMA weights.
"""

import copy
import dataclasses
import importlib
import json
import os
import types
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from dfot_tpu.algorithms import dfot_video as JA
from dfot_tpu.experiments import video_generation as JVG
from dfot_tpu.training import checkpoint as JC
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.training import trainer as JT
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.experiments import video_generation as TVG
from dfot_tpu_torch.models.uvit import UViTSpec
from dfot_tpu_torch.training import checkpoint as TC
from dfot_tpu_torch.training import state as TST
from dfot_tpu_torch.training import trainer as TT
from dfot_tpu_torch.utils.weights import init_random_weights, uvit3d_state_dict_from_flax

from test_torch_port_cli import SMALL, jax_imports_fourier_buffers  # noqa: F401
from test_torch_port_sampling import _pin_noise, rel_err
from test_torch_port_train_loop import _state_equal
from test_torch_port_train_step import _first_bias_copy, _tie_output_bias
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


TMAIN = importlib.import_module("dfot_tpu_torch.__main__")
FP32_RTOL, BF16_RTOL = 1e-4, 2e-2
STEPS = 3
TRAIN = [a for a in SMALL if a != "experiment.tasks=[validation]"] + [
    "experiment.tasks=[training]", "experiment.training.batch_size=2",
    f"experiment.training.max_steps={STEPS}", "experiment.training.lr=1e-3",
    "algorithm.lr_scheduler.num_warmup_steps=1", "experiment.ema.decay=0.5",
    "++algorithm.backbone.external_cond_dropout=0.0", "++algorithm.logging.loss_freq=1",
    "experiment.training.data.num_workers=0",
    "experiment.training.checkpointing.every_n_train_steps=2",
    # two channels per GroupNorm group: with one, a conv bias ahead of a
    # GroupNorm has a gradient of rounding noise only, which Adam scales up
    # to a full update of random sign
    "++algorithm.backbone.channels=[64,64]",
]
LEVELS_KEY = 5


@pytest.fixture(scope="module")
def train_ckpt(tmp_path_factory):
    """An upstream-layout ``.ckpt`` of the training configuration's model,
    seeded random weights (the Fourier buffers included)."""
    algo = build_algorithm(load_config(TRAIN), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "warm_start.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, path)
    return path


@pytest.fixture
def distinct_run_dirs(monkeypatch):
    """A run directory is stamped to the second: runs of one test get one a
    second apart."""
    clock = iter(datetime(2026, 1, 1) + timedelta(seconds=i) for i in range(1000))
    monkeypatch.setattr(TMAIN, "datetime", types.SimpleNamespace(now=lambda: next(clock)))


def _pin_draws(monkeypatch, port=True):
    """The noise pinned on both sides; the noise levels of one fixed JAX key
    in every step, on both sides (``port=False``: the port draws its own)."""
    _pin_noise(monkeypatch)
    real = JNL.training_noise_levels

    def fixed(rng, cfg, mask, train=True):
        return real(jax.random.PRNGKey(LEVELS_KEY), cfg, mask, train)

    monkeypatch.setattr(JT, "training_noise_levels", fixed)
    monkeypatch.setattr(JNL, "training_noise_levels", fixed)
    if not port:
        return

    def port_levels(generator, cfg, mask, train=True, draws=None, rows=None):
        assert rows is None  # one process
        jcfg = JNL.NoiseLevelConfig(**dataclasses.asdict(cfg))
        k, loss_mask = real(jax.random.PRNGKey(LEVELS_KEY), jcfg, jnp.asarray(mask.cpu().numpy()),
                            train)
        return (torch.as_tensor(np.asarray(k), device=mask.device),
                torch.as_tensor(np.asarray(loss_mask), device=mask.device))

    monkeypatch.setattr(TT, "training_noise_levels", port_levels)


def _tie_jax_output_bias(monkeypatch):
    real = JA.DFoTVideoAlgo._train_apply

    def tied(self, params, *args, **kw):
        return real(self, _tie_output_bias(params, self.cfg.backbone.patch_size), *args, **kw)

    monkeypatch.setattr(JA.DFoTVideoAlgo, "_train_apply", tied)


def _fp32(monkeypatch):
    """Both algorithms built in fp32."""
    monkeypatch.setattr(JVG, "build_algorithm", lambda cfg: JA.build_algorithm(cfg, jnp.float32))
    monkeypatch.setattr(TVG, "build_algorithm",
                        lambda cfg, device=None: build_algorithm(cfg, torch.float32, device))


def _lines(run_dir):
    files = [os.path.join(d, f) for d, _, fs in os.walk(run_dir) for f in fs
             if f == "metrics.jsonl"]
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [json.loads(line) for line in f]


def _step_metrics(run_dir):
    return {x["step"]: (x["loss"], x["grad_norm"]) for x in _lines(run_dir) if "loss" in x}


def _ckpt_dir(run_dir):
    dirs = [d for d, sub, _ in os.walk(run_dir) if os.path.basename(d) == "checkpoints"]
    assert len(dirs) == 1, dirs
    return dirs[0]


def _jax_ema_as_port(ckpt_dir, cfg):
    tree = JC.restore_checkpoint(JC.latest_checkpoint(ckpt_dir))["ema_params"]
    spec = UViTSpec.from_config(cfg.algorithm.backbone, cfg.algorithm.max_frames)
    tree = _first_bias_copy(tree, spec.patch_size)
    return uvit3d_state_dict_from_flax(tree, None, spec, 3, 180)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_training_cli_matches_main(monkeypatch, tmp_path, train_ckpt,
                                   jax_imports_fourier_buffers, precision):
    _pin_draws(monkeypatch)
    _tie_jax_output_bias(monkeypatch)
    if precision == "fp32":
        _fp32(monkeypatch)
    rtol = FP32_RTOL if precision == "fp32" else BF16_RTOL
    argv = TRAIN + [f"load={train_ckpt}"]
    exp = run(argv + [f"output_dir={tmp_path / 'port'}"], device="cpu")
    jax_main.run(argv + [f"output_dir={tmp_path / 'jax'}"])
    got, want = _step_metrics(tmp_path / "port"), _step_metrics(tmp_path / "jax")
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        for name, g, w in zip(("loss", "grad_norm"), got[step], want[step]):
            assert np.isfinite(g) and g == pytest.approx(w, rel=rtol), (step, name)
    tdir, jdir = _ckpt_dir(tmp_path / "port"), _ckpt_dir(tmp_path / "jax")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["checkpoint_2", "checkpoint_3"]
    ema = TC.restore_checkpoint(TC.latest_checkpoint(tdir))["ema_params"]
    want_ema = _jax_ema_as_port(jdir, load_config(argv))
    assert set(ema) == set(want_ema)
    worst = {n: rel_err(ema[n].numpy(), want_ema[n].numpy()) for n in want_ema}
    assert max(worst.values()) < rtol, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    start = TC.restore_checkpoint(os.path.join(tdir, "checkpoint_2"))["ema_params"]
    assert any(not torch.equal(start[n], ema[n]) for n in ema)  # the EMA moved
    assert exp.state.step == STEPS and exp.algo.device.type == "cpu"
    assert exp.algo.model.embed_input.proj.weight.dtype == torch.float32

    if precision == "bf16":
        # the control: the port's own noise levels must miss the bound
        monkeypatch.undo()
        _pin_draws(monkeypatch, port=False)
        run(argv + [f"output_dir={tmp_path / 'control'}"], device="cpu")
        control = _step_metrics(tmp_path / "control")
        assert max(abs(control[s][0] / want[s][0] - 1) for s in want) > rtol


def test_resume_by_name(monkeypatch, tmp_path, train_ckpt, distinct_run_dirs):
    """Two steps under one +name, then ``load=<that name>`` to step 3: the
    registry (which the JAX package reads too) resolves the name to the
    first run's newest checkpoint, the restore gives the saved state back
    bit for bit, and the run goes on from step 3 with the unbroken run's
    learning rate, scheduler and step counts (its data start again at the
    first batch, as the JAX loop's do, so its weights are its own)."""
    _pin_draws(monkeypatch)
    restored = []
    real_load = TST.TrainState.load_state_dict

    def checked_load(self, state):
        real_load(self, state)
        _state_equal(self.state_dict(), state)  # before the next step changes it
        restored.append(copy.deepcopy(state))

    monkeypatch.setattr(TST.TrainState, "load_state_dict", checked_load)
    out = f"output_dir={tmp_path}"
    base = [a for a in TRAIN if not a.startswith("+name=")]
    unbroken = run(base + ["+name=whole", f"load={train_ckpt}", out], device="cpu")
    first = run(base + ["+name=first", f"load={train_ckpt}",
                        "experiment.training.max_steps=2", out], device="cpu")
    assert not restored  # warm starts load weights, not a train state
    resolved = TC.resolve_run_checkpoint("first", str(tmp_path))
    assert resolved == JC.resolve_run_checkpoint("first", str(tmp_path))
    assert resolved == os.path.join(first.ckpt_dir, "checkpoint_2")
    resumed = run(base + ["+name=second", "load=first", out], device="cpu")
    assert resumed.output_dir != first.output_dir
    assert len(restored) == 1
    _state_equal(restored[0], TC.restore_checkpoint(resolved))
    assert list(_step_metrics(resumed.output_dir)) == [3]
    a = TC.restore_checkpoint(TC.latest_checkpoint(resumed.ckpt_dir))
    b = TC.restore_checkpoint(TC.latest_checkpoint(unbroken.ckpt_dir))
    assert a["step"] == b["step"] == STEPS
    for key in ("scheduler", "param_groups", "micro_step"):
        assert a["opt_state"][key] == b["opt_state"][key], key
    assert resumed.state.optimizer.lr == unbroken.state.optimizer.lr
    with pytest.raises(FileNotFoundError, match="no run of that id or name"):
        run(base + ["+name=third", "load=nobody", out], device="cpu")


def test_validating_checkpoint_directories(tmp_path, distinct_run_dirs):
    """``tasks=[training,validation]`` validates the trained run's newest
    checkpoint (its EMA weights and buffers). ``val_all_ckpt`` sweeps the
    run's ``checkpoint_<step>`` directories in step order, each under
    ``validation/step_<N>``, with the metrics of a validation of
    ``load=<that directory>``; after the sweep the model holds the last
    one's weights."""
    out = f"output_dir={tmp_path}"
    trained = run(TRAIN + [out, "experiment.tasks=[training,validation]"], device="cpu")
    last = TC.restore_checkpoint(TC.latest_checkpoint(trained.ckpt_dir))
    ema = {**last["params"], **last["ema_params"]}
    state = trained.algo.model.state_dict()
    for n, v in ema.items():
        assert torch.equal(state[n], v), n
    assert any(not torch.equal(last["params"][n], v) for n, v in last["ema_params"].items())
    trained_metrics = {k: v for x in _lines(trained.output_dir) for k, v in x.items()
                       if k.startswith("validation/")}
    assert sorted(trained_metrics) == [f"validation/prediction/{m}"
                                       for m in ("mse", "psnr", "ssim")]
    val = [a for a in SMALL if not a.startswith("experiment.tasks")] + [
        "++algorithm.backbone.channels=[64,64]", "experiment.tasks=[validation]", out]
    sweep = run(val + [f"load={trained.output_dir}", "experiment.validation.val_all_ckpt=true"],
                device="cpu")
    swept = {k: v for x in _lines(sweep.output_dir) for k, v in x.items()
             if k.startswith("validation/")}
    assert list(swept) == [f"validation/step_{s}/prediction/{m}" for s in (2, 3)
                           for m in ("mse", "psnr", "ssim")]
    assert all(np.isfinite(v) for v in swept.values())
    for s in (2, 3):
        one = run(val + [f"load={os.path.join(trained.ckpt_dir, f'checkpoint_{s}')}"],
                  device="cpu")
        for k, v in one.last_metrics.items():
            assert swept[k.replace("validation/", f"validation/step_{s}/")] == v
    for k, v in trained_metrics.items():
        assert swept[k.replace("validation/", "validation/step_3/")] == v
    state = sweep.algo.model.state_dict()
    for n, v in ema.items():
        assert torch.equal(state[n], v), n
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="val_all_ckpt"):
        run(val + [f"load={tmp_path / 'empty'}", "experiment.validation.val_all_ckpt=true"],
            device="cpu")
