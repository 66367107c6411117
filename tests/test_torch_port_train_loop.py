"""The training loop's parts in the port against the JAX package, on the CPU.

- The training loader against ``dfot_tpu.data.loader.make_loader`` with
  ``num_workers=0`` (shuffled and not, ``drop_last`` and not, epochs 0-2)
  and against grain's worker processes, shuffled and not: the same batches,
  exact.
- Checkpoint directories against ``dfot_tpu.training.checkpoint`` under
  the same sequence of saves (blocking and in the background): the same
  directories survive top-k pruning and ``latest_checkpoint`` names the
  same step; the run registry resolves the same ``load=`` whichever
  package wrote it.
- A train state's save and restore, bit for bit, in the middle of a
  gradient accumulation cycle; and k steps, a save, a restore into a fresh
  state and n - k more steps equal to n unbroken steps, bit for bit (the
  draws injected), where a restore without the scheduler's position or the
  micro-step count must differ.
- ``make_eval_denoise`` against the JAX algorithm's on the same weights,
  draws pinned, fp32: the loss within 1e-5 relative, the x0
  reconstruction within 1e-4 relative L2.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfot_tpu.algorithms import dfot_video as JA
from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu.data import loader as JL
from dfot_tpu.data import video_dataset as JVD
from dfot_tpu.experiments.video_generation import VideoGenerationExperiment as JExperiment
from dfot_tpu.training import checkpoint as JC
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.training import state as JST
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm, flagship
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.data import loader as TL
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.models import uvit as TU
from dfot_tpu_torch.training import checkpoint as TC
from dfot_tpu_torch.training import noise_levels as TNL
from dfot_tpu_torch.training import optim as TO
from dfot_tpu_torch.training import state as TST
from dfot_tpu_torch.training import trainer as TT
from dfot_tpu_torch.utils.weights import init_random_weights

from test_torch_port_cli import SMALL, jax_imports_fourier_buffers  # noqa: F401
from test_torch_port_sampling import _pin_noise, rel_err
from torch_port_helpers import POSE_DIM, pinned, t, tiny_spec, one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


EVAL_LOSS_RTOL, EVAL_RECON_RTOL = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# the training loader
# ---------------------------------------------------------------------------


def _batches(loader, epochs=3):
    return [list(loader) for _ in range(epochs)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for ep_got, ep_want in zip(got, want):
        assert len(ep_got) == len(ep_want) > 0
        for a, b in zip(ep_got, ep_want):
            assert sorted(a) == sorted(b)  # grain's workers hand dicts back in key order
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_training_loader_matches_jax(shuffle, drop_last):
    """Epochs 0-2 of 11 videos in batches of 3: the seeded per-epoch
    shuffle, the last short batch dropped or kept, the epoch counter."""
    ds = JVD.SyntheticVideoDataset(num_videos=11, n_frames=2, resolution=4, cond_dim=16)
    lt = TL.make_loader(ds, 3, shuffle=shuffle, drop_last=drop_last, seed=5)
    lj = JL.make_loader(ds, 3, shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=0)
    assert len(lt) == len(lj) == (3 if drop_last else 4)
    got, want = _batches(lt), _batches(lj)
    _assert_same_batches(got, want)
    assert lt.epoch == lj.epoch == 3
    if shuffle:  # a new order every epoch
        assert not np.array_equal(got[0][0]["videos"], got[1][0]["videos"])


def test_unshuffled_worker_loader_matches_grain():
    """Grain's worker processes and the port's load in the same order:
    the dataset's unshuffled, grain's permutation shuffled; per-process
    shards raise."""
    ds = JVD.SyntheticVideoDataset(num_videos=10, n_frames=2, resolution=4, cond_dim=16)
    for shuffle in (False, True):
        lt = TL.make_loader(ds, 3, shuffle=shuffle, num_workers=2)
        lj = JL.make_loader(ds, 3, shuffle=shuffle, num_workers=2)
        try:
            assert isinstance(lj, JL.GrainDataLoader) and isinstance(lt, TL.WorkerDataLoader)
            assert len(lt) == len(lj)
            _assert_same_batches(_batches(lt, 2), _batches(lj, 2))
        finally:
            lt.close()
    # per-process shares: the JAX loader's strided slices
    for shard in ((0, 2), (1, 2)):
        for drop_last in (False, True):
            _assert_same_batches(
                _batches(TL.DataLoader(ds, 3, drop_last=drop_last, process_shard=shard), 2),
                _batches(JL.DataLoader(ds, 3, drop_last=drop_last, process_shard=shard), 2))


# ---------------------------------------------------------------------------
# checkpoint directories and the run registry
# ---------------------------------------------------------------------------


def _jax_state():
    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones(3)}
    return JST.create_train_state(params, optax.adamw(1e-3), use_ema=True)


def _port_state(seed=0, accumulate_steps=1, warmup=3):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 5), torch.nn.GELU(), torch.nn.Linear(5, 3))
    model.register_buffer("table", torch.randn(3))
    opt = TO.make_optimizer(model.parameters(), lr=1e-2, weight_decay=0.01,
                            num_warmup_steps=warmup, accumulate_steps=accumulate_steps)
    return TST.create_train_state(model, opt)


def test_topk_pruning_and_latest_match_jax(tmp_path):
    """The same saves (in the background and blocking, one step saved twice)
    leave the same complete directories on both sides after each save has
    ended, and the same newest step."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    js, ts = _jax_state(), _port_state()
    assert TC.latest_checkpoint(tdir) is None is JC.latest_checkpoint(jdir)
    for step, block in ((2, False), (4, False), (6, True), (8, False), (8, False), (10, True)):
        JC.save_checkpoint(jdir, step, js, save_top_k=2, block=block)
        TC.save_checkpoint(tdir, step, ts, save_top_k=2, block=block)
        JC.wait_for_checkpoints()
        TC.wait_for_checkpoints()
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)), step
        assert os.path.basename(TC.latest_checkpoint(tdir)) == os.path.basename(
            JC.latest_checkpoint(jdir)) == f"checkpoint_{step}"
    assert sorted(os.listdir(tdir)) == ["checkpoint_10", "checkpoint_8"]
    saved = TC.restore_checkpoint(TC.latest_checkpoint(tdir))
    assert set(saved) == {"params", "ema_params", "opt_state", "step"} and saved["step"] == 0
    os.makedirs(os.path.join(tdir, "checkpoint_12.partial"))  # a save in flight
    assert TC.latest_checkpoint(tdir).endswith("checkpoint_10")
    TC.prune_checkpoints(tdir, 1)
    assert sorted(os.listdir(tdir)) == ["checkpoint_10", "checkpoint_12.partial"]
    with pytest.raises(FileNotFoundError, match="not a checkpoint directory"):
        TC.restore_checkpoint(os.path.join(tdir, "checkpoint_12.partial"))


def test_registry_is_shared_with_jax(tmp_path):
    """Runs registered by either package resolve through either: by id, by
    name (the last registered wins), to the run's newest checkpoint."""
    root = str(tmp_path)
    runs = [(TC, "alpha", tmp_path / "a"), (JC, "beta", tmp_path / "b"),
            (JC, "alpha", tmp_path / "c"), (TC, "gamma", tmp_path / "d")]
    ids = []
    for i, (pkg, name, out) in enumerate(runs):
        ids.append(pkg.register_run(root, name, str(out)))
        TC.save_checkpoint(str(out / "checkpoints"), 10 * (i + 1), _port_state())
    for load in ids + ["alpha", "beta", "gamma", "delta"]:
        got = TC.resolve_run_checkpoint(load, root)
        assert got == JC.resolve_run_checkpoint(load, root), load
    assert TC.resolve_run_checkpoint("alpha", root) == str(tmp_path / "c" / "checkpoints"
                                                          / "checkpoint_30")
    assert TC.resolve_run_checkpoint(ids[1], root).endswith("checkpoint_20")
    assert TC.resolve_run_checkpoint("delta", root) is None
    assert TC.resolve_run_checkpoint("alpha", str(tmp_path / "nowhere")) is None


# ---------------------------------------------------------------------------
# the train state's state dict
# ---------------------------------------------------------------------------


def _state_equal(a, b, where=""):
    """Every tensor bit for bit, every other value equal."""
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _state_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _state_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _micro_step(state, seed):
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(seed))
    state.optimizer.zero_grad()
    state.model(x).square().mean().backward()
    state.optimizer.step()
    state.step += 1
    TST.gated_ema_update(state.ema, dict(state.model.named_parameters()), 0.5, state.step,
                         state.optimizer.accumulate_steps)


def test_state_round_trip_mid_accumulation(tmp_path):
    """Four micro-steps at three per update (one update, one cycle a third
    done), saved in the background, restored into a state of other weights:
    parameters, buffers, EMA, moments, scheduler, micro-step, gradient sum
    and step come back bit for bit, and the restored state steps on as the
    saved one does; the parameter objects stay those the optimizer holds."""
    state = _port_state(accumulate_steps=3)
    for i in range(4):
        _micro_step(state, i)
    assert state.optimizer.micro_step == 4 and state.optimizer._sum is not None
    path = TC.save_checkpoint(str(tmp_path), 4, state, block=False)["path"]
    before = {k: v for k, v in state.state_dict().items()}
    TC.wait_for_checkpoints()
    saved = TC.restore_checkpoint(path)
    other = _port_state(seed=1, accumulate_steps=3)
    params = list(other.model.parameters())
    other.load_state_dict(saved)
    assert all(p is q for p, q in zip(params, other.optimizer.params))
    _state_equal(other.state_dict(), before)
    assert other.optimizer.lr == state.optimizer.lr
    for s in (state, other):
        for i in (4, 5):
            _micro_step(s, i)
    _state_equal(other.state_dict(), state.state_dict())
    assert state.optimizer.micro_step == 6 and state.optimizer._sum is None


def test_ema_weights_swap_in_and_out():
    """The EMA shadow replaces the weights for the block and the live
    weights come back, the same tensors as before."""
    state = _port_state()
    for i in range(3):
        _micro_step(state, i)
    live = {n: p.data_ptr() for n, p in state.model.named_parameters()}
    x = torch.randn(2, 4)
    with state.ema_weights():
        for n, p in state.model.named_parameters():
            assert p.data_ptr() == state.ema[n].data_ptr() != live[n]
        swapped = state.model(x)
    for n, p in state.model.named_parameters():
        assert p.data_ptr() == live[n]
    reference = _port_state()
    reference.model.load_state_dict(state.ema_state_dict())
    assert torch.equal(swapped, reference.model(x))


@pytest.fixture(scope="module")
def tiny_training():
    """A tiny UViT3DPose's train step with injected draws (two micro-steps
    an update), ``fresh(seed)`` train states, six batches, ``run(state,
    batches)``, and the state of six unbroken steps from ``fresh(3)``."""
    spec = tiny_spec(use_checkpointing=(False, False, False, True))
    dcfg = flagship().dcfg
    nl = TNL.NoiseLevelConfig(is_continuous=True, n_context_tokens=1)
    step = TT.make_train_step(lambda m, x, k, c, cm: m(x, k, c, cm), dcfg,
                              TDC.make_schedule(dcfg, device="cpu"), nl, ema_decay=0.5,
                              accumulate_steps=2)

    def fresh(seed):
        pm = TU.UViT3DPose(spec, 3, 16, POSE_DIM, use_fourier_noise_emb=True)
        init_random_weights(pm, torch.Generator().manual_seed(seed))
        opt = TO.make_optimizer(pm.parameters(), lr=1e-2, num_warmup_steps=4, accumulate_steps=2)
        return TST.create_train_state(pm, opt)

    rng = np.random.default_rng(30)
    batches = [{
        "xs": t(rng.standard_normal((1, 8, 16, 16, 3)).astype(np.float32)),
        "conditions": t(rng.standard_normal((1, 8, 16, 16, POSE_DIM)).astype(np.float32)),
        "masks": torch.ones(1, 8, dtype=torch.bool),
        "levels": t(rng.uniform(0, 1, (1, 8)).astype(np.float32)),
        "noise": t(rng.standard_normal((1, 8, 16, 16, 3)).astype(np.float32)),
    } for _ in range(6)]

    def run(state, todo):
        for b in todo:
            state, _ = step(state, b, None, noise_levels=b["levels"], noise=b["noise"])
        return state

    return fresh, batches, run, run(fresh(3), batches)


@pytest.mark.parametrize("restore_without", [None, "scheduler", "micro_step"])
def test_resume_equals_an_unbroken_run(tmp_path, tiny_training, restore_without):
    """Three steps, a save, a restore into a state of other weights and three
    more steps give the six unbroken steps' state bit for bit (accumulation
    over two micro-steps, so the save falls mid-cycle; the warm-up still
    rising). Restored without the scheduler's position or the micro-step
    count, the weights must come out otherwise."""
    fresh, batches, run, unbroken = tiny_training
    first = run(fresh(3), batches[:3])
    TC.save_checkpoint(str(tmp_path), 3, first)
    saved = TC.restore_checkpoint(TC.latest_checkpoint(str(tmp_path)))
    resumed = fresh(4)
    if restore_without == "scheduler":
        saved["opt_state"]["scheduler"] = resumed.optimizer.scheduler.state_dict()
    elif restore_without == "micro_step":
        saved["opt_state"]["micro_step"] = 0
    resumed.load_state_dict(saved)
    resumed = run(resumed, batches[3:])
    if restore_without is None:
        _state_equal(resumed.state_dict(), unbroken.state_dict())
        assert resumed.optimizer.lr == unbroken.optimizer.lr
    else:
        with pytest.raises(AssertionError):
            _state_equal(resumed.state_dict()["params"], unbroken.state_dict()["params"])


# ---------------------------------------------------------------------------
# the eval denoiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("continuous", [True, False])
def test_eval_denoise_matches_jax(monkeypatch, tmp_path, jax_imports_fourier_buffers,
                                  continuous):
    """Loss and x0 reconstruction of one validation batch on the checkpoint's
    weights, fp32 on both sides, noise and noise levels pinned (the JAX
    levels drawn from a fixed key, handed to the port), for continuous
    diffusion and for the discrete schedule."""
    _pin_noise(monkeypatch)
    argv = SMALL if continuous else [a for a in SMALL if a != "@diffusion/continuous"]
    jcfg, tcfg = jax_load_config(argv), load_config(argv)
    talgo = build_algorithm(tcfg, torch.float32, device="cpu")
    init_random_weights(talgo.model, torch.Generator().manual_seed(2))
    path = str(tmp_path / "weights.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in talgo.model.state_dict().items()}}, path)
    jalgo = JA.build_algorithm(jcfg, jnp.float32)
    assert jalgo.dcfg.is_continuous is continuous
    params = JExperiment._import_torch_checkpoint(
        types.SimpleNamespace(algo=jalgo, cfg=jcfg), path)

    real = JNL.training_noise_levels
    monkeypatch.setattr(JNL, "training_noise_levels",
                        lambda rng, cfg, mask, train=True: real(jax.random.PRNGKey(5), cfg, mask,
                                                                train))
    ds = JVD.build_dataset(jcfg.dataset, "validation")
    batch = next(iter(JL.DataLoader(ds, 2, shuffle=False, drop_last=False)))
    conds = jalgo.process_conditions(batch["conds"])
    jbatch = {"xs": jalgo.normalize(jnp.asarray(batch["videos"])),
              "masks": jnp.asarray(batch["nonterminal"]), "conditions": jnp.asarray(conds)}
    want_loss, want_recons = jalgo.make_eval_denoise()(params, jbatch, jax.random.PRNGKey(0))
    levels = real(jax.random.PRNGKey(5), jalgo.nl_cfg, jbatch["masks"], False)[0]

    tbatch = {"xs": talgo.normalize(t(batch["videos"])), "masks": t(batch["nonterminal"]),
              "conditions": t(np.asarray(talgo.process_conditions(batch["conds"])))}
    got_loss, got_recons = talgo.make_eval_denoise()(
        tbatch, None, noise_levels=t(np.asarray(levels)),
        noise=pinned(tuple(tbatch["xs"].shape)))
    assert not talgo.model.training and not got_recons.requires_grad
    assert float(got_loss) == pytest.approx(float(want_loss), rel=EVAL_LOSS_RTOL)
    assert got_recons.shape == want_recons.shape == (2, 8, 16, 16, 3)
    assert rel_err(got_recons.numpy(), want_recons) < EVAL_RECON_RTOL
    loss_only = talgo.make_eval_loss()(tbatch, None, noise_levels=t(np.asarray(levels)),
                                       noise=pinned(tuple(tbatch["xs"].shape)))
    assert float(loss_only) == float(got_loss)
