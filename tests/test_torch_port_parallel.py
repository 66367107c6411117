"""The port's process-group layer against the JAX package's, on the CPU.

``dfot_tpu_torch.parallel`` (the launch read from the environment, the
mesh's shape rule, the FSDP rule), the loaders' ``process_shard`` (equal to
``dfot_tpu.data.loader``'s partitions and to grain's sharded sampler), the
sampler's NFE mesh (a 2-process gloo window equal to the one-process window
and to the JAX sampler's with the noise pinned, within 1e-5 relative L2) and
``python -m dfot_tpu_torch``'s multi-process launch: ``run(argv)`` in two
gloo processes, with ``torchrun``'s environment, equals the one-process
run, both in fp32, on the final weights (every tensor of the final
checkpoint within 1e-5 absolute) and on every logged number (training
losses, the mid-run validation's loss and sampled metrics, the final
validation's metrics; 1e-5 relative) in three forms: data
parallelism (batch 2 over two data ranks), FSDP2 (batch 1, fsdp 2, the
sharding floor lowered so that the tiny model has sharded parameters) and
ring attention (``mesh.tensor=2 mesh.sequence_parallel=true``); a
difference DFoT at data 2 likewise on its weights and every logged loss
(``diff_loss`` and ``xs_loss`` the global batch's); with loader workers, a
2-process run's training batches are grain's shards, rank by rank. The
2-process runs go one after another in one pair of processes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.data import loader as JL
from dfot_tpu.diffusion import core as JDC
from dfot_tpu.parallel import mesh as JM
from dfot_tpu.sampling import sampler as JSM
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.data import loader as TL
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.parallel import mesh as TM
from dfot_tpu_torch.parallel import multihost as TMH
from dfot_tpu_torch.sampling import sampler as TSM
from dfot_tpu_torch.training import checkpoint as TC
from dfot_tpu_torch.utils.weights import init_random_weights

from test_torch_port_ring import _free_port, run_workers
from test_torch_port_sampling import MASKS, _pin_noise, hg_pairs, jax_dcfg, rel_err, small_dcfg
from torch_port_helpers import one_thread, pinned

WEIGHT_ATOL, METRIC_RTOL, WINDOW_RTOL = 1e-5, 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# the launch, the mesh's rules
# ---------------------------------------------------------------------------

LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
               "SLURM_PROCID", "SLURM_LOCALID", "COORDINATOR_ADDRESS")


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"SLURM_NTASKS": "1"}, None),
    ({"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
     TMH.Launch(1, 0, 0, "tcp://h:9")),
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1", "MASTER_ADDR": "h", "MASTER_PORT": "9"},
     TMH.Launch(4, 3, 1, "tcp://h:9")),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "0",
      "COORDINATOR_ADDRESS": "c:7"}, TMH.Launch(2, 1, 0, "tcp://c:7")),
    ({"COORDINATOR_ADDRESS": "c:7", "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"},
     TMH.Launch(4, 3, 1, "tcp://c:7")),
    ({"WORLD_SIZE": "2"}, "RANK"),
    ({"WORLD_SIZE": "2", "RANK": "1"}, "MASTER_ADDR"),
    ({"WORLD_SIZE": "2", "RANK": "2", "MASTER_ADDR": "h", "MASTER_PORT": "9"}, "outside"),
], ids=["none", "slurm_one_task", "torchrun_one", "torchrun", "slurm", "coordinator",
        "no_rank", "no_address", "bad_rank"])
def test_launch_env(monkeypatch, env, want):
    """The launch as the environment describes it, and a launch that says
    there are several processes but not enough to form the group raises
    (nothing drops to one process). ``detect_multiprocess_env`` is the JAX
    predicate: several processes, or a coordinator."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            TMH.launch_env()
        return
    assert TMH.launch_env() == want
    assert TMH.detect_multiprocess_env() == (want is not None and (
        want.world > 1 or "COORDINATOR_ADDRESS" in env))
    if want is None:
        TMH.initialize(device="cpu")  # no launcher: a no-op
        assert not torch.distributed.is_initialized()
        assert TMH.gather_for_metrics({"a": np.array([1.0, 2.0])})["a"].tolist() == [1.0, 2.0]
        assert TMH.broadcast_from_zero(3) == 3 and TMH.is_rank_zero() and TMH.world_size() == 1


@pytest.mark.parametrize("batch,world,tensor", [
    (8, 8, 1), (1, 2, 1), (2, 2, 1), (2, 2, 2), (6, 8, 2), (3, 8, 1), (16, 4, 4)])
def test_mesh_shape_matches_jax(batch, world, tensor):
    """The experiments' mesh shape: the JAX training formula
    (``dfot_tpu/experiments/video_generation.py:165-176``)."""
    import math

    avail = world // tensor
    data = math.gcd(batch, avail)
    want = (data, avail // data) + ((tensor,) if tensor > 1 else ())
    assert TM.mesh_shape(batch, world, tensor) == want
    with pytest.raises(ValueError, match="does not divide"):
        TM.mesh_shape(batch, 3, 2)


@pytest.mark.parametrize("shape", [(8,), (300, 256), (256, 300), (255, 257), (3, 3, 64, 128),
                                   (1152, 4608), (7, 9, 1025)])
@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_param_sharding_rule_matches_jax(shape, fsdp):
    """The FSDP rule: the axis JAX's ``param_sharding_rule`` shards, or
    replicated, at its 2**16 floor."""
    spec = JM.param_sharding_rule("w", shape, fsdp)
    want = next((i for i, a in enumerate(spec) if a == "fsdp"), None)
    assert TM.param_sharding_rule(shape, fsdp) == want


# ---------------------------------------------------------------------------
# per-process data shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (2, 3)])
@pytest.mark.parametrize("n", [10, 11])
def test_process_shards_match_jax(shard, n):
    """Every epoch's shares partition the records as the JAX loaders'
    (the in-process loader's strided slices, drop_last or wrapped; grain's
    consecutive pieces, shuffled within, for the worker loader), and the
    shares of the processes are disjoint and equal in length."""
    import grain.python as grain

    index, count = shard
    items = [{"i": np.array(i)} for i in range(n)]
    for shuffle in (False, True):
        for drop_last in (True, False):
            lt = TL.DataLoader(items, 2, shuffle=shuffle, drop_last=drop_last, seed=3,
                               process_shard=shard)
            lj = JL.DataLoader(items, 2, shuffle=shuffle, drop_last=drop_last, seed=3,
                               process_shard=shard)
            assert len(lt) == len(lj)
            for _ in range(2):  # two epochs
                got = [b["i"].tolist() for b in lt]
                assert got == [b["i"].tolist() for b in lj]
        shares = [TL.DataLoader(items, 1, shuffle=shuffle, seed=3, drop_last=True,
                                process_shard=(i, count))._index_order() for i in range(count)]
        assert len({len(s) for s in shares}) == 1
        assert len(set(np.concatenate(shares).tolist())) == sum(len(s) for s in shares)
        # the worker loader: the keys grain's sampler hands this process
        wt = TL.WorkerDataLoader(items, 2, shuffle=shuffle, seed=4, num_workers=2,
                                 process_shard=shard)
        sampler = grain.IndexSampler(
            num_records=n, shard_options=grain.ShardOptions(index, count, drop_remainder=True),
            shuffle=shuffle, num_epochs=1, seed=4)
        want = [sampler[j * count + index].record_key for j in range(len(sampler) // count)]
        assert list(wt.epoch_order()) == want
        assert len(wt) == len(JL.GrainDataLoader(items, 2, process_shard=shard))
    with pytest.raises(ValueError, match="outside"):
        TL.DataLoader(items, 2, process_shard=(2, 2))


# ---------------------------------------------------------------------------
# the sampler's NFE mesh
# ---------------------------------------------------------------------------


def torchrun_env(world: int = 2) -> dict:
    """What ``torchrun`` sets besides each process's ``RANK`` and
    ``LOCAL_RANK`` (``run_workers`` sets those)."""
    return {"WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(_free_port())}

_SAMPLER_WORKER = r"""
import json, os, sys, zlib
import numpy as np
import torch
sys.path.insert(0, os.environ["DFOT_REPO"])
torch.set_num_threads(1)
from dfot_tpu_torch.diffusion import core as TDC
from dfot_tpu_torch.guidance import history_guidance as THG
from dfot_tpu_torch.parallel import make_mesh, multihost
from dfot_tpu_torch.sampling import sampler as TSM
from dfot_tpu_torch.algorithms.dfot_video import flagship
import dataclasses

def pinned(shape):
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)

TDC.clipped_normal = lambda shape, clip, generator=None, device=None, dtype=torch.float32: \
    torch.as_tensor(pinned(tuple(shape)), dtype=dtype, device=device)
multihost.initialize(device="cpu")
rows = []

def model(x, noise_in, cond, cond_mask):
    rows.append(x.shape[0])
    return torch.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - \
        0.3 * cond_mask[:, None, None, None]

dcfg = dataclasses.replace(flagship().dcfg, sampling_timesteps=3, is_continuous=False)
masks = np.array(json.loads(os.environ["MASKS"]))
plan = TSM.plan_sampling(masks, THG.HistoryGuidance.vanilla(4.0), "full_sequence", 1000, 3, 8)
window = TSM.make_window_sampler(model, dcfg, TDC.make_schedule(dcfg, device="cpu"),
                                 mesh=make_mesh())
x0 = torch.as_tensor(pinned((2, 8, 4, 3)))
out = window(x0, plan, None)
# the mesh's checks and a data rank's rows of a batch
from dfot_tpu_torch.parallel import mesh as TM
for bad in ((3, 1), (1, 1, 1, 2)):
    try:
        make_mesh(bad)
    except ValueError:
        pass
    else:
        raise AssertionError(f"mesh shape {bad} accepted")
rank = int(os.environ["RANK"])
got = TM.shard_batch({"x": np.arange(6), "y": torch.arange(6)}, make_mesh((2, 1)))
assert got["x"].tolist() == got["y"].tolist() == list(range(rank, 6, 2)), got
assert TM.shard_batch({"x": np.arange(6)}, make_mesh((1, 2)))["x"].tolist() == list(range(6))
np.save(os.environ["OUT"] + os.environ["RANK"] + ".npy", out.numpy())
print(json.dumps({"rows": sorted(set(rows)), "nfe_rows": 2 * plan.nfe}))
torch.distributed.destroy_process_group()
"""


def test_sampler_nfe_mesh_matches_one_process_and_jax(monkeypatch, tmp_path):
    """A window of 3 DDIM steps through an analytic model with vanilla HG
    (NFE 2) at batch 2: each of two gloo processes evaluates half of the
    4 expanded rows, and both hold the window of one process and of the JAX
    sampler, the noise pinned on every side. The workers also hold
    ``make_mesh``'s shape checks (JAX's) and ``shard_batch``'s rows."""
    masks = np.stack([MASKS[0], MASKS[1]])
    outs = run_workers(tmp_path, _SAMPLER_WORKER, env={
        "MASKS": json.dumps(masks.tolist()), "OUT": str(tmp_path / "win"), **torchrun_env()})
    for out in outs:
        info = json.loads(out.strip().splitlines()[-1])
        assert info["rows"] == [info["nfe_rows"] // 2]  # each process its half of the rows
    got = [np.load(tmp_path / f"win{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(got[0], got[1])

    _pin_noise(monkeypatch)
    import dataclasses

    dcfg = dataclasses.replace(small_dcfg(3), is_continuous=False)
    jh, th = hg_pairs()[0]
    tplan = TSM.plan_sampling(masks, th, "full_sequence", 1000, 3, 8)
    jplan = JSM.plan_sampling(masks, jh, "full_sequence", 1000, 3, 8)

    def t_model(x, noise_in, cond, cond_mask):
        return torch.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - \
            0.3 * cond_mask[:, None, None, None]

    def j_model(variables, x, noise_in, cond, cond_mask):
        return jnp.tanh(x) * (1 + noise_in[:, :, None, None] / 1000.0) - \
            0.3 * cond_mask[:, None, None, None]

    x0 = pinned((2, 8, 4, 3))
    one = TSM.make_window_sampler(t_model, dcfg, TDC.make_schedule(dcfg, device="cpu"))(
        torch.as_tensor(x0), tplan, None)
    js = JDC.make_schedule(jax_dcfg(dcfg))
    want = JSM.make_window_sampler(j_model, jax_dcfg(dcfg), js)(
        None, jnp.asarray(x0), jnp.zeros_like(jnp.asarray(x0)),
        jax.tree_util.tree_map(jnp.asarray, jplan), None, jax.random.PRNGKey(0),
        num_hist=jplan.num_hist, num_gen=jplan.num_gen)
    assert rel_err(one, want) < WINDOW_RTOL
    assert rel_err(got[0], one.numpy()) < WINDOW_RTOL
    with pytest.raises(TypeError, match="DeviceMesh"):
        TSM.make_window_sampler(t_model, dcfg, TDC.make_schedule(dcfg, device="cpu"),
                                mesh=object())


# ---------------------------------------------------------------------------
# run(argv) in two processes
# ---------------------------------------------------------------------------

TINY = [
    "+name=tiny", "dataset=realestate10k_mini", "algorithm=dfot_video_pose",
    "experiment=video_generation", "@diffusion/continuous",
    "experiment.tasks=[training,validation]",
    "++algorithm.tasks.prediction.history_guidance.name=vanilla",
    "++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0",
    "dataset.resolution=16",
    # level 0 is a transformer level of 8 frames of 8 x 8 tokens: 512 tokens,
    # 256 query rows a rank of a ring of two
    "++algorithm.backbone.channels=[32,32]",
    "++algorithm.backbone.block_types=[TransformerBlock,TransformerBlock]",
    "++algorithm.backbone.block_dropouts=[0.0,0.0]",
    "++algorithm.backbone.num_updown_blocks=[1]",
    "++algorithm.backbone.num_mid_blocks=1",
    "++algorithm.backbone.num_heads=2",
    "++algorithm.backbone.emb_channels=32",
    "++algorithm.backbone.use_checkpointing=[false,false]",
    "++algorithm.backbone.external_cond_dropout=0.0",
    "algorithm.diffusion.sampling_timesteps=2",
    "experiment.validation.batch_size=2",
    "experiment.validation.limit_batch=1",
    "++algorithm.logging.metrics=[mse,psnr]",
    "++algorithm.logging.max_num_videos=0",
    "++algorithm.logging.loss_freq=1",
    "experiment.training.max_steps=2",
    "experiment.training.lr=1e-3",
    "algorithm.lr_scheduler.num_warmup_steps=1",
    "experiment.ema.decay=0.5",
    "experiment.training.data.num_workers=0",
    # a mid-run validation at the last step: the EMA's denoising loss and a
    # sampled batch scored
    "experiment.validation.val_every_n_step=2",
    "++experiment.validation.validate_sample=true",
    "wandb.mode=disabled",
]
FORMS = {
    "data": ["experiment.training.batch_size=2"],
    "fsdp": ["experiment.training.batch_size=1"],
    "ring": ["experiment.training.batch_size=2", "experiment.training.mesh.tensor=2",
             "experiment.training.mesh.sequence_parallel=true",
             "experiment.validation.mesh.tensor=2",
             "experiment.validation.mesh.sequence_parallel=true"],
}

_RUN_WORKER = r"""
import json, os, socket, sys, time


def agreed_port(name):
    # rank 0 takes a free port just before its run and hands it to rank 1
    path = os.path.join(os.environ["TMPDIR"], f"port_{name}")
    if os.environ["RANK"] == "0":
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        with open(path + ".tmp", "w") as f:
            f.write(str(port))
        os.replace(path + ".tmp", path)
        return port
    deadline = time.time() + 300
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"rank 0 named no port for run {name}")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def main():  # not at import: a loader worker imports this file
    import torch
    sys.path.insert(0, os.environ["DFOT_REPO"])
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.experiments import video_generation as TVG
    from dfot_tpu_torch.ops import ring_attention as TR
    from dfot_tpu_torch.parallel import mesh as TM

    TVG.build_algorithm = lambda cfg, device=None: build_algorithm(cfg, torch.float32, device)
    TM.FSDP_MIN_SIZE = int(os.environ["FSDP_MIN_SIZE"])
    calls = [0]
    spa = TR.sequence_parallel_attention

    def counted(*a, **kw):
        calls[0] += 1
        return spa(*a, **kw)

    TR.sequence_parallel_attention = counted
    batches = []  # the frame sums of each training batch's videos, row by row
    train_batch = TVG.VideoGenerationExperiment._train_batch

    def recorded(self, batch):
        batches.append([float(v.astype("float64").sum()) for v in batch["videos"]])
        return train_batch(self, batch)

    TVG.VideoGenerationExperiment._train_batch = recorded
    infos = {}
    for name, argv in json.loads(os.environ["RUNS"]).items():
        os.environ["MASTER_PORT"] = str(agreed_port(name))  # each run forms its own group
        calls[0] = 0
        batches.clear()
        print(f"run {name}")
        exp = run(argv, device="cpu")
        sharded = sum(isinstance(p, DTensor) for p in exp.algo.model.parameters())
        infos[name] = {"ring_calls": calls[0], "sharded": sharded, "metrics": exp.last_metrics,
                       "ckpt": exp.saves[-1]["path"], "log": exp.logger.path,
                       "batches": list(batches)}
    print(json.dumps(infos))


if __name__ == "__main__":
    main()
"""


@pytest.fixture(scope="module")
def warm_start(tmp_path_factory):
    """A seeded random upstream-layout ``.ckpt`` of the tiny model."""
    algo = build_algorithm(load_config(TINY), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "warm_start.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, path)
    return path


def _one_process_run(argv):
    """``run(argv)`` in this process, in fp32 as the workers run: (final
    checkpoint state, logged lines)."""
    from dfot_tpu_torch.experiments import video_generation as TVG

    real = TVG.build_algorithm
    TVG.build_algorithm = lambda cfg, device=None: real(cfg, torch.float32, device)
    try:
        exp = run(argv, device="cpu")
    finally:
        TVG.build_algorithm = real
    return TC.restore_checkpoint(exp.saves[-1]["path"]), _logged(exp.logger.path)


@pytest.fixture(scope="module")
def one_process_runs(warm_start, tmp_path_factory):
    """The one-process run at each batch the forms use."""
    return {batch: _one_process_run(
        TINY + [f"experiment.training.batch_size={batch}", f"load={warm_start}",
                f"output_dir={tmp_path_factory.mktemp(f'one{batch}')}"]) for batch in (1, 2)}


def _logged(path) -> list:
    """Every line of a run's ``metrics.jsonl`` without its clock readings."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "steps_per_sec")}
                for line in f]


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}{k}/")
    elif torch.is_tensor(tree):
        yield prefix, tree


@pytest.fixture(scope="module")
def two_process_runs(warm_start, tmp_path_factory):
    """Every 2-process ``run(argv)`` of the tests below, one after another in
    one pair of gloo processes (each run its own group, taken down when it
    returns): {name: (argv, the two ranks' last lines)}, and rank 0's stdout."""
    tmp = tmp_path_factory.mktemp("two")
    argvs = {form: TINY + FORMS[form] + [f"load={warm_start}", f"output_dir={tmp / form}"]
             for form in FORMS}
    argvs["difference"] = difference_argv(tmp) + [f"output_dir={tmp / 'difference'}"]
    argvs["workers"] = worker_loader_argv() + [f"load={warm_start}",
                                               f"output_dir={tmp / 'workers'}"]
    env = {"RUNS": json.dumps(argvs), "FSDP_MIN_SIZE": "1024", **torchrun_env()}
    outs = run_workers(tmp, _RUN_WORKER, env=env, timeout=600)
    infos = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert outs[0].count("process group: backend gloo, world size 2") == len(argvs)
    return {name: (argvs[name], [i[name] for i in infos]) for name in argvs}


def _assert_same_run(infos, want_state, want_logged):
    """Rank 0's final checkpoint and logged lines against the one-process
    run's: every tensor within WEIGHT_ATOL, every number within METRIC_RTOL."""
    got_state = TC.restore_checkpoint(infos[0]["ckpt"])
    assert got_state["step"] == want_state["step"] == 2
    want = dict(_tensors({k: want_state[k] for k in ("params", "ema_params")}))
    got = dict(_tensors({k: got_state[k] for k in ("params", "ema_params")}))
    assert got.keys() == want.keys()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst <= WEIGHT_ATOL, worst
    # the training losses (and where the run validates, the mid-run
    # validation loss and sampled metrics and the final validation's
    # metrics), as rank 0 logged them
    got_logged = _logged(infos[0]["log"])
    assert [sorted(r) for r in got_logged] == [sorted(r) for r in want_logged]
    for g, w in zip(got_logged, want_logged):
        for name, value in w.items():
            assert g[name] == pytest.approx(value, rel=METRIC_RTOL), (name, g["step"])


@pytest.mark.parametrize("form", list(FORMS))
def test_two_process_run_matches_one_process(form, one_process_runs, two_process_runs):
    batch = 1 if form == "fsdp" else 2
    _, infos = two_process_runs[form]
    if form == "ring":
        assert all(i["ring_calls"] > 0 for i in infos)
    if form == "fsdp":
        assert all(i["sharded"] > 0 for i in infos)
    _assert_same_run(infos, *one_process_runs[batch])
    assert any("validation/loss" in r for r in one_process_runs[batch][1])
    assert infos[1]["metrics"] == {} and infos[0]["metrics"]  # rank 0 scores


def difference_argv(tmp) -> list:
    """A tiny difference DFoT on a seeded DMLab-layout directory under
    ``tmp`` (three episodes a split, 32 px), two training steps at batch 2."""
    rng = np.random.default_rng(0)
    for i, frames in enumerate((7, 9, 6)):
        for split in ("training", "validation"):
            d = tmp / "dmlab" / split / f"ep{i}"
            d.mkdir(parents=True, exist_ok=True)
            video = rng.integers(0, 256, (frames, 32, 32, 3)).astype(np.uint8)
            np.savez(d / f"v{i}.npz", video=video, actions=rng.integers(0, 3, frames))
    return ["+name=diff", "dataset=dmlab", "algorithm=difference_dfot_video",
            "experiment=video_generation", f"dataset.save_dir={tmp / 'dmlab'}",
            "++dataset.latent.enabled=false", "dataset.resolution=32", "dataset.max_frames=4",
            "dataset.context_length=0", "++algorithm.backbone.hidden_size=64",
            "++algorithm.backbone.depth=1", "++algorithm.backbone.num_heads=2",
            "experiment.tasks=[training]", "experiment.training.batch_size=2",
            "experiment.training.max_steps=2", "experiment.training.data.num_workers=0",
            "++algorithm.logging.loss_freq=1", "wandb.mode=disabled"]


def worker_loader_argv() -> list:
    """The tiny recipe's training alone, shuffled, with one loader worker."""
    drop = ("experiment.tasks=", "experiment.training.data.num_workers=",
            "experiment.validation.val_every_n_step=")
    return [a for a in TINY if not a.startswith(drop)] + [
        "experiment.tasks=[training]", "experiment.training.data.num_workers=1",
        "experiment.training.data.shuffle=true", "experiment.training.batch_size=2"]


def test_two_process_difference_dfot_logs_the_global_losses(two_process_runs, tmp_path):
    """The difference DFoT's step logs ``diff_loss`` and ``xs_loss`` beside
    the loss: at data 2 every one of them is the global batch's, as the
    one-process run logs it, and the weights are the one-process run's."""
    argv, infos = two_process_runs["difference"]
    argv = [a for a in argv if not a.startswith("output_dir=")]
    want_state, want_logged = _one_process_run(argv + [f"output_dir={tmp_path}"])
    assert all({"diff_loss", "xs_loss"} <= set(r) for r in want_logged if "loss" in r)
    _assert_same_run(infos, want_state, want_logged)


def test_two_process_worker_loader_reads_grain_shards(two_process_runs):
    """With loader workers (``num_workers > 0``) a data rank reads grain's
    shard, as the JAX package's ``GrainDataLoader`` under data parallelism:
    piece ``index`` of ``count`` consecutive equal pieces of the records,
    shuffled within the piece. A 2-process run's training batches are, rank
    by rank, the records of grain's sharded ``IndexSampler``. (Such a run
    groups the records otherwise than the one-process run, so only the
    in-process loader's runs equal it: the tests above.)"""
    import grain.python as grain

    from dfot_tpu_torch.data.video_dataset import build_dataset

    argv, infos = two_process_runs["workers"]
    cfg = load_config(argv)
    dataset = build_dataset(cfg.dataset, "training")
    seed = cfg.experiment.training.get("manual_seed", 0)
    for index, info in enumerate(infos):
        sampler = grain.IndexSampler(
            num_records=len(dataset), shard_options=grain.ShardOptions(index, 2, True),
            shuffle=True, num_epochs=1, seed=seed)
        keys = [sampler[j * 2 + index].record_key for j in range(2)]  # two steps of one row
        want = [[float(dataset[k]["videos"].astype(np.float64).sum())] for k in keys]
        assert info["batches"] == want, index


def test_tensor_axis_without_ring_raises(tmp_path, warm_start):
    with pytest.raises(NotImplementedError, match="A16b"):
        run(TINY + ["experiment.training.mesh.tensor=2", f"load={warm_start}",
                    f"output_dir={tmp_path}"], device="cpu")
    with pytest.raises(ValueError, match="does not divide 1 processes"):
        run(TINY + FORMS["ring"] + [f"load={warm_start}", f"output_dir={tmp_path}"],
            device="cpu")


_ONE_RANK_WORKER = r"""
import json, os, sys
import torch
sys.path.insert(0, os.environ["DFOT_REPO"])
torch.set_num_threads(1)
from dfot_tpu_torch.__main__ import run
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.experiments import video_generation as TVG

TVG.build_algorithm = lambda cfg, device=None: build_algorithm(cfg, torch.float32, device)
exp = run(json.loads(os.environ["ARGV"]), device="cpu")
print(json.dumps({"ckpt": exp.saves[-1]["path"], "log": exp.logger.path,
                  "group_after": torch.distributed.is_initialized()}))
"""


def test_one_process_launch_makes_a_one_rank_group(warm_start, one_process_runs, tmp_path):
    """``torchrun`` of one process: a one-rank group (gloo here, NCCL on the
    card) and its (1, 1) mesh, the run the plain one-process run; the group
    is taken down when ``run`` returns."""
    argv = TINY + ["experiment.training.batch_size=2", f"load={warm_start}",
                   f"output_dir={tmp_path / 'out'}"]
    (out,) = run_workers(tmp_path, _ONE_RANK_WORKER, n=1,
                         env={"ARGV": json.dumps(argv), **torchrun_env(1)})
    assert "process group: backend gloo, world size 1" in out
    info = json.loads(out.strip().splitlines()[-1])
    assert info["group_after"] is False
    want_state, want_logged = one_process_runs[2]
    got_state = TC.restore_checkpoint(info["ckpt"])
    for k, w in _tensors({k: want_state[k] for k in ("params", "ema_params")}):
        g = dict(_tensors({k2: got_state[k2] for k2 in ("params", "ema_params")}))[k]
        assert torch.equal(g, w), k
    assert _logged(info["log"]) == want_logged
