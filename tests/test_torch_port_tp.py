"""Megatron tensor parallelism of the port (``dfot_tpu_torch/parallel/tensor.py``)
against the JAX package's layout rule and against the unsharded model.

- The classification: the port's column/row/none role of every parameter of
  UViT3DPose (plain and axial), DiT3D (full and factorized), DiT1D,
  FacMatDiT, UNet3D and FAR-DiT equals ``dfot_tpu.parallel.mesh.
  tp_param_sharding_rule`` on the flax path the JAX importer gives that
  parameter, but for the named cases: a block whose heads the tensor size
  does not divide stays replicated where JAX's rule reads only the width,
  and UNet3D and FAR-DiT stay whole where JAX's suffix rule gives some of
  their layers a spec (their layers do not form the port's Megatron pairs;
  under ``jit`` JAX's specs are a layout and change no result).
- The layers: in two gloo processes each model's forward and every
  gradient leaf at tensor 2 (dropout on, its mask drawn at the whole width)
  equal the unsharded model's within ``RTOL`` = 1e-5 relative (L2), fp32;
  a row-parallel layer that adds its bias on every rank misses.
- ``python -m dfot_tpu_torch``: ``run(argv)`` at tensor 2 in two processes
  and at (data 1, fsdp 2, tensor 2) in four equals the one-process run on
  every final-checkpoint tensor (1e-5 absolute) and every logged number
  (1e-5 relative); no parameter is a DTensor on the tensor axis; the
  tensor-2 checkpoint validates in one process to the same metrics.
"""

import json

import numpy as np
import pytest
import torch

from dfot_tpu.parallel.mesh import tp_param_sharding_rule
from dfot_tpu.utils import torch_ckpt as JTC
from dfot_tpu_torch.parallel import tensor as TT

from test_torch_port_parallel import TINY, _assert_same_run, torchrun_env
from test_torch_port_ring import run_workers
from torch_port_helpers import one_thread

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# the classification against JAX's rule
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(dict(v), path)
        else:
            yield path, np.asarray(v)


def jax_roles(model, importer, size):
    """{port parameter name: JAX's role of the flax leaves it lands in}: each
    tensor of ``model.state_dict()`` filled with its own number, imported,
    and every leaf's numbers read back (``importer`` fuses or transposes)."""
    names = [n for n in model.state_dict() if ".timesteps." not in n]
    state = {n: np.full(tuple(model.state_dict()[n].shape), i + 1, np.float32)
             for i, n in enumerate(names)}
    roles = {}
    for path, leaf in _flat(importer(state)):
        spec = tp_param_sharding_rule(path, leaf.shape, size)
        role = None if spec is None else ("column" if spec[-1] == "tensor" else "row")
        for i in np.unique(leaf).astype(int):
            roles.setdefault(names[i - 1], set()).add(role)
    assert all(len(r) == 1 for r in roles.values()), roles
    return {n: r.pop() for n, r in roles.items()}


def _uvit(**kw):
    from torch_port_helpers import POSE_DIM, tiny_spec
    from dfot_tpu_torch.models.uvit import UViT3DPose

    spec = tiny_spec(**kw)
    importer = lambda s: JTC.import_uvit3d_params(s, spec.num_updown_blocks, 4, 2)  # noqa: E731
    return UViT3DPose(spec, 3, 16, POSE_DIM, use_fourier_noise_emb=True), importer


def _dit(**kw):
    from dfot_tpu_torch.models import dit as TD

    spec = dict(hidden_size=48, depth=2, num_heads=2, patch_size=2, max_temporal_length=4,
                spatial_mlp_ratio=4.0)
    spec.update(kw)
    return TD.DiT3D(TD.DiTSpec(**spec), 3, (8, 8)), JTC.import_dit3d_params


def _dit1d():
    from dfot_tpu_torch.models import dit1d as TD1

    spec = TD1.DiT1DSpec(hidden_size=64, depth=2, num_heads=2, max_temporal_length=4)
    return TD1.DiT1D(spec, 4, 8), JTC.import_dit1d_params


def _unet3d():
    from test_torch_port_backbones import UNET
    from dfot_tpu_torch.models import unet3d as TU

    model = TU.UNet3D(TU.UNet3DSpec(**UNET), 3, 16, use_causal_mask=True)
    return model, lambda s: JTC.import_unet3d_params(s, num_levels=2, num_res_blocks=2)


def _far():
    from test_torch_port_backbones import FAR
    from dfot_tpu_torch.models import far as TF

    model = TF.FARDiT(TF.FARSpec(**FAR), 3, (8, 8), external_cond_type="label",
                      external_cond_num_classes=5, external_cond_dropout=0.1)
    return model, JTC.import_far_params


FACMAT = dict(variant="factorized_matrix_attention", pos_emb_type="rope_2d", embed_col_dim=16,
              embed_row_dim=16, num_col_heads=2, num_row_heads=2, matrix_use_bias=True,
              use_temporal_rope=True, mlp_ratio=4.0)

MODELS = {
    "uvit3d_pose": lambda: _uvit(),
    "uvit3d_pose_axial": lambda: _uvit(block_types=("ResBlock", "ResBlock",
                                                    "AxialTransformerBlock", "TransformerBlock")),
    "uvit3d_pose_3_heads": lambda: _uvit(num_heads=3, channels=(32, 32, 48, 48)),
    "dit3d": lambda: _dit(),
    "dit3d_factorized": lambda: _dit(variant="factorized_attention", mlp_ratio=4.0,
                                     pos_emb_type="sinusoidal_factorized"),
    "dit3d_3_heads": lambda: _dit(num_heads=3),
    "dit1d": _dit1d,
    "facmat_dit": lambda: _dit(**FACMAT),
    "unet3d": _unet3d,
    "far_dit": _far,
}

# the parameters JAX's rule gives a spec and the port keeps whole: {model:
# (a pattern of their names, why)}
NAMED_DIFFERENCES = {
    # 3 heads at tensor 2: JAX shards the fused width 7C = 336 and the MLP
    # hidden; the port keeps a block whole where its heads do not divide
    "uvit3d_pose_3_heads": (r"fused_attn_mlp_proj|attn_out|mlp_out", "heads do not divide"),
    "dit3d_3_heads": (r"attn\.(qkv|proj)", "heads do not divide"),
    # JAX's suffix rule reads UNet3D's to_qkv as column, to_out as row (the
    # temporal one as column: "temporal_attn/proj"), its emb_proj as row
    "unet3d": (r"to_qkv|to_out|emb_layers", "UNet3D stays whole"),
    # FAR's to_q/k/v (fused to qkv), attn_out, ff fc1/fc2 and its
    # norm_out/proj_out ("out/kernel") get specs in JAX
    "far_dit": (r"to_[qkv]|to_out|mlp\.net|norm_out|proj_out", "FAR-DiT stays whole"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_classification_matches_jax_rule(name):
    import re

    model, importer = MODELS[name]()
    want = jax_roles(model, importer, 2)
    got = TT.tensor_parallel_roles(model, 2)
    pattern, _ = NAMED_DIFFERENCES.get(name, (None, None))
    differ = {n for n in want if got[n] != want[n]}
    named = {n for n in differ if pattern and re.search(pattern, n)}
    assert differ == named, sorted(differ - named)
    for n in named:  # each named difference is a spec the port does not shard
        assert got[n] is None and want[n] is not None, n
    if pattern is None:
        assert not differ
    else:
        assert named, f"{name}: no parameter differs"
    # the port shards only what JAX's rule gives the same role
    assert all(want[n] == r for n, r in got.items() if r is not None)
    assert set(got) == {n for n, _ in model.named_parameters()}


# ---------------------------------------------------------------------------
# the layers at tensor 2 against the unsharded model
# ---------------------------------------------------------------------------

_LAYER_WORKER = r"""
import json, os, sys, copy
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ["DFOT_REPO"])
torch.set_num_threads(1)
from dfot_tpu_torch.parallel import tensor as TT
from dfot_tpu_torch.models import dit as TD, dit1d as TD1
from dfot_tpu_torch.models.uvit import UViT3DPose, UViTSpec
from dfot_tpu_torch.utils.weights import init_random_weights

rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=2)
g = torch.Generator().manual_seed(0)

def uvit(block):
    spec = UViTSpec(channels=(32, 32), emb_channels=32, patch_size=2,
                    block_types=("ResBlock", block), block_dropouts=(0.0, 0.3),
                    num_updown_blocks=(1,), num_mid_blocks=1, num_heads=2,
                    max_temporal_length=4)
    model = UViT3DPose(spec, 3, 16, 6, use_fourier_noise_emb=True, external_cond_dropout=0.3)
    x = torch.randn(2, 4, 16, 16, 3, generator=g)
    return model, (x, torch.rand(2, 4, generator=g), torch.randn(2, 4, 16, 16, 6, generator=g))

def dit(**kw):
    spec = dict(hidden_size=32, depth=2, num_heads=2, patch_size=2, max_temporal_length=4,
                spatial_mlp_ratio=4.0)
    spec.update(kw)
    model = TD.DiT3D(TD.DiTSpec(**spec), 3, (8, 8))
    return model, (torch.randn(2, 4, 8, 8, 3, generator=g), torch.rand(2, 4, generator=g) * 999)

def dit1d():
    model = TD1.DiT1D(TD1.DiT1DSpec(hidden_size=32, depth=2, num_heads=2,
                                    max_temporal_length=4, qk_norm=True), 4, 8)
    return model, (torch.randn(2, 4, 1, 8, 4, generator=g), torch.rand(2, 4, generator=g) * 999)

MODELS = {
    "uvit3d_pose": lambda: uvit("TransformerBlock"),
    "uvit3d_pose_axial": lambda: uvit("AxialTransformerBlock"),
    "dit3d": dit,
    "dit3d_factorized": lambda: dit(variant="factorized_attention", mlp_ratio=4.0,
                                    pos_emb_type="sinusoidal_factorized"),
    "dit1d": dit1d,
    "facmat_dit": lambda: dit(variant="factorized_matrix_attention", pos_emb_type="rope_2d",
                              embed_col_dim=16, embed_row_dim=16, num_col_heads=2,
                              num_row_heads=2, matrix_use_bias=True, use_temporal_rope=True,
                              mlp_ratio=4.0),
}

def run(model, args):
    model.train()
    model.zero_grad(set_to_none=True)
    torch.manual_seed(5)  # the dropout masks: the same stream on both sides
    out = model(*args)
    (out * torch.cos(out)).mean().backward()
    grads = {n: TT.gather_whole(model, n, p.grad) for n, p in model.named_parameters()}
    return out.detach(), grads

def rel(a, b, floor=1e-30):
    return float((a - b).norm() / max(float(b.norm()), floor))

mutant_forward = TT.RowParallelLinear.forward
def bias_on_every_rank(self, x):
    y = TT._ReduceFromGroup.apply(torch.nn.functional.linear(x, self.weight, self.bias),
                                  self.tp_group)
    return y

result = {}
for name, make in MODELS.items():
    model, args = make()
    init_random_weights(model, torch.Generator().manual_seed(1))
    want, want_g = run(model, args)
    sharded = copy.deepcopy(model)
    plan = TT.apply_tensor_parallel(sharded, dist.group.WORLD)
    got, got_g = run(sharded, args)
    # a leaf's error against its own norm, or against a thousandth of the
    # largest leaf's where its gradient is zero in exact arithmetic (a conv
    # bias before a GroupNorm of one channel a group)
    floor = 1e-3 * max(float(v.norm()) for v in want_g.values())
    worst = max([rel(got, want)] + [rel(got_g[n], want_g[n], floor) for n in want_g])
    local = sum(p.numel() for p in sharded.parameters())
    TT.RowParallelLinear.forward = bias_on_every_rank
    mutant, _ = run(sharded, args)
    TT.RowParallelLinear.forward = mutant_forward
    TT.remove_tensor_parallel(sharded)
    back, _ = run(sharded, args)
    result[name] = {"worst": worst, "mutant": rel(mutant, want), "back": rel(back, want),
                    "sharded": len(plan), "local": local,
                    "whole": sum(p.numel() for p in model.parameters())}
print(json.dumps(result))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def layer_results(tmp_path_factory):
    outs = run_workers(tmp_path_factory.mktemp("tp_layers"), _LAYER_WORKER)
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return got


@pytest.mark.parametrize("name", ["uvit3d_pose", "uvit3d_pose_axial", "dit3d",
                                  "dit3d_factorized", "dit1d", "facmat_dit"])
def test_tensor_parallel_layers_match_unsharded(layer_results, name):
    """Forward and every gradient leaf (gathered whole) at tensor 2 against
    the unsharded model, dropout on (U-ViT: 0.3 in the MLP, whose mask is
    drawn at the whole hidden width, and the pose dropout); the shards hold
    fewer numbers than the model; a row layer that adds its bias on each
    rank misses; the layers made whole again compute the unsharded model."""
    for rank, got in enumerate(layer_results):
        r = got[name]
        assert r["sharded"] > 0 and r["local"] < r["whole"], (rank, r)
        assert r["worst"] < RTOL, (rank, r)
        assert r["back"] < RTOL, (rank, r)
        assert r["mutant"] > 100 * RTOL, (rank, r)


# ---------------------------------------------------------------------------
# python -m dfot_tpu_torch at tensor 2
# ---------------------------------------------------------------------------

TP_FORMS = {
    # 2 processes: (data 1, fsdp 1, tensor 2)
    "tensor": (2, ["experiment.training.batch_size=2", "experiment.training.mesh.tensor=2",
                   "experiment.validation.mesh.tensor=2"]),
    # 4 processes: (data 1, fsdp 2, tensor 2), the sharding floor lowered so
    # that FSDP2 shards the tiny model's tensor-parallel shards further
    "fsdp_tensor": (4, ["experiment.training.batch_size=1", "experiment.training.mesh.tensor=2",
                        "experiment.validation.mesh.tensor=2"]),
}


def _tp_worker() -> str:
    """The parallel tests' ``run(argv)`` worker, also reporting the tensor
    size the model ran at and the DTensors placed on a tensor axis."""
    from test_torch_port_parallel import _RUN_WORKER

    return _RUN_WORKER.replace(
        '''        sharded = sum(isinstance(p, DTensor) for p in exp.algo.model.parameters())''',
        '''        sharded = sum(isinstance(p, DTensor) for p in exp.algo.model.parameters())
        on_tensor_axis = sum("tensor" in (p.device_mesh.mesh_dim_names or ())
                             for p in exp.algo.model.parameters() if isinstance(p, DTensor))
        from dfot_tpu_torch.parallel.tensor import tensor_parallel_size
        tp = tensor_parallel_size(exp.algo.model)''').replace(
        '''"ring_calls": calls[0], "sharded": sharded,''',
        '''"ring_calls": calls[0], "sharded": sharded, "tp": tp,
                       "on_tensor_axis": on_tensor_axis,''')


@pytest.fixture(scope="module")
def warm_start_tp(tmp_path_factory):
    from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
    from dfot_tpu_torch.config import load_config
    from dfot_tpu_torch.utils.weights import init_random_weights

    algo = build_algorithm(load_config(TINY), torch.float32, device="cpu")
    init_random_weights(algo.model, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "warm_start.ckpt")
    torch.save({"state_dict": {"diffusion_model.model." + k: v
                               for k, v in algo.model.state_dict().items()}}, path)
    return path


def _resume_argv(argv, ckpt):
    """Training alone from a checkpoint directory, one more step."""
    drop = ("output_dir=", "load=", "experiment.tasks=", "experiment.training.max_steps=")
    return [a for a in argv if not a.startswith(drop)] + [
        "experiment.tasks=[training]", "experiment.training.max_steps=3", f"load={ckpt}"]


def _one_process(argv, out):
    """The one-process run of ``argv`` (its meshes dropped): (final
    checkpoint state, logged lines, its directory)."""
    from test_torch_port_parallel import TVG_fp32, _logged
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.training import checkpoint as TC

    argv = [a for a in argv if not a.startswith(("output_dir=", "experiment.training.mesh",
                                                 "experiment.validation.mesh"))]
    with TVG_fp32():
        exp = run(argv + [f"output_dir={out}"], device="cpu")
    path = exp.saves[-1]["path"]
    return TC.restore_checkpoint(path), _logged(exp.logger.path), path


@pytest.fixture(scope="module")
def tp_runs(warm_start_tp, tmp_path_factory):
    """Each form's one-process run, then its run in its own group of gloo
    processes, the tensor form with a second run resuming the one-process
    run's checkpoint at tensor 2: {form: (argv, one-process run, the ranks'
    last lines)}."""
    got = {}
    for form, (n, extra) in TP_FORMS.items():
        tmp = tmp_path_factory.mktemp(form)
        argv = TINY + extra + [f"load={warm_start_tp}", f"output_dir={tmp / 'out'}"]
        one = _one_process(argv, tmp / "one")
        runs = {form: argv}
        if form == "tensor":
            runs["resume"] = _resume_argv(argv, one[2]) + [f"output_dir={tmp / 'resume'}"]
        env = {"RUNS": json.dumps(runs), "FSDP_MIN_SIZE": "1024", **torchrun_env(n)}
        outs = run_workers(tmp, _tp_worker(), n=n, env=env, timeout=600)
        lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        for name, run_argv in runs.items():
            got[name] = (run_argv, one, [line[name] for line in lines])
    return got


@pytest.mark.parametrize("form", list(TP_FORMS))
def test_tensor_parallel_run_matches_one_process(form, tp_runs):
    """``run(argv)`` with ``mesh.tensor=2`` (no ``sequence_parallel``) trains
    and validates with the weights sharded Megatron-style and equals the
    one-process run: every final-checkpoint tensor (gathered whole, under
    the upstream names) within 1e-5 absolute, every logged number within
    1e-5 relative. No parameter is a DTensor on the tensor axis (FSDP2's
    DTensors live on the (data, fsdp) mesh)."""
    _, (want_state, want_logged, _), infos = tp_runs[form]
    assert all(i["tp"] == 2 and i["on_tensor_axis"] == 0 for i in infos)
    if form == "fsdp_tensor":
        assert all(i["sharded"] > 0 for i in infos)
    _assert_same_run(infos, want_state, want_logged)
    assert any("validation/loss" in r for r in want_logged)


def test_tensor_parallel_checkpoint_loads_at_tensor_1(tp_runs, tmp_path):
    """A checkpoint holds whole tensors under the upstream names, so it moves
    between tensor sizes: the one-process checkpoint resumed at tensor 2
    trains the step the one-process resume trains (weights within 1e-5),
    and the tensor-2 run's checkpoint, validated in one process, gives the
    metrics the one-process run's checkpoint gives."""
    from test_torch_port_parallel import TVG_fp32
    from dfot_tpu_torch.__main__ import run
    from dfot_tpu_torch.training import checkpoint as TC

    argv, (_, _, one_ckpt), infos = tp_runs["resume"]
    want_state, want_logged, _ = _one_process(argv, tmp_path / "resume")
    assert TC.restore_checkpoint(infos[0]["ckpt"])["step"] == want_state["step"] == 3
    worst = max(float((TC.restore_checkpoint(infos[0]["ckpt"])["params"][k] - v).abs().max())
                for k, v in want_state["params"].items())
    assert worst <= 1e-5, worst

    argv, _, infos = tp_runs["tensor"]
    keep = [a for a in argv if not a.startswith(("output_dir=", "load=", "experiment.tasks=",
                                                 "experiment.training.mesh",
                                                 "experiment.validation.mesh"))]
    metrics = []
    for i, ckpt in enumerate((infos[0]["ckpt"], one_ckpt)):
        with TVG_fp32():
            exp = run(keep + ["experiment.tasks=[validation]", f"load={ckpt}",
                              f"output_dir={tmp_path / str(i)}"], device="cpu")
        metrics.append(exp.last_metrics)
    assert metrics[0] and set(metrics[0]) == set(metrics[1])
    for name, value in metrics[1].items():
        assert metrics[0][name] == pytest.approx(value, rel=RTOL), name
