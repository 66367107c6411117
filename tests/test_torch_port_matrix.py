"""The port's matrix-attention DiTs against the JAX package.

``MatrixAttention``, ``MatrixDiTBlock`` and DiT3D in both matrix variants
(``full_matrix_attention``, ``factorized_matrix_attention``) get seeded
random weights in the port; ``import_dit3d_params(port.state_dict())`` gives
the JAX modules the same weights, and both see the same seeded numpy inputs
in fp32 on the CPU. Column and row heads are both above one (c = 2, r = 3),
so a mix-up of the two head axes cannot pass; a frame has P = 16 patches.

Tolerances: outputs 1e-5 relative (L2). The matrix blocks are the same
chain of products and the plain LayerNorm in both packages; the factorized
variant's spatial blocks run the port's plain B8 and B10, whose LayerNorm
takes its variance as E[x^2] - mu^2, and a DiT of two blocks stays within
the bound. Gradients of every parameter 1e-4 relative (L2).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.algorithms.dfot_video import build_algorithm as jax_build_algorithm
from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu.models import dit as JD
from dfot_tpu.models import embeddings as JE
from dfot_tpu.models import matrix as JM
from dfot_tpu.utils.torch_ckpt import import_dit3d_params
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.models import dit as TD
from dfot_tpu_torch.models import embeddings as TE
from dfot_tpu_torch.models import matrix as TM
from dfot_tpu_torch.utils.weights import dit3d_state_dict_from_flax, init_random_weights
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, C, T = 16, 48, 4  # patches a frame (8 x 8 latents, patch 2), width, frames
MATRIX = dict(embed_col_dim=8, embed_row_dim=48, num_col_heads=2, num_row_heads=3)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randomized(model, seed=0):
    init_random_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


def jax_params(state: dict, path=()):
    """The port's (prefixed) state dict as the JAX module's params, down
    ``path`` of the DiT3D tree."""
    tree = import_dit3d_params({k: v.detach().numpy() for k, v in state.items()})
    for part in path:
        tree = tree[part]
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def prefixed(module, prefix: str) -> dict:
    return {prefix + k: v for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# MatrixAttention and MatrixDiTBlock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed_u", [None, "identity"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("flatten_rope", [False, True])
@pytest.mark.parametrize("multi_token", [False, True])
def test_matrix_attention_matches(multi_token, flatten_rope, use_bias, fixed_u):
    # identity U needs E_col = P: c = 2 heads of n = 8 rows
    ecol = P if fixed_u else MATRIX["embed_col_dim"]
    c, r, erow = MATRIX["num_col_heads"], MATRIX["num_row_heads"], MATRIX["embed_row_dim"]
    n, d = ecol // c, erow // r
    dim = n * d if flatten_rope else d
    kw = dict(multi_token=multi_token, flatten_rope=flatten_rope, use_bias=use_bias,
              fixed_u=fixed_u)
    pm = randomized(TM.MatrixAttention(P, C, ecol, erow, c, r,
                                       rope=TE.RopeTables(TE.make_rope_1d(dim, T)), **kw), seed=1)
    if fixed_u:
        assert not hasattr(pm, "qkv_u") and not hasattr(pm, "proj_u")
    jm = JM.MatrixAttention(col_dim=P, row_dim=C, embed_col_dim=ecol, embed_row_dim=erow,
                            num_col_heads=c, num_row_heads=r, rope=JE.make_rope_1d(dim, T), **kw)
    x = np.random.default_rng(1).standard_normal((2, T, P, C)).astype(np.float32)
    want = jm.apply(jax_params(prefixed(pm, "dit_base.blocks.0.attn."), ("dit", "block_0", "attn")),
                    jnp.asarray(x))
    got = pm(t(x))
    assert got.shape == x.shape
    assert rel_err(got.detach(), want) < OUT_RTOL


@pytest.mark.parametrize("mlp_ratio", [4.0, None])
def test_matrix_block_matches(mlp_ratio):
    d = MATRIX["embed_row_dim"] // MATRIX["num_row_heads"]
    pm = randomized(TM.MatrixDiTBlock(
        P, C, **MATRIX, mlp_ratio=mlp_ratio, matrix_rope=TE.RopeTables(TE.make_rope_1d(d, T)),
        use_bias=True), seed=2)
    assert hasattr(pm, "mlp") == (mlp_ratio is not None)
    jm = JM.MatrixDiTBlock(col_hidden_size=P, row_hidden_size=C, **MATRIX, mlp_ratio=mlp_ratio,
                           matrix_rope=JE.make_rope_1d(d, T), use_bias=True)
    rng = np.random.default_rng(2)
    x, c = (rng.standard_normal((2, T * P, C)).astype(np.float32) for _ in range(2))
    want = jm.apply(jax_params(prefixed(pm, "dit_base.blocks.0."), ("dit", "block_0")),
                    jnp.asarray(x), jnp.asarray(c))
    assert rel_err(pm(t(x), t(c)).detach(), want) < OUT_RTOL


# ---------------------------------------------------------------------------
# DiT3D in both matrix variants
# ---------------------------------------------------------------------------


def spec_kw(**kw):
    base = dict(hidden_size=C, depth=2, num_heads=2, patch_size=2, max_temporal_length=T,
                pos_emb_type="rope_2d", spatial_mlp_ratio=4.0, matrix_use_bias=True,
                use_temporal_rope=True, **MATRIX)
    base.update(kw)
    return base


def dit_pair(seed, **kw):
    s = spec_kw(**kw)
    pm = randomized(TD.DiT3D(TD.DiTSpec(**s), 3, (8, 8)), seed)
    jm = JD.DiT3D(spec=JD.DiTSpec(**s), x_channels=3, resolution=(8, 8))
    return jm, jax_params(pm.state_dict()), pm


VARIANTS = [
    dict(variant="factorized_matrix_attention"),
    dict(variant="full_matrix_attention"),
    dict(variant="factorized_matrix_attention", matrix_multi_token=True, flatten_matrix_rope=True,
         pos_emb_type="sinusoidal_factorized", use_gradient_checkpointing=True),
    dict(variant="full_matrix_attention", use_temporal_rope=False, matrix_use_bias=False,
         pos_emb_type="sinusoidal_2d"),
]
VARIANT_IDS = ["factorized", "full", "factorized-multi_token-flat_rope", "full-no_rope"]


@pytest.mark.parametrize("kw", VARIANTS, ids=VARIANT_IDS)
def test_matrix_dit3d_forward_matches(kw):
    """Two frames beyond max_temporal_length: the joint image-video batch,
    whose images go through the matrix blocks as one-frame videos."""
    jm, jv, pm = dit_pair(3, **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, T + 2, 8, 8, 3)).astype(np.float32)
    k = rng.integers(0, 1000, (2, T + 2)).astype(np.float32)
    want = jm.apply(jv, jnp.asarray(x), jnp.asarray(k))
    got = pm(t(x), t(k))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_err(got.detach(), want) < OUT_RTOL


@pytest.mark.parametrize("kw", VARIANTS[:2], ids=VARIANT_IDS[:2])
def test_matrix_dit3d_gradients_match_jax(kw):
    """Every parameter's gradient against ``jax.grad``, carried onto the
    port's names by ``dit3d_state_dict_from_flax``."""
    jm, jv, pm = dit_pair(4, use_gradient_checkpointing=True, **kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, 8, 8, 3)).astype(np.float32)
    k = rng.integers(0, 1000, (2, T)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(k))
        return jnp.mean(out * jnp.asarray(g))

    want_loss, want = jax.value_and_grad(jloss)(jv["params"])
    want = dit3d_state_dict_from_flax(jax.device_get(want), None, 2)
    pm.train()
    loss = (pm(t(x), t(k)) * t(g)).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-8)
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and any(".attn.qkv_u" in n for n in got)
    bad = {n: e for n in want if (e := rel_err(got[n].numpy(), want[n].numpy())) > GRAD_RTOL}
    assert not bad, bad


def test_matrix_state_dict_round_trip():
    """The inverse map gives the port's state dict back, bit for bit."""
    _, jv, pm = dit_pair(5, variant="factorized_matrix_attention")
    back = dit3d_state_dict_from_flax(jax.device_get(jv["params"]), None, 2)
    state = pm.state_dict()
    assert set(back) == set(state)
    for name, value in back.items():
        assert torch.equal(value, state[name]), name


# ---------------------------------------------------------------------------
# every FacMatDiT and FullMatDiT preset through build_algorithm
# ---------------------------------------------------------------------------


def _presets():
    out = []
    for family, backbone in (("FacMatDiT", "dit3d_factorized_matrix"),
                             ("FullMatDiT", "dit3d_full_matrix")):
        base = os.path.join(ROOT, "configurations", "shortcut", family)
        for path in sorted(glob.glob(os.path.join(base, "**", "*.yaml"), recursive=True)):
            name = os.path.relpath(path, base)[: -len(".yaml")]
            out.append((backbone, f"@{family}/{name}"))
    return out


PRESETS = _presets()


def test_every_preset_is_listed():
    assert len(PRESETS) == 30
    assert ("dit3d_factorized_matrix", "@FacMatDiT/L") in PRESETS
    assert ("dit3d_full_matrix", "@FullMatDiT/XL") in PRESETS


@pytest.mark.parametrize("backbone,preset", PRESETS, ids=[p for _, p in PRESETS])
def test_preset_builds_as_jax_composes_it(backbone, preset):
    """The UCF-101 latent composition with each preset: the port's
    ``build_algorithm`` (on the meta device) holds the spec the JAX
    algorithm builds from ``dfot_tpu.config``'s composition."""
    argv = ["+name=ucf", "dataset=ucf_101", "algorithm=dfot_video",
            "experiment=video_generation", f"algorithm/backbone={backbone}", preset]
    algo = build_algorithm(load_config(argv), device="meta")
    jalgo = jax_build_algorithm(jax_load_config(argv))
    spec = algo.model.spec
    assert dataclasses.asdict(spec) == dataclasses.asdict(jalgo.model.spec)
    assert algo.x_shape == tuple(jalgo.x_shape) == (8, 8, 32)
    blocks = algo.model.dit_base.temporal_blocks if spec.variant.startswith("factorized") \
        else algo.model.dit_base.blocks
    assert all(isinstance(b, TM.MatrixDiTBlock) for b in blocks) and len(blocks) == spec.depth
