"""The difference-DFoT (``dfot_tpu_torch/algorithms/difference_dfot.py``) and
the difference-DiT's doubled RoPE (``models/embeddings.py:make_rope_3d``)
against the JAX package's (``dfot_tpu/algorithms/difference_dfot.py``,
``dfot_tpu/models/embeddings.py:308``).

- The doubled tables equal the JAX package's for both merges.
- The difference-DiT (DiT3D with ``double_rope_merge``) on the same weights
  (``import_dit3d_params(port.state_dict())``), fp32 on the CPU, forward and
  every gradient leaf within ``RTOL`` = 1e-5 relative (L2) of the JAX model
  and ``jax.grad``: both merges, on the merged 2T frames (beyond the
  model's T, which DiTBase runs as its joint image-video split, as the JAX
  model does) and on a merged sequence shorter than the table (its first
  rows: a short concat sequence does not get two copies of its positions).
- The algorithm from the ``tests/test_refine_and_difference.py`` composition,
  both merges: the train step's ``loss``, ``diff_loss`` and ``xs_loss``
  within 1e-5 relative of the JAX step's, the draws made by the JAX step's
  ``jax.random.split`` chain and injected; ``sample_videos`` with the noise
  pinned on both sides (``prediction`` and ``prediction_diff`` within
  ``WINDOW_RTOL``), the interleaved merge with one context frame, a sliding
  window over the merged stream (3 frames, windows of 4 merged tokens), and
  the concat merge's raise for context.
- ``difference_dit3d_factorized_matrix`` (FacMatDiT, interleaved): the same
  train step and window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.algorithms import build_algorithm as jax_build
from dfot_tpu.config import load_config as jax_load_config
from dfot_tpu.diffusion import core as JDC
from dfot_tpu.models import embeddings as JE
from dfot_tpu.training import noise_levels as JNL
from dfot_tpu.utils.torch_ckpt import import_dit3d_params
from dfot_tpu_torch.algorithms.dfot_video import build_algorithm
from dfot_tpu_torch.config import load_config
from dfot_tpu_torch.models import embeddings as TE
from dfot_tpu_torch.utils.weights import dit3d_state_dict_from_flax, init_random_weights

from test_refine_and_difference import TINY_DIFF_OVERRIDES
from test_torch_port_dit import dit_pair, rel_err
from test_torch_port_remainders import pin_noise
from torch_port_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


RTOL = 1e-5
WINDOW_RTOL = 1e-4
MATRIX = ["algorithm/backbone=difference_dit3d_factorized_matrix",
          "++algorithm.backbone.hidden_size=32", "++algorithm.backbone.embed_row_dim=32",
          "++algorithm.backbone.num_heads=2", "++algorithm.backbone.num_row_heads=2",
          "++algorithm.backbone.depth=1", "++algorithm.backbone.use_gradient_checkpointing=false"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("merge", ["concat", "interleaved"])
def test_doubled_tables_equal_jax(merge):
    got = TE.make_rope_3d(48, (3, 2, 4), double_merge=merge)
    want = JE.make_rope_3d(48, (3, 2, 4), double_merge=merge)
    assert got.cos.shape == (2 * 3 * 8, 48)
    np.testing.assert_array_equal(got.cos, np.asarray(want.cos, np.float32))
    np.testing.assert_array_equal(got.sin, np.asarray(want.sin, np.float32))
    with pytest.raises(ValueError, match="double-rope merge"):
        TE.make_rope_3d(48, (3, 2, 4), double_merge="stacked")


@pytest.mark.parametrize("frames", [8, 2], ids=["merged_2T", "shorter_than_table"])
@pytest.mark.parametrize("merge", ["concat", "interleaved"])
def test_difference_dit_matches_jax(merge, frames):
    jm, jv, pm = dit_pair(seed=20, resolution=(8, 8), variant="full", pos_emb_type="rope_3d",
                          spatial_mlp_ratio=4.0, double_rope_merge=merge)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, frames, 8, 8, 3)).astype(np.float32)
    k = rng.integers(0, 1000, (2, frames)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(params):
        out = jm.apply({**jv, "params": params}, jnp.asarray(x), jnp.asarray(k))
        return jnp.mean(out * jnp.asarray(g)), out

    # one jitted call: eager, jax.grad compiles op by op
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    out = pm(t(x), t(k))
    assert rel_err(out.detach(), want) < RTOL
    pm.zero_grad(set_to_none=True)
    (out * t(g)).mean().backward()
    want_grads = dit3d_state_dict_from_flax(jax.device_get(grads), None, 2)
    off = {n: e for n, p in pm.named_parameters()
           if (e := rel_err(p.grad, want_grads[n])) > RTOL}
    assert not off, off
    # control: the plain table over 2T frames in place of two copies of T.
    # It misses for the interleaved merge. The concat merge reads the same
    # rows: a merged sequence runs its first T frames through the table's
    # first T * P rows (its first copy) and the rest as single-frame images
    with torch.no_grad():
        for block in pm.dit_base.blocks:
            block.attn.rope = TE.RopeTables(TE.make_rope_3d(64, (8, 4, 4)))
        err = rel_err(pm(t(x), t(k)), want)
    assert err > 100 * RTOL if merge == "interleaved" else err < RTOL


def _algos(extra):
    """The JAX and the port algorithm of one composition, fp32, on the port's
    seeded weights."""
    argv = TINY_DIFF_OVERRIDES + extra
    talgo = build_algorithm(load_config(argv), torch.float32, device="cpu")
    init_random_weights(talgo.model, torch.Generator().manual_seed(30))
    jalgo = jax_build(jax_load_config(argv), compute_dtype=jnp.float32)
    state = {k: v.numpy() for k, v in talgo.model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, import_dit3d_params(state))
    return jalgo, params, talgo


CASES = {"concat": ["++algorithm.backbone.merge_type=concat"],
         "interleaved": ["++algorithm.backbone.merge_type=interleaved"],
         "factorized_matrix": MATRIX}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    from dfot_tpu.training.state import create_train_state
    import optax

    jalgo, params, talgo = _algos(CASES[case])
    rng = np.random.default_rng(31)
    xs = rng.standard_normal((2, 2, 8, 8, 3)).astype(np.float32)
    masks = np.array([[True, True], [True, False]])
    key = jax.random.PRNGKey(32)
    r_k, r_noise, _ = jax.random.split(key, 3)
    levels = np.asarray(JNL._rand_levels(jax.random.split(r_k, 4)[0], (2, 2), jalgo.nl_cfg))
    merged_shape = (2, 4, 8, 8, 3)
    noise = np.asarray(JDC.clipped_normal(r_noise, merged_shape, jalgo.dcfg.clip_noise))
    jstate = create_train_state(params, optax.sgd(0.0), use_ema=False)
    _, want = jalgo.make_train_step()(jstate, {"xs": jnp.asarray(xs),
                                               "masks": jnp.asarray(masks)}, key)
    start = {k: v.clone() for k, v in talgo.model.state_dict().items()}
    tstate = talgo.make_train_state()
    _, got = talgo.make_train_step()(tstate, {"xs": t(xs), "masks": t(masks)}, None,
                                     noise_levels=t(levels), noise=t(noise), dropout=False)
    talgo.model.load_state_dict(start)
    for name in ("loss", "diff_loss", "xs_loss"):
        assert float(got[name]) == pytest.approx(float(want[name]), rel=RTOL), name
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-4)
    # control: the frames' own noise for the difference stream too
    same = np.concatenate([noise[:, 2:], noise[:, 2:]], axis=1) if case == "concat" else \
        np.repeat(noise[:, 1::2], 2, axis=1)
    _, ctrl = talgo.make_train_step()(tstate, {"xs": t(xs), "masks": t(masks)}, None,
                                      noise_levels=t(levels), noise=t(same), dropout=False)
    assert abs(float(ctrl["diff_loss"]) - float(want["diff_loss"])) > 100 * RTOL * float(
        want["diff_loss"])


@pytest.mark.parametrize("case,frames,nct", [
    ("concat", 2, 0), ("interleaved", 2, 1), ("interleaved_sliding", 3, 1),
    ("factorized_matrix", 2, 1)])
def test_sample_videos_matches_jax(monkeypatch, case, frames, nct):
    pin_noise(monkeypatch)
    extra = {"interleaved_sliding": CASES["interleaved"] + [
        "++algorithm.tasks.prediction.sliding_context_len=2"]}.get(case, CASES.get(case))
    jalgo, params, talgo = _algos(extra)
    xs = np.random.default_rng(33).standard_normal((1, frames, 8, 8, 3)).astype(np.float32)
    want = jalgo.sample_videos(params, jax.random.PRNGKey(0), jnp.asarray(xs),
                               n_context_tokens=nct)
    got = talgo.sample_videos(None, t(xs), n_context_tokens=nct)
    assert sorted(got) == sorted(want) == ["gt", "prediction", "prediction_diff"]
    for key in ("prediction", "prediction_diff"):
        assert got[key].shape == xs.shape
        assert rel_err(got[key], want[key]) < WINDOW_RTOL, key
    if nct:
        np.testing.assert_array_equal(got["prediction"][:, 0].numpy(), xs[:, 0])
    if case == "concat":
        with pytest.raises(ValueError, match="interleaved merge"):
            talgo.sample_videos(None, t(xs), n_context_tokens=1)
