"""The ring hop's plain versions and the ring loop around them, on the CPU.

``dfot_tpu_torch.ops.ring_attention`` runs a hop as one kernel launch on the
card (the ring entries of B1, B4 and B5: the fold and the gradient sums
inside the kernels, a ``LocalRing``'s visiting shard indexed by
``kv_shift`` instead of rolled). Here, where the plain hops run:

- a ``LocalRing`` of R = 2 and 4 equals, bit for bit in fp32, forward and
  backward, the roll-based composite the ring was before: the plain block on
  shards moved by ``LocalRing.hop``, ``fold_block`` between blocks, the plain
  backward formulas summed in fp32 with the dk, dv sums travelling with
  their shard and brought home by one more hop;
- the ring through the plain hops matches JAX's
  ``sequence_parallel_attention`` at R = 2 and 4: the forward with its
  per-hop Pallas flash block in interpret mode (rtol 2e-5, atol 2e-5), the
  gradients through its dense block (rtol 1e-4, atol 1e-4; fp32 with other
  summation orders);
- a ``LocalRing`` never moves a shard (``hop`` is not called), and a
  ``ProcessRing`` posts hop s + 1's transfer before hop s's kernel and waits
  for it after, into a second pair of buffers;
- each ctypes signature of ``ops/_cuda.py`` has the arity and argument kinds
  of its ``extern "C"`` entry in ``csrc/``.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.ops.ring_attention import sequence_parallel_attention as jax_ring
from dfot_tpu.parallel import make_mesh
from dfot_tpu_torch.ops import _cuda
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import ring_attention as TR

from torch_port_helpers import one_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def _composite(q, k, v, do, ring):
    """The roll-based ring: (o, dq, dk, dv) of the sharded q, k, v against
    the sharded upstream gradient ``do``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = TR.block_attention(q, k, v, scale)
    ck, cv = k, v
    for _ in range(ring.size - 1):
        ck, cv = ring.hop(ck, cv)
        o, lse = TR.fold_block(o, lse, *TR.block_attention(q, ck, cv, scale))
    o = o.to(q.dtype)
    delta = TA._delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    ck, cv = k, v
    for hop in range(ring.size):
        if hop:
            ck, cv, dk, dv = ring.hop(ck, cv, dk, dv)
        dq += TA._dq_plain(q, ck, cv, do, lse, delta, False, scale)
        b_dk, b_dv = TA._dkv_plain(q, ck, cv, do, lse, delta, False, scale)
        dk += b_dk
        dv += b_dv
    if ring.size > 1:
        dk, dv = ring.hop(dk, dv)
    return o, dq, dk, dv


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("shape", [(2, 3, 128, 8), (1, 2, 64, 64)])
def test_shift_indexed_ring_equals_the_roll_based_one(R, shape):
    ring = TR.LocalRing(R)
    q, k, v, do = (ring.shard(torch.tensor(a)) for a in _inputs(shape, seed=R))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = TR.ring_attention(*leaves, ring)
    got = (o.detach(), *torch.autograd.grad(o, leaves, do))
    want = _composite(q, k, v, do, ring)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w), f"{name}: {float((g - w).abs().max())}"


def test_plain_hops_fold_and_sum_at_home():
    """One hop at a time: hop s's block is q against the shard of rank
    r - s (the stacked heads ``kv_shift`` back), and the dk, dv sums land at
    the visiting shard's home heads."""
    R, B, H = 3, 2, 2
    ring = TR.LocalRing(R)
    q, k, v, do = (torch.tensor(a) for a in _inputs((R * B, H, 64, 16), seed=9))
    scale = 0.25
    lse = TA.attention_reference(q, k, v, False, scale, True)[1]
    delta = torch.tensor(np.random.RandomState(10).rand(*q.shape[:-1], 1).astype(np.float32))
    for s in range(R):
        shift = ring.kv_shift(s, q)
        assert shift == s * B * H
        ks, vs = k, v
        for _ in range(s):
            ks, vs = ring.hop(ks, vs)
        o, b_lse = TR.ring_fwd_hop_plain(q, k, v, None, None, shift, True, scale)
        want_o, want_lse = TA.attention_reference(q, ks, vs, False, scale, True)
        assert torch.equal(o, want_o) and torch.equal(b_lse, want_lse)
        dq, dk, dv = TR.ring_bwd_hop_plain(q, k, v, do, lse, delta, None, None, None, shift,
                                           True, scale)
        b_dk, b_dv = TA._dkv_plain(q, ks, vs, do, lse, delta, False, scale)
        for _ in range(R - s):  # the rest of the way round: home
            b_dk, b_dv = ring.hop(b_dk, b_dv)
        assert torch.equal(dq, TA._dq_plain(q, ks, vs, do, lse, delta, False, scale))
        assert torch.equal(dk, b_dk) and torch.equal(dv, b_dv)


@pytest.mark.parametrize("R", [2, 4])
def test_plain_hops_match_jax_ring(cpu_mesh_devices, R):
    """The JAX ring over a tensor axis of R: its forward with the Pallas
    flash block in interpret mode (``_block_flash``), 128 query rows a rank
    at R = 4, and ``jax.grad`` of sum(sin(o)) through its dense block (JAX
    cannot differentiate the interpret-mode flash block inside the ring's
    ``shard_map``)."""
    q, k, v, _ = _inputs((1, 2, 128 * R, 32), seed=11 + R)
    mesh = make_mesh((8 // R, 1, R))
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jax_ring(*args, mesh, axis_name="tensor", use_flash=True, interpret=True))
    want_grads = jax.jit(jax.grad(
        lambda *a: jnp.sum(jnp.sin(jax_ring(*a, mesh, axis_name="tensor", use_flash=False))),
        (0, 1, 2)))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = TR.sequence_parallel_attention(*ts, TR.LocalRing(R))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_local_ring_moves_no_shard(monkeypatch):
    def refuse(self, *tensors):
        raise AssertionError("a LocalRing's ring loop moved a shard")

    monkeypatch.setattr(TR.LocalRing, "hop", refuse)
    q, k, v, do = (torch.tensor(a, requires_grad=True) for a in _inputs((1, 2, 256, 8), 4))
    o = TR.sequence_parallel_attention(q, k, v, TR.LocalRing(4))
    o.backward(do)
    want = TA.attention_reference(q.detach(), k.detach(), v.detach())
    np.testing.assert_allclose(o.detach().numpy(), want.numpy(), rtol=2e-5, atol=2e-6)


class _LoggedRing:
    """A ring whose shards travel (as a ProcessRing's) and which logs its
    transfers; a transfer hands the same shards back."""

    moves_shards = True

    def __init__(self, size, log):
        self.size, self.log = size, log

    def kv_shift(self, hop, x):
        return 0

    def start_hop(self, tensors, into=None):
        self.log.append(("post", None if into is None else tuple(t.data_ptr() for t in into)))
        ring = self

        class Transfer:
            def wait(self):
                ring.log.append(("wait",))
                received = into or tuple(t.clone() for t in tensors)
                for r, t in zip(received, tensors):
                    r.copy_(t)
                return received

        return Transfer()

    def hop(self, *tensors):
        self.log.append(("sums",))
        return tensors


def test_process_ring_overlaps_the_transfer_with_the_hop(monkeypatch):
    """Hop s + 1's K/V transfer is posted before hop s's kernel and waited
    for after it; from the third hop on it lands in the buffers two hops
    old (double-buffered; the inputs are never written). Backward, the dk,
    dv sums travel after each hop's kernels."""
    log = []
    for name in ("ring_fwd_hop", "ring_dq_hop", "ring_dkv_hop"):
        fn = getattr(TR, name)

        def logged(*args, _fn=fn, _name=name, **kwargs):
            log.append((_name, args[1].data_ptr()))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(TR, name, logged)
    ring = _LoggedRing(4, log)
    q, k, v, do = (torch.tensor(a) for a in _inputs((1, 2, 64, 8), 6))
    k.requires_grad_()
    o = TR.ring_attention(q, k, v, ring)
    kinds = [e[0] for e in log]
    assert kinds == ["post", "ring_fwd_hop", "wait"] * 3 + ["ring_fwd_hop"]
    seen = [e[1] for e in log if e[0] == "ring_fwd_hop"]
    assert seen[0] == k.data_ptr() and len(set(seen)) == 3 and seen[1] == seen[3]
    assert log[0][1] is None and log[3][1] is None and log[6][1][0] == seen[1]
    log.clear()
    o.backward(do)
    kinds = [e[0] for e in log]
    hop = ["post", "ring_dq_hop", "ring_dkv_hop", "sums", "wait"]
    assert kinds == hop * 3 + ["ring_dq_hop", "ring_dkv_hop", "sums"]


_C_KINDS = {"void*": "P", "float": "F", "int": "I", "long long": "L", "int64_t": "L"}
_PY_KINDS = {_cuda._P: "P", _cuda._F: "F", _cuda._I: "I", _cuda._L: "L"}


def _c_entries() -> dict:
    entries = {}
    for src in (ROOT / "dfot_tpu_torch" / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.replace("const", "").split()[:-1])
                kinds.append("P" if "*" in p else _C_KINDS[p])
            entries[name] = kinds
    return entries


def test_ctypes_signatures_match_the_c_entries():
    entries = _c_entries()
    assert {"dfot_ring_fwd", "dfot_ring_bwd_dq", "dfot_ring_bwd_dkv"} <= set(entries)
    assert set(_cuda._SIGNATURES) == set(entries)
    for name, argtypes in _cuda._SIGNATURES.items():
        assert [_PY_KINDS[t] for t in argtypes] == entries[name], name
