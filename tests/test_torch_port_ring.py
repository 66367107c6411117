"""Ring attention of the port against the JAX package's, on the CPU.

``dfot_tpu_torch.ops.ring_attention`` (a ``LocalRing`` of R = 2 and 4
virtual ranks in this process, and a ``ProcessRing`` of two gloo processes)
is held to ``dfot_tpu.ops.ring_attention.sequence_parallel_attention`` over
the ``tensor`` axis of ``make_mesh((2, 1, 4))``: the forward at rtol
2e-5, atol 2e-6 (``tests/test_ring_attention.py``'s), and ``jax.grad`` of
``sum(sin(o))`` at rtol 1e-4, atol 1e-5, on the same numpy inputs; the
JAX ring's per-hop Pallas flash block in interpret mode too. A control ring
differentiated by autograd through the fold, whose blocks' LSE carries no
gradient (the custom op ``dfot::flash_attention`` marks it so), must miss
the gradient tolerance. The gates: an N the ring does not divide raises, and
the dispatcher's ring route and the DiT's packed route switch at exactly 128
query rows a rank.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfot_tpu.ops.ring_attention import sequence_parallel_attention as jax_ring
from dfot_tpu.parallel import make_mesh
from dfot_tpu_torch.models import dit as TD
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import ring_attention as TR

from torch_port_helpers import one_thread

FWD_RTOL, FWD_ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _inputs(shape=(2, 3, 32, 8), seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_reference(cpu_mesh_devices):
    """(inputs, o, (dq, dk, dv) of sum(sin(o))) of the JAX ring over the
    tensor axis of ``make_mesh((2, 1, 4))``: what every ring size computes."""
    q, k, v = _inputs()
    mesh = make_mesh((2, 1, 4))

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_ring(q, k, v, mesh, axis_name="tensor")))

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = jax_ring(*args, mesh, axis_name="tensor")
    grads = jax.grad(loss, (0, 1, 2))(*args)
    return (q, k, v), np.asarray(out), tuple(np.asarray(g) for g in grads)


def _port_ring(q, k, v, ring, attend=TR.sequence_parallel_attention):
    ts = tuple(torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attend(*ts, ring)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), tuple(t.grad.numpy() for t in ts)


def _close(got, want, rtol, atol) -> bool:
    return np.allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("R", [2, 4])
def test_local_ring_matches_jax(jax_reference, R):
    (q, k, v), want, want_grads = jax_reference
    got, got_grads = _port_ring(q, k, v, TR.LocalRing(R))
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_local_ring_matches_jax_flash_block(cpu_mesh_devices):
    """The JAX ring with its per-hop Pallas flash block in interpret mode
    (the TPU path of ``_block_flash``), 128 query rows a rank."""
    q, k, v = _inputs((1, 2, 512, 64), seed=3)
    mesh = make_mesh((2, 1, 4))
    want = jax_ring(*(jnp.asarray(a) for a in (q, k, v)), mesh, axis_name="tensor",
                    use_flash=True, interpret=True)
    got = TR.sequence_parallel_attention(*(torch.tensor(a) for a in (q, k, v)), TR.LocalRing(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_RTOL, atol=2e-5)


def _ring_through_autodiff(q, k, v, ring):
    """Control: the fold differentiated by autograd, each block's LSE from
    the custom op, which gives it no gradient."""
    qs, ks, vs = (ring.shard(t) for t in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = TA.flash_attention(qs, ks, vs, False, scale, return_lse=True)
    o = o.float()
    for _ in range(ring.size - 1):
        ks, vs = ring.hop(ks, vs)
        b_o, b_lse = TA.flash_attention(qs, ks, vs, False, scale, return_lse=True)
        o, lse = TR.fold_block(o, lse, b_o.float(), b_lse)
    return ring.gather(o.to(q.dtype))


def test_ring_without_lse_gradient_misses(jax_reference):
    (q, k, v), want, want_grads = jax_reference
    got, got_grads = _port_ring(q, k, v, TR.LocalRing(4), _ring_through_autodiff)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)  # the forward is right
    assert not all(_close(g, w, GRAD_RTOL, GRAD_ATOL) for g, w in zip(got_grads, want_grads))


def test_ring_rejects_indivisible():
    q, k, v = (torch.tensor(a[:, :, :30]) for a in _inputs())
    with pytest.raises(ValueError, match="not divisible"):
        TR.sequence_parallel_attention(q, k, v, TR.LocalRing(4))


@pytest.mark.parametrize("R", [2, 4])
def test_routes_switch_at_128_rows(R):
    """The dispatcher's ring route, and with it the DiT attention's packed
    route, at exactly 128 query rows a rank: at 128 the ring runs (and the
    packed qkv route does not), at 64 fewer tokens a rank it does not."""
    ring = TR.LocalRing(R)
    n_ring, n_flash = 128 * R, 64 * R  # 128 and 64 rows a rank
    prior = TA.set_sequence_parallel(ring)
    try:
        assert TA.attention_route(n_ring, 64) == "ring"
        assert TA.attention_route(n_ring - R, 72) != "ring"  # 127 rows a rank
        assert TA.attention_route(n_ring, 64, causal=True) == "flash"
        assert TA.attention_route(n_flash, 64) == "flash"
    finally:
        assert TA.set_sequence_parallel(prior) is ring
    assert TA.attention_route(n_ring, 64) == "flash"

    torch.manual_seed(0)
    attn = TD.Attention(16, 2)
    calls = {"packed": 0, "ring": 0}
    packed, spa = TD.attention_from_packed_qkv, TR.sequence_parallel_attention

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for n, via_ring in ((n_ring, True), (n_flash, False)):
        x = torch.randn(1, n, 16)
        with torch.no_grad():
            want = attn(x)
        calls.update(packed=0, ring=0)
        prior = TA.set_sequence_parallel(ring)
        try:
            TD.attention_from_packed_qkv = count("packed", packed)
            TR.sequence_parallel_attention = count("ring", spa)
            with torch.no_grad():
                got = attn(x)
        finally:
            TD.attention_from_packed_qkv, TR.sequence_parallel_attention = packed, spa
            TA.set_sequence_parallel(prior)
        assert calls == ({"packed": 0, "ring": 1} if via_ring else {"packed": 1, "ring": 0})
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, os.environ["DFOT_REPO"])
torch.set_num_threads(1)
from dfot_tpu_torch.ops import attention as TA
from dfot_tpu_torch.ops import ring_attention as TR

rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank, world_size=2)
data = np.load(os.environ["INPUTS"])
ring = TR.ProcessRing()
ts = [torch.tensor(data[n], requires_grad=True) for n in "qkv"]
out = TR.sequence_parallel_attention(*ts, ring)
torch.sin(out).sum().backward()
# the dispatcher routes a long enough row through the same ring
big = [torch.tensor(data[n + "_big"]) for n in "qkv"]
prior = TA.set_sequence_parallel(ring)
routed = TA.attention(*big)
TA.set_sequence_parallel(prior)
plain = TA.attention_reference(*big)
np.savez(os.environ["OUT"] + f"{rank}.npz", o=out.detach().numpy(),
         dq=ts[0].grad.numpy(), dk=ts[1].grad.numpy(), dv=ts[2].grad.numpy(),
         routed_err=float((routed - plain).abs().max()))
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, source: str, n: int = 2, env=None, timeout: int = 240) -> list:
    """Run ``source`` in ``n`` processes of one gloo group (``RANK`` and
    ``LOCAL_RANK``, the rendezvous ``INIT`` and ``DFOT_REPO`` set; ``env``
    added); returns their stdouts."""
    script = tmp_path / "worker.py"
    script.write_text(source)
    init = f"tcp://localhost:{_free_port()}"
    procs = []
    for rank in range(n):
        penv = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", ""),
                "PYTHONPATH": ROOT, "DFOT_REPO": ROOT, "RANK": str(rank),
                "LOCAL_RANK": str(rank), "INIT": init,
                "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path), **(env or {})}
        procs.append(subprocess.Popen([sys.executable, str(script)], env=penv, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(out)
    return outs


def test_process_ring_matches_jax(jax_reference, tmp_path):
    (q, k, v), want, want_grads = jax_reference
    big = _inputs((1, 2, 256, 8), seed=5)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, q_big=big[0], k_big=big[1], v_big=big[2])
    outs = run_workers(tmp_path, _WORKER, env={"INPUTS": str(tmp_path / "in.npz"),
                                               "OUT": str(tmp_path / "out")})
    assert all(json.loads(o.strip().splitlines()[-1])["ok"] for o in outs)
    for rank in range(2):
        got = np.load(tmp_path / f"out{rank}.npz")
        np.testing.assert_allclose(got["o"], want, rtol=FWD_RTOL, atol=FWD_ATOL)
        for name, w in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert float(got["routed_err"]) < 1e-5
