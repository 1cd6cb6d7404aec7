"""PyTorch port (``bcfl_tpu_torch``): ring attention
(``bcfl_tpu_torch/parallel/ring_attention.py``) against the JAX package's
(``bcfl_tpu/parallel/ring_attention.py``) on the same numpy-seeded
float32 inputs.

- ``ring_attention_gspmd`` and ``ring_attention_sharded`` (the port's
  single-controller forms over a CPU device list) against JAX's two forms
  on the conftest's 8 virtual CPU devices, at n = 2, 4 and 8 blocks,
  causal and not, with a padding key bias: outputs within 2e-5 absolute
  and relative; the input gradients of a weighted sum within 5e-5 (JAX's
  own ring tests hold the ring to dense attention at 2e-5 to 5e-5);
- the rotation count: ``n - 1`` per call;
- the ``torch.distributed`` form over CPU ``gloo`` at world size 2 and 4
  (spawned ranks, 120 s deadline) against JAX's ``ring_attention_sharded``:
  each rank's block of the output and of the q, k, v gradients, at the
  same tolerances.
"""

import importlib
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

# the packages export the function ring_attention under the module's name
jra = importlib.import_module("bcfl_tpu.parallel.ring_attention")
tra = importlib.import_module("bcfl_tpu_torch.parallel.ring_attention")

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
OUT_TOL = 2e-5
GRAD_TOL = 5e-5
B, H, S, D = 2, 2, 64, 8


def _inputs(seed=0, S=S):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, S), np.int32)
    mask[0, S - 14:] = 0
    mask[1, 5:] = 0
    bias = np.where(mask > 0, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, g


def _jax(form, n, causal, q, k, v, bias, g):
    """JAX's output and the gradients of ``sum(out * g)`` in q, k, v."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    fn = getattr(jra, form)

    def loss(q, k, v):
        out = fn(q, k, v, jnp.asarray(bias), mesh, causal=causal)
        return (out * g).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(fn, n, causal, q, k, v, bias, g):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt, torch.tensor(bias), [torch.device("cpu")] * n,
             causal=causal)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("form", ["ring_attention_gspmd",
                                  "ring_attention_sharded"])
def test_single_controller_ring_matches_jax(form, n, causal):
    q, k, v, bias, g = _inputs(n)
    want, wgrads = _jax(form, n, causal, q, k, v, bias, g)
    tra.reset_rotations()
    got, grads = _port(getattr(tra, form), n, causal, q, k, v, bias, g)
    assert tra.rotations() == n - 1
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    for a, b in zip(grads, wgrads):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ring_without_bias_and_in_bfloat16_keeps_q_dtype():
    q, k, v, _, _ = _inputs(7)
    want, _ = _jax("ring_attention_gspmd", 4, True, q, k, v,
                   np.zeros((B, S), np.float32), np.ones_like(q))
    got = tra.ring_attention_gspmd(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), None,
                                   [torch.device("cpu")] * 4, causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_TOL, rtol=OUT_TOL)
    half = tra.ring_attention_sharded(
        *(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)), None,
        [torch.device("cpu")] * 2)
    assert half.dtype == torch.bfloat16 and half.shape == (B, H, S, D)
    with pytest.raises(ValueError, match="seq 64 not divisible by seq size 3"):
        tra.ring_attention_sharded(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), None,
                                   [torch.device("cpu")] * 3)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from bcfl_tpu_torch.parallel.ring_attention import ring_attention

    rank, world, port, src, dst, causal = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    data = np.load(src)
    blk = data["q"].shape[2] // world
    own = slice(rank * blk, (rank + 1) * blk)
    q, k, v = (torch.tensor(data[n][:, :, own], requires_grad=True)
               for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, torch.tensor(data["bias"][:, own]),
                         causal=causal == "1")
    (out * torch.tensor(data["g"][:, :, own])).sum().backward()
    np.savez(dst, out=out.detach().numpy(), dq=q.grad.numpy(),
             dk=k.grad.numpy(), dv=v.grad.numpy())
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ring_matches_jax(world, causal, tmp_path):
    q, k, v, bias, g = _inputs(10 + world)
    want, wgrads = _jax("ring_attention_sharded", world, causal,
                        q, k, v, bias, g)
    src = tmp_path / "in.npz"
    np.savez(src, q=q, k=k, v=v, bias=bias, g=g)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(port),
         str(src), str(tmp_path / f"out{r}.npz"), str(int(causal))],
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    blk = S // world
    for r in range(world):
        own = slice(r * blk, (r + 1) * blk)
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_allclose(got["out"], want[:, :, own],
                                   atol=OUT_TOL, rtol=OUT_TOL)
        for name, w in zip(("dq", "dk", "dv"), wgrads):
            np.testing.assert_allclose(got[name], w[:, :, own],
                                       atol=GRAD_TOL, rtol=GRAD_TOL)
