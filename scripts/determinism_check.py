#!/usr/bin/env python3
"""Run-to-run determinism of the port on the card: each step of a round,
computed twice on the same inputs, must give the same bits.

    python3 scripts/determinism_check.py

A resumed run reproduces the uninterrupted one bit for bit only when every
step is deterministic. For path (a) (bert-base, seq 128, dense) and path
(b) (seq 512, flash) of ``chip_smoke.py`` this prints, per step, what
differs between two computations: one client's gradients after one step
(with and without dropout), the four clients' local training, the codec's
encode and the aggregate; then the three flash kernels on the same
inputs twice. It also runs one step under
``torch.use_deterministic_algorithms(True)`` and prints any op that
refuses. It exits non-zero when anything differs or refuses.
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def differing(a, b) -> dict:
    """``{leaf: max |a - b|}`` over the leaves whose bits differ."""
    return {p: float((a[p].float() - b[p].float()).abs().max())
            for p in a if not torch.equal(a[p], b[p])}


def check_path(cfg, label) -> bool:
    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.models.convert import load_trainable

    eng = FedEngine(cfg, device="cuda")
    model = eng.model
    loss_fn = cs.make_loss_fn(model, cfg.task)
    batches, _ = eng._round_batches(0)
    batch = {k: v[0][0] for k, v in batches.items()}
    ok = True

    def grads(seed):
        load_trainable(model, eng.trainable0)
        model.train()
        model.zero_grad(set_to_none=True)
        gen = None if seed is None else prng.generator("cuda", seed, 2, 3)
        loss, _, _ = loss_fn(batch, gen)
        loss.backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}, float(loss)

    for seed in (None, 7):
        (g1, l1), (g2, l2) = grads(seed), grads(seed)
        d = differing(g1, g2)
        ok &= l1 == l2 and not d
        print(f"{label} one step, dropout {'on' if seed else 'off'}: loss "
              f"equal {l1 == l2}; gradients differing in {len(d)} of "
              f"{len(g1)}: {sorted(d.items(), key=lambda kv: -kv[1])[:8]}",
              flush=True)

    def gens():
        return prng.client_round_generators(cfg.seed, cfg.num_clients, 0,
                                            eng.device)

    n1, s1 = cs.train_clients(eng.local_train, eng.trainable0, batches,
                              gens())
    n2, s2 = cs.train_clients(eng.local_train, eng.trainable0, batches,
                              gens())
    d = differing(n1, n2)
    ok &= bool(torch.equal(s1, s2)) and not d
    print(f"{label} local training of {cfg.num_clients} clients twice: "
          f"stats equal {torch.equal(s1, s2)}; trees differing in {len(d)} "
          f"leaves: {sorted(d.items(), key=lambda kv: -kv[1])[:8]}",
          flush=True)
    enc = []
    for _ in range(2):
        zero = cc.zero_residual(eng.trainable0, cfg.num_clients)
        enc.append(cs.encode_deltas(cfg.compression, n1, eng.trainable0,
                                    zero, prng.codec_uniforms(cfg.seed, 0)))
    (p1, r1, e1), (p2, r2, e2) = enc
    parts = {p: [k for k in p1[p] if not torch.equal(p1[p][k], p2[p][k])]
             for p in p1}
    parts = {p: v for p, v in parts.items() if v}
    dr, de = differing(r1, r2), differing(e1, e2)
    ok &= not (parts or dr or de)
    print(f"{label} encode twice: payload parts differing {parts}, "
          f"reconstruction {len(dr)} leaves, residual {len(de)} leaves",
          flush=True)
    w = torch.ones(cfg.num_clients, device="cuda")
    da = differing(cs.collapse(r1, w, eng.trainable0),
                   cs.collapse(r1, w, eng.trainable0))
    ok &= not da
    print(f"{label} aggregate twice: {len(da)} leaves differing", flush=True)
    torch.use_deterministic_algorithms(True)
    try:
        grads(7)
        print(f"{label} one step under use_deterministic_algorithms: no op "
              "refused", flush=True)
    except RuntimeError as e:
        ok = False
        print(f"{label} one step under use_deterministic_algorithms "
              f"refused: {str(e)[:600]}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return ok


def check_flash() -> bool:
    from bcfl_tpu_torch.ops import flash_kernels as fk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, H, S, D = 32, 12, 512, 64
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    bias = torch.zeros(B, S, device="cuda")
    bias[:, 400:] = -1e9
    outs = []
    for _ in range(2):
        qq, kk, vv, bb = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v, bias))
        o = fk.FlashAttentionFn.apply(qq, kk, vv, bb, False)
        o.backward(do)
        outs.append((o.detach(), qq.grad, kk.grad, vv.grad, bb.grad))
    same = {n: bool(torch.equal(a, b)) for n, a, b in zip(
        ("out", "dq", "dk", "dv", "dbias"), *outs) if a is not None}
    print(f"flash kernels twice at [{B}, {H}, {S}, {D}] bf16: {same}",
          flush=True)
    return all(same.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("determinism_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from bcfl_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(smoke.nvidia_smi_line(), flush=True)
    ok = check_path(smoke.main_config(num_rounds=1), "path (a)")
    dataset = smoke.write_long_docs()
    ok &= check_path(smoke.flash_config(dataset, num_rounds=1), "path (b)")
    ok &= check_flash()
    print(f"deterministic: {ok} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
