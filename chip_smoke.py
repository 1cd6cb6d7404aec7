#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bcfl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # phases 1-4
    python3 chip_smoke.py --profile    # phases 1-4, then 5

Phases, each of which raises (and the script exits non-zero) on failure:

1. ``build``: compile every hand-written CUDA kernel of the main path from
   ``bcfl_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. ``kernels``: hold each kernel to its plain PyTorch version on the card,
   bit for bit: ``int8_quantize`` on its registered ``bench_shapes`` grids
   (stochastic and deterministic), ``topk_select`` on its ``bench_shapes``
   rows, one row for each leaf width of bert-base (the
   23,440,896-wide word embeddings included), a row of ties and a row with
   -0.0. One line per kernel and shape: kernel ms, plain ms, bound ms and,
   for top-k, ``torch.topk`` ms as a yardstick the port never calls.
3. ``main``: two rounds of 4-client bert-base FedAvg with the ``int8+topk``
   codec through ``bcfl_tpu_torch.entrypoints.run`` at full width (random
   weights from the seed, 2 local steps of 32 x 128 tokens). Checks finite
   losses and parameters, that both kernels launched, and that the bytes
   on the wire equal ``payload_nbytes``; prints per-round wall, samples/s,
   compression ratio and peak memory.
4. ``reference``: on a small input, a tiny-bert server round on the card
   against the same round on the CPU (float32, dropout off, at the
   tolerance of ``tests/test_torch_round.py``), and the codec tree encode
   on the card against the CPU, payload bit for bit.
5. ``profile`` (only with ``--profile``): one warm main-path round
   split into its stages (local training, codec, FedAvg mean) on the host
   clock, and under ``torch.profiler``: the device's busy share and the
   kernels by device time.

The script prints the card's name and power limit first, and as its last
three lines the kernels' JSON record, the card line again and the result
``{"ok": true, "device": {...}}``. Times are CUDA-event means over
repeated launches after a warm-up; the caches are warm.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOPK_FRAC = 0.05  # the codec's default topk_frac

# leaf widths of bert-base's trainable tree (vocab 30522)
BERT_BASE_WIDTHS = (23440896, 2359296, 589824, 393216, 3072, 1536, 768, 2)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches after one
    warm-up launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------- kernels


class KernelStats:
    """What the JSON record says of one kernel. A field stays None (null in
    the record) until this run has measured it."""

    def __init__(self, op):
        self.name = op.name
        self.source = f"bcfl_tpu_torch/csrc/{op.name}.cu"
        self.replaces = op.replaces.split()[0]
        self.max_abs_err = self.launches = None
        # per-round totals over the main path's calls
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = None
        self.bound_by = None

    def compared(self, err: float):
        self.max_abs_err = max(self.max_abs_err or 0.0, err)

    def add_times(self, ms, plain, bnd, by, lib=None):
        self.ms = (self.ms or 0.0) + ms
        self.plain_ms = (self.plain_ms or 0.0) + plain
        self.bound_ms = (self.bound_ms or 0.0) + bnd
        if lib is not None:
            self.library_ms = (self.library_ms or 0.0) + lib
        self.bound_by = by

    def record(self):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": self.bound_by, "library_ms": self.library_ms}


def int8_case(ck, st, gen, C, M, chunk, stochastic, label, iters):
    g = torch.randn((C, M, chunk), generator=gen, device="cuda") * 1e-3
    u = (torch.rand((C, M, chunk), generator=gen, device="cuda")
         if stochastic else None)
    q, s = ck.INT8_QUANTIZE(g, u, stochastic=stochastic)
    q_ref, s_ref = ck.int8_quantize_ref(g, u, stochastic=stochastic)
    torch.cuda.synchronize()
    same = bits_equal(q, q_ref) and bits_equal(s, s_ref)
    st.compared(max(max_abs(q, q_ref), max_abs(s, s_ref)))
    ms = time_ms(lambda: ck.INT8_QUANTIZE(g, u, stochastic=stochastic), iters)
    plain = time_ms(lambda: ck.int8_quantize_ref(g, u, stochastic=stochastic),
                    iters)
    n = C * M * chunk
    nbytes = n * (4 + (4 if stochastic else 0) + 1) + C * M * 4
    bnd, by = bound_ms(nbytes, 6 * n)
    print(f"int8_quantize {label} [{C},{M},{chunk}] "
          f"stochastic={int(stochastic)}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"{'identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise RuntimeError(f"int8_quantize differs from its plain version "
                           f"at {label} stochastic={stochastic}")
    return ms, plain, bnd, by


def topk_case(ck, st, x, k, label, iters):
    val, idx = ck.TOPK_SELECT(x, k=k)
    val_ref, idx_ref = ck.topk_select_ref(x, k=k)
    torch.cuda.synchronize()
    same = bits_equal(val, val_ref) and torch.equal(idx, idx_ref)
    st.compared(max_abs(val, val_ref))
    ms = time_ms(lambda: ck.TOPK_SELECT(x, k=k), iters)
    plain = time_ms(lambda: ck.topk_select_ref(x, k=k), iters)
    a = x.abs()
    lib = time_ms(lambda: torch.topk(a, k, dim=1), iters)
    R, N = x.shape
    bnd, by = bound_ms(R * N * 4 + R * k * 8, R * N)
    print(f"topk_select {label} [{R},{N}] k={k}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}), torch.topk "
          f"{lib:.4f} ms, {'identical' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise RuntimeError(f"topk_select differs from its plain version at "
                           f"{label}")
    return ms, plain, bnd, by, lib


def leaf_k(n: int) -> int:
    return max(1, int(math.ceil(TOPK_FRAC * n)))


def phase_kernels(ck, stats):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    s4, s5 = stats["int8_quantize"], stats["topk_select"]
    for op in (ck.INT8_QUANTIZE, ck.TOPK_SELECT):
        if op.parity != "bit-identical":
            raise RuntimeError(f"{op.name}: no check for parity "
                               f"{op.parity!r}")
    for sh in ck.INT8_QUANTIZE.bench_shapes:
        M = -(-sh["N"] // sh["chunk"])
        for stochastic in (True, False):
            int8_case(ck, s4, gen, sh["C"], M, sh["chunk"], stochastic,
                      sh["label"], 20)
    rows = [(sh["label"], sh["R"], sh["N"])
            for sh in ck.TOPK_SELECT.bench_shapes]
    rows += [(f"bert-base-width-{n}", 1, n) for n in BERT_BASE_WIDTHS]
    for label, R, N in rows:
        x = torch.randn((R, N), generator=gen, device="cuda")
        topk_case(ck, s5, x, leaf_k(N), label, 5 if R * N > 1 << 22 else 20)
    # ties: few distinct magnitudes of both signs, so the k-th value is
    # shared by many entries and the lower-index-first rule decides
    x = (torch.randint(-3, 4, (4, 100003), generator=gen, device="cuda")
         .float() * 0.5)
    for k in (1, 777, 50001, 100003):
        topk_case(ck, s5, x, k, f"ties-k{k}", 5)
    # -0.0 must come back as -0.0 (sign bit kept), zeros of both signs tie
    x = torch.zeros((2, 4099), device="cuda")
    x[0, ::3] = -0.0
    x[1, 5::7] = -0.0
    x[1, 11] = -2.5
    x[0, 4000] = 1.0
    for k in (1, 3, 4099):
        topk_case(ck, s5, x, k, f"negzero-k{k}", 5)


def main_path_calls(template, comp, C):
    """The kernel calls ``encode_tree`` makes in one round, from the
    template's leaf widths: top-k once per distinct width over the
    ``[L*C, N]`` stack, int8 once per distinct ``min(chunk, k)`` over the
    concatenated value grids."""
    from bcfl_tpu_torch.compression.codecs import _leaf_k

    widths = {}
    for x in template.values():
        widths[x.numel()] = widths.get(x.numel(), 0) + 1
    topk = [(cnt * C, n, _leaf_k(comp, n)) for n, cnt in sorted(widths.items())]
    grids = {}
    for n, cnt in widths.items():
        k = _leaf_k(comp, n)
        c = min(comp.chunk, k)
        grids[c] = grids.get(c, 0) + cnt * -(-k // c)
    int8 = [(C, M, c) for c, M in sorted(grids.items())]
    return topk, int8


def time_main_path_shapes(ck, stats, template, comp, C):
    """Per-round kernel, plain, bound and library times summed over the
    main path's own calls (random inputs of those shapes)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    topk, int8 = main_path_calls(template, comp, C)
    s4, s5 = stats["int8_quantize"], stats["topk_select"]
    for R, N, k in topk:
        x = torch.randn((R, N), generator=gen, device="cuda")
        s5.add_times(*topk_case(ck, s5, x, k, "main-path",
                                3 if R * N > 1 << 24 else 10))
        del x
    for C_, M, c in int8:
        s4.add_times(*int8_case(ck, s4, gen, C_, M, c, comp.stochastic,
                                "main-path", 20))
    return topk, int8


# ------------------------------------------------------------ main path


def main_config(**kw):
    """bert-base at full width (vocab 30522), 4 clients, 2 local steps of
    32 x 128 tokens, the int8+topk codec at its defaults."""
    from bcfl_tpu_torch.compression import CompressionConfig
    from bcfl_tpu_torch.config import FedConfig

    base = dict(
        name="chip-smoke-bert-base", model="bert-base", mode="server",
        num_clients=4, num_rounds=2, seq_len=128, batch_size=32,
        max_local_batches=2, dataset="synthetic", vocab_size=30522,
        compression=CompressionConfig(kind="int8+topk"))
    base.update(kw)
    return FedConfig(**base)


def phase_main(stats, smi):
    from bcfl_tpu_torch.compression import payload_nbytes
    from bcfl_tpu_torch.entrypoints import run
    from bcfl_tpu_torch.ops import codec_kernels as ck
    from bcfl_tpu_torch.ops import registry

    cfg = main_config()
    print(smi, flush=True)
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    result = run(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        stats[name].launches = n
    print(f"main path: {wall:.2f} s incl. set-up, launches {launches}, "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {name} never launched on the main "
                               f"path")
    want = payload_nbytes(cfg.compression, result.trainable) * cfg.num_clients
    samples = cfg.num_clients * cfg.max_local_batches * cfg.batch_size
    for r in result.metrics.rounds:
        print(f"round {r.round}: wall {r.wall_s:.3f} s, "
              f"{samples / r.wall_s:.1f} samples/s, compression ratio "
              f"{r.compression_ratio:.3f}, train_loss {r.train_loss:.5f}, "
              f"global_loss {r.global_loss}", flush=True)
        if not (math.isfinite(r.train_loss) and r.global_loss is not None
                and math.isfinite(r.global_loss)):
            raise RuntimeError(f"round {r.round}: non-finite loss")
        if r.bytes_on_wire != want:
            raise RuntimeError(f"round {r.round}: bytes_on_wire "
                               f"{r.bytes_on_wire} != payload_nbytes {want}")
    for p, t in result.trainable.items():
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite parameter {p}")
    return time_main_path_shapes(ck, stats, result.trainable, cfg.compression,
                                 cfg.num_clients)


# -------------------------------------------------------------- profile


def phase_profile():
    """Where one warm main-path round spends its time: the round's three
    stages timed on the host clock with a synchronize after each, then the
    same round under ``torch.profiler`` for the device's busy time and the
    kernels by device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bcfl_tpu_torch.compression import codecs as cc
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed import client_step as cs
    from bcfl_tpu_torch.fed.engine import FedEngine
    from bcfl_tpu_torch.parallel import masked_weighted_mean

    cfg = main_config(num_rounds=1, eval_every=0)
    eng = FedEngine(cfg, device="cuda")
    C, g = cfg.num_clients, eng.trainable0
    batches, n_ex = eng._round_batches(0)
    w = eng._weights(np.ones((C,), np.float32), n_ex)
    resid = cc.zero_residual(g, C)

    def one_round():
        t = {}
        t0 = time.perf_counter()
        gens = prng.client_round_generators(cfg.seed, C, 0, eng.device)
        new_t, _ = cs.train_clients(eng.local_train, g, batches, gens)
        torch.cuda.synchronize()
        t["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, dec, _ = cs.compress_stage(eng._comp, new_t, g, resid,
                                      prng.codec_uniforms(cfg.seed, 0))
        torch.cuda.synchronize()
        t["codec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        masked_weighted_mean(cs.recon(g, dec, new_t), w, g)
        torch.cuda.synchronize()
        t["mean"] = time.perf_counter() - t0
        return t

    one_round()  # warm
    t = one_round()
    total = sum(t.values())
    print("round stages (host clock, synchronized, warm): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms ({v / total:.1%})" for k, v in t.items())
        + f", total {total * 1e3:.1f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    # device-side events are kernels and memcpys, plus the mirrors of host
    # annotations (e.g. "Optimizer.step#AdamW.step") that span the kernels
    # launched inside them: those are left out, or the time counts twice
    host_keys = {e.key for e in avg if e.device_type == DeviceType.CPU}
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.key not in host_keys]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"profiled round: device busy {busy:.1f} ms = "
          f"{busy / (total * 1e3):.1%} of the unprofiled warm round "
          f"({total * 1e3:.1f} ms; the profiled one took "
          f"{wall * 1e3:.1f} ms)", flush=True)
    print("device kernels by device time:", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}", flush=True)
    print("host ops by the device time they launched:", flush=True)
    ops = [e for e in avg if e.device_type == DeviceType.CPU
           and e.device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:100]}", flush=True)


# ------------------------------------------------------------ reference


def phase_reference():
    """The main path's functions on a small input: the card against the
    CPU (plain versions), as the CPU tests hold the CPU against JAX."""
    import numpy as np

    from bcfl_tpu_torch.compression import CompressionConfig, encode_tree
    from bcfl_tpu_torch.core import prng
    from bcfl_tpu_torch.fed.client_step import (
        make_local_train, make_loss_fn, server_round)
    from bcfl_tpu_torch.models import build, full_float32_matmuls
    from bcfl_tpu_torch.models.bert import init_params
    from bcfl_tpu_torch.models.convert import trainable_tree

    full_float32_matmuls()
    rng = np.random.default_rng(0)
    C, steps, B, S = 2, 2, 4, 16
    batches_np = {
        "ids": rng.integers(4, 512, (C, steps, B, S)).astype(np.int32),
        "mask": (np.arange(S)[None, None, None, :]
                 < rng.integers(4, S + 1, (C, steps, B, 1))).astype(np.int32),
        "labels": rng.integers(0, 2, (C, steps, B)).astype(np.int32),
        "example_mask": np.ones((C, steps, B), np.float32)}
    comp = CompressionConfig(kind="int8+topk", topk_frac=1.0,
                             stochastic=False)
    base = build("tiny-bert", num_labels=2, vocab_size=512,
                 dtype=torch.float32, dropout_rate=0.0)
    init_params(base, prng.generator("cpu", 7))
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        g0 = trainable_tree(model)
        batches = {k: torch.from_numpy(v).to(dev)
                   for k, v in batches_np.items()}
        w = torch.tensor([3.0, 1.0], device=dev)
        resid = {p: torch.zeros((C,) + tuple(x.shape), device=dev)
                 for p, x in g0.items()}
        local = make_local_train(model, make_loss_fn(model))
        out[dev] = server_round(local, comp, g0, batches, w, [None] * C,
                                resid)
    # the tolerance of tests/test_torch_round.py: AdamW moves a coordinate
    # with a near-zero gradient by up to lr per step in the direction of
    # its float32 noise, so every coordinate is held to 2 * lr * steps plus
    # one quantization step, and all but 1e-4 of them (the key biases,
    # whose exact gradient is zero, left out) to 2e-6 plus one step
    lr, far, total, worst = 5e-5, 0, 0, 0.0
    for p, x in out["cpu"].global_t.items():
        step = float(out["cpu"].payload[p]["s"].max())
        err = (out["cuda"].global_t[p].cpu() - x).abs()
        worst = max(worst, float(err.max()))
        if float(err.max()) > 2 * lr * steps * 1.01 + step:
            raise RuntimeError(f"reference round: {p} differs by "
                               f"{float(err.max())}")
        if not p.endswith("/key/bias"):
            far += int((err > 2e-6 + step).sum())
            total += err.numel()
    if far > total * 1e-4:
        raise RuntimeError(f"reference round: {far} of {total} coordinates "
                           "past 2e-6 plus one quantization step")
    print(f"reference round (tiny-bert, f32, card vs CPU): max |diff| "
          f"{worst:.3e}, {far} of {total} coordinates past 2e-6 + one "
          "quantization step", flush=True)
    # the codec alone: card vs CPU on one delta, payload bit for bit
    tree = {p: torch.from_numpy(rng.standard_normal((3,) + tuple(x.shape))
                                .astype(np.float32))
            for p, x in out["cpu"].global_t.items()}
    comp = CompressionConfig(kind="int8+topk", topk_frac=0.05)
    draw = prng.codec_uniforms(5, 0)

    def uniforms(i, shape, device):
        return draw(i, shape, torch.device("cpu")).to(device)

    pay_cpu = encode_tree(comp, tree, uniforms)
    pay_gpu = encode_tree(comp, {p: x.cuda() for p, x in tree.items()},
                          uniforms)
    for p, parts in pay_cpu.items():
        for name, t in parts.items():
            if not bits_equal(pay_gpu[p][name].cpu(), t):
                raise RuntimeError(f"codec payload {p}/{name}: card and CPU "
                                   "differ")
    print(f"codec payload (int8+topk, {len(tree)} leaves, 3 clients): card "
          "and CPU bit-identical", flush=True)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the four phases, a stage and kernel "
                         "breakdown of one warm main-path round")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from bcfl_tpu_torch.ops import codec_kernels as ck
    from bcfl_tpu_torch.ops import cuda_build, registry

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    stats = {op.name: KernelStats(op) for op in registry.kernel_ops()}
    t0 = time.perf_counter()
    secs = cuda_build.build_all(list(ck.KERNEL_SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s wall, nvcc seconds "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}",
          flush=True)
    phase_kernels(ck, stats)
    phase_main(stats, smi)
    phase_reference()
    if args.profile:
        phase_profile()
    print(json.dumps({"kernels": [s.record() for s in stats.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
