"""Tensor parallelism's rounding at llama2-7b width, on one NVIDIA GPU:
``tp=2`` (both shards on ``cuda:0``) against ``tp=1`` on the same random
weights (seed 0), LoRA adapters (rank 8, ``b`` drawn nonzero so the
per-shard merge matters) and batch (8 x 512 random tokens, random labels),
in bf16 and float32 compute.

    python3 scripts/tp_precision.py [--layers N]    # from the repo's root

Prints, for each compute dtype and each order (tp=1 first, then tp=2
first): the classification loss, the logits' relative L2 distance to
float32 tp=1, and each layer's output's relative L2 distance to the same
layer at tp=1 in the same dtype and to float32 tp=1; then, on layer 0's
own input, each projection and the attention output per head shard against
the matching slice of the tp=1 op (max |diff|). Needs one card and about
40 GB of its memory at full depth.
"""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bcfl_tpu_torch.models import (build, full_float32_matmuls,  # noqa: E402
                                   lora, lora_targets, tp_param_specs)
from bcfl_tpu_torch.models.convert import leaf_specs  # noqa: E402
from bcfl_tpu_torch.models.llama import rms_norm, rope  # noqa: E402
from bcfl_tpu_torch.ops import cuda_build  # noqa: E402
from bcfl_tpu_torch.ops.flash import flash_attention  # noqa: E402
from bcfl_tpu_torch.parallel import tp_linear  # noqa: E402


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def set_dtype(model, dtype):
    for mod in model.modules():
        if "cfg" in vars(mod):
            mod.cfg = dataclasses.replace(mod.cfg, dtype=dtype)


def forward(model, ids, mask, labels, adapters):
    """(loss, logits, [each layer's output, float32])"""
    outs = []
    hooks = [layer.register_forward_hook(
        lambda m, a, o: outs.append(o.detach().float()))
        for name, layer in model.model.named_children()
        if name.startswith("layer_")]
    try:
        with torch.no_grad(), lora.attached(model, adapters):
            logits = model(ids, mask).float()
    finally:
        for h in hooks:
            h.remove()
    return float(F.cross_entropy(logits, labels)), logits, outs


def layer0_ops(model, ids, adapters, devices, specs):
    """Layer 0's q/k/v, attention and o_proj per head shard against the
    tp=1 op's slice, on layer 0's own input, in the model's dtype."""
    c = model.model.cfg
    att = model.model.layer_0.attention
    x = model.model.embed(ids).to(c.dtype)
    h = rms_norm(x, model.model.layer_0.input_norm)
    B, S, _ = h.shape
    hd, n = c.head_dim, len(devices)
    H, KV = c.num_heads // n, c.kv_heads // n
    rep = c.num_heads // c.kv_heads
    pos = torch.arange(S, device=h.device)
    kb = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    width = {"q_proj": H * hd, "k_proj": KV * hd, "v_proj": KV * hd}

    def split(t, heads):  # [B, S, heads*hd] -> [B, heads, S, hd]
        return t.view(B, S, heads, hd).transpose(1, 2)

    res = {}
    with torch.no_grad(), lora.attached(model, adapters):
        tp_linear.unshard(model)
        full = {nm: tp_linear.dense(h, getattr(att, nm), c.dtype)
                for nm in ("q_proj", "k_proj", "v_proj")}
        q1 = rope(split(full["q_proj"], c.num_heads), pos, c.rope_theta)
        k1 = rope(split(full["k_proj"], c.kv_heads), pos,
                  c.rope_theta).repeat_interleave(rep, dim=1)
        v1 = split(full["v_proj"], c.kv_heads).repeat_interleave(rep, dim=1)
        o1 = flash_attention(q1, k1, v1, kb, causal=True)
        o1f = o1.transpose(1, 2).reshape(B, S, -1)
        y1 = tp_linear.dense(o1f, att.o_proj, c.dtype)
        tp_linear.shard_base(model, specs, devices)
        parts = []
        for i in range(n):
            got = {}
            for nm in ("q_proj", "k_proj", "v_proj"):
                w = width[nm]
                got[nm] = tp_linear.column(h, getattr(att, nm), i, n,
                                           c.dtype)
                res[f"{nm}[{i}]"] = float(
                    (got[nm] - full[nm][..., i * w:(i + 1) * w]).abs().max())
            qi = rope(split(got["q_proj"], H), pos, c.rope_theta)
            ki = rope(split(got["k_proj"], KV), pos,
                      c.rope_theta).repeat_interleave(rep, dim=1)
            vi = split(got["v_proj"], KV).repeat_interleave(rep, dim=1)
            hs = slice(i * H, (i + 1) * H)
            oi = flash_attention(qi, ki, vi, kb, causal=True)
            res[f"attn[{i}]"] = float((oi - o1[:, hs]).abs().max())
            # the shard's attention on tp=1's own q, k, v heads
            oj = flash_attention(q1[:, hs], k1[:, hs], v1[:, hs], kb,
                                 causal=True)
            res[f"attn-same-input[{i}]"] = float(
                (oj - o1[:, hs]).abs().max())
            parts.append(o1f[..., i * H * hd:(i + 1) * H * hd])
        y2 = tp_linear.row(parts, att.o_proj, c.dtype)
        res["o_proj row vs dense"] = float((y2 - y1).abs().max())
        res["o_proj |dense| max"] = float(y1.abs().max())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_precision: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cuda_build.build_all()
    full_float32_matmuls()
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    with dev:
        model = build("llama2-7b", num_labels=2, num_layers=args.layers,
                      dtype=torch.bfloat16)
    model.eval()
    specs = tp_param_specs(model, {s.path: s for s in leaf_specs(model)})
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    adapters = lora.init_lora(gen, model, 8, lora_targets("llama2-7b"))
    for p, t in adapters.items():
        if p.endswith("/b"):
            t.normal_(0.0, 1e-3, generator=gen)
    ids = torch.randint(0, model.model.cfg.vocab_size, (8, 512),
                        generator=gen, device=dev)
    mask = torch.ones_like(ids)
    labels = torch.randint(0, 2, (8,), generator=gen, device=dev)
    devices = [dev, dev]
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        set_dtype(model, dtype)
        for order in ((1, 2), (2, 1)):
            for tp in order:
                if tp == 2:
                    tp_linear.shard_base(model, specs, devices)
                else:
                    tp_linear.unshard(model)
                runs[dtype, tp, order] = forward(model, ids, mask, labels,
                                                 adapters)
    ref = runs[torch.float32, 1, (1, 2)]
    for (dtype, tp, order), (loss, logits, outs) in runs.items():
        print(f"{dtype} tp={tp} order={order}: loss {loss:.6f}, logits "
              f"rel to f32 tp=1 {rel(logits, ref[1]):.3e}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        a, b = runs[dtype, 2, (1, 2)][2], runs[dtype, 1, (1, 2)][2]
        for i, (x2, x1) in enumerate(zip(a, b)):
            print(f"{dtype} layer {i}: tp2 vs tp1 {rel(x2, x1):.3e}, "
                  f"tp1 vs f32 {rel(x1, ref[2][i]):.3e}, tp2 vs f32 "
                  f"{rel(x2, ref[2][i]):.3e}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        set_dtype(model, dtype)
        for k, v in layer0_ops(model, ids, adapters, devices,
                               specs).items():
            print(f"{dtype} layer 0 {k}: {v:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
