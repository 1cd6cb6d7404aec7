"""Command line: port of ``bcfl_tpu/entrypoints/__main__.py`` for the
flags the ported slice supports.

    python -m bcfl_tpu_torch.entrypoints --preset smoke --device cpu
    python -m bcfl_tpu_torch.entrypoints --preset server_iid_medical \\
        --model bert-base --compress int8+topk --device cuda

``--device`` defaults to ``cuda``, which raises when no GPU is present.
Any flag of the JAX command line that is not listed here is rejected as
"not ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from bcfl_tpu_torch.compression import KINDS as COMPRESS_KINDS
from bcfl_tpu_torch.entrypoints.presets import get_preset, list_presets
from bcfl_tpu_torch.entrypoints.run import run

# (flag, FedConfig field)
_FIELD_FLAGS = (
    ("clients", "num_clients"), ("rounds", "num_rounds"), ("model", "model"),
    ("dataset", "dataset"), ("seq_len", "seq_len"),
    ("batch_size", "batch_size"), ("lr", "learning_rate"),
    ("max_local_batches", "max_local_batches"),
    ("eval_every", "eval_every"), ("seed", "seed"),
    ("compute_dtype", "compute_dtype"),
)


def build_parser() -> argparse.ArgumentParser:
    # no prefix matching: "--mode" must not be taken for "--model"
    ap = argparse.ArgumentParser(prog="bcfl_tpu_torch", allow_abbrev=False)
    ap.add_argument("--preset", default="smoke",
                    help=f"one of: {', '.join(list_presets())}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--max-local-batches", type=int, default=None)
    ap.add_argument("--eval-every", type=int, default=None,
                    help="evaluate every Nth round (the last round always "
                         "evaluates); 0 = never")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--compress", default=None, choices=list(COMPRESS_KINDS),
                    help="compress the update exchange (int8, topk, "
                         "int8+topk), with error feedback")
    ap.add_argument("--compress-topk", type=float, default=None,
                    metavar="FRAC",
                    help="fraction of coordinates the topk codecs keep "
                         "(default 0.05)")
    ap.add_argument("--compress-chunk", type=int, default=None, metavar="N",
                    help="elements per int8 quantization chunk (default 256)")
    ap.add_argument("--no-compress-ef", action="store_true",
                    help="disable the error-feedback residual")
    return ap


def build_config(args):
    cfg = get_preset(args.preset)
    overrides = {field: getattr(args, flag) for flag, field in _FIELD_FLAGS
                 if getattr(args, flag) is not None}
    if (args.compress is not None or args.compress_topk is not None
            or args.compress_chunk is not None or args.no_compress_ef):
        kind = (args.compress if args.compress is not None
                else cfg.compression.kind)
        if kind == "none" and args.compress != "none":
            raise SystemExit(
                "--compress-topk/--compress-chunk/--no-compress-ef have no "
                "effect without a codec: add --compress {int8,topk,int8+topk}")
        comp_kw = {"kind": kind}
        if args.compress_topk is not None:
            comp_kw["topk_frac"] = args.compress_topk
        if args.compress_chunk is not None:
            comp_kw["chunk"] = args.compress_chunk
        if args.no_compress_ef:
            comp_kw["error_feedback"] = False
        overrides["compression"] = dataclasses.replace(cfg.compression,
                                                       **comp_kw)
    return cfg.replace(**overrides)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if rest:
        ap.error(f"not ported yet (or unknown): {' '.join(rest)}")
    cfg = build_config(args)
    run(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
