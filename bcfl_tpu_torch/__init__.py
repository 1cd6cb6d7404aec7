"""PyTorch + CUDA port of ``bcfl_tpu`` for one NVIDIA H100.

The package mirrors ``bcfl_tpu``'s layout module by module; each module's
docstring names its JAX counterpart. It imports ``torch`` and numpy, never
JAX or anything of ``bcfl_tpu``.

Scope today: BERT/ALBERT text classifiers trained by server-mode FedAvg,
serverless ring gossip, or buffered async aggregation (FedBuff), with
PageRank (or DBSCAN, modified-Z, community) gating over the latency graph,
the hash-chained ledger over device-side fingerprints, and the
``int8+topk`` update codec; flash attention for long inputs. All five TPU
kernels of the JAX package (the codec's ``int8_quantize`` and
``topk_select``, flash attention's forward and two backward kernels) run
as hand-written CUDA kernels (``bcfl_tpu_torch/csrc``). Everything else
raises "not ported yet" at config time (:mod:`bcfl_tpu_torch.config`).

Entry points take ``device=None`` meaning ``"cuda"`` and raise when no GPU
is present; pass ``device="cpu"`` explicitly to run the plain versions.
"""

__version__ = "0.1.0"
