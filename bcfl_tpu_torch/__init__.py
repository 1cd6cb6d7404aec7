"""PyTorch + CUDA port of ``bcfl_tpu`` for one NVIDIA H100.

The package mirrors ``bcfl_tpu``'s layout module by module; each module's
docstring names its JAX counterpart. It imports ``torch`` and numpy, never
JAX or anything of ``bcfl_tpu``.

Slice 1 (this package's scope today): server-mode synchronous FedAvg of
BERT/ALBERT text classifiers with the ``int8+topk`` update codec, whose two
TPU kernels (``int8_quantize``, ``topk_select``) run as hand-written CUDA
kernels (``bcfl_tpu_torch/csrc``). Everything else raises "not ported yet"
at config time (:mod:`bcfl_tpu_torch.config`).

Entry points take ``device=None`` meaning ``"cuda"`` and raise when no GPU
is present; pass ``device="cpu"`` explicitly to run the plain versions.
"""

__version__ = "0.1.0"
