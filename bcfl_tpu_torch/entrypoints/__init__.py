"""Entry points (port of ``bcfl_tpu/entrypoints``): :func:`run` and the
``python -m bcfl_tpu_torch.entrypoints`` command line."""

from bcfl_tpu_torch.entrypoints.run import run  # noqa: F401
