"""Entry points (port of ``bcfl_tpu/entrypoints``): :func:`run`,
:func:`run_sweep` and the ``python -m bcfl_tpu_torch.entrypoints`` command
line."""

from bcfl_tpu_torch.entrypoints.run import run, run_sweep  # noqa: F401
