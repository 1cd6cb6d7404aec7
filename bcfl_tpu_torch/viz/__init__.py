"""Result figures (port of ``bcfl_tpu/viz``; matplotlib is imported only
when a figure is drawn)."""

from bcfl_tpu_torch.viz.plots import (  # noqa: F401
    accuracy_curves,
    grouped_bars,
    info_passing_bars,
    run_report,
    sweep_report,
)
