"""Result figures: port of ``bcfl_tpu/viz/plots.py`` (the reference's
notebook plots as library functions).

The reference hard-codes its published results into matplotlib cells
(``All_graphs_IMDB_dataset.ipynb`` cells 15/18/21/23/26/29 and the MT twin) —
grouped-bar latency/accuracy/memory by worker count, sync-vs-async
info-passing bars (with/without the BC-FL payload), and 4-way
accuracy-vs-round curves. Here the same figures render from live
:class:`~bcfl_tpu_torch.metrics.metrics.RunMetrics` (or plain dicts), so every run
can regenerate the paper's figure set.

Styling follows the dataviz method: a validated categorical palette in fixed
slot order, recessive grid, thin marks, text in ink tokens (never series
colors). matplotlib is imported only when a figure is drawn, so a machine
without it (the card's) runs everything else.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

# validated categorical palette (fixed slot order — never cycled)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100"]
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#e4e3df"


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=INK_2, labelsize=9)
    ax.yaxis.grid(True, color=GRID, linewidth=0.8)
    ax.set_axisbelow(True)


def grouped_bars(
    groups: Sequence[str],
    series: Mapping[str, Sequence[float]],
    ylabel: str,
    title: str,
    path: Optional[str] = None,
):
    """Reference cells 15/18/21: e.g. latency by worker count, one bar group
    per count, one color per mode (server vs serverless)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 3.4), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    _style(ax)
    n = len(series)
    width = 0.8 / max(n, 1)
    for i, (name, vals) in enumerate(series.items()):
        xs = [g + i * width - 0.4 + width / 2 for g in range(len(groups))]
        ax.bar(xs, vals, width * 0.92, color=SERIES[i % len(SERIES)],
               label=name, linewidth=0)
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels(groups)
    ax.set_ylabel(ylabel, color=INK_2, fontsize=9)
    ax.set_title(title, color=INK, fontsize=11, loc="left")
    if len(series) >= 2:
        ax.legend(frameon=False, fontsize=9, labelcolor=INK_2)
    fig.tight_layout()
    if path:
        fig.savefig(path, facecolor=SURFACE)
        plt.close(fig)
    return fig


def info_passing_bars(
    filters: Sequence[str],
    sync_times: Sequence[float],
    async_times: Sequence[float],
    title: str = "Information passing time",
    path: Optional[str] = None,
):
    """Reference cells 23/26: sync vs async transfer time per anomaly filter
    (and with/without the BC-FL ledger payload when called twice)."""
    return grouped_bars(
        filters, {"sync": sync_times, "async": async_times},
        ylabel="seconds", title=title, path=path,
    )


def accuracy_curves(
    curves: Mapping[str, Sequence[float]],
    title: str = "Global accuracy vs round",
    path: Optional[str] = None,
):
    """Reference cells 29/31: accuracy-per-round for up to four configs
    (serverless/server x IID/Non-IID)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 3.4), dpi=150)
    fig.patch.set_facecolor(SURFACE)
    _style(ax)
    for i, (name, ys) in enumerate(curves.items()):
        xs = range(1, len(ys) + 1)
        color = SERIES[i % len(SERIES)]
        ax.plot(xs, ys, color=color, linewidth=2, label=name)
        if len(ys):
            ax.annotate(f"{ys[-1]:.2f}", (len(ys), ys[-1]),
                        textcoords="offset points", xytext=(4, 0),
                        fontsize=8, color=INK_2)
    ax.set_xlabel("round", color=INK_2, fontsize=9)
    ax.set_ylabel("accuracy", color=INK_2, fontsize=9)
    ax.set_title(title, color=INK, fontsize=11, loc="left")
    if len(curves) >= 2:
        ax.legend(frameon=False, fontsize=9, labelcolor=INK_2)
    fig.tight_layout()
    if path:
        fig.savefig(path, facecolor=SURFACE)
        plt.close(fig)
    return fig


def run_report(metrics, out_dir: str, name: str = "run") -> List[str]:
    """Render the figure set for one finished run; returns written paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    accs = metrics.global_accuracies
    if accs:
        p = os.path.join(out_dir, f"{name}_accuracy.png")
        accuracy_curves({name: accs}, path=p)
        paths.append(p)
    last = metrics.rounds[-1] if metrics.rounds else None
    if last is not None and last.info_passing_sync_s is not None:
        p = os.path.join(out_dir, f"{name}_info_passing.png")
        info_passing_bars(["final round"], [last.info_passing_sync_s],
                          [last.info_passing_async_s], path=p)
        paths.append(p)
    return paths


def sweep_report(results: Dict[int, object], out_dir: str,
                 name: str = "sweep") -> List[str]:
    """Figures across a 5/10/20-worker sweep (reference cells 15/18/21):
    latency, final accuracy, and memory by client count."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    counts = sorted(results)
    labels = [str(c) for c in counts]

    def metric(fn):
        return [fn(results[c].metrics) for c in counts]

    latency = metric(lambda m: sum(r.wall_s for r in m.rounds) / 60.0)
    final_acc = metric(
        lambda m: (m.global_accuracies[-1] if m.global_accuracies else 0.0))
    mem = metric(lambda m: m.resources.get("memory_gb", 0.0))

    paths = []
    for vals, ylabel, fname in (
        (latency, "latency (min)", "latency"),
        (final_acc, "final accuracy", "accuracy"),
        (mem, "memory (GB)", "memory"),
    ):
        p = os.path.join(out_dir, f"{name}_{fname}.png")
        grouped_bars(labels, {name: vals}, ylabel=ylabel,
                     title=f"{ylabel} by clients", path=p)
        paths.append(p)
    return paths
