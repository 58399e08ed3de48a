"""``plot_am()`` — Manhattan-style plot of the per-SNP outlier statistics.

Reference: ``PlotAM()`` (SURVEY.md §3.1): the outlier statistic by genomic
position, chromosome-striped, colored by the iteration at which each SNP's
statistic changed, selected markers highlighted. matplotlib replaces the
reference's ggplot2/plotly stack.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eagleeverything_tpu_torch.api.read import MapHandle
from eagleeverything_tpu_torch.models.oracle import AMResult


def change_iterations(outlier_stats) -> np.ndarray:
    """Iteration at which each SNP's statistic substantially changed
    (0 = never): >25% of the SNP's initial statistic AND >1.0 absolute —
    the LD partners of selected markers, not the global re-conditioning
    ripple. (Reference PlotAM's iteration coloring.) Shared by the
    matplotlib plot and the GUI's interactive payload."""
    stack = np.stack(outlier_stats)
    if stack.shape[0] < 2:
        return np.zeros(stack.shape[1], dtype=int)
    diffs = np.abs(np.diff(stack, axis=0))  # (its-1, p)
    base = np.maximum(stack[0], 1.0)
    changed = (diffs.max(axis=0) / base > 0.25) & (diffs.max(axis=0) > 1.0)
    return np.where(changed, diffs.argmax(axis=0) + 1, 0)


def plot_am(
    res: AMResult,
    map: Optional[MapHandle] = None,
    itnum: Optional[int] = None,
    save: Optional[str] = None,
    show: bool = False,
    chr_colors: tuple[str, str] = ("#3b4cc0", "#8ea0cc"),
    type: str = "manhattan",
    highlight_changes: bool = False,
):
    """Plot the scan (reference: ``PlotAM()``).

    Args:
      res: result of :func:`am`.
      map: marker map for chromosome striping; without it, SNP index is the
        x axis.
      itnum: which iteration's statistics to plot (default: last).
      save: path to write the figure (PNG/PDF by extension; ``.html``
        writes a self-contained interactive Manhattan with hover tooltips
        — the reference PlotAM's optional plotly interactivity).
      show: call ``plt.show()``.
      type: "manhattan" (t_j by position) or "trace" (extBIC trajectory).
    Returns the matplotlib Figure (or the path for ``.html`` saves).
    """
    if save is not None and save.endswith(".html"):
        if type != "manhattan":
            raise ValueError("interactive .html export is manhattan-only")
        if itnum is not None:
            raise ValueError(
                "interactive .html export always shows each SNP's peak "
                "statistic across iterations (with per-point "
                "iteration-of-change tooltips); itnum= only applies to "
                "static figure output")
        from eagleeverything_tpu_torch import gui
        payload = gui._plot_data(res, map)
        html = gui.render_manhattan_html(
            payload, title=f"eagle-tpu scan — trait {res.trait_name}")
        with open(save, "w") as f:
            f.write(html)
        return save
    if show:
        # interactive path only: pyplot picks a GUI backend
        import matplotlib.pyplot as plt

        def _make_fig(figsize):
            return plt.subplots(figsize=figsize)
    else:
        # backend-free, thread-safe, leak-free: no pyplot registration —
        # safe from server threads (the GUI renders plots per request)
        from matplotlib.figure import Figure

        def _make_fig(figsize):
            fig = Figure(figsize=figsize)
            return fig, fig.subplots()

    if type == "trace":
        fig, ax = _make_fig((6, 4))
        ax.plot(range(len(res.extbic_path)), res.extbic_path, "o-")
        ax.set_xlabel("iteration (markers in model)")
        ax.set_ylabel("extBIC")
        ax.set_title(f"extBIC trajectory — trait {res.trait_name}")
    else:
        if not res.outlier_stats:
            raise ValueError("AMResult holds no outlier statistics to plot")
        if itnum is None:
            # default: each SNP's max statistic across iterations — selected
            # markers keep their peak value instead of the zeroed-out final
            # sweep (reference PlotAM colors by the iteration at which the
            # statistic changed; the peak view carries the same information
            # for the highlights)
            t = np.max(np.stack(res.outlier_stats), axis=0)
            it = len(res.outlier_stats) - 1
        else:
            it = itnum
            t = np.asarray(res.outlier_stats[it])
        p = t.shape[0]
        fig, ax = _make_fig((10, 4))
        # reference PlotAM colors each SNP by the iteration at which its
        # statistic changed; overlay that as point brightness when there
        # is more than one iteration
        change_it = None
        if highlight_changes and len(res.outlier_stats) > 1 and itnum is None:
            change_it = change_iterations(res.outlier_stats)

        if map is not None:
            chroms = np.asarray(map.chrom)
            uniq = list(dict.fromkeys(chroms.tolist()))  # stable order
            x = np.empty(p)
            offset = 0.0
            ticks, tick_labels = [], []
            for ci, c in enumerate(uniq):
                m = chroms == c
                pos = np.asarray(map.pos)[m].astype(float)
                span = pos.max() - pos.min() + 1 if m.sum() else 1.0
                x[m] = offset + (pos - pos.min())
                ax.scatter(x[m], t[m], s=6,
                           color=chr_colors[ci % len(chr_colors)],
                           linewidths=0)
                ticks.append(offset + span / 2)
                tick_labels.append(str(c))
                offset += span * 1.02
            ax.set_xticks(ticks)
            ax.set_xticklabels(tick_labels)
            ax.set_xlabel("chromosome")
        else:
            x = np.arange(p, dtype=float)
            ax.scatter(x, t, s=6, color=chr_colors[0], linewidths=0)
            ax.set_xlabel("SNP index")
        if change_it is not None and change_it.any():
            m = change_it > 0
            ax.scatter(x[m], t[m], s=10, c=change_it[m], cmap="autumn",
                       linewidths=0, alpha=0.8, zorder=2.5,
                       label="statistic changed during selection")
            ax.legend(loc="upper right", fontsize=8, frameon=False)
        for rank, j in enumerate(res.indices):
            if j < p:
                ax.scatter([x[j]], [t[j]], s=40, color="#d7342f", zorder=3)
                ax.annotate(str(rank + 1), (x[j], t[j]),
                            textcoords="offset points", xytext=(4, 4),
                            fontsize=8, color="#d7342f")
        ax.set_ylabel("outlier statistic $t_j$")
        which = (f"peak over {len(res.outlier_stats)} iterations"
                 if itnum is None else f"iteration {it}")
        ax.set_title(
            f"AM scan — trait {res.trait_name}, {which}, "
            f"{len(res.indices)} selected"
        )
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=150)
    if show:
        plt.show()
    return fig
