"""Result plots (port of ``exploring_meta_tpu/utils/plotter.py`` but for
the ML10 bar plots, which belong to the host envs; reference
``utils/plotter.py`` and ``misc_scripts/plot_stuff.py``).

Each function computes what it returns first, with numpy and
``scipy.stats`` (the Student-t band of a seed sweep), and only then
imports matplotlib (headless, Agg). Where matplotlib is not installed it
prints one line and writes no figure; the returned numbers are the same,
so a sweep's summary keeps its band on a machine without matplotlib.
scipy is imported inside the functions too.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _pyplot(fn: str, target):
    """-> ``matplotlib.pyplot`` (Agg), or None after one printed line when
    matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"{fn}: matplotlib is not installed; no figure written to "
              f"{target}")
        return None
    return plt


def _title_path(plot: dict, path: str) -> str:
    return os.path.join(path, f"{plot['title'].replace(' ', '_')}.png")


def _finish(plt, fig, ax, plot: dict, save: bool, path: str) -> None:
    ax.set_title(plot["title"])
    ax.set_xlabel(plot.get("x_legend", ""))
    ax.set_ylabel(plot.get("y_legend", ""))
    if save:
        fig.savefig(_title_path(plot, path), dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_dict(plot: dict, save: bool = False, path: str = ".") -> None:
    """{title, x_legend, y_legend, x_axis, y_axis[, std]} line plot
    (reference ``plotter.py:10-27``)."""
    y = np.asarray(plot["y_axis"], dtype=float)
    x = np.asarray(plot.get("x_axis", np.arange(len(y))))
    std = (np.asarray(plot["std"], dtype=float) if "std" in plot else None)
    plt = _pyplot("plot_dict", _title_path(plot, path) if save else None)
    if plt is None:
        return
    fig, ax = plt.subplots()
    ax.plot(x, y)
    if std is not None:
        ax.fill_between(x, y - std, y + std, alpha=0.3)
    _finish(plt, fig, ax, plot, save, path)


def plot_dict_explicit(plot: dict, save: bool = False,
                       path: str = ".") -> None:
    """Line-per-series variant: ``y_axis`` is {series: values} or a list
    of lists (reference ``plotter.py:30-48``)."""
    ys = plot["y_axis"]
    series = ([(str(k), np.asarray(v, dtype=float)) for k, v in ys.items()]
              if isinstance(ys, dict)
              else [(None, np.asarray(v, dtype=float)) for v in ys])
    plt = _pyplot("plot_dict_explicit",
                  _title_path(plot, path) if save else None)
    if plt is None:
        return
    fig, ax = plt.subplots()
    for label, vals in series:
        ax.plot(vals, label=label)
    if isinstance(ys, dict):
        ax.legend()
    _finish(plt, fig, ax, plot, save, path)


def plot_sim_across_layers_average(mean_per_layer: dict,
                                   std_per_layer: dict, title: str = "",
                                   save_path: str | None = None) -> None:
    """Per-layer representation-similarity means with stdev errorbars
    (reference ``rc_rl.py:374-391``)."""
    plt = _pyplot("plot_sim_across_layers_average", save_path)
    if plt is None:
        return
    # keys arrive as str(layer): sort numerically ("10" after "2")
    layers = sorted(mean_per_layer, key=lambda k: int(k), reverse=True)
    means = [mean_per_layer[l] for l in layers]
    errs = [std_per_layer.get(l, 0.0) for l in layers]
    fig, ax = plt.subplots()
    x = np.arange(len(layers))
    ax.plot(x, means, linestyle="-", marker="o", alpha=0.7)
    ax.errorbar(x, means, yerr=errs, fmt="o")
    ax.set_title(title)
    ax.set_xlabel("Layers")
    ax.set_ylabel("CCA Similarity")
    ax.set_xticks(x)
    ax.set_xticklabels([f"L{l}" if str(l) != "-1" else "Head"
                        for l in layers])
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_list(values, title: str = "", save_path: str | None = None) -> None:
    """One curve of ``values``."""
    vals = np.asarray(values, dtype=float)
    plt = _pyplot("plot_list", save_path)
    if plt is None:
        return
    fig, ax = plt.subplots()
    ax.plot(vals)
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_checkpoint_sweeps(run_dirs: list, save_path: str | None = None,
                           confidence: float = 0.5,
                           max_checkpoint: int | None = None) -> dict:
    """Per-checkpoint test-accuracy curves across seed runs + Student-t
    confidence band (reference ``misc_scripts/plot_stuff.py:10-74``,
    consuming each run dir's ``ckpnt_results.json`` as ``eval_vision``
    writes it) -> ``{"checkpoints", "mean", "halfwidth"}``; only the
    checkpoints every run has enter the band."""
    from scipy import stats

    all_vals: dict = {}
    per_run = []
    for d in run_dirs:
        with open(os.path.join(d, "ckpnt_results.json")) as f:
            sweep = {int(k): v for k, v in json.load(f).items()}
        if max_checkpoint is not None:
            sweep = {k: v for k, v in sweep.items() if k < max_checkpoint}
        per_run.append(sweep)
        for k, v in sweep.items():
            all_vals.setdefault(k, []).append(v)

    checkpoints = sorted(k for k, v in all_vals.items()
                         if len(v) == len(run_dirs))
    data = np.array([[all_vals[k][i] for k in checkpoints]
                     for i in range(len(run_dirs))])
    mean = data.mean(axis=0)
    if len(run_dirs) > 1:
        sem = stats.sem(data, axis=0)
        h = sem * stats.t.ppf((1 + confidence) / 2, len(run_dirs) - 1)
    else:
        h = np.zeros_like(mean)
    out = {"checkpoints": checkpoints, "mean": mean.tolist(),
           "halfwidth": np.asarray(h).tolist()}

    plt = _pyplot("plot_checkpoint_sweeps", save_path)
    if plt is None:
        return out
    fig, ax = plt.subplots()
    for i, sweep in enumerate(per_run):
        xs = sorted(sweep)
        ax.plot(xs, [sweep[x] for x in xs], "-o", alpha=0.5,
                label=f"seed_{i + 1}")
    ax.plot(checkpoints, mean, color="black")
    ax.fill_between(checkpoints, mean - h, mean + h, alpha=0.3)
    ax.set_xlabel("Checkpoints")
    ax.set_ylabel("Test Accuracy")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_runs_with_confidence(run_dirs: list, metric: str = "train_acc",
                              save_path: str | None = None,
                              confidence: float = 0.95) -> dict:
    """Mean curve with a Student-t confidence band across seeds / runs
    (reference ``misc_scripts/plot_stuff.py:10-74``), each run's
    ``metrics.json[metric]`` cut to the shortest -> ``{"mean",
    "halfwidth"}``."""
    from scipy import stats

    curves = []
    for d in run_dirs:
        with open(os.path.join(d, "metrics.json")) as f:
            curves.append(np.asarray(json.load(f)[metric], dtype=float))
    n = min(len(c) for c in curves)
    data = np.stack([c[:n] for c in curves])
    mean = data.mean(axis=0)
    sem = stats.sem(data, axis=0) if len(curves) > 1 else np.zeros(n)
    h = sem * stats.t.ppf((1 + confidence) / 2, max(len(curves) - 1, 1))
    out = {"mean": mean.tolist(), "halfwidth": h.tolist()}

    plt = _pyplot("plot_runs_with_confidence", save_path)
    if plt is None:
        return out
    fig, ax = plt.subplots()
    x = np.arange(n)
    ax.plot(x, mean)
    ax.fill_between(x, mean - h, mean + h, alpha=0.3)
    ax.set_title(f"{metric} over {len(curves)} runs")
    ax.set_xlabel("iteration")
    ax.set_ylabel(metric)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
