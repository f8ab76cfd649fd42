"""Training-curve plotting over ``BatchedMonitor`` episode CSVs (port of
toybox_tpu.results_plotter).

Capability parity with the reference's curve tooling (reference
baselines/baselines/results_plotter.py: windowed episode-reward curves
from monitor.csv directories, x-axis in timesteps/episodes/walltime),
re-designed around this repo's monitor format: each log directory holds
one or more ``*monitor.csv`` files written by
:class:`toybox_tpu_torch.utils.monitor.BatchedMonitor` (a ``#{json}`` header
line then ``r,l,t`` rows).

Usage::

    python -m toybox_tpu_torch.results_plotter --dirs LOG1 LOG2 \
        --xaxis timesteps --title Breakout --out curves.png

or from code::

    from toybox_tpu_torch.results_plotter import plot_results
    plot_results(["./log"], num_timesteps=10e6, xaxis="timesteps",
                 title="Breakout", out="curves.png")

matplotlib is only imported when a plot is actually drawn, so the data
helpers stay usable in headless/test contexts.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from toybox_tpu_torch.utils.monitor import EXT, load_results

X_TIMESTEPS = "timesteps"
X_EPISODES = "episodes"
X_WALLTIME = "walltime_hrs"
X_AXES = (X_TIMESTEPS, X_EPISODES, X_WALLTIME)
SMOOTH_WINDOW = 100


def load_monitor_dir(path):
    """All episodes from every ``*monitor.csv`` under ``path`` (or the
    file itself), merged in wall-clock order."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(glob.glob(os.path.join(path, "*" + EXT)))
    if not files:
        raise FileNotFoundError(f"no *{EXT} under {path}")
    episodes = []
    for f in files:
        episodes.extend(load_results(f))
    episodes.sort(key=lambda e: e["t"])
    return episodes


def episodes_to_xy(episodes, xaxis=X_TIMESTEPS):
    """(x, y) arrays for an episode list; y is per-episode reward."""
    y = np.array([e["r"] for e in episodes], dtype=np.float64)
    if xaxis == X_TIMESTEPS:
        x = np.cumsum([e["l"] for e in episodes], dtype=np.float64)
    elif xaxis == X_EPISODES:
        x = np.arange(1, len(episodes) + 1, dtype=np.float64)
    elif xaxis == X_WALLTIME:
        x = np.array([e["t"] for e in episodes], dtype=np.float64) / 3600.0
    else:
        raise ValueError(f"xaxis must be one of {X_AXES}, got {xaxis!r}")
    return x, y


def running_mean(y, window=SMOOTH_WINDOW):
    """Trailing-window mean of ``y``; entry i averages y[i-window+1 : i+1]
    (shorter at the start). Implemented with a prefix-sum difference
    rather than striding, so it is O(n) and copy-free."""
    y = np.asarray(y, dtype=np.float64)
    if y.size == 0:
        return y
    prefix = np.concatenate([[0.0], np.cumsum(y)])
    n = np.minimum(np.arange(1, y.size + 1), window)
    lo = np.maximum(np.arange(1, y.size + 1) - window, 0)
    return (prefix[1:] - prefix[lo]) / n


def truncate_to_timesteps(episodes, num_timesteps):
    """Keep the episode prefix whose cumulative length fits the budget."""
    if num_timesteps is None:
        return episodes
    total, out = 0, []
    for e in episodes:
        total += e["l"]
        if total > num_timesteps:
            break
        out.append(e)
    return out


def plot_results(dirs, num_timesteps=None, xaxis=X_TIMESTEPS, title="",
                 window=SMOOTH_WINDOW, out=None, labels=None):
    """Scatter raw episode rewards + windowed running-mean curve for each
    log dir on one axis. Returns the matplotlib Figure. ``out`` saves a
    PNG (Agg backend, safe headless)."""
    import matplotlib

    if out is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5))
    cmap = plt.get_cmap("tab10")
    for i, d in enumerate(dirs):
        episodes = truncate_to_timesteps(load_monitor_dir(d), num_timesteps)
        if not episodes:
            continue
        x, y = episodes_to_xy(episodes, xaxis)
        color = cmap(i % 10)
        label = labels[i] if labels else os.path.basename(os.path.normpath(d))
        ax.scatter(x, y, s=2, alpha=0.25, color=color)
        ax.plot(x, running_mean(y, window), color=color, label=label)
    ax.set_xlabel(xaxis)
    ax.set_ylabel(f"episode reward (window={window})")
    ax.set_title(title)
    if len(dirs) > 1 or labels:
        ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=120)
    return fig


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dirs", nargs="*", default=["./log"],
                   help="monitor-CSV log directories")
    p.add_argument("--num_timesteps", type=float, default=None)
    p.add_argument("--xaxis", choices=X_AXES, default=X_TIMESTEPS)
    p.add_argument("--title", default="")
    p.add_argument("--window", type=int, default=SMOOTH_WINDOW)
    p.add_argument("--out", default=None,
                   help="save PNG here instead of showing a window")
    args = p.parse_args(argv)
    fig = plot_results(args.dirs, args.num_timesteps, args.xaxis,
                       args.title, args.window, args.out)
    if args.out is None:
        import matplotlib.pyplot as plt

        plt.show()
    else:
        print(f"wrote {args.out}")
    return fig


if __name__ == "__main__":
    main()
