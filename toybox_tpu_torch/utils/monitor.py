"""Per-episode monitor CSV (port of toybox_tpu.utils.monitor; reference
baselines/bench/monitor.py:35-77: header json line + rows {r: reward,
l: length, t: wall time}), written by ``envs.vec_env.VecMonitor`` or by
``BatchedMonitor.record_info`` from the batched env's ``info``.
"""

from __future__ import annotations

import csv
import json
import os
import time

import numpy as np

EXT = "monitor.csv"


class BatchedMonitor:
    def __init__(self, path, header_extra=None):
        if not path.endswith(EXT):
            path = path + "." + EXT if not path.endswith(".") else path + EXT
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.tstart = time.time()
        self.f = open(path, "wt")
        header = {"t_start": self.tstart}
        if header_extra:
            header.update(header_extra)
        self.f.write("#%s\n" % json.dumps(header))
        self.writer = csv.DictWriter(self.f, fieldnames=("r", "l", "t"))
        self.writer.writeheader()
        self.f.flush()
        self.episode_rewards = []
        self.episode_lengths = []

    def record_info(self, info):
        """One row per finished episode of a batched env step's ``info``
        (``episode_return``, NaN for an env that is not done, and
        ``episode_length``; tensors or arrays), read to the host at once;
        one flush a call that finished any."""
        ep_ret = np.asarray(_host(info["episode_return"]))
        ep_len = np.asarray(_host(info["episode_length"]))
        done = ~np.isnan(ep_ret)
        now = round(time.time() - self.tstart, 6)
        for r, l in zip(ep_ret[done], ep_len[done]):
            self.episode_rewards.append(float(r))
            self.episode_lengths.append(int(l))
            self.writer.writerow({"r": round(float(r), 6), "l": int(l),
                                  "t": now})
        if done.any():
            self.f.flush()

    def close(self):
        self.f.close()


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def load_results(path):
    """Read a monitor.csv back into a list of episode dicts."""
    episodes = []
    with open(path) as f:
        header = f.readline()
        assert header.startswith("#")
        reader = csv.DictReader(f)
        for row in reader:
            episodes.append({"r": float(row["r"]), "l": int(row["l"]),
                             "t": float(row["t"])})
    return episodes
