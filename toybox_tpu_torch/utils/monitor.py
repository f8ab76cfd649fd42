"""Per-episode monitor CSV (port of the file format of
toybox_tpu.utils.monitor; reference baselines/bench/monitor.py:35-77:
header json line + rows {r: reward, l: length, t: wall time}), written by
``envs.vec_env.VecMonitor``.
"""

from __future__ import annotations

import csv
import json
import os
import time

EXT = "monitor.csv"


class BatchedMonitor:
    def __init__(self, path):
        if not path.endswith(EXT):
            path = path + "." + EXT if not path.endswith(".") else path + EXT
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.tstart = time.time()
        self.f = open(path, "wt")
        self.f.write("#%s\n" % json.dumps({"t_start": self.tstart}))
        self.writer = csv.DictWriter(self.f, fieldnames=("r", "l", "t"))
        self.writer.writeheader()
        self.f.flush()

    def close(self):
        self.f.close()


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
