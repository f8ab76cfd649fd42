"""kv logger (port of toybox_tpu.utils.logger): ``configure``, ``logkv``,
``logkv_mean``, ``dumpkvs``, ``log`` with its levels, ``get_dir`` and the
``ProfileKV``/``profile`` timers, with the stdout, log, json, csv and
tensorboard writers (the last with ``torch.utils.tensorboard``, scalars
only).

Running means are kept as (sum, count) pairs and written as their mean.
The CSV writer rewrites the file from its buffered rows when a new column
appears.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import sys
import tempfile
import time

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


def _as_scalar(v):
    """Float-ify array-likes and numpy scalars; pass strings and None."""
    if v is None or isinstance(v, str):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError

    def close(self):
        pass


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Boxed two-column table on a stream or file."""

    MAXWIDTH = 30

    def __init__(self, dest):
        self._owns = isinstance(dest, str)
        self.file = open(dest, "wt") if self._owns else dest

    def _fmt(self, v):
        s = f"{v:<8.3g}" if isinstance(v, float) else str(v)
        if len(s) > self.MAXWIDTH:
            s = s[:self.MAXWIDTH - 3] + "..."
        return s

    def writekvs(self, kvs):
        rows = sorted((self._fmt(k), self._fmt(_as_scalar(v)))
                      for k, v in kvs.items())
        if not rows:
            return
        kw = max(len(k) for k, _ in rows)
        vw = max(len(v) for _, v in rows)
        rule = "-" * (kw + vw + 7)
        body = "".join(f"| {k.ljust(kw)} | {v.ljust(vw)} |\n"
                       for k, v in rows)
        self.file.write(f"{rule}\n{body}{rule}\n")
        self.file.flush()

    def writeseq(self, seq):
        print(*seq, file=self.file, flush=True)

    def close(self):
        if self._owns:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """One JSON object per dump, newline-delimited."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        record = {k: _as_scalar(v) for k, v in kvs.items()}
        print(json.dumps(record), file=self.file, flush=True)

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """CSV with a growing column set: every row is buffered, and a dump
    that brings a new key rewrites the file with the wider header."""

    def __init__(self, filename):
        self.filename = filename
        self.keys: list = []
        self.rows: list = []
        open(filename, "w").close()

    @staticmethod
    def _cell(v):
        if v is None:
            return ""
        s = str(_as_scalar(v))
        if any(c in s for c in ",\"\n"):
            s = '"' + s.replace('"', '""') + '"'
        return s

    def _render(self, row):
        return ",".join(self._cell(row.get(k)) for k in self.keys) + "\n"

    def writekvs(self, kvs):
        row = dict(kvs)
        self.rows.append(row)
        fresh = sorted(k for k in row if k not in self.keys)
        if fresh or len(self.rows) == 1:
            self.keys.extend(fresh)
            with open(self.filename, "w") as f:
                f.write(",".join(self.keys) + "\n")
                f.writelines(self._render(r) for r in self.rows)
        else:
            with open(self.filename, "a") as f:
                f.write(self._render(row))


class TensorBoardOutputFormat(KVWriter):
    """Scalar summaries in a tensorboard event file under ``logdir``
    (``torch.utils.tensorboard``, which needs the ``tensorboard`` package:
    without it the format raises ImportError, as JAX's does without
    tensorflow); step = the count of ``writekvs`` calls."""

    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter
        os.makedirs(logdir, exist_ok=True)
        self._writer = SummaryWriter(log_dir=logdir)
        self._step = 0

    def writekvs(self, kvs):
        self._step += 1
        for k, v in kvs.items():
            v = _as_scalar(v)
            if isinstance(v, float):
                self._writer.add_scalar(k, v, global_step=self._step)
        self._writer.flush()

    def close(self):
        self._writer.close()


_WRITERS = {
    "stdout": lambda d, sfx: HumanOutputFormat(sys.stdout),
    "log": lambda d, sfx: HumanOutputFormat(os.path.join(d, f"log{sfx}.txt")),
    "json": lambda d, sfx: JSONOutputFormat(
        os.path.join(d, f"progress{sfx}.json")),
    "csv": lambda d, sfx: CSVOutputFormat(
        os.path.join(d, f"progress{sfx}.csv")),
    "tensorboard": lambda d, sfx: TensorBoardOutputFormat(
        os.path.join(d, f"tb{sfx}")),
}


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
    os.makedirs(ev_dir, exist_ok=True)
    try:
        factory = _WRITERS[fmt]
    except KeyError:
        raise ValueError(f"unknown log format {fmt!r}; "
                         f"known: {sorted(_WRITERS)}") from None
    return factory(ev_dir, log_suffix)


class Logger:
    CURRENT = None

    def __init__(self, dir, output_formats):
        self.dir = dir
        self.output_formats = list(output_formats)
        self.level = INFO
        self.name2val: dict = {}
        self._mean_sums: dict = {}
        self._mean_counts: dict = {}

    def logkv(self, key, val):
        """Record the latest value for key (overwrites within a window)."""
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        """Record val into a running mean for key over the current window."""
        if val is None:
            self.name2val[key] = None
            return
        self._mean_sums[key] = self._mean_sums.get(key, 0.0) + float(val)
        self._mean_counts[key] = self._mean_counts.get(key, 0) + 1
        self.name2val[key] = self._mean_sums[key] / self._mean_counts[key]

    def dumpkvs(self):
        """Write the window to every kv writer; returns what was written
        (nothing when the level is DISABLED)."""
        if self.level == DISABLED:
            return {}
        window = dict(self.name2val)
        for w in self.output_formats:
            if isinstance(w, KVWriter):
                w.writekvs(window)
        self.name2val.clear()
        self._mean_sums.clear()
        self._mean_counts.clear()
        return window

    def log(self, *args, level=INFO):
        """Print args to every sequence writer when level >= the logger's."""
        if level >= self.level:
            for w in self.output_formats:
                if isinstance(w, SeqWriter):
                    w.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for w in self.output_formats:
            w.close()


def configure(dir=None, format_strs=None, log_suffix=""):
    """Install a new current logger. The directory and formats default to
    TOYBOX_LOGDIR / OPENAI_LOGDIR and TOYBOX_LOG_FORMAT /
    OPENAI_LOG_FORMAT, else a fresh directory under the temp dir and
    stdout, log and csv."""
    dir = (dir or os.getenv("TOYBOX_LOGDIR") or os.getenv("OPENAI_LOGDIR")
           or os.path.join(tempfile.gettempdir(),
                           datetime.datetime.now().strftime(
                               "toybox-%Y-%m-%d-%H-%M-%S-%f")))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        env_fmt = (os.getenv("TOYBOX_LOG_FORMAT")
                   or os.getenv("OPENAI_LOG_FORMAT"))
        format_strs = (env_fmt.split(",") if env_fmt
                       else ["stdout", "log", "csv"])
    writers = [make_output_format(f, dir, log_suffix)
               for f in format_strs if f]
    Logger.CURRENT = Logger(dir=dir, output_formats=writers)
    return Logger.CURRENT


def get_current() -> Logger:
    if Logger.CURRENT is None:
        configure()
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def dumpkvs():
    return get_current().dumpkvs()


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def log(*args, **kwargs):
    get_current().log(*args, **kwargs)


def get_dir():
    return get_current().get_dir()


class ProfileKV:
    """Add the wall time spent inside the block to wait_<name>."""

    def __init__(self, name):
        self._key = f"wait_{name}"

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        lg = get_current()
        lg.name2val[self._key] = lg.name2val.get(self._key, 0.0) + elapsed
        return False


def profile(name):
    """Decorator form of ProfileKV."""
    def decorate(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with ProfileKV(name):
                return fn(*args, **kwargs)
        return timed
    return decorate
