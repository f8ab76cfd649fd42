"""kv logger (port of the part of toybox_tpu.utils.logger that ``learn``
and ``run.py`` use): ``configure``, ``logkv`` and ``dumpkvs``, with the
stdout, log, json and csv writers. The TensorBoard writer is not ported
(ROADMAP.md §1: the surface layers).

The CSV writer rewrites the file from its buffered rows when a new column
appears.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile


def _as_scalar(v):
    """Float-ify array-likes and numpy scalars; pass strings and None."""
    if v is None or isinstance(v, str):
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class HumanOutputFormat:
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

    def close(self):
        if self._owns:
            self.file.close()


class JSONOutputFormat:
    """One JSON object per dump, newline-delimited."""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        record = {k: _as_scalar(v) for k, v in kvs.items()}
        print(json.dumps(record), file=self.file, flush=True)

    def close(self):
        self.file.close()


class CSVOutputFormat:
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

    def close(self):
        pass


_WRITERS = {
    "stdout": lambda d, sfx: HumanOutputFormat(sys.stdout),
    "log": lambda d, sfx: HumanOutputFormat(os.path.join(d, f"log{sfx}.txt")),
    "json": lambda d, sfx: JSONOutputFormat(
        os.path.join(d, f"progress{sfx}.json")),
    "csv": lambda d, sfx: CSVOutputFormat(
        os.path.join(d, f"progress{sfx}.csv")),
}


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
    if fmt == "tensorboard":
        raise NotImplementedError("the tensorboard log format is not ported "
                                  "yet (ROADMAP.md §1: the surface layers)")
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
        self.name2val: dict = {}

    def logkv(self, key, val):
        """Record the latest value for key (overwrites within a window)."""
        self.name2val[key] = val

    def dumpkvs(self):
        """Write the window to every writer; returns what was written."""
        window = dict(self.name2val)
        for w in self.output_formats:
            w.writekvs(window)
        self.name2val.clear()
        return window

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
