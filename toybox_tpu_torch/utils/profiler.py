"""Profiling helpers (port of toybox_tpu.utils.profiler): a
``torch.profiler`` trace of a block written as a Chrome trace, a wall
timer that logs ``wait_<name>`` like the reference's ProfileKV, and named
trace ranges. ``ProfileKV`` itself lives in toybox_tpu_torch.utils.logger.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Trace the block with torch.profiler (the host, and the card when
    CUDA is available) and write it to ``logdir``/trace.json, a Chrome
    trace (chrome://tracing, Perfetto). ``logdir`` defaults to
    toybox_trace under the temp directory."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "toybox_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


@contextlib.contextmanager
def wall_timer(name: str, logger=None):
    """Wall-clock block timer; logs wait_<name> (a running mean) when
    given a logger, else prints the seconds. Device work the block
    enqueues is timed only as far as the block waits for it."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.logkv_mean(f"wait_{name}", dt)
    else:
        print(f"{name}: {dt:.3f}s")


def annotate(name: str):
    """Decorator: run the function inside a named trace range
    (torch.profiler.record_function)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
