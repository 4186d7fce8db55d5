"""Profiling and per-stage timing.

The port of the JAX package's utils/profiling.py: each stage logs its wall
clock in the same format ("Elapsed time (<stage>): HH h MM min SS s"). Set
DEEP_CARTO_PROFILE_DIR to capture a `torch.profiler` Chrome trace per
stage (host and, on the card, CUDA activity) under
<dir>/<stage>/trace.json; `annotate` then names a region inside it. With
the variable unset, nothing is traced and nothing is added.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Iterator

import torch

logger = logging.getLogger(__name__)

PROFILE_ENV = "DEEP_CARTO_PROFILE_DIR"


@contextlib.contextmanager
def maybe_trace(stage_name: str) -> Iterator[None]:
    """A `torch.profiler` trace of the stage when DEEP_CARTO_PROFILE_DIR is
    set; nothing otherwise."""
    profile_dir = os.environ.get(PROFILE_ENV)
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace_dir = os.path.join(profile_dir, stage_name.replace(" ", "_"))
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def stage_timer(stage_name: str) -> Iterator[None]:
    """Log a stage's wall clock, traced as `maybe_trace` traces."""
    start = time.time()
    try:
        with maybe_trace(stage_name):
            yield
    finally:
        elapsed = time.time() - start
        logger.info(
            "Elapsed time (%s): %s",
            stage_name,
            time.strftime("%H h %M min %S s", time.gmtime(elapsed)),
        )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a stage's trace (`record_function`) when
    DEEP_CARTO_PROFILE_DIR is set; nothing otherwise."""
    if not os.environ.get(PROFILE_ENV):
        yield
        return
    with torch.profiler.record_function(name):
        yield


def traced(stage_name: str):
    """Decorator form of maybe_trace for the tools' entry points."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with maybe_trace(stage_name):
                return fn(*args, **kwargs)

        return wrapper

    return decorate
