"""Profiling: stage traces and the program's spans.

Set DEEP_CARTO_PROFILE_DIR to capture a `torch.profiler` Chrome trace per
tool stage (host and, on the card, CUDA activity) under
<dir>/<stage>/trace.json. The port's spans (`annotate`) land in that trace,
or in any other `torch.profiler` session that is recording, on the clock of
the card's kernels and copies. With no profiler recording, nothing is
traced and a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator

import torch

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


class annotate:
    """A named span (`torch.profiler.record_function`) while a profiler is
    recording: the trace of `maybe_trace`, the benchmark's, or any caller's
    own `torch.profiler.profile`. With none recording it checks one flag and
    adds nothing to the trace. Spans are named `<layer>.<what>`; every span
    of the port goes through here.

        with annotate("transfer.d2h"):
            host = features.cpu()

        @annotate("trainer.fit")          # each call in a span of its own
        def fit_ensemble(...): ...

    Never around a `yield`, and never on a generator function: a span left
    open while the consumer runs would cover the consumer's work.
    """

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def __enter__(self) -> None:
        if torch.autograd.profiler._is_profiler_enabled:
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            span, self._span = self._span, None
            span.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


def traced(stage_name: str):
    """Decorator form of maybe_trace for the tools' entry points."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with maybe_trace(stage_name):
                return fn(*args, **kwargs)

        return wrapper

    return decorate
