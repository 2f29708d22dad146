"""Profiling hooks and the failure context (the reference package's
``utils/profiling.py``).

- :func:`profile_trace` runs a span under ``torch.profiler`` (CPU and
  CUDA activities) and writes a Chrome trace to ``<log_dir>/
  trace_<pid>.json`` (``--profile_dir``): the card's kernels, the
  host's operators, and the NVTX / ``record_function`` ranges that the
  span tracer (``obs/trace.py``) opens under an armed annotation.
- :func:`annotate` is one named range on that timeline: an NVTX range on
  a card and a ``record_function`` range.
- :func:`failure_context` is the original code's ``raise_MPI_error``
  without its process abort: log the traceback, dump the flight ring
  (``obs/flight.py``), run the caller's teardown, re-raise.
"""

from __future__ import annotations

import contextlib
import logging
import os
import traceback
from typing import Callable


@contextlib.contextmanager
def profile_trace(log_dir: str | None, enabled: bool = True):
    """Trace the enclosed span with ``torch.profiler`` into ``log_dir``
    (a Chrome trace, ``trace_<pid>.json``); a no-op when disabled or
    without a directory. Yields the profiler (None when off)."""
    if not (enabled and log_dir):
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline (and an NVTX range on a
    card)."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def failure_context(logger: logging.Logger | None = None,
                    teardown: Callable[[], None] | None = None,
                    name: str = "run"):
    """Log, dump the flight ring, tear down, re-raise. The teardown is
    the caller's; a dump or a teardown that fails never masks the run's
    own exception."""
    log = logger or logging.getLogger("neuroimagedisttraining_tpu_torch")
    try:
        yield
    except Exception as exc:
        log.error("FATAL in %s:\n%s", name, traceback.format_exc())
        # the last control-plane decisions, dumped before the teardown can
        # destroy more state
        try:
            from neuroimagedisttraining_tpu_torch.obs import flight

            flight.record("failure", name=name,
                          error=f"{type(exc).__name__}: {exc}")
            out = flight.dump(reason=f"failure_context: {name}")
            if out:
                log.error("flight recorder dumped to %s", out)
            else:
                evs = flight.events()
                if evs:
                    log.error("no flight dump path configured; last "
                              "%d of %d flight events: %s",
                              min(20, len(evs)), len(evs), evs[-20:])
        except Exception:  # noqa: BLE001 — best-effort post-mortem
            pass
        if teardown is not None:
            try:
                teardown()
            except Exception:
                log.error("teardown after failure also failed:\n%s",
                          traceback.format_exc())
        raise
