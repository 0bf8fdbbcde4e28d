"""Profiling and evaluation-ledger observability.

Counterpart of ``queasars_tpu/utils/profiling.py`` on ``torch.profiler``.
The evaluation ledger lives in the solver driver; this module captures a
profiler trace around any region of a solve.  The file it writes differs
from the JAX package's: a Chrome trace (JSON, one file per capture, open it
in ``chrome://tracing`` or Perfetto) instead of a TensorBoard/XProf
profile directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, label: str = "queasars") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host and, with a card, CUDA
    activity) of the enclosed region and export it as a Chrome trace to
    ``log_dir/<label>.<pid>.<ns>.pt.trace.json``; the wall time is logged
    either way.

    With ``log_dir`` None only wall-clock logging happens (cheap default).

    Usage::

        with trace("/tmp/torch-trace"):
            solver.compute_minimum_eigenvalue(hamiltonian)
    """
    start = time.perf_counter()
    try:
        if log_dir is None:
            yield
        else:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as profiler:
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(
                log_dir, f"{label}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
            )
            profiler.export_chrome_trace(path)
            logger.info("%s: trace written to %s", label, path)
    finally:
        logger.info("%s: %.3f s", label, time.perf_counter() - start)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a captured trace
    (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
