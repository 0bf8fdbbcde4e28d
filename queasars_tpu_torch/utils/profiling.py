"""Profiling: the port's span recorder and profiler trace capture.

Counterpart of ``queasars_tpu/utils/profiling.py`` on ``torch.profiler``.
The evaluation ledger lives in the EVQE solver loop and the kernel launch
counters in ``sim/*_kernels.py`` (``launch_counts``); this module holds the
rest of the port's observability:

- :func:`span` marks a region of the program under a fixed name.  The port
  opens spans at its layer boundaries:

  =================================  ==========================================
  span                               where
  =================================  ==========================================
  ``solve``                          the EVQE solver's solve entry points
  ``evaluator.build``                each evaluator a solve builds (the
                                     energy table, on the card)
  ``operator.<ClassName>``           each ``apply_operator`` of the solve's
                                     operator pipeline
  ``eigenstate``                     the final distribution (attribute
                                     ``entries``: the dict's size)
  ``nft.step``                       each lock-step NFT update on the device
  ``evaluator.population_energies``, the four evaluation entry points
  ``evaluator.population_probs``,    (``optim/objective.py``,
  ``evaluator.simulate_prefix_       ``optim/prefix.py``,
  states``, ``evaluator.nft_layer_   ``optim/sweep_kernel_launch.py``)
  sweep_launch``
  ``evaluator.evaluate_packed``      an operator evaluator's ``evaluate_packed``
  ``fold.build``                     each kron-fold pipeline built on the host
                                     (``sim/fold_pipeline.py``)
  ``wait.<site>``                    the host blocked on a device-to-host copy
  ``encode``                         the JSSP encoder's set-up and its
                                     Hamiltonian
  =================================  ==========================================

- :func:`recording` turns recording on for its body and returns the
  :class:`Recording`.  Outside one, :func:`span` returns one shared no-op
  context: it reads no clock, allocates nothing and takes no lock.
- :func:`counters` reads the counts the port keeps whether or not a
  recording is open (the kernel modules' ``launch_counts``, the fold
  pipeline's ``build_counts``); the solvers' entry points
  (:func:`solve_entry`) keep them at each solve's start, so
  :func:`counts_since` gives the counts of the last solves.
- :func:`trace` captures the card's kernels, copies and fills with
  ``torch.profiler`` (no host operator events) and writes them with the
  spans into one Chrome trace, on the profiler's clock (open it in
  ``chrome://tracing`` or Perfetto; the JAX package writes a
  TensorBoard/XProf profile directory instead).
- :func:`annotate` names a region for ``torch.profiler`` and opens a span.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import heapq
import json
import logging
import os
import sys
import threading
import time
from typing import Iterator, Optional, Sequence, Union

logger = logging.getLogger(__name__)

#: spans that start a request when no request span encloses them
REQUEST_SPANS = frozenset({"solve", "evaluator.evaluate_packed"})
#: the modules whose ``launch_counts`` a recording reads around each solve
LAUNCH_COUNTERS = tuple(
    f"queasars_tpu_torch.sim.{name}"
    for name in ("slot_kernels", "fold_kernels", "compact_kernels", "shard_kernels")
)
#: the module whose ``build_counts`` :func:`counters` reads
BUILD_COUNTER = "queasars_tpu_torch.sim.fold_pipeline"
#: :func:`counters` at the start of each solve, newest last
solve_starts: collections.deque = collections.deque(maxlen=1024)

#: the Chrome trace categories of the card's kernels, copies and fills
DEVICE_EVENTS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: the recording spans go to; None: recording is off
_active: Optional["Recording"] = None


class _Off:
    """The context :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _launch_snapshot() -> dict[str, int]:
    """Every loaded kernel module's launch counts, as ``<module>.<row>``."""
    counts = {}
    for name in LAUNCH_COUNTERS:
        module = sys.modules.get(name)
        if module is not None:
            prefix = name.rsplit(".", 1)[1]
            counts.update((f"{prefix}.{row}", n) for row, n in module.launch_counts.items())
    return counts


def counters() -> dict[str, int]:
    """The launch counts (``<module>.<row>``) and the fold pipeline's build
    counts (``fold_pipeline.<name>``) of the loaded modules."""
    counts = _launch_snapshot()
    module = sys.modules.get(BUILD_COUNTER)
    if module is not None:
        counts.update((f"fold_pipeline.{name}", n) for name, n in module.build_counts.items())
    return counts


def counts_since(solves: int) -> Optional[dict[str, int]]:
    """How far each of :func:`counters` grew from the start of the
    ``solves``-th last solve to now, or None where fewer solves were
    kept."""
    if solves < 1 or solves > len(solve_starts):
        return None
    before = solve_starts[-solves]
    return {name: n - before.get(name, 0) for name, n in counters().items()}


class Recording:
    """The spans recorded inside one :func:`recording`.

    ``spans`` holds ``(name, start_ns, end_ns, parent, request, attrs)`` per
    span in the order they opened; ``end_ns`` is None while a span is open.
    Times are ``time.perf_counter_ns()``.  ``parent`` is the index of the
    enclosing span on the same thread and ``request`` the index of the
    outermost ``solve`` or ``evaluator.evaluate_packed`` span around it
    (-1: none); a request span that no other encloses is its own request.
    ``launches`` maps the index of each closed ``solve`` span to the kernel
    launches made while it was open, per ``<module>.<row>``.
    """

    def __init__(self):
        self.spans: list[tuple] = []
        self.launches: dict[int, dict[str, int]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def summary(self) -> dict[str, dict]:
        """Per span name over the closed spans: ``count``, ``total_s`` and
        ``self_s`` (each span less the time its child spans cover)."""
        children = [0] * len(self.spans)
        for _, start, end, parent, _, _ in self.spans:
            if end is not None and parent >= 0:
                children[parent] += end - start
        out: dict[str, dict] = {}
        for index, (name, start, end, _, _, _) in enumerate(self.spans):
            if end is None:
                continue
            entry = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            entry["count"] += 1
            entry["total_s"] += (end - start) * 1e-9
            entry["self_s"] += (end - start - children[index]) * 1e-9
        return out

    def durations(self, prefix: Union[str, tuple], minus: Union[str, tuple] = ()) -> list[float]:
        """Seconds of each closed span whose name starts with ``prefix`` (a
        string or a tuple of them) and that no such span encloses, less the
        seconds of the outermost spans inside it whose names start with
        ``minus``."""
        top = [-1] * len(self.spans)
        cut = [False] * len(self.spans)
        less: dict[int, int] = {}
        for index, (name, start, end, parent, _, _) in enumerate(self.spans):
            outer = top[parent] if parent >= 0 else -1
            if outer < 0:
                if name.startswith(prefix):
                    top[index] = index
                    less[index] = 0
                continue
            top[index] = outer
            inside = cut[parent] and parent != outer
            if minus and name.startswith(minus) and not inside:
                if end is not None:
                    less[outer] += end - start
                cut[index] = True
            else:
                cut[index] = inside
        return [(self.spans[i][2] - self.spans[i][1] - less[i]) * 1e-9
                for i in less if self.spans[i][2] is not None]

    def innermost(self, times_ns: Sequence[int]) -> list[Optional[str]]:
        """The name of the innermost closed span open at each time in
        ``times_ns`` (the one that opened last), or None."""
        closed = sorted((s[1], i) for i, s in enumerate(self.spans) if s[2] is not None)
        out: list[Optional[str]] = [None] * len(times_ns)
        heap: list[tuple] = []
        cursor = 0
        for k in sorted(range(len(times_ns)), key=times_ns.__getitem__):
            t = times_ns[k]
            while cursor < len(closed) and closed[cursor][0] <= t:
                start, index = closed[cursor]
                heapq.heappush(heap, (-start, -index))
                cursor += 1
            while heap and self.spans[-heap[0][1]][2] <= t:
                heapq.heappop(heap)
            if heap:
                out[k] = self.spans[-heap[0][1]][0]
        return out


class _Span:
    """One open span of a recording."""

    __slots__ = ("recording", "name", "attrs", "index", "start", "launches")

    def __init__(self, recording: Recording, name: str, attrs: dict):
        self.recording, self.name, self.attrs = recording, name, attrs

    def __enter__(self):
        recording = self.recording
        stack = recording._stack()
        parent = stack[-1] if stack else -1
        self.launches = _launch_snapshot() if self.name == "solve" else None
        self.start = time.perf_counter_ns()
        with recording._lock:
            index = len(recording.spans)
            request = recording.spans[parent][4] if parent >= 0 else -1
            if request < 0 and self.name in REQUEST_SPANS:
                request = index
            recording.spans.append((self.name, self.start, None, parent, request, self.attrs))
        self.index = index
        stack.append(index)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        recording = self.recording
        _, start, _, parent, request, attrs = recording.spans[self.index]
        recording.spans[self.index] = (self.name, start, end, parent, request, attrs)
        recording._stack().pop()
        if self.launches is not None:
            before = self.launches
            recording.launches[self.index] = {
                row: n - before.get(row, 0) for row, n in _launch_snapshot().items()
            }
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records the enclosed region as span ``name``
    with ``attrs`` while a :func:`recording` is open, and does nothing
    otherwise.  The context's ``set(**attrs)`` adds attributes."""
    recording = _active
    if recording is None:
        return _OFF
    return _Span(recording, name, attrs)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def decorate(function):
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            recording = _active
            if recording is None:
                return function(*args, **kwargs)
            with _Span(recording, name, {}):
                return function(*args, **kwargs)

        return wrapper

    return decorate


def solve_entry(function):
    """Decorator of the solvers' entry points: each call runs inside
    ``span("solve")`` and first appends :func:`counters` to
    :data:`solve_starts`, recording or not."""
    recorded = spanned("solve")(function)

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        solve_starts.append(counters())
        return recorded(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span opened in the body (on any thread) into the
    returned :class:`Recording`; an enclosing recording resumes after."""
    global _active
    outer, _active = _active, Recording()
    try:
        yield _active
    finally:
        _active = outer


def _chrome_events(recorded: Recording, shift_ns: int, base_ns: int) -> list[dict]:
    """The closed spans as Chrome trace events: ``ts`` in microseconds from
    ``base_ns``, on the clock ``perf_counter_ns() - shift_ns``."""
    pid = os.getpid()
    events = []
    for name, start, end, parent, request, attrs in recorded.spans:
        if end is None:
            continue
        events.append({
            "ph": "X", "cat": "program", "name": name, "pid": pid, "tid": "program spans",
            "ts": (start - shift_ns - base_ns) / 1e3, "dur": (end - start) / 1e3,
            "args": {"request": request, **attrs},
        })
    return events


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, label: str = "queasars") -> Iterator[None]:
    """Record the enclosed region's spans and, with a card, its device
    activity (kernels, copies and fills, from ``torch.profiler`` with CUDA
    activity only), and export both as one Chrome trace to
    ``log_dir/<label>.<pid>.<ns>.pt.trace.json``; the wall time is logged
    either way.  The spans are shifted onto the profiler's clock, so a
    kernel lies in the timeline after the span that launched it.

    With ``log_dir`` None only wall-clock logging happens (cheap default).

    Usage::

        with trace("/tmp/torch-trace"):
            solver.compute_minimum_eigenvalue(hamiltonian)
    """
    start = time.perf_counter()
    try:
        if log_dir is None:
            yield
            return
        import torch

        profiler = None
        with recording() as recorded:
            if torch.cuda.is_available():
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as profiler:
                    yield
                    torch.cuda.synchronize()
                    mono, real = time.monotonic_ns(), time.time_ns()
            else:
                yield
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{label}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
        shift, data = 0, {"traceEvents": []}
        if profiler is not None:
            profiler.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
            # the card's own operations and the timeline's names; the CUDA
            # runtime calls and their flow arrows are host events
            data["traceEvents"] = [e for e in data["traceEvents"] if e.get("ph") == "M"
                                   or e.get("cat") in DEVICE_EVENTS]
            # the profiler stamps with the realtime or the monotonic clock:
            # take the one its trace start lies near; perf_counter is monotonic
            shift = time.perf_counter_ns() - time.monotonic_ns()
            trace_start = profiler.profiler.kineto_results.trace_start_ns()
            if abs(trace_start - real) < abs(trace_start - mono):
                shift += mono - real
        data["traceEvents"].extend(
            _chrome_events(recorded, shift, int(data.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as fh:
            json.dump(data, fh)
        logger.info("%s: trace written to %s", label, path)
    finally:
        logger.info("%s: %.3f s", label, time.perf_counter() - start)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region: a ``torch.profiler.record_function`` event inside
    a profiler's capture, and span ``name`` inside a recording."""
    from torch.profiler import record_function

    with record_function(name), span(name):
        yield
