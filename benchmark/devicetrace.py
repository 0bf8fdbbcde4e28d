"""What a ``--trace 1`` run records: host spans, the work handed to the
port's evaluation entry points, and the device's kernels from
``torch.profiler``, read in memory (no trace file is written).

- :class:`Spans` times calls from the benchmark's own wrappers on the host
  clock, with no synchronize.
- :class:`EntryWork` wraps the port's evaluation entry points wherever a
  module of the port holds them, records what each outermost call is handed
  (references to the small genome tensors, and sizes) and turns that into
  bytes and FLOPs by :mod:`benchmark.roofline` once the window has closed.
  It also counts the slot kernels' launches (the port's
  ``launch_counts``) inside and outside those calls.
- :class:`DeviceWindow` runs the profiler over the window and reduces its
  device events to busy time, kernel time by name and idle gaps.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from benchmark import roofline


class Spans:
    """Host-clock spans: per name, the total seconds and the count, and
    every interval (for labelling the device's idle gaps)."""

    def __init__(self):
        self.intervals: list[tuple[float, float, str, int]] = []
        self.depth = 0

    @contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            self.intervals.append((start, time.perf_counter(), name, self.depth))

    def wrap(self, obj, attribute: str, name: str) -> None:
        """Time every call of ``obj.attribute`` under ``name``."""
        inner = getattr(obj, attribute)

        def timed(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attribute, timed)

    def total(self, name: str) -> float:
        return sum(end - start for start, end, n, _ in self.intervals if n == name)

    def count(self, name: str) -> int:
        return sum(1 for *_, n, _ in self.intervals if n == name)

    def labels_at(self, times) -> list[str]:
        """The innermost span open at each host time in ``times`` (spans
        nest: one client thread opens and closes them in order)."""
        events = sorted([(s, 1, n) for s, _, n, _ in self.intervals]
                        + [(e, 0, n) for _, e, n, _ in self.intervals])
        order = sorted(range(len(times)), key=lambda k: times[k])
        out, stack, cursor = [""] * len(times), [], 0
        for k in order:
            while cursor < len(events) and events[cursor][0] <= times[k]:
                _, opening, name = events[cursor]
                if opening:
                    stack.append(name)
                elif stack:
                    stack.pop()
                cursor += 1
            out[k] = stack[-1] if stack else "outside spans"
        return out


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


class EntryWork:
    """Bytes and FLOPs handed to the port's evaluation entry points."""

    #: module, function and the rule that counts one call's work
    ENTRIES = (
        ("queasars_tpu_torch.optim.objective", "population_energies", "energies"),
        ("queasars_tpu_torch.optim.objective", "population_probs", "probs"),
        ("queasars_tpu_torch.optim.prefix", "simulate_prefix_states", "states"),
        ("queasars_tpu_torch.optim.sweep_kernel_launch", "nft_layer_sweep_launch", "sweep"),
    )

    def __init__(self):
        self.calls: list[tuple] = []
        self.launches_inside = 0
        self.recording = False
        self._local = threading.local()
        self._patched: list[tuple] = []

    def launches(self) -> int:
        """Launches of the port's hand-written slot kernels so far."""
        module = sys.modules.get("queasars_tpu_torch.sim.slot_kernels")
        return sum(module.launch_counts.values()) if module is not None else 0

    def install(self) -> None:
        """Wrap every entry point in every loaded module of the port that
        holds it (modules bind them by name at import)."""
        for module_name, function, rule in self.ENTRIES:
            module = sys.modules.get(module_name)
            if module is None or not hasattr(module, function):
                continue
            original = getattr(module, function)
            wrapper = self._wrapper(original, rule)
            for loaded in list(sys.modules.values()):
                if not getattr(loaded, "__name__", "").startswith("queasars_tpu_torch"):
                    continue
                for attribute, value in list(vars(loaded).items()):
                    if value is original:
                        setattr(loaded, attribute, wrapper)
                        self._patched.append((loaded, attribute, original))

    def uninstall(self) -> None:
        for module, attribute, original in reversed(self._patched):
            setattr(module, attribute, original)
        self._patched.clear()

    def _wrapper(self, original, rule):
        def counted(*args, **kwargs):
            depth = getattr(self._local, "depth", 0)
            if depth or not self.recording:
                return original(*args, **kwargs)
            self._local.depth = 1
            before = self.launches()
            try:
                return original(*args, **kwargs)
            finally:
                self._local.depth = 0
                self.launches_inside += self.launches() - before
                self._record(rule, args, kwargs)

        return counted

    def _record(self, rule, args, kwargs) -> None:
        """Keep what the call's work depends on: references to its small
        integer and mask tensors (never a state), and sizes."""
        if rule in ("energies", "probs", "states"):
            gate_types, layer_mask = args[0], args[3]
            initial = kwargs.get("initial_state", args[5] if rule == "states" and len(args) > 5
                                 else None)
            self.calls.append((rule, kwargs.get("n_qubits", args[4] if rule == "states"
                                                else None),
                               gate_types, layer_mask, initial is not None))
        else:
            (gate_types, _controls, _angles, layer_mask, last_layer, coords, n_free,
             active) = args[:8]
            self.calls.append(("sweep", kwargs["n_qubits"], gate_types, layer_mask,
                               kwargs.get("initial_state") is not None, last_layer, coords,
                               n_free, active, kwargs["maxiter"], kwargs["reset_interval"]))

    def least_seconds(self) -> tuple[float, dict]:
        """The least time of all recorded calls, and per rule (seconds,
        bound by bytes, bound by operations, calls)."""
        total, by_rule = 0.0, defaultdict(lambda: [0.0, 0, 0, 0])
        cache: dict = {}

        def host(t):
            key = id(t)
            if key not in cache:
                cache[key] = (t, _host(t))
            return cache[key][1]

        for call in self.calls:
            rule, n, gate_types, layer_mask, from_state = call[:5]
            gt, lm = host(gate_types), host(layer_mask)
            if rule == "energies":
                moved, flops = roofline.energies_work(gt, lm, n, from_state)
            elif rule == "probs":
                moved, flops = roofline.probs_work(gt, lm, n, from_state)
            elif rule == "states":
                moved, flops = roofline.states_work(gt, lm, n, from_state)
            else:
                last, coords, n_free, active, maxiter, reset = call[5:]
                moved, flops = roofline.layer_sweep_work(
                    gt, lm, host(last), host(coords), host(n_free), host(active), n, maxiter,
                    reset, from_state)
            seconds, bound = roofline.least_seconds(moved, flops)
            total += seconds
            entry = by_rule[rule]
            entry[0] += seconds
            entry[1 if bound == "bytes" else 2] += 1
            entry[3] += 1
        return total, dict(by_rule)


class DeviceWindow:
    """``torch.profiler`` over a window, device activity only, reduced in
    memory."""

    def __init__(self):
        self.profile = None
        self._mono_real = (0, 0)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.profile = profile(activities=[ProfilerActivity.CUDA])
        self.profile.start()
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._mono_real = (time.monotonic_ns(), time.time_ns())
        self.profile.stop()

    def device_events(self) -> list[tuple[str, float, float, str]]:
        """(name, start, end, kind) of every device operation, in host
        ``perf_counter`` seconds; kind is ``kernel``, ``memcpy`` or
        ``memset``."""
        from torch.autograd import DeviceType

        results = self.profile.profiler.kineto_results
        raw = [(e.name(), e.start_ns(), e.end_ns()) for e in results.events()
               if e.device_type() == DeviceType.CUDA]
        # the profiler stamps with the realtime or the monotonic clock:
        # take the one its trace start lies near; perf_counter is monotonic
        mono, real = self._mono_real
        trace_start = results.trace_start_ns()
        shift = time.perf_counter_ns() - time.monotonic_ns()
        if abs(trace_start - real) < abs(trace_start - mono):
            shift += mono - real
        out = []
        for name, start, end in raw:
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            out.append((name, (start + shift) * 1e-9, (end + shift) * 1e-9, kind))
        return out


def union_seconds(intervals, lo: float, hi: float) -> tuple[float, list[tuple[float, float]]]:
    """Length of the union of ``intervals`` clipped to [lo, hi], and the
    gaps it leaves there."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    busy, gaps, cursor = 0.0, [], lo
    for a, b in clipped:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < hi:
        gaps.append((cursor, hi))
    return busy, gaps


def reduce_window(events, lo: float, hi: float, spans: Spans) -> dict:
    """Busy seconds, kernel seconds and counts by name, and idle seconds by
    the host span open in the middle of each gap."""
    busy, gaps = union_seconds([(a, b) for _, a, b, _ in events], lo, hi)
    by_name: dict[str, float] = defaultdict(float)
    kernels, kernel_seconds = 0, 0.0
    for name, a, b, kind in events:
        if b <= lo or a >= hi:
            continue
        seconds = min(b, hi) - max(a, lo)
        by_name[name] += seconds
        if kind == "kernel":
            kernels += 1
            kernel_seconds += seconds
    idle_by_label: dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, spans.labels_at([(a + b) / 2 for a, b in gaps])):
        idle_by_label[label] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by_label.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=hi - lo, kernels=kernels, kernel_s=kernel_seconds,
                device_ops=[[n, s] for n, s in top], idle_gaps=[[n, s] for n, s in idle],
                longest_gap_s=max((b - a for a, b in gaps), default=0.0),
                names=len(by_name))
