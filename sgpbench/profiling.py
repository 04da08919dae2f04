"""The traced stretch of a window: ``torch.profiler`` over a span of calls,
reduced to the device's busy time, its kernel launches, each operation's
device seconds (``device_s``, for the metrics' readers) and a breakdown
(the ten operations with the most of them, and the longest idle gaps); and
the device clock of a whole window (``DeviceClock``), for an end-to-end
metric read from the device's trace.

The busy time is the union of the device's activity intervals (kernels,
copies, sets), so that intervals that overlap count once. Idle gaps are the
stretches between them, each named at its middle as
``<span>/<program span>:<op>``: the benchmark's own host span open then
(``call``), the program's innermost span open then (``solver.linesearch``;
``-`` for none) and the outermost host operation running then
(``aten::sub``; ``python`` for none).
"""
from __future__ import annotations

import bisect
import contextlib
import time

SPAN_PREFIX = 'sgpbench.'
PROGRAM_PREFIX = 'tpu_sgp_torch.'


def span(name: str):
    """A host span of the benchmark, seen in the trace as
    ``sgpbench.<name>``; a no-op outside a profile."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Stretch:
    """Profile from ``start`` to ``stop``, once, and count what the caller
    did inside: ``calls`` and solver-loop ``iters``."""

    def __init__(self, enabled: bool, device: str):
        self.enabled = enabled
        self.device = device
        self.state = 'before'
        self.prof = None
        self.calls = self.iters = 0
        self.t0 = self.t1 = None
        if enabled:
            # the profiler's first start takes seconds on the card: pay it
            # in set-up, not inside the window
            with self._profile():
                if device == 'cuda':
                    import torch
                    torch.ones(1, device=device).add_(1)
                self._sync()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    @property
    def on(self) -> bool:
        return self.state == 'on'

    def start(self) -> None:
        if not self.enabled or self.state != 'before':
            return
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.state = 'on'

    def stop(self) -> None:
        if self.state != 'on':
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.state = 'after'

    def elapsed(self) -> float:
        """Seconds since the stretch started (0 before)."""
        return time.perf_counter() - self.t0 if self.on else 0.0

    def _sync(self) -> None:
        if self.device == 'cuda':
            import torch
            torch.cuda.synchronize()

    def count(self, calls=0, iters=0) -> None:
        if self.on:
            self.calls += int(calls)
            self.iters += int(iters)

    def summary(self):
        """``None`` if nothing was profiled, else busy and window seconds,
        kernel launches, the counts, each operation's device seconds and
        the breakdown."""
        if self.state != 'after':
            return None
        return reduce(self.prof, self.t1 - self.t0, self.calls, self.iters)


class DeviceClock:
    """The device's busy seconds over the calls of a whole window, for an
    end-to-end metric read from the device's trace: each call profiled in a
    session of its own that records device activity alone, so that no
    session holds more than one call's kernels (a session's buffers are
    bounded, and a window of a launch-bound loop holds about a million
    kernels). ``busy_s`` is the sum over the calls of the union of their
    kernels', copies' and sets' intervals; ``None`` when off, and always on
    the CPU, which has no device trace."""

    def __init__(self, enabled: bool, device: str):
        self.enabled = enabled and device == 'cuda'
        self.busy_s = 0.0 if self.enabled else None
        self.calls = 0
        if self.enabled:
            # a session's first start is slow: pay it in set-up
            with self.call():
                import torch
                torch.ones(1, device=device).add_(1)
            self.busy_s, self.calls = 0.0, 0

    @contextlib.contextmanager
    def call(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            prof.stop()
            self.busy_s += device_busy_s(prof)
            self.calls += 1


def device_busy_s(prof) -> float:
    """The union of a session's device activity intervals, in seconds:
    kernels, copies and sets, not the ranges that host spans lay over them
    on the device's line."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    intervals = [(e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and not e.is_user_annotation()
                 and not e.name().startswith((SPAN_PREFIX, PROGRAM_PREFIX))]
    return sum(b - a for a, b in union(intervals)) / 1e9


def union(intervals):
    """Merge (start, end) intervals; returns the merged, sorted list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof, window_s: float, calls: int, iters: int):
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    device, host = [], []
    kernels = 0
    for e in events:
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX) and e.device_type == cuda:
            continue            # a host span's range on the device's line
        if e.device_type == cuda:
            device.append((tr.start, tr.end))
            if not e.name.startswith(('Memcpy', 'Memset')):
                kernels += 1
        elif e.name.startswith((SPAN_PREFIX, PROGRAM_PREFIX, 'aten::')):
            host.append((tr.start, tr.end, e.name))
    busy = union(device)
    busy_us = sum(b - a for a, b in busy)

    # idle gaps inside the profiled stretch, named by what the host did
    spans = _outermost(h for h in host if h[2].startswith(SPAN_PREFIX))
    ops = _outermost(h for h in host if h[2].startswith('aten::'))
    mids = [0.5 * (a + b) for (_, a), (b, _) in zip(busy, busy[1:])]
    inner = _innermost(((a, b, n[len(PROGRAM_PREFIX):]) for a, b, n in host
                        if n.startswith(PROGRAM_PREFIX)), mids, '-')
    gaps = {}
    for (_, a), (b, _), mid, prog in zip(busy, busy[1:], mids, inner):
        name = _at(spans, mid, SPAN_PREFIX + 'outside')[len(SPAN_PREFIX):]
        key = f'{name}/{prog}:{_at(ops, mid, "python")}'
        gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6

    # every operation with device time, the most first; the breakdown
    # prints the first ten, the readers take the whole stretch's
    timed = sorted((e for e in prof.key_averages()
                    if e.self_device_time_total > 0
                    and not e.key.startswith(SPAN_PREFIX)),
                   key=lambda e: e.self_device_time_total, reverse=True)
    device_s = {}
    for e in timed:
        device_s[e.key] = (device_s.get(e.key, 0.0)
                           + e.self_device_time_total / 1e6)
    return {'busy_s': busy_us / 1e6, 'window_s': window_s,
            'kernels': kernels, 'calls': calls, 'iters': iters,
            'device_s': device_s,
            'breakdown': {
                'device_ops': [[e.key, e.self_device_time_total / 1e6]
                               for e in timed[:10]],
                'idle_gaps': sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:10]}}


def _outermost(intervals):
    """The (start, end, name) intervals that no other one contains, in
    order of start (host spans and operations nest, per thread)."""
    out = []
    for a, b, name in sorted(intervals):
        if not out or a >= out[-1][1]:
            out.append((a, b, name))
    return out


def _innermost(intervals, times, default):
    """For each of the ascending ``times``, the name of the interval of
    ``intervals`` (start, end, name) open then that started last (the
    innermost, where they nest), else ``default``."""
    # by start, and of two that start together the outer one first
    todo = sorted(intervals, key=lambda h: (h[0], -h[1]), reverse=True)
    stack, out = [], []
    for t in times:
        while todo and todo[-1][0] <= t:
            stack.append(todo.pop())
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else default)
    return out


def _at(intervals, t, default):
    """The name of the interval of ``intervals`` (from ``_outermost``)
    that holds ``t``, else ``default``."""
    i = bisect.bisect_right(intervals, (t, float('inf'), '')) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i][2]
    return default
