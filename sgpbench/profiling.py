"""The traced stretch of a window: ``torch.profiler`` over a span of calls,
reduced to the device's busy time, its kernel launches and a breakdown.

The busy time is the union of the device's activity intervals (kernels,
copies, sets), so that intervals that overlap count once. Idle gaps are the
stretches between them, each named by the benchmark's own host span that
was open at its middle (``span``) and by the host operation running then,
where the profiler saw one.
"""
from __future__ import annotations

import bisect
import time

SPAN_PREFIX = 'sgpbench.'


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
        kernel launches, the counts, and the breakdown."""
        if self.state != 'after':
            return None
        return reduce(self.prof, self.t1 - self.t0, self.calls, self.iters)


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
        elif e.name.startswith(SPAN_PREFIX) or e.name.startswith('aten::'):
            host.append((tr.start, tr.end, e.name))
    busy = union(device)
    busy_us = sum(b - a for a, b in busy)

    # idle gaps inside the profiled stretch, named by what the host did
    spans = _outermost(h for h in host if h[2].startswith(SPAN_PREFIX))
    ops = _outermost(h for h in host if not h[2].startswith(SPAN_PREFIX))
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        name = _at(spans, mid, SPAN_PREFIX + 'outside')[len(SPAN_PREFIX):]
        key = f'{name}:{_at(ops, mid, "python")}'
        gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6

    top = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith(SPAN_PREFIX)),
                 key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {'busy_s': busy_us / 1e6, 'window_s': window_s,
            'kernels': kernels, 'calls': calls, 'iters': iters,
            'breakdown': {
                'device_ops': [[e.key, e.self_device_time_total / 1e6]
                               for e in top],
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


def _at(intervals, t, default):
    """The name of the interval of ``intervals`` (from ``_outermost``)
    that holds ``t``, else ``default``."""
    i = bisect.bisect_right(intervals, (t, float('inf'), '')) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i][2]
    return default
