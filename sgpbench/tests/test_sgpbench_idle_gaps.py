"""The breakdown's idle gaps (``profiling.reduce``) on a hand-built trace:
each gap is named by the benchmark's span, the program's innermost span
and the host operation open at its middle, and the seconds are the gaps'
own, whatever their names."""
import sys
from types import SimpleNamespace

import pytest
import torch

from sgpbench_tiny import BENCH

sys.path.insert(0, BENCH)

import profiling  # noqa: E402

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def event(name, start, end, device=CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class Trace:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        return []


# microseconds; a call holds one solver trip: a line search with a flag
# wait (sync), then an update; device work between host steps
HOST = [
    event('sgpbench.call', 0, 1000),
    event('tpu_sgp_torch.solver.trip', 100, 850),
    event('tpu_sgp_torch.solver.linesearch', 100, 500),
    event('aten::sub', 120, 180),
    event('tpu_sgp_torch.sync', 300, 400),
    event('aten::is_nonzero', 300, 400),
    event('tpu_sgp_torch.solver.update', 500, 850),
    event('aten::add', 550, 650),
    event('sgpbench.call', 0, 1000, CUDA),       # a span on the card's line
]
DEVICE = [event('kernel_a', 10, 100, CUDA), event('kernel_b', 200, 250, CUDA),
          event('Memcpy DtoH', 330, 360, CUDA), event('kernel_c', 380, 420,
                                                      CUDA),
          event('kernel_d', 760, 800, CUDA), event('kernel_e', 950, 1100,
                                                   CUDA)]
# gap (start, end) -> its name
GAPS = {(100, 200): 'call/solver.linesearch:aten::sub',
        (250, 330): 'call/solver.linesearch:python',
        (360, 380): 'call/sync:aten::is_nonzero',
        (420, 760): 'call/solver.update:aten::add',
        (800, 950): 'call/-:python'}


def test_idle_gaps_are_named_by_the_program_span():
    out = profiling.reduce(Trace(HOST + DEVICE), 1.2e-3, 1, 1)
    gaps = dict(out['breakdown']['idle_gaps'])
    want = {name: (b - a) / 1e6 for (a, b), name in GAPS.items()}
    assert gaps == pytest.approx(want, rel=1e-12, abs=0)
    # the seconds are the gaps' own: the idle time of the stretch
    busy = (90 + 50 + 30 + 40 + 40 + 150) / 1e6
    assert out['busy_s'] == pytest.approx(busy, rel=1e-12)
    assert sum(gaps.values()) == pytest.approx(1.09e-3 - busy, rel=1e-12)
    assert out['kernels'] == 5
    assert out['breakdown']['device_ops'] == []


def test_innermost_takes_the_span_that_started_last():
    spans = [(0, 10, 'outer'), (0, 4, 'first'), (2, 3, 'deep'),
             (6, 9, 'second'), (12, 14, 'later')]
    at = profiling._innermost(spans, [1, 2.5, 3.5, 5, 7, 11, 13, 15], '-')
    assert at == ['first', 'deep', 'first', 'outer', 'second', '-', 'later',
                  '-']


def test_the_names_hold_no_program_span_without_one():
    out = profiling.reduce(Trace([HOST[0]] + DEVICE), 1.2e-3, 1, 1)
    names = [k for k, _ in out['breakdown']['idle_gaps']]
    assert names and all(k.startswith('call/-:') for k in names)
