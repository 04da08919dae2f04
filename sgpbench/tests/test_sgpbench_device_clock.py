"""The device clock of a whole window (``profiling.DeviceClock``) and the
end-to-end metric it serves, ``frame_device_s`` on the 410 frame cell: the
union of a session's device intervals without the ranges that spans lay
over them, no clock on the CPU, the manifest's entries, a tiny run of the
cell on the CPU and on the card."""
import json
import os
import sys
from types import SimpleNamespace

import pytest

import sgpbench_tiny

sys.path.insert(0, sgpbench_tiny.BENCH)

import profiling  # noqa: E402

CELL = 'frame410_kl.single'


class _Event:
    def __init__(self, name, start, end, cuda=True, annotation=False):
        import torch
        kinds = torch.autograd.DeviceType
        self._v = (name, start, end, kinds.CUDA if cuda else kinds.CPU,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _session(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_a_sessions_busy_time_is_the_union_of_its_device_activity():
    events = [_Event('kernel_a', 0, 400), _Event('kernel_b', 300, 600),
              _Event('Memcpy DtoH', 1000, 1100),
              _Event('Memset', 1050, 1200),
              # ranges over the kernels, not device work
              _Event('sgpbench.call', 0, 5000),
              _Event('tpu_sgp_torch.solver.trip', 0, 4000),
              _Event('any_annotation', 0, 9000, annotation=True),
              # the host's side
              _Event('cudaLaunchKernel', 0, 8000, cuda=False)]
    assert profiling.device_busy_s(_session(events)) == pytest.approx(
        800e-9)
    assert profiling.device_busy_s(_session([])) == 0.0


@pytest.mark.parametrize('enabled', [True, False])
def test_the_clock_reads_nothing_on_the_cpu(enabled):
    clock = profiling.DeviceClock(enabled, 'cpu')
    with clock.call():
        pass
    assert clock.busy_s is None and clock.calls == 0


def test_the_reader_takes_busy_seconds_over_frames():
    run = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    read = run.reader('frame_device_s')
    assert read({'frames_done': 4, 'device_busy_s': 0.2}) == 0.05
    assert read({'frames_done': 4, 'device_busy_s': None}) is None
    assert read({'frames_done': 0, 'device_busy_s': 0.0}) is None


def test_the_410_frame_reports_its_device_time_end_to_end():
    """frame_device_s is the cell's end-to-end metric beside setup_s and
    every per-layer metric of the cell moves it; the frame's wall is per
    layer there, and end to end on the beta frame alone."""
    with open(os.path.join(sgpbench_tiny.REPO, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    run = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    ends = run.cell_metrics(manifest, CELL, False)
    assert {m['name'] for m in ends} == {'frame_device_s', 'setup_s'}
    (dev,) = [m for m in ends if m['name'] == 'frame_device_s']
    assert (dev['source'], dev['unit'], dev['better'],
            dev['workloads']) == ('device_trace', 's', 'lower', [CELL])
    (wall,) = [m for m in manifest['end_to_end']
               if m['name'] == 'frame_solve_s']
    assert wall['workloads'] == ['frame2048_beta.single']
    layers = run.cell_metrics(manifest, CELL, True)
    assert 'frame_solve_s.frame410' in {m['name'] for m in layers}
    assert {m['moves'] for m in layers} == {'frame_device_s'}
    assert all(m['workloads'] == [CELL] for m in layers)


def test_a_run_of_the_cell_on_the_cpu(tmp_path):
    """The clock is on in the window of a run without a trace, and reads
    nothing on the CPU; a traced run reads the frame's wall per layer."""
    root = sgpbench_tiny.copy(str(tmp_path))
    out = sgpbench_tiny.run(root, CELL, trace=0)
    assert out['correct'], out['compared']
    assert set(out['metrics']) == {'setup_s'}
    out = sgpbench_tiny.run(root, CELL, seconds=0.6, trace=1)
    assert out['correct'], out['compared']
    assert out['metrics']['frame_solve_s.frame410']['value'] > 0


@pytest.mark.cuda
def test_the_cell_reads_its_device_time_on_the_card(tmp_path):
    """On the card the window's device seconds a frame read a number,
    below the traced run's wall a frame (the 410 frame's device is idle
    most of the time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA)')
    root = sgpbench_tiny.copy(str(tmp_path))
    out = sgpbench_tiny.run(root, CELL, trace=0, device='cuda')
    assert out['correct'], out['compared']
    dev = out['metrics']['frame_device_s']['value']
    traced = sgpbench_tiny.run(root, CELL, trace=1, device='cuda')
    wall = traced['metrics']['frame_solve_s.frame410']['value']
    assert 0 < dev < wall
