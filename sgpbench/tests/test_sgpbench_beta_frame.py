"""The whole-frame beta cell (``frame2048_beta.single``): its two readers
on records made here, wherever the beta kernels rank in the stretch, the
profile's ``device_s`` beside its unchanged breakdown, its entries in
``BENCHMARK.json``, and a tiny copy of the cell run on the CPU: correct,
and its configuration's control not correct."""
import json
import os
import sys
from types import SimpleNamespace

import pytest

import sgpbench_tiny

sys.path.insert(0, sgpbench_tiny.BENCH)

import profiling  # noqa: E402

CELL = 'frame2048_beta.single'
CONFIG = 'm13_frame2048_beta'
METRICS = ('beta_div_roofline_pct.frame2048', 'beta_div_device_pct.frame2048')
# the frame cells' idle share, launches an iteration and iterations a
# frame, this cell's own (the 410 frame's move its device time)
FRAME = ('device_idle_pct.frame2048', 'launches_per_iter.frame2048',
         'iters_per_frame.frame2048')
# the tiny copy's cuts, as sgpbench_tiny.CUTS cuts the other cells: a
# 64x64 field of 8 stars. The limit lies between the program's reading
# here (3.5e-2 on every seed: the fields are fixed) and the bfloat16
# control's (0.77)
CUTS = {
    'workloads/frame2048_beta.single.json': {
        'inputs': {'calls': 2},
        'trace': {'start_s': 0.0, 'span_s': 0.2},
        'limits': {'x_gap_p90': 0.1}},
    'configs/m13_frame2048_beta.json': {
        'height': 64, 'width': 64, 'n_stars': 8},
}
# the kernels' names as the profiler gives them on the card
F32 = 'void (anonymous namespace)::beta_div_kernel<float, 1>(float const*)'
F64 = ('void (anonymous namespace)::beta_div_kernel<double, 0>(double '
       'const*)')
# a second pass that folds the blocks' partial sums, as a kernel that
# spreads a long row over many blocks may name it
FOLD32 = ('void (anonymous namespace)::beta_div_kernel_fold<float>(float '
          'const*)')
FOLD64 = ('void (anonymous namespace)::beta_div_kernel_fold<double>(double '
          'const*)')


def copy(dst: str, cuts=CUTS) -> str:
    root = sgpbench_tiny.copy(dst)
    for rel, cut in cuts.items():
        path = os.path.join(root, 'sgpbench', rel)
        with open(path) as f:
            doc = json.load(f)
        for key, val in cut.items():
            if isinstance(val, dict):
                doc[key].update(val)
            else:
                doc[key] = val
        with open(path, 'w') as f:
            json.dump(doc, f)
    return root


def _record(ops, busy=0.5):
    """A record as ``profiling.reduce`` makes it from a stretch whose
    operations took ``ops`` ([name, device seconds]): every one in
    ``device_s``, the ten with the most in the breakdown."""
    ops = sorted(ops, key=lambda op: op[1], reverse=True)
    return {'profile': {'busy_s': busy, 'window_s': 1.0, 'calls': 1,
                        'device_s': dict(ops),
                        'breakdown': {'device_ops': ops[:10],
                                      'idle_gaps': []}},
            'calls': 1, 'attempted': 1}


def _ranked(kernels, rank):
    """The operations of a stretch in which ``kernels`` ([name, seconds])
    follow ``rank`` operations that took longer, among 40 in all."""
    slow = [[f'aten::slow{i}', 0.3 - 1e-3 * i] for i in range(rank)]
    fast = [[f'aten::fast{i}', 1e-6 * (i + 1)] for i in range(40 - rank)]
    return slow + kernels + fast


def _traced(pixels):
    """A recording that holds ``pixels`` under the beta kernel's counter
    (none at all where ``pixels`` is None), as the newest one."""
    from tpu_sgp_torch import observability as obs
    with obs.tracing():
        with obs.span('beta.objective'):
            if pixels is not None:
                obs.count('beta_div.pixels', pixels)


@pytest.fixture(scope='module')
def readers():
    mod = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    return {m: mod.reader(m) for m in METRICS}


@pytest.mark.parametrize('name,size', [(F32, 4), (F64, 8)])
def test_the_readers_count_the_bytes_of_the_kernels_type(readers, name,
                                                         size):
    n = 4 * 2 ** 22
    _traced(n)
    rec = _record([['aten::mul', 0.3], [name, 0.01], ['aten::add', 0.02]])
    want = 100.0 * (3 * size * n / 3.35e12) / 0.01
    assert readers[METRICS[0]](rec) == pytest.approx(want, rel=1e-12)
    assert readers[METRICS[1]](rec) == pytest.approx(100.0 * 0.01 / 0.5)


def test_the_readers_return_nothing_without_the_kernel_or_counter(readers):
    _traced(2 ** 22)
    for rec in (_record([['aten::mul', 0.3]]), _record([]), {},
                {'profile': None}):
        assert readers[METRICS[0]](rec) is None
        assert readers[METRICS[1]](rec) is None
    # both types' instances in one stretch: no one item size
    both = _record([[F32, 0.01], [F64, 0.01]])
    assert readers[METRICS[0]](both) is None
    # a program without the pixel counter (the parent's): the roofline
    # says nothing, the kernel's share of the busy time still reads
    _traced(None)
    rec = _record([[F32, 0.01]])
    assert readers[METRICS[0]](rec) is None
    assert readers[METRICS[1]](rec) == pytest.approx(2.0)


@pytest.mark.parametrize('rank', [10, 11, 39])
def test_the_readers_read_the_kernel_wherever_it_ranks(readers, rank):
    n = 4 * 2 ** 22
    _traced(n)
    leads = _record(_ranked([[F32, 0.01]], 0))
    assert leads['profile']['breakdown']['device_ops'][0][0] == F32
    rec = _record(_ranked([[F32, 0.01]], rank))
    assert F32 not in dict(rec['profile']['breakdown']['device_ops'])
    want = 100.0 * (3 * 4 * n / 3.35e12) / 0.01
    for m in METRICS:
        assert readers[m](rec) == readers[m](leads)
    assert readers[METRICS[0]](rec) == pytest.approx(want, rel=1e-12)
    assert readers[METRICS[1]](rec) == pytest.approx(100.0 * 0.01 / 0.5)


@pytest.mark.parametrize('rank', [0, 12])
@pytest.mark.parametrize('names,size', [((F32, FOLD32), 4),
                                        ((F64, FOLD64), 8)])
def test_the_readers_sum_every_beta_kernel_of_one_type(readers, rank, names,
                                                      size):
    n = 2 ** 22
    _traced(n)
    rec = _record(_ranked([[names[0], 0.003], [names[1], 0.0005]], rank))
    want = 100.0 * (3 * size * n / 3.35e12) / 0.0035
    assert readers[METRICS[0]](rec) == pytest.approx(want, rel=1e-12)
    assert readers[METRICS[1]](rec) == pytest.approx(100.0 * 0.0035 / 0.5)


def test_the_readers_refuse_mixed_or_untyped_beta_kernels(readers):
    _traced(2 ** 22)
    untyped = 'beta_div_kernel_fold(float const*)'
    for ops in ([[F32, 0.01], [FOLD64, 0.001]],
                [[F32, 0.01], [untyped, 0.001]],
                _ranked([[F32, 0.01], [F64, 0.01]], 20)):
        rec = _record(ops)
        assert readers[METRICS[0]](rec) is None
        assert readers[METRICS[1]](rec) is None


class _Profile:
    """What ``profiling.reduce`` reads of a profiler: no events, and
    ``key_averages`` of (name, self device microseconds)."""

    def __init__(self, averages):
        self._averages = [SimpleNamespace(key=k, self_device_time_total=t)
                          for k, t in averages]

    def events(self):
        return []

    def key_averages(self):
        return self._averages


def test_reduce_keeps_the_breakdowns_ten_and_every_op_beside_it():
    us = {'aten::mul': 500, 'aten::add': 40, F32: 300, 'aten::where': 7,
          'aten::copy_': 90, 'aten::_fft_r2c': 120, 'aten::le': 3,
          'aten::_fft_c2r': 60, 'tpu_sgp_torch.beta.objective': 250,
          'aten::sum': 15, FOLD32: 80, 'aten::sub': 33, 'aten::neg': 2,
          'aten::idle': 0, 'sgpbench.call': 900}
    out = profiling.reduce(_Profile(list(us.items())), 1.0, 1, 1)
    # the ten with the most device time, the benchmark's spans left out,
    # as the breakdown always held them
    assert out['breakdown']['device_ops'] == [
        ['aten::mul', 500e-6], [F32, 300e-6],
        ['tpu_sgp_torch.beta.objective', 250e-6],
        ['aten::_fft_r2c', 120e-6], ['aten::copy_', 90e-6], [FOLD32, 80e-6],
        ['aten::_fft_c2r', 60e-6], ['aten::add', 40e-6], ['aten::sub', 33e-6],
        ['aten::sum', 15e-6]]
    assert out['breakdown']['idle_gaps'] == []
    assert out['device_s'] == {k: t / 1e6 for k, t in us.items()
                               if t and not k.startswith('sgpbench.')}
    assert list(out['device_s'])[:10] == [
        k for k, _ in out['breakdown']['device_ops']]


def test_the_cells_entries_in_the_manifest():
    with open(os.path.join(sgpbench_tiny.REPO, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    run = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    (cfg,) = [c for c in manifest['configs'] if c['name'] == CONFIG]
    with open(os.path.join(sgpbench_tiny.REPO, cfg['file'])) as f:
        doc = json.load(f)
    assert (doc['height'], doc['width'], doc['reference']) == (
        2048, 2048, 'sgp_beta_plain')
    (cell,) = [w for w in manifest['workloads'] if w['name'] == CELL]
    assert (cell['config'], cell['chips']) == (CONFIG, 1)
    with open(os.path.join(sgpbench_tiny.BENCH, 'workloads',
                           CELL + '.json')) as f:
        work = json.load(f)
    assert (work['entry'], work['inputs']['kind'], work['inputs']['lanes'],
            work['inputs']['calls']) == ('restore_stamps', 'fields', 1, 4)
    assert 'call' not in work
    ends = {m['name'] for m in run.cell_metrics(manifest, CELL, False)}
    assert ends == {'frame_solve_s', 'setup_s'}
    layers = {m['name'] for m in run.cell_metrics(manifest, CELL, True)}
    assert layers == set(METRICS) | set(FRAME)
    for m in manifest['per_layer']:
        if m['name'] in METRICS:
            assert (m['layer'], m['moves'], m['workloads']) == (
                'Operator, divergence', 'frame_solve_s', [CELL])
        if m['name'] in FRAME:
            assert (m['moves'], m['workloads']) == ('frame_solve_s', [CELL])


def test_the_cell_runs_correct_on_a_small_field(tmp_path):
    root = copy(str(tmp_path))
    for trace in (0, 1):
        out = sgpbench_tiny.run(root, CELL, seed=2 ** 35 + 5, trace=trace)
        assert out['correct'], out['compared']
        assert out['compared']['flux_gap_max']['value'] < 1e-4
        assert out['attempted'] >= 1 and out['failed'] == 0
        if not trace:
            assert set(out['metrics']) == {'frame_solve_s', 'setup_s'}
        else:
            # no device on the CPU: only the iteration count reads
            assert set(out['metrics']) == {'iters_per_frame.frame2048'}


def test_the_cells_control_is_not_correct(tmp_path):
    root = copy(str(tmp_path))
    with open(os.path.join(root, 'sgpbench', 'configs',
                           CONFIG + '.json')) as f:
        control = json.load(f)['control']
    out = sgpbench_tiny.run(root, CELL, seed=2 ** 35 + 5, control=control)
    assert not out['correct']
    gap = out['compared']['x_gap_p90']
    assert gap['value'] > gap['limit']


@pytest.mark.cuda
def test_the_cell_reads_its_kernel_on_the_card(tmp_path):
    """A 512x512 copy traced on the card, so that the beta kernel's row
    leads the breakdown as the cell's does: correct, both readers find the
    kernel in a real profile, its roofline share at most 100 %, as they
    find it in the profile's ``device_s``, and the cell's idle
    share, launches an iteration and iterations a frame read."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA)')
    cuts = dict(CUTS)
    cuts['configs/m13_frame2048_beta.json'] = {
        'height': 512, 'width': 512, 'n_stars': 160}
    root = copy(str(tmp_path), cuts)
    out = sgpbench_tiny.run(root, CELL, trace=1, device='cuda')
    assert out['correct'], out['compared']
    got = {k: v['value'] for k, v in out['metrics'].items()}
    assert set(got) == set(METRICS) | set(FRAME)
    assert 0 < got[METRICS[0]] <= 100
    assert 0 < got[METRICS[1]] <= 100
    assert 0 <= got['device_idle_pct.frame2048'] < 100
    assert got['launches_per_iter.frame2048'] > 0
    assert got['iters_per_frame.frame2048'] >= 1
