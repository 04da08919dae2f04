"""The whole-frame beta cell (``frame2048_beta.single``): its two readers
on records made here, its entries in ``BENCHMARK.json``, and a tiny copy
of the cell run on the CPU: correct, and its configuration's control not
correct."""
import json
import os

import pytest

import sgpbench_tiny

CELL = 'frame2048_beta.single'
CONFIG = 'm13_frame2048_beta'
METRICS = ('beta_div_roofline_pct.frame2048', 'beta_div_device_pct.frame2048')
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
    return {'profile': {'busy_s': busy, 'window_s': 1.0, 'calls': 1,
                        'breakdown': {'device_ops': ops, 'idle_gaps': []}},
            'calls': 1, 'attempted': 1}


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
    assert layers == set(METRICS)
    for m in manifest['per_layer']:
        if m['name'] in METRICS:
            assert (m['layer'], m['moves'], m['workloads']) == (
                'Operator, divergence', 'frame_solve_s', [CELL])


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
            # no device on the CPU: the two readers find nothing
            assert not set(out['metrics']) & set(METRICS)


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
    leads the breakdown as the cell's does: correct, and both readers find
    the kernel in a real profile, its roofline share at most 100 %."""
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
    assert set(got) == set(METRICS)
    assert 0 < got[METRICS[0]] <= 100
    assert 0 < got[METRICS[1]] <= 100
