"""The beta star-stamp cell (``stamps_beta.batch12288``) on the CPU, in a
tiny copy: correct, with its three per-layer values read from the
program's beta spans and counter, and its configuration's control not
correct."""
import json
import os

import sgpbench_tiny

CELL = 'stamps_beta.batch12288'
# the tiny copy's cuts, as sgpbench_tiny.CUTS cuts the other cells. The
# limit lies between the program's reading here (4.5e-3) and the TF32
# control's (2.3e-2)
CUT = {'inputs': {'batch': 48},
       'call': {'phase1_iters': 20, 'tail_bucket': 16},
       'check': {'lanes': 48, 'longest': 4},
       'trace': {'start_s': 0.0, 'span_s': 0.2},
       'limits': {'x_gap_p90': 0.012}}


def copy(dst: str) -> str:
    root = sgpbench_tiny.copy(dst)
    path = os.path.join(root, 'sgpbench', 'workloads', CELL + '.json')
    with open(path) as f:
        doc = json.load(f)
    for key, val in CUT.items():
        doc[key].update(val)
    with open(path, 'w') as f:
        json.dump(doc, f)
    return root


def test_the_beta_cell_runs_correct_with_its_per_layer_values(tmp_path):
    root = copy(str(tmp_path))
    for trace in (0, 1):
        out = sgpbench_tiny.run(root, CELL, seed=2 ** 34 + 11, trace=trace)
        assert out['correct'], out['compared']
        assert out['compared']['flux_gap_max']['value'] < 1e-4
        if not trace:
            assert set(out['metrics']) == {'stamps_per_s', 'setup_s'}
            continue
        got = {k: v['value'] for k, v in out['metrics'].items()}
        assert set(got) == {'beta_objective_host_pct.beta',
                            'beta_gradient_host_pct.beta',
                            'beta_rows_per_stamp.beta'}
        assert 0 < got['beta_objective_host_pct.beta'] < 100
        assert 0 < got['beta_gradient_host_pct.beta'] < 100
        # at least set-up's pass and one trial an iteration of phase 1
        assert got['beta_rows_per_stamp.beta'] >= 1 + 20


def test_the_beta_cells_control_is_not_correct(tmp_path):
    root = copy(str(tmp_path))
    with open(os.path.join(root, 'sgpbench', 'configs',
                           'm13_stamps_beta_section.json')) as f:
        control = json.load(f)['control']
    out = sgpbench_tiny.run(root, CELL, seed=2 ** 34 + 11, control=control)
    assert not out['correct']
    gap = out['compared']['x_gap_p90']
    assert gap['value'] > gap['limit']


def test_the_parent_programs_readers_return_nothing():
    """A program without the beta spans and counter (a recording that
    holds none) leaves the three values out and raises nothing."""
    from tpu_sgp_torch import observability as obs
    mod = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    rec = {'profile': {'window_s': 1.0, 'calls': 2}, 'calls': 2,
           'attempted': 96}
    with obs.tracing():
        with obs.span('entry'):
            pass
    for name in ('beta_objective_host_pct.beta',
                 'beta_gradient_host_pct.beta', 'beta_rows_per_stamp.beta'):
        assert mod.reader(name)(rec) is None
