"""Whole runs of tiny copies of the cells on the CPU: sound, the program
broken underneath in each way a cell can be, and the control in the
program's place. The serving and tiles cells are kept as workload files
outside BENCHMARK.json (PERF.md), and their kinds are tested here too. The look for a card is skipped; the rest of a run is
driven as the benchmark's command drives it."""
import numpy as np
import pytest
import torch

import sgpbench_tiny

CELLS = ('stamps_k1.batch12288', 'stamps_k1.serve', 'frame410_kl.single',
         'frame410_kl.tiles25')
CONTROL = {'stamps_k1.batch12288': 'tf32', 'stamps_k1.serve': 'tf32',
           'frame410_kl.single': 'bf16', 'frame410_kl.tiles25': 'bf16'}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return sgpbench_tiny.copy(str(tmp_path_factory.mktemp('bench')))


def unchanged(monkeypatch):
    """Every solver step returns the state it was given: the loop stops
    after its first trip with the starting point."""
    import tpu_sgp_torch.solvers.sgp as sgp
    real = sgp._solve_impl

    def stuck(*args, **kw):
        args = list(args)
        args[9] = args[9].replace(max_iter=1)
        return real(*args, **kw)
    monkeypatch.setattr(sgp, '_solve_impl', stuck)


def _wrap_restore(monkeypatch, alter):
    import tpu_sgp_torch.parallel.batch as batch
    import tpu_sgp_torch.parallel.session as session
    real = batch.restore_stamps

    def broken(stamps, *args, **kw):
        res = real(stamps, *args, **kw)
        return res._replace(x=alter(res.x, stamps))
    monkeypatch.setattr(batch, 'restore_stamps', broken)
    monkeypatch.setattr(session, 'restore_stamps', broken)


def half(monkeypatch):
    """The second half of a batch is never solved: its answers are the
    observed stamps as they came."""
    def alter(x, stamps):
        x = x.clone()
        h = x.shape[0] // 2
        x[h:] = torch.as_tensor(np.asarray(stamps), dtype=x.dtype,
                                device=x.device)[h:].reshape(x[h:].shape)
        return x
    _wrap_restore(monkeypatch, alter)


def altered(monkeypatch):
    """One answer of each call scaled by 1 %, where it is produced."""
    import tpu_sgp_torch

    def alter(x, stamps):
        x = x.clone()
        x[0] *= 1.01
        return x
    _wrap_restore(monkeypatch, alter)
    real = tpu_sgp_torch.sgp

    def sgp(*args, **kw):
        out = list(real(*args, **kw))
        out[0] = out[0] * 1.01
        return tuple(out)
    monkeypatch.setattr(tpu_sgp_torch, 'sgp', sgp)


FAULTS = [(c, f) for c in CELLS for f in (unchanged, half, altered)
          if not (c == 'frame410_kl.single' and f is half)]


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(root, cell):
    out = sgpbench_tiny.run(root, cell)
    assert out['correct'], out['compared']
    assert out['failed'] == 0 and out['attempted'] > 0
    assert set(out['metrics']) >= {'setup_s'}
    assert list(out)[-1] == 'compared'


@pytest.mark.parametrize('cell,fault', FAULTS,
                         ids=[f'{c}-{f.__name__}' for c, f in FAULTS])
def test_broken_program_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = sgpbench_tiny.run(root, cell)
    assert not out['correct'], out['compared']


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(root, cell):
    out = sgpbench_tiny.run(root, cell, control=CONTROL[cell])
    assert not out['correct'], out['compared']
    assert out['compared']['x_gap_p90']['value'] > \
        out['compared']['x_gap_p90']['limit']


@pytest.mark.parametrize('cell', ['stamps_k1.batch12288',
                                  'frame410_kl.single'])
def test_traced_run_reports_per_layer_metrics(root, cell):
    out = sgpbench_tiny.run(root, cell, trace=1)
    assert out['correct']
    assert out['metrics'], out
    assert out['device']['window_s'] > 0
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
