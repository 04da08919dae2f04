"""The per-layer metrics that read the program's spans
(``metrics/loop_trips_per_call.py``, ``host_syncs_per_trip.py``,
``sync_wait_pct.py``, ``projection_host_pct.py``, ``linesearch_host_pct.py``,
``entry_host_pct.py``): a tiny traced run of a stamp cell and of a frame
cell reports each as a number, the shares lie in [0, 100] and the three
disjoint ones add up to at most 100; with no recording or no profile a
reader gives nothing."""
import json
import os

import pytest

import sgpbench_tiny

STEMS = ('loop_trips_per_call', 'host_syncs_per_trip', 'sync_wait_pct',
         'projection_host_pct', 'linesearch_host_pct', 'entry_host_pct')
DISJOINT = ('sync_wait_pct', 'linesearch_host_pct', 'entry_host_pct')


def span_metrics(kind: str) -> list:
    with open(os.path.join(sgpbench_tiny.REPO, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    return [m['name'] for m in manifest['per_layer']
            if m['name'].split('.')[0] in STEMS
            and m['name'].endswith('.' + kind)]


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    root = sgpbench_tiny.copy(str(tmp_path_factory.mktemp('spans')))
    return {kind: sgpbench_tiny.run(root, cell, seconds=0.6, trace=1)
            for kind, cell in (('batch', 'stamps_k1.batch12288'),
                               ('frame', 'frame410_kl.single'))}


def test_the_manifest_names_each_reader_once_a_cell():
    assert len(span_metrics('batch')) == 6
    assert len(span_metrics('frame')) == 5
    assert 'loop_trips_per_call.frame' not in span_metrics('frame')


@pytest.mark.parametrize('kind', ['batch', 'frame'])
def test_a_traced_run_reports_every_span_metric(traced, kind):
    out = traced[kind]
    assert out['correct'], out['compared']
    values = {k: v['value'] for k, v in out['metrics'].items()}
    for name in span_metrics(kind):
        assert name in values, name
        if name.split('.')[0].endswith('_pct'):
            assert 0.0 <= values[name] <= 100.0, (name, values[name])
        else:
            assert values[name] > 0, (name, values[name])
    # a trip tests the loop's flag and, at least once, the line search's
    assert values[f'host_syncs_per_trip.{kind}'] >= 2.0
    assert sum(values[f'{stem}.{kind}'] for stem in DISJOINT) <= 100.0
    if kind == 'batch':
        # phase 1, two tails and the finishing pass: at least each's
        # first trip
        assert values['loop_trips_per_call.batch'] >= 4
    else:
        assert 'loop_trips_per_call.frame' not in values


def test_readers_give_nothing_without_a_recording_or_a_profile(
        monkeypatch, traced):
    from tpu_sgp_torch import observability
    run = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    rec = {'profile': {'window_s': 1.0, 'calls': 2, 'iters': 50,
                       'busy_s': 0.5, 'kernels': 10}}
    assert observability.last_trace() is not None
    for stem in STEMS:
        assert run.reader(stem)({'profile': None}) is None, stem
    monkeypatch.setattr(observability, '_current', None)
    for stem in STEMS:
        assert run.reader(stem)(rec) is None, stem
    # a program without the tracer (the parent of this benchmark's spans)
    monkeypatch.delattr(observability, 'last_trace')
    for stem in STEMS:
        assert run.reader(stem)(rec) is None, stem
