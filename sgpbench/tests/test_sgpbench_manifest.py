"""BENCHMARK.json against the rules its readers rely on, and every name it
holds against the files that serve it."""
import json
import os
import re

import pytest

from sgpbench_tiny import BENCH, REPO, load_run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\t\n]{1,200}$')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')


@pytest.fixture(scope='module')
def manifest():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {'command', 'paths', 'run_seconds', 'configs',
                             'workloads', 'end_to_end', 'per_layer'}
    assert manifest['paths'] == ['sgpbench']
    assert 1 <= manifest['run_seconds'] <= 51
    assert isinstance(manifest['run_seconds'], int)
    assert all(TEXT.match(w) for w in manifest['command'])
    assert os.path.exists(os.path.join(REPO, manifest['command'][1]))


@pytest.mark.parametrize('section', ['configs', 'workloads', 'end_to_end',
                                     'per_layer'])
def test_names_and_units(manifest, section):
    names = [e['name'] for e in manifest[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in manifest[section]:
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
            assert e['source'] in SOURCES
        for key in ('why', 'layer', 'source'):
            if key in e:
                assert TEXT.match(e[key]), (e['name'], key)


def test_bad_names_are_caught():
    assert not NAME.match('has space')
    assert not NAME.match('a,b')
    assert not NAME.match('a/b')
    assert not NAME.match('µs')
    assert not UNIT.match('tokens per second')
    assert UNIT.match('stamps/s') and UNIT.match('%')


def test_configs_and_cells_match_their_files(manifest):
    used = {w['config'] for w in manifest['workloads']}
    assert used == {c['name'] for c in manifest['configs']}
    for c in manifest['configs']:
        with open(os.path.join(REPO, c['file'])) as f:
            doc = json.load(f)
        assert c['file'].startswith('sgpbench/configs/')
        assert set(c['reduced']) == set(doc['reduced'])
        assert not any(k.endswith(('_dim', '_rank')) for k in c['reduced'])
    for w in manifest['workloads']:
        with open(os.path.join(BENCH, 'workloads', w['name'] + '.json')) as f:
            doc = json.load(f)
        assert (doc['config'], doc['traffic'], doc['chips'], doc['why']) == (
            w['config'], w['traffic'], w['chips'], w['why'])
        assert w['chips'] == 1
        assert os.path.exists(os.path.join(BENCH, 'traffic',
                                           doc['kind'] + '.py'))


def test_bounds(manifest):
    for m in manifest['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert any(m['name'] == 'setup_s' and 'workloads' not in m
               for m in manifest['end_to_end'])


def test_every_cell_reports_what_it_must(manifest):
    """setup_s, one more end-to-end metric and one per-layer metric a cell;
    every per-layer metric's ``moves`` reported in each of its cells; every
    metric has a reader."""
    run = load_run(REPO)
    e2e = {m['name'] for m in manifest['end_to_end']}
    for w in manifest['workloads']:
        cell = w['name']
        ends = {m['name'] for m in run.cell_metrics(manifest, cell, False)}
        layers = run.cell_metrics(manifest, cell, True)
        assert 'setup_s' in ends and len(ends) >= 2, cell
        assert layers, cell
        for m in layers:
            assert m['moves'] in e2e
            assert m['moves'] in ends, (cell, m['name'])
    for m in manifest['end_to_end'] + manifest['per_layer']:
        assert callable(run.reader(m['name']))
    layer = {}
    for m in manifest['per_layer']:
        layer.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layer.values())


def test_size(manifest):
    assert os.path.getsize(os.path.join(REPO, 'BENCHMARK.json')) < 64 * 1024
