"""A configuration, its reference, a workload and a per-layer metric added
as new files become a cell, with no file of the benchmark edited; a
configuration names its reference and the entry's deployment arguments;
and no run loads JAX or the JAX package."""
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

import sgpbench_tiny

# a reference that reads beta0 and lr0 (TAKES), checks it got them and
# records its calls: the KL reference otherwise, which is right since
# KL-SGP ignores beta
TAKES_BETA = """

TAKES = ('max_iter', 'tol_convergence', 'beta0', 'lr0')
_solve_kl = solve


def solve(gn, psf, bkg, settings, **kw):
    if (settings['beta0'], settings['lr0']) != (1.005, 0.001):
        raise ValueError(f'beta0 and lr0 did not come through: {settings}')
    with open(__file__ + '.calls', 'a') as f:
        f.write('solve\\n')
    return _solve_kl(gn, psf, bkg, settings, **kw)
"""


def digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            if '__pycache__' in base:
                continue
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_make_a_cell(tmp_path):
    root = sgpbench_tiny.copy(str(tmp_path))
    before = digest(root)
    bench = os.path.join(root, 'sgpbench')
    with open(os.path.join(bench, 'configs', 'm13_subframe410_kl.json')) as f:
        cfg = json.load(f)
    cfg.update(height=40, width=56, n_stars=5, tol_convergence=1e-4,
               reference='field_plain', beta0=1.005, lr0=0.001)
    with open(os.path.join(bench, 'configs', 'small_field.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, 'reference', 'sgp_plain.py')) as f:
        plain = f.read()
    with open(os.path.join(bench, 'reference', 'field_plain.py'), 'w') as f:
        f.write(plain + TAKES_BETA)
    cell = {'config': 'small_field', 'traffic': 'pairs', 'kind': 'closed_loop',
            'chips': 1, 'why': 'two small fields a call',
            'entry': 'restore_stamps',
            'inputs': {'kind': 'fields', 'lanes': 2, 'calls': 1,
                       'family_seed': 5},
            'check': {'calls': 1, 'lanes': 2, 'longest': 1},
            'trace': {'start_s': 0.0, 'span_s': 0.1},
            'limits': {'x_gap_p90': 0.2}}
    with open(os.path.join(bench, 'workloads', 'small.pairs.json'), 'w') as f:
        json.dump(cell, f)
    with open(os.path.join(bench, 'metrics', 'lanes_a_call.py'), 'w') as f:
        f.write('def read(rec):\n'
                '    return rec["frames_done"] / rec["calls"]\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    manifest['workloads'].append({k: cell[k] for k in (
        'config', 'traffic', 'chips', 'why')} | {'name': 'small.pairs'})
    next(m for m in manifest['end_to_end']
         if m['name'] == 'frame_solve_s')['workloads'].append('small.pairs')
    manifest['per_layer'].append({
        'name': 'lanes_a_call.pairs', 'unit': 'lanes', 'better': 'higher',
        'source': 'program_counter', 'layer': 'Entry', 'moves':
        'frame_solve_s', 'workloads': ['small.pairs']})
    new_manifest = os.path.join(root, 'BENCHMARK.new.json')
    with open(new_manifest, 'w') as f:
        json.dump(manifest, f)

    mod = sgpbench_tiny.load_run(root)
    for trace in (0, 1):
        args = mod.parse(['--workload', 'small.pairs', '--seed', '4',
                          '--seconds', '0.5', '--trace', str(trace)])
        out = mod.run_cell(args, device='cpu', manifest_path=new_manifest)
        assert out['correct'], out['compared']
        if trace:
            assert out['metrics']['lanes_a_call.pairs']['value'] == 2.0
        else:
            assert set(out['metrics']) == {'frame_solve_s', 'setup_s'}
    assert os.path.exists(os.path.join(bench, 'reference',
                                       'field_plain.py.calls'))
    after = digest(root)
    assert {p: h for p, h in after.items() if p in before} == before


def add_file(root, kind, base, name, **keys):
    """``<kind>/<name>.json``: a copy of ``<kind>/<base>.json`` with
    ``keys`` set."""
    with open(os.path.join(root, 'sgpbench', kind, base + '.json')) as f:
        doc = json.load(f)
    doc.update(keys)
    with open(os.path.join(root, 'sgpbench', kind, name + '.json'),
              'w') as f:
        json.dump(doc, f)


def test_a_configuration_names_its_reference(tmp_path):
    root = sgpbench_tiny.copy(str(tmp_path))
    ref = os.path.join(root, 'sgpbench', 'reference')
    with open(os.path.join(ref, 'sgp_plain.py')) as f:
        plain = f.read()
    body = '    for key, val in KNOWN.items():\n'
    assert plain.count(body) == 1
    mark = ("    with open(__file__ + '.calls', 'a') as f: "
            "f.write('solve\\n')\n")
    with open(os.path.join(ref, 'sgp_plain_twin.py'), 'w') as f:
        f.write(plain.replace(body, mark + body))
    add_file(root, 'configs', 'm13_stamps_kl_k1', 'stamps_twin',
             reference='sgp_plain_twin')
    add_file(root, 'workloads', 'stamps_k1.batch12288', 'twin.batch',
             config='stamps_twin')
    out = sgpbench_tiny.run(root, 'stamps_k1.batch12288', seed=2 ** 35 + 7)
    calls = os.path.join(ref, 'sgp_plain_twin.py.calls')
    assert not os.path.exists(calls)
    twin = sgpbench_tiny.run(root, 'twin.batch', seed=2 ** 35 + 7)
    with open(calls) as f:
        assert f.read().count('solve') >= 1
    assert out['correct'], out['compared']
    assert twin['compared'] == out['compared']


def test_an_unknown_reference_names_the_path_it_looked_for(tmp_path):
    root = sgpbench_tiny.copy(str(tmp_path))
    add_file(root, 'configs', 'm13_stamps_kl_k1', 'stamps_nowhere',
             reference='no_such_reference')
    add_file(root, 'workloads', 'stamps_k1.batch12288', 'nowhere.batch',
             config='stamps_nowhere')
    path = os.path.join(root, 'sgpbench', 'reference',
                        'no_such_reference.py')
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        sgpbench_tiny.run(root, 'nowhere.batch', seconds=0.3)


class Called(Exception):
    """Raised by a stand-in entry once it has its keywords."""


def test_the_configuration_gives_beta0_and_lr0_to_the_entry(tmp_path,
                                                           monkeypatch):
    import tpu_sgp_torch.parallel.batch as batch
    import tpu_sgp_torch.parallel.session as session
    seen = {}

    def recorder(name):
        def entry(*args, **kw):
            seen[name] = kw
            raise Called(name)
        return entry
    monkeypatch.setattr(batch, 'restore_stamps', recorder('restore_stamps'))
    monkeypatch.setattr(session, 'RestorationSession',
                        recorder('RestorationSession'))
    root = sgpbench_tiny.copy(str(tmp_path))
    add_file(root, 'configs', 'm13_stamps_kl_k1', 'stamps_beta_args',
             beta0=1.005, lr0=0.001)
    add_file(root, 'configs', 'm13_subframe410_kl', 'frame_beta_args',
             beta0=1.005)
    for base, name, config in (
            ('stamps_k1.batch12288', 'args.batch', 'stamps_beta_args'),
            ('stamps_k1.serve', 'args.serve', 'stamps_beta_args'),
            ('frame410_kl.single', 'args.single', 'frame_beta_args')):
        add_file(root, 'workloads', base, name, config=config)
    today = {'restore_stamps': {'fluxes', 'sat_level', 'device', 'flatten',
                                'phase1_iters', 'tail_bucket'},
             'RestorationSession': {'stamp_shape', 'sat_level', 'device'}}
    for cell, entry, beta in (
            ('stamps_k1.batch12288', 'restore_stamps', False),
            ('stamps_k1.serve', 'RestorationSession', False),
            ('args.batch', 'restore_stamps', True),
            ('args.serve', 'RestorationSession', True)):
        seen.clear()
        with pytest.raises(Called):
            sgpbench_tiny.run(root, cell, seconds=0.3)
        kw = seen[entry]
        if beta:
            assert (kw['beta0'], kw['lr0']) == (1.005, 0.001)
            assert set(kw) == today[entry] | {'beta0', 'lr0'}
        else:
            assert set(kw) == today[entry], cell
    # the facade takes no beta0: a configuration that gives one is refused
    with pytest.raises(ValueError, match='beta0'):
        sgpbench_tiny.run(root, 'args.single', seconds=0.3)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    mod = sgpbench_tiny.load_run(sgpbench_tiny.REPO)
    for name in ('jax', 'jaxlib', 'flax', 'tpu_sgp'):
        monkeypatch.setitem(sys.modules, name + '.fake', object())
    monkeypatch.delitem(sys.modules, 'jax', raising=False)
    assert mod.forbidden_modules() == ['flax', 'jax', 'jaxlib', 'tpu_sgp']
    for name in ('jax', 'jaxlib', 'flax', 'tpu_sgp'):
        monkeypatch.delitem(sys.modules, name + '.fake')
    monkeypatch.setitem(sys.modules, 'tpu_sgp_torch.fake', object())
    monkeypatch.setitem(sys.modules, 'jaxtyping', object())
    if not any(n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpu_sgp')
               for n in sys.modules):
        assert mod.forbidden_modules() == []


CHILD = '''
import json, sys
sys.path.insert(0, {tests!r})
import sgpbench_tiny
out = sgpbench_tiny.run({root!r}, {cell!r}, seconds=0.5)
ref = {ref!r}
sys.path.insert(0, ref)
import reference.sgp_plain
tops = sorted({{n.split('.')[0] for n in sys.modules}})
print(json.dumps({{'correct': out['correct'], 'compared': out['compared'], 'tops': tops}}))
'''


def test_a_run_loads_no_jax(tmp_path):
    root = sgpbench_tiny.copy(str(tmp_path))
    code = CHILD.format(tests=sgpbench_tiny.HERE, root=root,
                        cell='stamps_k1.batch12288',
                        ref=os.path.join(root, 'sgpbench'))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['correct'], out['compared']
    assert not set(out['tops']) & {'jax', 'jaxlib', 'flax', 'tpu_sgp'}
    assert 'tpu_sgp_torch' in out['tops']


def test_the_command_refuses_without_the_program(tmp_path):
    root = sgpbench_tiny.copy(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, 'sgpbench/run.py', '--workload',
         'frame410_kl.single', '--seed', '1', '--seconds', '1', '--trace',
         '0'], capture_output=True, text=True, timeout=300, cwd=root,
        env={k: v for k, v in os.environ.items() if k != 'PYTHONPATH'})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
