"""A configuration, a workload and a per-layer metric added as new files
become a cell, with no file of the benchmark edited; and no run loads
JAX or the JAX package."""
import hashlib
import json
import os
import subprocess
import sys

import sgpbench_tiny


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
    cfg.update(height=40, width=56, n_stars=5, tol_convergence=1e-4)
    with open(os.path.join(bench, 'configs', 'small_field.json'), 'w') as f:
        json.dump(cfg, f)
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
    after = digest(root)
    assert {p: h for p, h in after.items() if p in before} == before


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
