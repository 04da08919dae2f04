"""The port's example scripts (``examples_torch/``) as command lines on
the CPU: the determinism check at a 96x96 frame, the compaction scan at
B=64 on two grid points and the recycling soak for a few seconds with a
batch limit, each in a process of its own with ``--device cpu``, their
verdicts and exit codes asserted; and every script raising without a card
when it is not given ``--device cpu``.

The processes run torch on one thread (several test workers share a few
cores) and flush float32 subnormals (``tests/_flush_subnormals``).
"""
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ('deconvolve_demo', 'serving_demo', 'build_allsky_map',
           'time_halo_operator', 'scan_compaction', 'determinism_check',
           'serving_recycle_soak', 'distributed_demo')


def cli(name: str, *args: str, timeout: float = 240.0):
    """Run ``examples_torch/<name>.py args --device cpu``; its exit code
    and standard output."""
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, 'tests', '_flush_subnormals'),
         os.environ.get('PYTHONPATH', '')]))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'examples_torch', f'{name}.py'),
         *args, '--device', 'cpu'], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=REPO)
    return r.returncode, r.stdout + r.stderr[-3000:]


def test_determinism_check_verdict():
    """Six fresh processes (both arms, three perturbations) on a 96x96
    frame: the stable arm agrees, exit 0; the control's line is either of
    its two verdicts."""
    rc, out = cli('determinism_check', '--size', '96')
    assert rc == 0, out
    runs = re.findall(r'stable=(True|False) perturb=(\S+): DETERMINISM '
                      r'stable=\1 iters=(\d+)', out)
    assert len(runs) == 6, out
    assert len({it for s, _, it in runs if s == 'True'}) == 1, out
    assert re.search(r'^(NEGATIVE CONTROL INCONCLUSIVE|negative control OK)',
                     out, re.M), out
    assert re.search(r'^OK: stable_sums=True iteration counts agree', out,
                     re.M), out


def test_scan_compaction_lines():
    """B=64, two grid points, one repeat: one line a point, each with its
    stamps/s, wall and unconverged lanes; exit 0."""
    rc, out = cli('scan_compaction', 'kl', '1', '--stamps', '64',
                  '--grid', '20:16,26:32')
    assert rc == 0, out
    points = re.findall(r'^kl p1=(\d+) tail=(\d+): ([\d,]+) stamps/s \(wall '
                        r'([\d.]+) ms, unconverged@p1=(\d+)\)$', out, re.M)
    assert [(p1, tail) for p1, tail, *_ in points] == [('20', '16'),
                                                       ('26', '32')], out
    for *_, rate, wall, unconv in points:
        assert float(wall) > 0 and 0 <= int(unconv) <= 64
    # fewer lanes run past the later phase-1 cut
    assert int(points[1][4]) <= int(points[0][4])


def test_serving_recycle_soak_verdict():
    """One worker process (the soak's deadline passes during it) with a
    limit of one device call: the watchdog recycles it, every submitted
    request completes, SOAK OK and exit 0."""
    rc, out = cli('serving_recycle_soak', '0.01', '250', '1')
    assert rc == 0, out
    cycle = re.search(r'^cycle 1: (\d+)/(\d+) requests, (\d+) device calls, '
                      r'recycled=True, rss ([\d.]+) -> ([\d.]+) MB', out,
                      re.M)
    assert cycle, out
    done, submitted, calls = (int(v) for v in cycle.groups()[:3])
    assert done == submitted > 0 and calls >= 1
    assert re.search(r'^SOAK OK: 1 process cycles, 1 watchdog recycles, '
                     rf'{done}/{done} requests completed \(zero loss=True\)$',
                     out, re.M), out


@pytest.mark.parametrize('name', SCRIPTS)
def test_script_raises_without_a_card(name, monkeypatch, tmp_path):
    """Without ``--device cpu`` a script computes on the card, and without
    a card it raises (``device.resolve_device``): no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the script would run on it')
    spec = importlib.util.spec_from_file_location(
        f'examples_torch_{name}',
        os.path.join(REPO, 'examples_torch', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA device is available'):
        mod.main([])
