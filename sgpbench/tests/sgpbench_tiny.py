"""Tiny copies of the benchmark's cells for the CPU tests: the whole
``sgpbench`` folder and ``BENCHMARK.json`` copied into a temporary
directory, the copies' sizes cut so that a run takes seconds on the CPU,
and the copy's ``run.py`` loaded as a module."""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

# what each cell's copy cuts: {file: {key: value or {nested key: value}}}.
# The limits are the tiny sizes' own, between the program's readings on the
# CPU (stamps up to 2.1e-3, frames 1.4e-2) and the controls' (stamps from
# 1.6e-2, frames from 0.81).
CUTS = {
    'workloads/stamps_k1.batch12288.json': {
        'inputs': {'batch': 48},
        'call': {'phase1_iters': 20, 'tail_bucket': 16},
        'check': {'lanes': 48, 'longest': 4},
        'trace': {'start_s': 0.0, 'span_s': 0.2},
        'limits': {'x_gap_p90': 0.005}},
    'workloads/stamps_k1.serve.json': {
        'inputs': {'pool': 256},
        'arrivals': {'rate_per_s': 6.0},
        'sizes': {'max': 16},
        'server': {'warm_max_batch': 32, 'max_batch': 32},
        'trace': {'start_s': 0.0, 'span_s': 0.2},
        'limits': {'x_gap_p90': 0.005}},
    'workloads/frame410_kl.single.json': {
        'inputs': {'calls': 2},
        'trace': {'start_s': 0.0, 'span_s': 0.2},
        'limits': {'x_gap_p90': 0.1}},
    'workloads/frame410_kl.tiles25.json': {
        'inputs': {'lanes': 3},
        'check': {'lanes': 3},
        'trace': {'start_s': 0.0, 'span_s': 0.2},
        'limits': {'x_gap_p90': 0.1}},
    'configs/m13_subframe410_kl.json': {
        'height': 64, 'width': 64, 'n_stars': 8},
}


def copy(dst: str) -> str:
    """The benchmark copied to ``dst`` with the cuts above; returns the
    copy's root."""
    shutil.copytree(BENCH, os.path.join(dst, 'sgpbench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), dst)
    for rel, cut in CUTS.items():
        path = os.path.join(dst, 'sgpbench', rel)
        with open(path) as f:
            doc = json.load(f)
        for key, val in cut.items():
            if isinstance(val, dict):
                doc[key].update(val)
            else:
                doc[key] = val
        with open(path, 'w') as f:
            json.dump(doc, f)
    return dst


def load_run(root: str):
    """The copy's ``run.py`` as a module, the program importable."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    # the run imports the copy's own check.py, which finds the references
    # beside it, and not one that a run of another copy left imported
    sys.modules.pop('check', None)
    spec = importlib.util.spec_from_file_location(
        'sgpbench_run_copy', os.path.join(root, 'sgpbench', 'run.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str, cell: str, seed: int = 2 ** 33 + 3, seconds: float = 1.0,
        trace: int = 0, control=None, device: str = 'cpu') -> dict:
    """One run of a copied cell (on the CPU unless ``device`` says
    otherwise); the result's dict."""
    import torch
    torch.set_num_threads(2)
    mod = load_run(root)
    args = mod.parse(['--workload', cell, '--seed', str(seed), '--seconds',
                      str(seconds), '--trace', str(trace)])
    return mod.run_cell(args, device=device, control=control)
