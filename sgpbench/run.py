"""Run one cell of the benchmark of ``tpu_sgp_torch`` and print its result.

    python3 sgpbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell is ``sgpbench/workloads/<cell>.json``;
it names its configuration (``sgpbench/configs/<config>.json``) and its
traffic kind (``sgpbench/traffic/<kind>.py``), which makes the inputs from
the seed, warms the program up on the cell's own shapes and drives the
measured window. The metrics the cell reports are the entries of
``BENCHMARK.json`` that name it, each read by ``sgpbench/metrics/<name>.py``
(or by the reader of the name's part before its first dot). With
``--trace 0`` they are the end-to-end metrics, with ``--trace 1`` the
per-layer ones, from a profiled stretch of the window. After the window the
answers are compared with the plain reference (``sgpbench/check.py``). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each compared number beside its
limit (also the last lines of standard error).

Exits with code 2, printing no result, without a CUDA device, with fewer
devices than the cell asks for, without the program, or when JAX or the
JAX package was loaded.
"""
import time

_T0 = time.perf_counter()       # set-up is timed from here

import argparse                                   # noqa: E402
import importlib.util                             # noqa: E402
import json                                       # noqa: E402
import os                                         # noqa: E402
import sys                                        # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that no run may load, compared by whole top-level name: the port's
# own name begins with the JAX package's
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tpu_sgp')


class Refused(Exception):
    """A run that must print no result."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module, found by its path alone, so
    that a name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the file of
    the name's part before its first dot (``device_idle_pct.batch`` is
    read by ``metrics/device_idle_pct.py``)."""
    for stem in (metric, metric.split('.')[0]):
        path = os.path.join(HERE, 'metrics', stem + '.py')
        if os.path.exists(path):
            return load_module(path, 'sgpbench_metric_' +
                               stem.replace('.', '_')).read
    raise FileNotFoundError(f'no reader for the metric {metric!r} under '
                            f'{os.path.join(HERE, "metrics")}')


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics of ``manifest`` that ``cell`` reports: end-to-end ones
    without ``--trace``, per-layer ones with it. An entry with a
    ``workloads`` key names its cells; an end-to-end entry without one is
    every cell's, a per-layer entry without one every cell's that reports
    the end-to-end metric it moves."""
    e2e = [m for m in manifest['end_to_end']
           if cell in m.get('workloads', [cell])]
    if not trace:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in manifest['per_layer']
            if (cell in m['workloads'] if 'workloads' in m
                else m['moves'] in names)]


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    base = os.path.join(ROOT, '.sgpbench_cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(base, sub)


def program_in_checkout() -> bool:
    """Whether ``tpu_sgp_torch`` is the checkout's own copy."""
    spec = importlib.util.find_spec('tpu_sgp_torch')
    return spec is not None and spec.origin.startswith(ROOT + os.sep)


def forbidden_modules() -> list:
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a traffic kind gets: the cell, its configuration, the seed and
    the window's length, the device, and the clock of the set-up."""

    def __init__(self, cell, config, seed, seconds, trace, device):
        self.cell = cell
        self.config = config
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.setup_s = None
        self.setup_parts = {}
        self.device_clock = False
        self._mark = _T0

    def part(self, name: str) -> None:
        """Close one part of the set-up (import, inputs, warm-up)."""
        now = time.perf_counter()
        self.setup_parts[name] = now - self._mark
        self._mark = now

    def window_start(self) -> float:
        """The first timed call starts now: set-up ends here."""
        now = time.perf_counter()
        self.setup_s = now - _T0
        return now

    def rng(self, *key):
        """A NumPy generator drawn from the seed and ``key``."""
        import numpy as np
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed] + [int(k) for k in key]))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device: str = 'cuda', manifest_path=None,
             control=None) -> dict:
    """One run of a cell: the result as a dict. ``device='cpu'`` skips
    the look for a card (the tests drive a run so); ``control`` judges the
    reference computed in that lower precision in the program's place
    (``control.py``)."""
    manifest = load_json(manifest_path or os.path.join(ROOT,
                                                       'BENCHMARK.json'))
    path = os.path.join(HERE, 'workloads', args.workload + '.json')
    if not os.path.exists(path):
        raise Refused(f'no workload file {path}')
    cell = load_json(path)
    config = load_json(os.path.join(HERE, 'configs',
                                    cell['config'] + '.json'))
    metrics = cell_metrics(manifest, args.workload, bool(args.trace))
    readers = {m['name']: reader(m['name']) for m in metrics}

    import torch
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise Refused('torch.cuda.is_available() is False')
        if torch.cuda.device_count() < int(cell['chips']):
            raise Refused(f'{torch.cuda.device_count()} CUDA devices, the '
                          f'cell asks for {cell["chips"]}')
        torch.cuda.set_device(0)
        torch.cuda.init()
    # the program refuses TF32 in the operator it runs in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import tpu_sgp_torch  # noqa: F401
    except ImportError as exc:
        raise Refused(f'the program tpu_sgp_torch cannot be imported: '
                      f'{exc}') from None

    sys.path.insert(0, HERE)
    import check
    kind = load_module(os.path.join(HERE, 'traffic', cell['kind'] + '.py'),
                       'sgpbench_traffic_' + cell['kind'])
    run = Run(cell, config, args.seed, args.seconds, bool(args.trace),
              device)
    # an end-to-end metric from the device's trace: the window's every call
    # is profiled for the device's busy time (``profiling.DeviceClock``)
    run.device_clock = not args.trace and any(
        m['source'] == 'device_trace' for m in metrics)
    run.part('import')
    rec = kind.run(run)
    rec['setup_s'] = run.setup_s
    rec['setup_parts'] = run.setup_parts

    dev = {'platform': 'gpu' if device == 'cuda' else 'cpu',
           'kind': (torch.cuda.get_device_name(0) if device == 'cuda'
                    else 'cpu'),
           'count': int(cell['chips']),
           'memory_peak_bytes': (int(torch.cuda.max_memory_allocated())
                                 if device == 'cuda' else 0)}
    if args.trace:
        prof = rec.get('profile') or {}
        dev['busy_s'] = prof.get('busy_s', 0.0)
        dev['window_s'] = prof.get('window_s', 0.0)

    answers = rec.pop('answers')
    if device == 'cuda':
        torch.cuda.empty_cache()
    compared = check.compare(cell, config, answers, device, control)
    del answers

    values = {}
    for m in metrics:
        v = readers[m['name']](rec)
        if v is not None:
            values[m['name']] = {'value': float(v), 'unit': m['unit']}
    out = {'correct': all(c['value'] <= c['limit'] for c in
                          compared.values()),
           'attempted': int(rec['attempted']),
           'failed': int(rec['failed']),
           'metrics': values,
           'device': dev}
    if args.trace:
        out['breakdown'] = (rec.get('profile') or {}).get(
            'breakdown', {'device_ops': [], 'idle_gaps': []})
    out['setup_parts_s'] = rec['setup_parts']
    out['compared'] = compared
    found = forbidden_modules()
    if found:
        raise Refused(f'modules loaded that no run may load: {found}')
    return out


def main(argv=None) -> int:
    cache_dirs()
    sys.path.insert(0, ROOT)
    args = parse(argv)
    try:
        if not program_in_checkout():
            raise Refused(f'the program tpu_sgp_torch is not in the '
                          f'checkout {ROOT}')
        out = run_cell(args)
    except Refused as exc:
        print(f'sgpbench: {exc}', file=sys.stderr)
        return 2
    for name, c in out['compared'].items():
        print(f'{name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
