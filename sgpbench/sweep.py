"""Find the knee of a serving cell: the highest offered rate that the
program sustains without a growing backlog.

    python3 sgpbench/sweep.py --workload stamps_kl.serve --seed 5 \
        --seconds 15 --rates 20,30,40,50

One process builds and warms the cell's serving stack once, then offers a
window of the cell's traffic at each rate in turn and prints one JSON line
a rate: the requests offered and answered, the latencies' median and 95th
percentile, the backlog at the window's close (requests not yet answered),
the median latency of the window's last third over its first (above 1 the
queue grew), and the stamps answered a second. The cell's own rate is set
once from this, at about four fifths of the knee; the benchmark's runs do
not sweep.
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--rates', required=True)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    bench.cache_dirs()
    cell = bench.load_json(os.path.join(HERE, 'workloads',
                                        a.workload + '.json'))
    config = bench.load_json(os.path.join(HERE, 'configs',
                                          cell['config'] + '.json'))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = bench.load_module(os.path.join(HERE, 'traffic',
                                          cell['kind'] + '.py'),
                             'sgpbench_traffic_' + cell['kind'])
    run = bench.Run(cell, config, a.seed, a.seconds, False, a.device)
    svc = kind.Service(run)
    try:
        for k, rate in enumerate(float(r) for r in a.rates.split(',')):
            before = svc.server.batches_served
            w = svc.window(a.seconds, run.rng(10, k), rate=rate)
            lat = w['latency_s'] * 1e3
            third = len(lat) // 3
            print(json.dumps({
                'rate_per_s': rate, 'offered': len(lat),
                'answered': int(w['ok'].sum()),
                'p50_ms': float(np.percentile(lat, 50)),
                'p95_ms': float(np.percentile(lat, 95)),
                'backlog_at_close': int(w['backlog']),
                'growth': float(np.median(lat[-third:])
                                / np.median(lat[:third])),
                'late_ms': float(w['late_s'] * 1e3),
                'stamps_per_s': float(w['sizes'][w['ok']].sum()
                                      / a.seconds),
                'device_calls': svc.server.batches_served - before}),
                flush=True)
    finally:
        svc.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
