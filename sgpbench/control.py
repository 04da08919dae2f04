"""The control of a cell's correctness check, and the program's readings
beside it, on several seeds in one process.

    python3 sgpbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 4

For each seed, one short run of the cell as ``run.py`` makes it, judged
twice: with the program's answers (the lower readings of ``x_gap_p90``),
and with the plain reference computed in the precision just below the
configuration's (its ``control``: TF32 products where the configuration
runs float32 with TF32 off, bfloat16 where it runs other float32) in the
program's place, which the check has to find not correct (the upper
readings). Prints one JSON line a seed and judgement. The benchmark's own
runs never run this.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=4.0)
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    bench.cache_dirs()
    cell = bench.load_json(os.path.join(HERE, 'workloads',
                                        a.workload + '.json'))
    control = bench.load_json(os.path.join(
        HERE, 'configs', cell['config'] + '.json'))['control']
    for seed in a.seeds.split(','):
        args = bench.parse(['--workload', a.workload, '--seed', seed,
                            '--seconds', str(a.seconds)])
        for judged in (None, control):
            out = bench.run_cell(args, device=a.device, control=judged)
            print(json.dumps({'workload': a.workload, 'seed': int(seed),
                              'judged': judged or 'program',
                              'correct': out['correct'],
                              'compared': out['compared']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
