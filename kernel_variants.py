#!/usr/bin/env python3
"""Time edited variants of the port's two kernels on one NVIDIA GPU.

    python3 kernel_variants.py

Each variant is a copy of ``tpu_sgp_torch/csrc/<kernel>.cu`` with one
design constant or launch rule changed, built side by side with the port's
nvcc flags into ``build/kernel_variants/``. Each is timed through the
port's own wrapper (CUDA events) at the main path's shapes on one set of
seeded operands, in the order listed and then in reverse. The variants
change speed, not arithmetic: each result must equal that of the kernel as
built, or the script fails (on K1's long row the variants sum in another
order, so x is held to 1e-5 of max|x| there). K1's long row, one 410x410
frame, is also timed on the one-block-a-row path beside the grid path. Prints the card, the ptxas line of the main
path's instantiation of every variant, and one line a timing. Exits
non-zero without a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

CSRC = Path(__file__).resolve().parent / 'tpu_sgp_torch' / 'csrc'
OUT = Path(__file__).resolve().parent / 'build' / 'kernel_variants'
# (kernel, variant) -> edits of the source, (old, new) each
VARIANTS = {
    ('stamp_solver', 'as built'): [],
    ('stamp_solver', 'bisection depth 2'): [
        ('constexpr int kDepth = 1;', 'constexpr int kDepth = 2;')],
    ('stamp_solver', 'bisection depth 3'): [
        ('constexpr int kDepth = 1;', 'constexpr int kDepth = 3;')],
    ('stamp_solver', 'no register cap (3 blocks an SM)'): [
        ('sizeof(T) == 4 && MAXT == 128 ? 4 : 1', '1')],
    ('stamp_solver', 'tap row length read at run time'): [
        ('if (threads <= 128 && lay.pitch == 32)', 'if (false)')],
    ('flux_projection', 'as built'): [],
    ('flux_projection', '8 rows a block'): [
        ('constexpr int kRowWarps = 4;', 'constexpr int kRowWarps = 8;')],
    ('flux_projection', 'long row: 8 pixels a thread'): [
        ('constexpr int kGridPer = 4;', 'constexpr int kGridPer = 8;')],
    ('flux_projection', 'long row: 2 pixels a thread'): [
        ('constexpr int kGridPer = 4;', 'constexpr int kGridPer = 2;')],
}
MAIN_INSTANCES = ('solve_stamps_kernel<f,128,',
                  'project_rows_warp_kernel<f,32>',
                  'project_rows_grid_kernel<f,')
LONG_ROW = cs.LONG_ROWS[0]


def build(key):
    """nvcc on the edited copy; returns the library and its main-path
    ptxas entries."""
    from tpu_sgp_torch.kernels import _build
    kernel, variant = key
    text = (CSRC / f'{kernel}.cu').read_text()
    for old, new in VARIANTS[key]:
        if old not in text:
            raise RuntimeError(f'{kernel} "{variant}": {old!r} not in source')
        text = text.replace(old, new)
    d = OUT / f'{list(VARIANTS).index(key)}-{kernel}'
    d.mkdir(parents=True, exist_ok=True)
    (d / f'{kernel}.cu').write_text(text)
    for header in CSRC.glob('*.cuh'):
        (d / header.name).write_text(header.read_text())
    lib = d / f'lib{kernel}.so'
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                           str(d / f'{kernel}.cu')], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {kernel} "{variant}":\n'
                           f'{proc.stdout}{proc.stderr}')
    report = cs.ptxas_summary(proc.stdout + proc.stderr)
    return lib, {k: v for k, v in report.items()
                 if k.startswith(MAIN_INSTANCES)}


def main() -> int:
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print('FAIL: torch.cuda.is_available() is False; this run needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels import _build, flux_projection, stamp_solver
    from tpu_sgp_torch.projection.flux_projection import section_steps
    print(cs.run(['nvidia-smi', '--query-gpu=name,power.limit',
                  '--format=csv,noheader']).splitlines()[0])

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    for (kernel, variant), (_, report) in built.items():
        print(f'{kernel} "{variant}": ptxas {report}')

    # the operands: K2 on the main path's stamps, K1 at the main path's
    # full and tail widths
    cfg = SGPConfig(**cs.BENCH_CFG)
    k2_args = stamp_rows(*cs.main_path_inputs(cs.MAIN_B), cs.SAT_LEVEL,
                         torch.float32, 'cuda')
    steps = section_steps(torch.float32)
    k1_args = {rows: cs.projection_case(torch, rows, cs.N_PIX, torch.float32,
                                        True, 'cuda', 99)
               for rows in (cs.MAIN_B, cs.COMPACTION['tail_bucket'])}
    long_args = cs.projection_case(torch, *LONG_ROW, torch.float32, False,
                                   'cuda', 399)
    wrappers = {'stamp_solver': stamp_solver, 'flux_projection':
                flux_projection}

    def use(key):
        """Point the port's wrapper of this kernel at the variant's
        library."""
        kernel = key[0]
        _build._LOADED[kernel] = ctypes.CDLL(str(built[key][0]))
        wrappers[kernel]._entry.cache_clear()
        if kernel == 'flux_projection':
            flux_projection.launch_plan.cache_clear()

    def cases(kernel):
        if kernel == 'stamp_solver':
            return [(f'({cs.MAIN_B}, {cs.N_PIX})', 5,
                     lambda: stamp_solver.solve_rows(*k2_args, cfg))]
        long_row = lambda path: flux_projection.project_rows(
            *long_args, steps, False, path=path)
        return [(f'({rows}, {cs.N_PIX})', 50,
                 lambda a=a: flux_projection.project_rows(*a, steps, True))
                for rows, a in k1_args.items()] + [
            (f'{LONG_ROW} grid path', 50, lambda: long_row('grid')),
            (f'{LONG_ROW} one block a row', 20, lambda: long_row('rows'))]

    first = {}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for key in order:
        use(key)
        for shape, reps, fn in cases(key[0]):
            out = {}
            ms = cs.time_ms(torch, lambda: out.update(r=fn()), reps=reps)
            got = out['r'] if isinstance(out['r'], tuple) else (out['r'],)
            base = first.setdefault((key[0], shape), got)
            if 'grid path' in shape:
                same = float((got[0] - base[0]).abs().max()
                             / base[0].abs().max()) <= 1e-5
            else:
                same = all(torch.equal(a, b) for a, b in zip(got, base))
            cs.check(same, f'{key[0]} "{key[1]}" {shape}: result equals '
                     f'the kernel as built')
            print(f'{key[0]} "{key[1]}" {shape} float32: {ms:.4f} ms',
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
