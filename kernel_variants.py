#!/usr/bin/env python3
"""Time edited variants of the port's two kernels on one NVIDIA GPU.

    python3 kernel_variants.py

Each variant is a copy of ``tpu_sgp_torch/csrc/<kernel>.cu`` with one
design constant, launch rule or layout changed, built side by side with
the port's nvcc flags into ``build/kernel_variants/``. Each is timed
through the port's own wrapper (CUDA events) at the main path's shapes on
one set of seeded operands, in the order listed and then in reverse: K2
whole and its operator alone at phase 7's count of applications. The variants change
speed, not arithmetic: each result must equal that of the kernel as built,
or the script fails. Two compare otherwise: on K1's long row the variants
sum in another order, so x is held to 1e-5 of max|x| there; K2 with its
float32 operator on the FP32 pipes (the earlier design, Patch<float>: the
library as built, on the route its launch plan takes for the shapes that
the tensor cores' blocks do not fit, named here for the main path's
stamps) sums in another order too, so its operator is held to
``chip_smoke.OPERATOR_TOL`` and its solve to chip_smoke.py phase 7's limits
against the kernel as built. K1's
long row, one 410x410 frame, is also timed on the one-block-a-row path
beside the grid path. Prints the card, the ptxas line of the main path's
instantiations and the tensor cores' instructions (HMMA) in them for every
variant, and one line a timing. Exits non-zero without a GPU.
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

CSRC = Path(__file__).resolve().parent / 'tpu_sgp_torch' / 'csrc'
OUT = Path(__file__).resolve().parent / 'build' / 'kernel_variants'
# K2's float32 operator on the FP32 pipes, the library as built on the
# plan's Patch<float> route: its results differ from the tensor cores'
# within chip_smoke.py's limits, not bit for bit
FP32_PIPES = 'FP32-pipe operator (the earlier float32 design)'
# variants that run the library as built on another route: (design,
# transposed) of kernels/stamp_solver.py:route_plan at the main path's shape
ROUTED = {('stamp_solver', FP32_PIPES): ('Patch', False)}
# (kernel, variant) -> edits of the source, (old, new) each
VARIANTS = {
    ('stamp_solver', 'as built'): [],
    ('stamp_solver', 'bisection depth 2'): [
        ('constexpr int kDepth = 1;', 'constexpr int kDepth = 2;')],
    ('stamp_solver', 'bisection depth 3'): [
        ('constexpr int kDepth = 1;', 'constexpr int kDepth = 3;')],
    ('stamp_solver', 'no register cap'): [
        ('sizeof(T) == 4 && MAXT == 128 ? 4 : 1', '1')],
    ('stamp_solver', 'tap row length read at run time'): [
        ('if (threads <= 128 && lay.pitch == 32)', 'if (false)')],
    # lane (g, t) takes reduction columns 2t and 2t + 1 of a k-step, so its
    # two A values of a row are one 8-byte load (rows 8 banks apart)
    ('stamp_solver', 'k-step columns paired, A by 8-byte loads'): [
        ('stride(pitch + 4)', 'stride(pitch + 8)'),
        ('arow0 = (row % L.h) * L.stride + t;',
         'arow0 = (row % L.h) * L.stride + 2 * t;'),
        ('arow1 = ((row + 8) % L.h) * L.stride + t;',
         'arow1 = ((row + 8) % L.h) * L.stride + 2 * t;'),
        ('boff = p - 1 + t - g - 16 * ni;',
         'boff = p - 1 + 2 * t - g - 16 * ni;'),
        ('b_frag(tb - 8 * dir, 4 * dir, prev);',
         'b_frag(tb - 8 * dir, dir, prev);'),
        ('b_frag(tb + dir * c0, 4 * dir, cur);',
         'b_frag(tb + dir * c0, dir, cur);'),
        ('__float_as_uint(r0[c0]), __float_as_uint(r1[c0]),\n'
         '            __float_as_uint(r0[c0 + 4]), __float_as_uint(r1[c0 + 4])',
         'PAIR(r0, 0).x, PAIR(r1, 0).x, PAIR(r0, 0).y, PAIR(r1, 0).y'),
        ('__float_as_uint(r0[lo_x + c0]),\n'
         '                                __float_as_uint(r1[lo_x + c0]),\n'
         '                                __float_as_uint(r0[lo_x + c0 + 4]),\n'
         '                                __float_as_uint(r1[lo_x + c0 + 4])',
         'PAIR(r0, lo_x).x, PAIR(r1, lo_x).x, PAIR(r0, lo_x).y, '
         'PAIR(r1, lo_x).y'),
        ('struct TcPatch {',
         '#define PAIR(r, o) (*reinterpret_cast<const uint2*>(r + o + c0))\n'
         'struct TcPatch {')],
    ('flux_projection', 'as built'): [],
    ('flux_projection', '8 rows a block'): [
        ('constexpr int kRowWarps = 4;', 'constexpr int kRowWarps = 8;')],
    ('flux_projection', 'long row: 8 pixels a thread'): [
        ('constexpr int kGridPer = 4;', 'constexpr int kGridPer = 8;')],
    ('flux_projection', 'long row: 2 pixels a thread'): [
        ('constexpr int kGridPer = 4;', 'constexpr int kGridPer = 2;')],
}
MAIN_INSTANCES = ('solve_stamps_kernel<f,128,',
                  'apply_operator_kernel<f,128,',
                  'project_rows_warp_kernel<f,32>',
                  'project_rows_grid_kernel<f,')
LONG_ROW = cs.LONG_ROWS[0]


def build(key):
    """nvcc on the edited copy; returns the library and its main-path
    ptxas entries, each with its HMMA count."""
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
    hmma = cs.sass_count(lib, 'HMMA')
    return lib, {k: f'{v} HMMA {hmma.get(k, 0)}' for k, v in report.items()
                 if k.startswith(MAIN_INSTANCES)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('FAIL: torch.cuda.is_available() is False; this run needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels import _build, flux_projection, stamp_solver
    from tpu_sgp_torch.kernels.flux_projection import section_steps
    print(cs.run(['nvidia-smi', '--query-gpu=name,power.limit',
                  '--format=csv,noheader']).splitlines()[0])

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    for key in ROUTED:
        built[key] = built[(key[0], 'as built')]
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
    planned = stamp_solver.stamp_solver_plan

    def use(key):
        """Point the port's wrappers of this kernel at the variant's
        library, and K2's launch plan at the variant's route if it names
        one."""
        kernel = key[0]
        _build.use_library(kernel, built[key][0])
        if kernel == 'stamp_solver':
            stamp_solver.stamp_solver_plan = planned if key not in ROUTED \
                else lambda h, w, dtype, smem_limit: stamp_solver.route_plan(
                    *ROUTED[key], h, w, dtype, smem_limit)[0]

    # K2's operator alone at phase 7's count of applications (chip_smoke.py
    # phase 8), from the kernel as built
    use(('stamp_solver', 'as built'))
    iters = stamp_solver.solve_rows(*k2_args, cfg)[1]
    reps = max(1, round(int((3 + 2 * iters).sum()) / (2 * cs.MAIN_B)))
    gn, taps = k2_args[0], k2_args[4]
    unit = gn / gn.amax(1, keepdim=True)
    once = stamp_solver.apply_operator(gn, taps, 1)

    def cases(kernel):
        if kernel == 'stamp_solver':
            return [(f'({cs.MAIN_B}, {cs.N_PIX})', 5,
                     lambda: stamp_solver.solve_rows(*k2_args, cfg)),
                    (f'operator ({cs.MAIN_B}, {cs.N_PIX}) {reps} x (AT A)', 3,
                     lambda: stamp_solver.apply_operator(unit, taps, reps))]
        long_row = lambda path: flux_projection.project_rows(
            *long_args, steps, False, path=path)
        return [(f'({rows}, {cs.N_PIX})', 50,
                 lambda a=a: flux_projection.project_rows(*a, steps, True))
                for rows, a in k1_args.items()] + [
            (f'{LONG_ROW} grid path', 50, lambda: long_row('grid')),
            (f'{LONG_ROW} one block a row', 20, lambda: long_row('rows'))]

    def agrees(key, shape, got, base) -> bool:
        """The variant's result against the kernel as built's."""
        if 'grid path' in shape:
            return float((got[0] - base[0]).abs().max()
                         / base[0].abs().max()) <= 1e-5
        if key[1] != FP32_PIPES:
            return all(torch.equal(a, b) for a, b in zip(got, base))
        if shape.startswith('operator'):   # phase 8's check, one (AT A)
            one = stamp_solver.apply_operator(gn, taps, 1)
            return float((one - once).abs().max() / gn.abs().max()) \
                <= cs.OPERATOR_TOL['float32']
        cs.k2_full_width_agree(torch, *got, *base,
                               f'K2 "{key[1]}" vs as built')
        return True

    first = {}
    keys = list(VARIANTS) + list(ROUTED)
    for key in keys + keys[::-1]:
        use(key)
        for shape, n, fn in cases(key[0]):
            out = {}
            ms = cs.time_ms(torch, lambda: out.update(r=fn()), reps=n)
            got = out['r'] if isinstance(out['r'], tuple) else (out['r'],)
            base = first.setdefault((key[0], shape), got)
            cs.check(agrees(key, shape, got, base),
                     f'{key[0]} "{key[1]}" {shape}: result agrees with '
                     f'the kernel as built')
            print(f'{key[0]} "{key[1]}" {shape} float32: {ms:.4f} ms',
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
