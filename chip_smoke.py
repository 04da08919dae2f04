#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or a few):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; TF32
     off for matrix products and convolutions;
  2. build: nvcc compiles ``tpu_sgp_torch/csrc/flux_projection.cu`` and
     ``tpu_sgp_torch/csrc/stamp_solver.cu`` side by side; their ptxas
     reports (registers, spills) and resident blocks an SM, for every
     instantiation;
  3. the projection kernel against its plain PyTorch version on the same
     CUDA tensors, float32 and float64, with and without saturation, at the
     main path's (12288, 961) and at a ragged (7, 256); their times at the
     main path's full width (12288, 961) and its tail width (2048, 961);
  4. the main path at full size: 12288 synthetic 31x31 stamps through
     ``restore_stamps(..., flatten=True)`` with the bench configuration and
     ``projection_method='pallas'``; the kernel's launch count in that run;
  5. the same solve at B=256 on the card and on the CPU (plain projection),
     float64 lane for lane, float32 as distributions;
  6. the whole-solver kernel against its plain PyTorch version on the card,
     B=256 main-path stamps: float64 lane for lane, float32 stop rule 3 as
     distributions, float32 stop rule 1 (max_iter=20) lane by lane and
     against float64 truth;
  7. the whole-solver path at full width: ``solve_stamps_pallas`` on the
     same 12288 stamps as phase 4, one launch a call, its iterations against
     phase 4's; the kernel alone and its plain version timed, and held
     against each other at this shape;
  8. the whole-solver kernel's operator alone against the dense circulant
     product, float32 and float64; its time at phase 7's count of
     operator applications, as a share of the kernel's time.

Then a JSON line of the kernels, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It exits non-zero without a GPU.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

MAIN_B = 12288
N_PIX = 31 * 31
SAT_LEVEL = 65000.0
BENCH_CFG = dict(max_iter=100, stop_criterion=3, tol_convergence=1e-4,
                 init_recon=2, proj_type=1, has_flux=True,
                 has_sat_level=True, dtype='float32', divergence='kl',
                 track_discr=False, projection_method='pallas')
COMPACTION = dict(phase1_iters=26, tail_bucket=2048)
# max|kernel - plain| / max|plain|: the two sum a row in different orders,
# so a sign census can differ by one section at the last step
KERNEL_TOL = {'float32': 1e-5, 'float64': 1e-10}
FLUX_RTOL = {'float32': 1e-4, 'float64': 1e-9}
LIBRARIES = ('flux_projection', 'stamp_solver')
# K2's operator alone against the dense circulant product, max|dy| over
# max|x|: the two sum 961 products a pixel in different orders
OPERATOR_TOL = {'float32': 1e-5, 'float64': 1e-12}
K2_B = 256
# whole-solver kernel against its plain version, float32, per-lane
# max|dx|/max|x|. Late iterations take their BB steplength from sums that
# cancel, so float32 rounding moves a few lanes' paths far more than the
# rest (see PERF.md). Stop rule 1 at max_iter=20 (phase 6), every lane
# 20 iterations; the max is about twice the 2x4-patch kernel's reading,
# 5.390e-03, where the plain version itself lies 5.403e-03 from float64
# truth on its worst lane and the kernel 1.190e-03 (PERF.md):
K2_F32_REL = {'median': 2e-4, 'p95': 2e-3, 'max': 1e-2}
# the same run against float64 truth: the kernel's median and 95th
# percentile no more than this times the plain version's (phase 6)
TRUTH_RATIO = 1.5
# Stop rule 3 at full width (phase 7), where a lane may also stop some
# iterations earlier or later on one side (the iteration counts are held
# as distributions), so x is held over all lanes by median and 95th
# percentile, and by its max on the lanes of equal iterations; about twice
# the readings on the H100 (PERF.md):
K2_FULL_REL = {'median': 1e-3, 'p95': 2e-2}
K2_FULL_REL_SAME = {'median': 5e-4, 'p95': 6e-3, 'max': 7e-2}
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def projection_case(torch, rows: int, n: int, dtype, has_sat: bool,
                    device, seed: int):
    """Random (rows, n) projection inputs with per-row b and cap; the cap
    leaves room for the flux (n * cap >= 1.5 b)."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(50.0, 500.0, rows)
    c = rng.normal(0.5, 1.0, (rows, n))
    dia = rng.uniform(0.5, 2.0, (rows, n))
    cap = rng.uniform(1.5, 3.0, rows) * b / n
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return t(b), t(c), t(dia), t(cap) if has_sat else torch.zeros_like(t(b))


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the float32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / F32_FLOP_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def ptxas_summary(log: str) -> dict:
    """Registers, spills and static shared memory of every kernel
    instantiation in a ptxas report, by name ``kernel<type,threads,...>``,
    as ``R regs spill S/L B smem M B``."""
    out, name, spill = {}, None, ''
    for ln in log.splitlines():
        m = re.search(r"([a-z_]+_kernel)I([fd])((?:Li\d+E)*)", ln)
        if 'Compiling entry function' in ln and m:
            args = ','.join([m[2]] + re.findall(r'Li(\d+)E', m[3]))
            name = f'{m[1]}<{args}>'
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      ln)
        if m:
            spill = f'spill {m[1]}/{m[2]} B'
            continue
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', ln)
        if m and name:
            out[name] = f'{m[1]} regs {spill} smem {m[2] or 0} B'
            name = None
    return out


def occupancy(lib, name: str) -> dict:
    """Resident blocks an SM of each instantiation the library reports
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through its
    ``tpu_sgp_<name>_occupancy`` entry), by name."""
    import ctypes
    fn = getattr(lib, f'tpu_sgp_{name}_occupancy')
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out, i = {}, 0
    buf = ctypes.create_string_buffer(128)
    n, blocks = ctypes.c_int(), ctypes.c_int()
    while (err := fn(i, 0, buf, len(buf), ctypes.byref(n),
                     ctypes.byref(blocks))) != -1:
        check(err == 0, f'occupancy query {i} of {name}: CUDA error {err}')
        out[buf.value.decode()] = (f'{blocks.value} blocks/SM at '
                                   f'n={n.value or "any"}')
        i += 1
    return out


def phase_build() -> None:
    """Phase 2: one nvcc for each source, all started together. Each
    library's time is its own nvcc's wall, overlapping the other's."""
    from concurrent.futures import ThreadPoolExecutor
    from tpu_sgp_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(one, LIBRARIES))
    total = time.perf_counter() - t0
    for name, (lib, secs) in zip(LIBRARIES, built):
        print(f'build: {lib.name} in {secs:.2f} s (side by side, all '
              f'{total:.2f} s)')
        report = ptxas_summary(lib.with_name(lib.name + '.log').read_text())
        resident = occupancy(_build.load_library(name), name)
        print(f'ptxas {name}: ' + '; '.join(
            f'{k} {v}' + (f', {resident[k]}' if k in resident else '')
            for k, v in report.items()))


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn`` on the card, CUDA events, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch, device) -> dict:
    """Phase 3: kernel against plain version, then their times."""
    from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                       project_rows_plain)
    from tpu_sgp_torch.projection.flux_projection import section_steps

    main_err = None
    seed = 0
    for rows, n in ((MAIN_B, N_PIX), (7, 256)):
        for name in ('float32', 'float64'):
            dtype = getattr(torch, name)
            steps = section_steps(dtype)
            for has_sat in (True, False):
                seed += 1
                b, c, dia, cap = projection_case(torch, rows, n, dtype,
                                                 has_sat, device, seed)
                got = project_rows(b, c, dia, cap, steps, has_sat)
                want = project_rows_plain(b, c, dia, cap, steps, has_sat)
                torch.cuda.synchronize()
                abs_err = float((got - want).abs().max())
                rel = abs_err / float(want.abs().max())
                flux = float(((got.sum(-1) - b).abs() / b).max())
                print(f'kernel ({rows}, {n}) {name} has_sat={has_sat}: '
                      f'max|dx|/max|x|={rel:.3e} (limit '
                      f'{KERNEL_TOL[name]:.0e}) flux rel err={flux:.3e}')
                check(bool(torch.isfinite(got).all()), 'finite kernel x')
                check(rel <= KERNEL_TOL[name], 'kernel agrees with plain')
                check(flux <= FLUX_RTOL[name], 'kernel conserves flux')
                if (rows, n, name, has_sat) == (MAIN_B, N_PIX, 'float32',
                                                 True):
                    main_err = abs_err

    # at the main path's full width, then at its tail width
    steps = section_steps(torch.float32)
    for rows in (MAIN_B, COMPACTION['tail_bucket']):
        b, c, dia, cap = projection_case(torch, rows, N_PIX, torch.float32,
                                         True, device, 99)
        ms = time_ms(torch, lambda: project_rows(b, c, dia, cap, steps, True))
        plain_ms = time_ms(torch, lambda: project_rows_plain(b, c, dia, cap,
                                                             steps, True))
        # read b, c, dia, cap once, write x once; per pixel and section
        # point an add, a multiply, a max, a min and the sum's add, and
        # about 8 operations for the bracket and the final evaluation
        k1_bound = bound((3 * rows * N_PIX + 2 * rows) * 4,
                         rows * N_PIX * (steps * 7 * 5 + 8))
        print(f'kernel time ({rows}, {N_PIX}) float32 has_sat=True: '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
              f'{k1_bound["bound_ms"]:.4f} ms ({k1_bound["bound_by"]})')
        if rows == MAIN_B:
            main = dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms,
                        **k1_bound, library_ms=None)
    return main


def main_path_inputs(b: int):
    from tpu_sgp_torch.simulate import synthetic_star_stamps
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=31, seed=42)
    fluxes = stamps.sum(axis=(1, 2)) - N_PIX * bkgs
    return stamps, psf, bkgs, fluxes


def restore(torch, inputs, device, dtype='float32'):
    from tpu_sgp_torch import SGPConfig, restore_stamps
    stamps, psf, bkgs, fluxes = inputs
    cfg = SGPConfig(**{**BENCH_CFG, 'dtype': dtype})
    res = restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                         sat_level=SAT_LEVEL, flatten=True, device=device,
                         **COMPACTION)
    if res.x.is_cuda:
        torch.cuda.synchronize()
    return res


def check_restoration(torch, res, inputs, device) -> None:
    stamps, _, _, fluxes = inputs
    x = res.x
    check(x.device.type == torch.device(device).type,
          f'x lies on {device}')
    check(tuple(x.shape) == stamps.shape, 'x has the stamps\' shape')
    check(bool(torch.isfinite(x).all()), 'x is finite')
    flux_err = (x.double().sum((1, 2)).cpu().numpy() - fluxes) / fluxes
    worst = float(np.abs(flux_err).max())
    limit = FLUX_RTOL[str(x.dtype).removeprefix('torch.')]
    print(f'flux conservation {x.dtype} on {device}: max |sum(x) - flux| / '
          f'flux = {worst:.3e} (limit {limit:.0e})')
    check(worst <= limit, 'every stamp conserves its flux')


def phase_main_path(torch, card: str) -> tuple:
    """Phase 4: the main path at full size, after one warm-up run. The
    kernel's launch count is that of the first timed run; the wall is the
    median of three timed runs."""
    from tpu_sgp_torch.kernels.flux_projection import project_rows
    inputs = main_path_inputs(MAIN_B)
    restore(torch, inputs, 'cuda')           # warm-up
    walls = []
    for i in range(3):
        if i == 0:
            project_rows.launches = 0
        t0 = time.perf_counter()
        res = restore(torch, inputs, 'cuda')
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = project_rows.launches
            check_restoration(torch, res, inputs, 'cuda')
            check(launches > 0,
                  'the main path launched the projection kernel')
    wall = float(np.median(walls))
    iters = res.iters.cpu().numpy()
    print(f'main path B={MAIN_B} float32 pallas: wall median={wall:.4f} s '
          f'(runs {", ".join(f"{w:.4f}" for w in walls)}) '
          f'stamps/s={MAIN_B / wall:.1f} iters median={np.median(iters):g} '
          f'max={iters.max()} kernel launches={launches} [{card}]')
    return launches, wall, iters


def phase_card_vs_cpu(torch) -> None:
    """Phase 5: B=256 on the card (kernel) against the CPU (plain).

    float64: the same per-lane iteration counts and x to 1e-7 relative
    (the port and the JAX package on the CPU agree to 5e-9 here).
    float32: the stop rule's relative decrease sits near its 1e-4
    tolerance for several iterations, so a change of summation order moves
    a lane's stop by a few iterations and its x by up to about 1e-2
    relative; the JAX package against itself (flatten=True against the
    (H, W) layout, CPU) differs by up to 8 iterations on this batch. So
    float32 compares distributions: equal medians, mean |diters| <= 1."""
    inputs = main_path_inputs(256)
    for dtype in ('float64', 'float32'):
        gpu = restore(torch, inputs, 'cuda', dtype)
        cpu = restore(torch, inputs, 'cpu', dtype)
        check_restoration(torch, gpu, inputs, 'cuda')
        check_restoration(torch, cpu, inputs, 'cpu')
        it_g = gpu.iters.cpu().numpy().astype(int)
        it_c = cpu.iters.numpy().astype(int)
        diff = np.abs(it_g - it_c)
        xg = gpu.x.cpu().numpy()
        xc = cpu.x.numpy()
        rel = float((np.abs(xg - xc).max(axis=(1, 2))
                     / np.abs(xc).max(axis=(1, 2))).max())
        print(f'card vs cpu B=256 {dtype}: iters median {np.median(it_g):g} '
              f'vs {np.median(it_c):g}, |diters| histogram '
              f'{np.bincount(diff).tolist()}, mean |diters|={diff.mean():.4f}'
              f', max rel |dx|={rel:.3e}')
        check(np.median(it_g) == np.median(it_c), 'median iterations equal')
        if dtype == 'float64':
            check(diff.max() == 0, 'float64: equal per-lane iterations')
            check(rel <= 1e-7, 'float64: x agrees to 1e-7')
        else:
            check(diff.mean() <= 1.0, 'float32: mean |diters| <= 1')


def phase_k2_vs_plain(torch) -> None:
    """Phase 6: the whole-solver kernel against its plain version on the
    same CUDA tensors, B=256 main-path stamps, bench configuration.

    float64: equal per-lane iterations and x to 1e-7 relative. float32,
    stop rule 3: equal medians, mean |diters| <= 1 (see phase 5). float32,
    stop rule 1 at max_iter=20, where every lane runs 20 iterations:
    per-lane max|dx|/max|x| within ``K2_F32_REL``, and both float32
    results against the plain version in float64: the kernel's median and
    95th percentile within ``TRUTH_RATIO`` times the plain version's."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels.stamp_solver import solve_rows, solve_rows_plain
    inputs = main_path_inputs(K2_B)
    fluxes = inputs[3]
    for label, over in (('float64 stop 3', dict(dtype='float64')),
                        ('float32 stop 3', {}),
                        ('float32 stop 1 max_iter=20',
                         dict(stop_criterion=1, max_iter=20))):
        cfg = SGPConfig(**{**BENCH_CFG, **over})
        args = stamp_rows(*inputs, SAT_LEVEL, cfg.torch_dtype, 'cuda')
        x, it = solve_rows(*args, cfg)
        xp, ip = solve_rows_plain(*args, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(x).all()), f'{label}: finite kernel x')
        flux = float(np.abs(x.double().sum(1).cpu().numpy() / fluxes
                            - 1).max())
        check(flux <= FLUX_RTOL[cfg.dtype], f'{label}: kernel conserves flux')
        it, ip = it.cpu().numpy().astype(int), ip.cpu().numpy().astype(int)
        diff = np.abs(it - ip)
        rel = ((x - xp).abs().amax(1) / xp.abs().amax(1)).cpu().numpy()
        print(f'K2 kernel vs plain B={K2_B} {label}: iters median '
              f'{np.median(it):g} vs {np.median(ip):g}, max {it.max()} vs '
              f'{ip.max()}, mean |diters|={diff.mean():.4f}, per-lane '
              f'max|dx|/max|x| median {np.median(rel):.3e} p95 '
              f'{np.percentile(rel, 95):.3e} max {rel.max():.3e}, flux rel '
              f'err={flux:.3e}')
        if cfg.dtype == 'float64':
            check(diff.max() == 0, 'K2 float64: equal per-lane iterations')
            check(rel.max() <= 1e-7, 'K2 float64: x agrees to 1e-7')
        elif cfg.stop_criterion == 3:
            check(np.median(it) == np.median(ip),
                  'K2 float32: median iterations equal')
            check(diff.mean() <= 1.0, 'K2 float32: mean |diters| <= 1')
        else:
            check(np.median(rel) <= K2_F32_REL['median']
                  and np.percentile(rel, 95) <= K2_F32_REL['p95']
                  and rel.max() <= K2_F32_REL['max'],
                  f'K2 float32 stop rule 1: x within {K2_F32_REL}')
            # both float32 results against float64 truth (the plain version
            # in float64 on the same stamps): the kernel's sum order may
            # stray from the truth no further than the plain version's
            cfg64 = SGPConfig(**{**BENCH_CFG, **over, 'dtype': 'float64'})
            x64, _ = solve_rows_plain(*stamp_rows(*inputs, SAT_LEVEL,
                                                  torch.float64, 'cuda'),
                                      cfg64)
            truth = {}
            for who, got in (('kernel', x), ('plain', xp)):
                r = ((got.double() - x64).abs().amax(1)
                     / x64.abs().amax(1)).cpu().numpy()
                truth[who] = (float(np.median(r)),
                              float(np.percentile(r, 95)), float(r.max()))
            print(f'K2 float32 vs float64 truth B={K2_B} stop 1 '
                  f'max_iter=20, per-lane max|dx|/max|x| median / p95 / '
                  f'max: kernel ' + ' / '.join(f'{v:.3e}' for v in
                                              truth['kernel'])
                  + ', plain ' + ' / '.join(f'{v:.3e}' for v in
                                            truth['plain']))
            for i, what in ((0, 'median'), (1, 'p95')):
                check(truth['kernel'][i] <= TRUTH_RATIO * truth['plain'][i],
                      f'K2 float32 {what} distance to float64 truth within '
                      f'{TRUTH_RATIO}x the plain version\'s')


def phase_k2_full(torch, card: str, unfused_wall: float,
                  unfused_iters) -> dict:
    """Phase 7: ``solve_stamps_pallas`` at full width on phase 4's inputs,
    after one warm-up call; the wall is the median of three calls, each
    ending in a synchronize, with the kernel's launches counted from 0 in
    each. Then the kernel alone and its plain version, CUDA events, on the
    same operands; their last results are held against each other with
    phase 6's stop-rule-3 limits on the iterations and ``K2_FULL_REL``
    and ``K2_FULL_REL_SAME`` on x, and give the kernel's max_abs_err."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import (solve_stamps_pallas,
                                                         stamp_rows)
    from tpu_sgp_torch.kernels.stamp_solver import solve_rows, solve_rows_plain
    from tpu_sgp_torch.projection.flux_projection import bracket_bits
    inputs = main_path_inputs(MAIN_B)
    stamps, psf, bkgs, fluxes = inputs
    cfg = SGPConfig(**BENCH_CFG)

    def run():
        out = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT_LEVEL, cfg)
        torch.cuda.synchronize()
        return out

    run()                                   # warm-up
    walls, counts = [], []
    for _ in range(3):
        solve_rows.launches = 0
        t0 = time.perf_counter()
        x, iters = run()
        walls.append(time.perf_counter() - t0)
        counts.append(solve_rows.launches)
    check(counts == [1, 1, 1], 'one whole-solver launch per call')
    check(x.is_cuda and tuple(x.shape) == stamps.shape,
          'K2 x lies on the card in the stamps\' shape')
    check(bool(torch.isfinite(x).all()), 'K2 x is finite')
    flux = float(np.abs(x.double().sum((1, 2)).cpu().numpy() / fluxes
                        - 1).max())
    check(flux <= FLUX_RTOL['float32'], 'K2: every stamp conserves its flux')
    it = iters.cpu().numpy().astype(int)
    diff = np.abs(it - np.asarray(unfused_iters, dtype=int))
    wall = float(np.median(walls))
    print(f'K2 path B={MAIN_B} float32 solve_stamps_pallas: wall median='
          f'{wall:.4f} s (runs {", ".join(f"{w:.4f}" for w in walls)}) '
          f'stamps/s={MAIN_B / wall:.1f} iters median={np.median(it):g} '
          f'max={it.max()} launches per call={counts} flux rel err='
          f'{flux:.3e} [{card}]')
    print(f'K2 vs unfused path B={MAIN_B}: iters median {np.median(it):g} '
          f'vs {np.median(unfused_iters):g}, mean |diters|='
          f'{diff.mean():.4f}, |diters| histogram '
          f'{np.bincount(diff).tolist()}; unfused wall {unfused_wall:.4f} s')
    check(np.median(it) == np.median(unfused_iters),
          'K2 and the unfused path: median iterations equal')
    check(diff.mean() <= 1.0, 'K2 and the unfused path: mean |diters| <= 1')

    args = stamp_rows(*inputs, SAT_LEVEL, torch.float32, 'cuda')
    out = {}
    ms = time_ms(torch, lambda: out.update(kernel=solve_rows(*args, cfg)),
                 reps=5)
    plain_ms = time_ms(
        torch, lambda: out.update(plain=solve_rows_plain(*args, cfg)), reps=1)
    (xk, ik), (xp, ip) = out['kernel'], out['plain']
    ik, ip = ik.cpu().numpy().astype(int), ip.cpu().numpy().astype(int)
    diff = np.abs(ik - ip)
    rel = ((xk - xp).abs().amax(1) / xp.abs().amax(1)).cpu().numpy()
    same = rel[diff == 0]
    max_abs = float((xk - xp).abs().max())
    print(f'K2 kernel vs plain B={MAIN_B} float32 stop 3: iters median '
          f'{np.median(ik):g} vs {np.median(ip):g}, max {ik.max()} vs '
          f'{ip.max()}, mean |diters|={diff.mean():.4f}, |diters| histogram '
          f'{np.bincount(diff).tolist()}, per-lane max|dx|/max|x| median '
          f'{np.median(rel):.3e} p95 {np.percentile(rel, 95):.3e} max '
          f'{rel.max():.3e} (lanes of equal iterations: median '
          f'{np.median(same):.3e} p95 {np.percentile(same, 95):.3e} max '
          f'{same.max():.3e}), max|dx|={max_abs:.4f}')
    check(bool(torch.isfinite(xk).all()), 'K2 full width: finite kernel x')
    check(np.median(ik) == np.median(ip),
          'K2 full width: median iterations equal to the plain version\'s')
    check(diff.mean() <= 1.0, 'K2 full width: mean |diters| <= 1')
    check(np.median(rel) <= K2_FULL_REL['median']
          and np.percentile(rel, 95) <= K2_FULL_REL['p95'],
          f'K2 full width: x within {K2_FULL_REL} of the plain version')
    check(np.median(same) <= K2_FULL_REL_SAME['median']
          and np.percentile(same, 95) <= K2_FULL_REL_SAME['p95']
          and same.max() <= K2_FULL_REL_SAME['max'],
          f'K2 full width, lanes of equal iterations: x within '
          f'{K2_FULL_REL_SAME} of the plain version')
    # this run's work: each lane applies the 961-tap operator 3 + 2 * iters
    # times (N^2 multiply-adds of 2 operations each) and projects 1 + iters
    # times (per bisection step and pixel an add, a divide, a max, a min and
    # the sum's add, and about 8 operations around the bisection); read the
    # stamps, backgrounds, fluxes, levels and taps once, write x and iters
    n = N_PIX
    ops = float(((3 + 2 * it) * 2 * n * n
                 + (1 + it) * (bracket_bits(torch.float32) * 5 + 8) * n).sum())
    k2_bound = bound((3 * MAIN_B * n + 3 * MAIN_B + n) * 4, ops)
    print(f'K2 kernel time ({MAIN_B}, {n}) float32: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {k2_bound["bound_ms"]:.4f} ms '
          f'({k2_bound["bound_by"]}, {ops / 1e12:.4f} TFLOP)')
    return dict(launches=counts[0], max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, **k2_bound,
                library_ms=None), int((3 + 2 * ik).sum())


def phase_operator(torch, k2_ms: float, applications: int) -> None:
    """Phase 8: K2's operator alone (``apply_operator``, the solver's own
    device code) against its plain twin, the dense circulant product, on
    main-path rows and taps: ``(AT A) x`` to ``OPERATOR_TOL`` of max|x|
    (only the order of the sums differs). Then its time at phase 7's own
    count of applications (``3 + 2 * iters`` a lane, summed), as a share of
    the kernel's ``k2_ms``, beside the plain twin's time for the same
    count."""
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels.stamp_solver import (apply_operator,
                                                    apply_operator_plain)
    inputs = main_path_inputs(MAIN_B)
    for name, tol in OPERATOR_TOL.items():
        dtype = getattr(torch, name)
        gn, _, _, _, taps = stamp_rows(*inputs, SAT_LEVEL, dtype, 'cuda')
        got = apply_operator(gn, taps, 1)
        want = apply_operator_plain(gn, taps, 1)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / gn.abs().max())
        print(f'K2 operator (AT A) x ({MAIN_B}, {N_PIX}) {name}: '
              f'max|dy|/max|x|={rel:.3e} (limit {tol:.0e})')
        check(bool(torch.isfinite(got).all()), f'{name}: finite operator')
        check(rel <= tol, f'{name}: operator agrees with the dense product')
    gn, _, _, _, taps = stamp_rows(*inputs, SAT_LEVEL, torch.float32, 'cuda')
    gn = gn / gn.amax(1, keepdim=True)
    reps = max(1, round(applications / (2 * MAIN_B)))
    scale = applications / (2 * MAIN_B * reps)
    ms = time_ms(torch, lambda: apply_operator(gn, taps, reps), reps=3) * scale
    plain_ms = time_ms(torch, lambda: apply_operator_plain(gn, taps, reps),
                       reps=3) * scale
    flop = 2.0 * N_PIX * N_PIX * applications
    print(f'K2 operator time ({MAIN_B}, {N_PIX}) float32 at phase 7\'s '
          f'{applications} applications ({reps} x (AT A) a row, scaled by '
          f'{scale:.4f}, {apply_operator.resident} blocks/SM as the '
          f'solver): {ms:.4f} ms, {flop / ms / 1e9:.2f} TFLOP/s '
          f'({100 * flop / ms / 1e-3 / F32_FLOP_S:.1f} % of the float32 '
          f'peak), {100 * ms / k2_ms:.1f} % of the kernel\'s {k2_ms:.4f} '
          f'ms; the rest {k2_ms - ms:.4f} ms; dense product {plain_ms:.4f} '
          f'ms')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('FAIL: torch.cuda.is_available() is False; this run needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 1

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(['nvidia-smi', '--query-gpu=name,power.limit',
                '--format=csv,noheader']).splitlines()[0]
    from tpu_sgp_torch.kernels import _build
    nvcc_version = run([_build.nvcc(), '--version']).splitlines()[-1]
    print(f'env: python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda} nvcc "{nvcc_version}" card "{card}" '
          f'devices={torch.cuda.device_count()}')

    # 2-8
    phase_build()
    kernel = phase_kernel(torch, 'cuda')
    launches, unfused_wall, unfused_iters = phase_main_path(torch, card)
    phase_card_vs_cpu(torch)
    phase_k2_vs_plain(torch)
    k2, applications = phase_k2_full(torch, card, unfused_wall,
                                     unfused_iters)
    phase_operator(torch, k2['ms'], applications)

    print(json.dumps({'kernels': [{
        'name': 'flux_projection', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/flux_projection.cu',
        'replaces': 'tpu_sgp/experimental/pallas_projection.py:40',
        'launches': launches, **kernel}, {
        'name': 'stamp_solver', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/stamp_solver.cu',
        'replaces': 'tpu_sgp/experimental/pallas_batch.py:57', **k2}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
