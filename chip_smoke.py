#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--from N]

With ``--from N`` (13 to 17) phases 3 to N - 1 are skipped and no result is
printed: a short run for work on the later phases.

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
     product, float32 and float64; its time at phase 7's count of operator
     applications, as a share of the kernel's time;
  9. each plain-PyTorch projection method ('bisect', 'section', 'sort',
     'secant', warm 'bisect') on the card against the CPU at (12288, 961),
     float32 and float64, with and without saturation; each one's time and
     kernel launches a call at (12288, 961) float32;
 10. the KL default path at full size: phase 4's stamps through
     ``restore_stamps`` with the bench configuration exactly (default
     projection 'bisect'), beside phase 4's 'pallas' wall;
 11. the beta path at full size: the JAX bench's beta configuration
     ('section', beta0 1.005, lr0 1e-3), and the final beta distribution;
 12. phases 10 and 11 at B=256 on the card and on the CPU, float64 lane for
     lane, float32 as distributions;
 13. the projection kernel on long rows, one whole frame a row: (1, 168100)
     and (4, 65536), float32 and float64, with and without saturation,
     against its plain version; the time of the grid path (a row split over
     many blocks) beside the one-block-a-row path's, the plain version's
     and the bound;
 14. the FFT operators on the card: 'otf' against the dense circulant at
     31x31 and 64x64 and its adjoint identity; 'linear' against a direct
     zero-padded convolution and against the CPU at 410x410 with a 31x31
     and a 9x13 PSF; 'matmul_split' against 'matmul_flat'; the time of an
     operator pair at padded sizes 440, 448, 480 and 512;
 15. the whole-frame path: a 410x410 star field under a 31x31 PSF through
     ``tpu_sgp_torch.sgp`` and through ``solve`` with the JAX bench's two
     whole-frame configurations (200 fixed iterations for ms an iteration;
     stop rule 3 at 1e-5 for iterations and wall), with the warm 'bisect'
     projection and with 'pallas' (the kernel on one 168100-pixel row, its
     launches counted); a 256x256 frame with a PSF of its own shape ('otf')
     through ``sgp``; ``sgp_beta_div`` at 410x410; one profiled run;
 16. the whole-frame solve on the card against the CPU: float64 equal
     iterations and x within 1e-7 under stop rule 3; float32 within 1e-3
     (relative L2) of float64 after 10 fixed iterations, and its distance
     after 25 and 50;
 17. ``richardson_lucy`` and ``wiener`` on the card against the CPU, and a
     ``solve_checkpointed`` run on the card that equals the uninterrupted
     solve.

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
# bench.py:630-633 exactly: the default projection, 'bisect'
KL_CFG = {k: v for k, v in BENCH_CFG.items() if k != 'projection_method'}
# bench.py:215-241: the beta workload
BETA_CFG = dict(KL_CFG, divergence='beta', adapt_beta=True, schedule_lr=True,
                projection_method='section')
# configuration and restore_stamps arguments of each path
PATHS = {'pallas': (BENCH_CFG, COMPACTION),
         'kl bisect': (KL_CFG, COMPACTION),
         'beta section': (BETA_CFG, dict(phase1_iters=28, tail_bucket=2048,
                                         beta0=1.005, lr0=1e-3))}
# the plain-PyTorch projections of phase 9 ('warm' is 'bisect' warm-started)
METHODS = ('bisect', 'section', 'sort', 'secant', 'warm')
# phase 9: card against CPU, float64 max|dx|/max|x|
METHOD_TOL_F64 = 1e-10
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
# phase 13: the long rows, (rows, pixels): one 410x410 frame, four 256x256
LONG_ROWS = ((1, 410 * 410), (4, 256 * 256))
# phases 15-16: the JAX bench's whole-frame workload (bench.py:387-413): a
# 410x410 star field, a 31x31 PSF, background 150, no flux given, no
# saturation, the warm-started bisection
FRAME_BKG = 150.0
FRAME_BASE = dict(init_recon=2, proj_type=1, has_flux=False,
                  has_sat_level=False, dtype='float32', track_discr=False,
                  warm_projection=True)
FRAME_TIMED = dict(FRAME_BASE, max_iter=200, stop_criterion=1)
FRAME_CONVERGED = dict(FRAME_BASE, max_iter=500, stop_criterion=3,
                       tol_convergence=1e-5)
# phase 14: max|dy|/max|y| between two ways to the same product (FFT and
# dense, FFT and direct sum, card and CPU): only the order of the sums and
# the FFT's roundoff differ
FFT_TOL = {'float32': 1e-5, 'float64': 1e-12}
# phase 16: float32 against float64 after these fixed iteration counts;
# the first is held to 1e-3
F32_ITERS = (10, 25, 50)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f'check failed: {what}')


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def projection_case(torch, rows: int, n: int, dtype, has_sat: bool,
                    device, seed: int):
    """Random (rows, n) projection inputs with per-row b and cap; the cap
    leaves room for the flux (n * cap >= 1.5 b). Rows longer than a stamp
    keep a stamp's flux a pixel, as a frame's flux grows with its size."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(50.0, 500.0, rows) * max(1.0, n / N_PIX)
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


def restore(torch, inputs, device, dtype='float32', path='pallas'):
    from tpu_sgp_torch import SGPConfig, restore_stamps
    stamps, psf, bkgs, fluxes = inputs
    cfg, kw = PATHS[path]
    cfg = SGPConfig(**{**cfg, 'dtype': dtype})
    res = restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                         sat_level=SAT_LEVEL, flatten=True, device=device,
                         **kw)
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


def phase_card_vs_cpu(torch, path: str = 'pallas') -> None:
    """Phase 5 (and 12 for the other paths): B=256 on the card (kernel)
    against the CPU (plain).

    float64: the same per-lane iteration counts and x to 1e-7 relative
    (the port and the JAX package on the CPU agree to 5e-9 here).
    float32: the stop rule's relative decrease sits near its 1e-4
    tolerance for several iterations, so a change of summation order moves
    a lane's stop by a few iterations and its x by up to about 1e-2
    relative; the JAX package against itself (flatten=True against the
    (H, W) layout, CPU) differs by up to 8 iterations on this batch. So
    float32 compares distributions: equal medians, mean |diters| <= 1. On
    the beta path the final beta is held like x."""
    inputs = main_path_inputs(256)
    label = '' if path == 'pallas' else f' {path}'
    for dtype in ('float64', 'float32'):
        gpu = restore(torch, inputs, 'cuda', dtype, path)
        cpu = restore(torch, inputs, 'cpu', dtype, path)
        check_restoration(torch, gpu, inputs, 'cuda')
        check_restoration(torch, cpu, inputs, 'cpu')
        it_g = gpu.iters.cpu().numpy().astype(int)
        it_c = cpu.iters.numpy().astype(int)
        diff = np.abs(it_g - it_c)
        xg = gpu.x.cpu().numpy()
        xc = cpu.x.numpy()
        rel = float((np.abs(xg - xc).max(axis=(1, 2))
                     / np.abs(xc).max(axis=(1, 2))).max())
        beta_rel = float((np.abs(gpu.beta.cpu().numpy() - cpu.beta.numpy())
                          / np.abs(cpu.beta.numpy())).max())
        print(f'card vs cpu B=256{label} {dtype}: iters median '
              f'{np.median(it_g):g} vs {np.median(it_c):g}, |diters| '
              f'histogram {np.bincount(diff).tolist()}, mean |diters|='
              f'{diff.mean():.4f}, max rel |dx|={rel:.3e}'
              + (f', max rel |dbeta|={beta_rel:.3e}' if 'beta' in path
                 else ''))
        check(np.median(it_g) == np.median(it_c), 'median iterations equal')
        if dtype == 'float64':
            check(diff.max() == 0, 'float64: equal per-lane iterations')
            check(rel <= 1e-7, 'float64: x agrees to 1e-7')
            check(beta_rel <= 1e-7, 'float64: beta agrees to 1e-7')
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


def count_launches(torch, fn) -> tuple:
    """Kernels the card ran during one call of ``fn`` (``torch.profiler``'s
    device events, memory copies and sets left out) and the host's
    ``cudaLaunchKernel`` calls in it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(('Memcpy', 'Memset'))]
    host = [e for e in prof.events() if e.name.startswith('cudaLaunchKernel')]
    return len(device), len(host)


def phase_methods(torch) -> None:
    """Phase 9: each plain-PyTorch projection method on the card against
    the same call on the CPU, at the main path's (12288, 961), float32 and
    float64, with and without saturation (the cap leaves room for the
    flux). float64: x within ``METHOD_TOL_F64`` of max|x|; float32: the
    card's flux error <= 1e-4. The warm start takes the cold guided
    secant's root moved by 1e-3 of itself as its previous root, and 1e-3 of
    it as its previous step (a warm window that holds the root). Then each
    method's time a call at (12288, 961) float32 with saturation (CUDA
    events, mean of 5 after a warm-up) and the kernels it launches a call
    (``torch.profiler``)."""
    from tpu_sgp_torch.projection import flux_projection as fp

    def call(method, b, c, dia, cap, has_sat, lam_prev=None):
        ones = torch.ones_like(b)
        sat = cap if has_sat else None
        if method == 'warm':
            return fp.project_df_bisect_warm(
                b, c, dia, ones, sat, has_sat, lam_prev=lam_prev,
                dlam_prev=1e-3 * lam_prev.abs())[0]
        return fp.project(method, b, c, dia, ones, sat_level=sat,
                          has_sat=has_sat)

    def warm_root(args, has_sat):
        lam = fp._guided_root(args[0], args[1], args[2],
                              torch.ones_like(args[0]), args[3], has_sat,
                              None)[1]
        return lam * (1.0 + 1e-3)

    seed = 200
    for name in ('float32', 'float64'):
        dtype = getattr(torch, name)
        for has_sat in (True, False):
            seed += 1
            args = projection_case(torch, MAIN_B, N_PIX, dtype, has_sat,
                                   'cuda', seed)
            cpu_args = [a.cpu() for a in args]
            lam_prev = warm_root(args, has_sat)
            parts = []
            for method in METHODS:
                got = call(method, *args, has_sat, lam_prev)
                want = call(method, *cpu_args, has_sat, lam_prev.cpu())
                torch.cuda.synchronize()
                got = got.cpu()
                check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                      f'{method} {name}: finite x of the input dtype')
                rel = float((got - want).abs().max() / want.abs().max())
                b = cpu_args[0].double()
                flux = float(((got.double().sum(-1) - b).abs() / b).max())
                parts.append(f'{method} {rel:.3e} / {flux:.3e}')
                if name == 'float64':
                    check(rel <= METHOD_TOL_F64,
                          f'{method} float64: card agrees with the CPU')
                check(flux <= FLUX_RTOL['float32'],
                      f'{method} {name}: the card conserves flux')
            print(f'methods card vs cpu ({MAIN_B}, {N_PIX}) {name} '
                  f'has_sat={has_sat}, max|dx|/max|x| / card flux rel err: '
                  + ', '.join(parts))

    args = projection_case(torch, MAIN_B, N_PIX, torch.float32, True, 'cuda',
                           299)
    lam_prev = warm_root(args, True)
    for method in METHODS:
        fn = lambda: call(method, *args, True, lam_prev)
        ms = time_ms(torch, fn, reps=5)
        kernels, host = count_launches(torch, fn)
        print(f'method time ({MAIN_B}, {N_PIX}) float32 has_sat=True '
              f'{method}: {ms:.4f} ms a call, {kernels} kernels on the card '
              f'({host} cudaLaunchKernel calls)')


def profile_call(torch, fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: its wall (slowed by the
    profiler), the card's busy milliseconds (the device time of every
    kernel and copy), the device events, and the six ATen operations of
    most device time as text."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.key.startswith('aten::')),
                 key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return wall, busy, len(device), '; '.join(
        f'{e.key} {e.self_device_time_total / 1e3:.3f} ms x{e.count}'
        for e in top)


def profile_path(torch, path: str, inputs) -> None:
    """One more run of ``path`` under ``torch.profiler``
    (``profile_call``)."""
    wall, busy, events, top = profile_call(
        torch, lambda: restore(torch, inputs, 'cuda', path=path))
    print(f'{path} path profile B={MAIN_B}: wall {wall:.4f} s (profiled), '
          f'card busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} % of '
          f'the wall), {events} device events; most device time: {top}')


def phase_path(torch, card: str, path: str, pallas_wall: float) -> None:
    """Phases 10 and 11: phase 4's stamps through ``restore_stamps`` on
    ``path`` at full size, one warm-up run, then three timed runs; every
    stamp finite and conserving its flux; the wall beside phase 4's. Then
    one profiled run of ``path`` and, in phase 10, of phase 4's path."""
    inputs = main_path_inputs(MAIN_B)
    restore(torch, inputs, 'cuda', path=path)            # warm-up
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        res = restore(torch, inputs, 'cuda', path=path)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            check_restoration(torch, res, inputs, 'cuda')
    wall = float(np.median(walls))
    iters = res.iters.cpu().numpy()
    extra = ''
    if 'beta' in path:
        beta = res.beta.cpu().numpy()
        check(bool(np.isfinite(beta).all()), 'finite final beta')
        extra = (f' final beta median={np.median(beta):.6f} '
                 f'min={beta.min():.6f} max={beta.max():.6f}')
    print(f'{path} path B={MAIN_B} float32: wall median={wall:.4f} s (runs '
          f'{", ".join(f"{w:.4f}" for w in walls)}) stamps/s='
          f'{MAIN_B / wall:.1f} iters median={np.median(iters):g} '
          f'max={iters.max()}{extra}; pallas path wall {pallas_wall:.4f} s '
          f'[{card}]')
    for name in (path, 'pallas') if path == 'kl bisect' else (path,):
        profile_path(torch, name, inputs)


def phase_long_rows(torch) -> dict:
    """Phase 13: K1 on rows too long for one block, at ``LONG_ROWS``. The
    launcher must pick the grid path by itself (``launch_plan``); its
    result, and the one-block-a-row path's, against the plain version to
    ``KERNEL_TOL`` of max|x|. Then the times at (1, 168100) float32
    without saturation, the whole-frame solve's own call: grid path,
    one-block path, grid path again, plain version."""
    from tpu_sgp_torch.kernels.flux_projection import (launch_plan,
                                                       project_rows,
                                                       project_rows_plain)
    from tpu_sgp_torch.projection.flux_projection import section_steps
    main_err, seed = None, 300
    for rows, n in LONG_ROWS:
        for name in ('float32', 'float64'):
            dtype = getattr(torch, name)
            steps = section_steps(dtype)
            chosen, _, blocks = launch_plan(rows, n, dtype, 'auto', 0)
            check(chosen == 'grid' and blocks > rows,
                  f'({rows}, {n}) {name}: the launcher splits the rows over '
                  f'the grid')
            for has_sat in (True, False):
                seed += 1
                args = projection_case(torch, rows, n, dtype, has_sat,
                                       'cuda', seed)
                before = project_rows.grid_launches
                got = project_rows(*args, steps, has_sat)
                check(project_rows.grid_launches == before + 1,
                      'the call took the grid path')
                one = project_rows(*args, steps, has_sat, path='rows')
                want = project_rows_plain(*args, steps, has_sat)
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                abs_err = float((got - want).abs().max())
                rel, rel_one = abs_err / scale, float(
                    (one - want).abs().max()) / scale
                flux = float(((got.sum(-1) - args[0]).abs() / args[0]).max())
                print(f'kernel long row ({rows}, {n}) {name} has_sat='
                      f'{has_sat}: grid path ({blocks} blocks) max|dx|/max|x|'
                      f'={rel:.3e}, one block a row {rel_one:.3e} (limit '
                      f'{KERNEL_TOL[name]:.0e}) flux rel err={flux:.3e}')
                check(bool(torch.isfinite(got).all()), 'finite kernel x')
                check(max(rel, rel_one) <= KERNEL_TOL[name],
                      'long-row kernel agrees with plain')
                check(flux <= FLUX_RTOL[name], 'long-row kernel conserves '
                      'flux')
                if (rows, name, has_sat) == (1, 'float32', False):
                    main_err = abs_err

    rows, n = LONG_ROWS[0]
    steps = section_steps(torch.float32)
    args = projection_case(torch, rows, n, torch.float32, False, 'cuda', 399)
    grid = lambda: project_rows(*args, steps, False)
    ms = time_ms(torch, grid, reps=50)
    one_ms = time_ms(torch, lambda: project_rows(*args, steps, False,
                                                 path='rows'), reps=50)
    ms2 = time_ms(torch, grid, reps=50)
    plain_ms = time_ms(torch, lambda: project_rows_plain(*args, steps,
                                                         False), reps=5)
    k1_bound = bound((3 * rows * n + 2 * rows) * 4,
                     rows * n * (steps * 7 * 5 + 8))
    _, _, blocks = launch_plan(rows, n, torch.float32, 'auto', 0)
    print(f'kernel long row time ({rows}, {n}) float32 has_sat=False: grid '
          f'path {ms:.4f} ms ({blocks} blocks; again {ms2:.4f} ms), one '
          f'block a row {one_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{k1_bound["bound_ms"]:.5f} ms ({k1_bound["bound_by"]})')
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms, **k1_bound,
                library_ms=None)


def frame_inputs():
    """The whole-frame workload: a 410x410 field of 60 stars and its 31x31
    PSF (bench.py:402-403)."""
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(410, 410, n_stars=60, psf_size=31,
                                       fwhm=3.0, seed=7)
    return img, psf


def otf_frame_inputs(size: int = 256):
    """A frame whose PSF has its own shape, so 'auto' picks 'otf': 40 stars
    blurred circularly, background 150, Poisson noise."""
    from tpu_sgp_torch.simulate import _circular_degrade, gaussian_psf
    rng = np.random.default_rng(8)
    psf = gaussian_psf(size, 3.0)
    truth = np.zeros((size, size))
    np.add.at(truth, (rng.integers(2, size - 2, 40),
                      rng.integers(2, size - 2, 40)),
              rng.uniform(2e3, 8e4, 40))
    blurred = _circular_degrade(truth, psf) + FRAME_BKG
    return rng.poisson(np.maximum(blurred, 0.0)).astype(np.float64), psf


def solve_frame(torch, img, psf, cfg, device='cuda'):
    """``solve`` on one frame as bench.py:411-419 calls it: the operands
    placed on the device beforehand, the wall around the solve alone,
    ending in a synchronize. Returns (result, wall seconds)."""
    from tpu_sgp_torch.solvers.sgp import solve
    t = lambda a: torch.as_tensor(a, dtype=cfg.torch_dtype, device=device)
    gn, psf_d = t(img[None]), t(psf)
    bkg = torch.full_like(gn, FRAME_BKG)
    z = torch.zeros_like(gn)
    if gn.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(gn, psf_d, bkg, z, 0.0, z, 1.0, 1e-3, 0.0, cfg)
    if gn.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_frame(torch, x, img, what: str, dtype: str = 'float32') -> float:
    """A restored frame: on the card or the host as given, finite, of the
    frame's shape, its flux sum(gn - bkg) conserved."""
    x = torch.as_tensor(x)
    check(tuple(x.shape[-2:]) == img.shape, f'{what}: x has the frame\'s '
          f'shape')
    check(bool(torch.isfinite(x).all()), f'{what}: x is finite')
    flux = float((img - FRAME_BKG).sum())
    err = abs(float(x.double().sum()) - flux) / flux
    check(err <= FLUX_RTOL[dtype], f'{what}: flux conserved ({err:.3e})')
    return err


def phase_operators(torch) -> None:
    """Phase 14: the FFT and split operators on the card."""
    import torch.nn.functional as F
    from tpu_sgp_torch.ops import psf_operator as op
    from tpu_sgp_torch.simulate import gaussian_psf, moffat_psf

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    rng = np.random.default_rng(400)
    for size in (31, 64):
        psf = gaussian_psf(size, 2.8)
        x = rng.uniform(0.0, 100.0, (8, size, size))
        y = rng.uniform(0.0, 100.0, (8, size, size))
        for name, tol in FFT_TOL.items():
            t = lambda a: torch.as_tensor(a, dtype=getattr(torch, name),
                                          device='cuda')
            A, AT = op.make_operator(t(psf), (size, size), 'otf')
            A_d, AT_d = op.make_operator(t(psf), (size, size), 'matmul')
            ra, rat = rel(A(t(x)), A_d(t(x))), rel(AT(t(x)), AT_d(t(x)))
            lhs = (A(t(x)) * t(y)).sum((1, 2)).double()
            rhs = (t(x) * AT(t(y))).sum((1, 2)).double()
            adj = float(((lhs - rhs).abs() / lhs.abs()).max())
            print(f'operator otf vs dense {size}x{size} {name}: A {ra:.3e} '
                  f'AT {rat:.3e} (limit {tol:.0e}), <Ax,y> vs <x,ATy> '
                  f'{adj:.3e}')
            check(max(ra, rat) <= tol, f"'otf' {name} equals the dense "
                  f'circulant')
            check(adj <= 10 * tol, f"'otf' {name}: AT is the adjoint")

    img, _ = frame_inputs()
    shape = img.shape
    x = np.stack([img, rng.uniform(0.0, 100.0, shape)])
    for label, psf in (('31x31', gaussian_psf(31, 3.0)),
                       ('9x13', moffat_psf(13, 3.0)[2:11] * 1.7)):
        kh, kw = psf.shape
        for name, tol in FFT_TOL.items():
            dtype = getattr(torch, name)
            t = lambda a, dev='cuda': torch.as_tensor(a, dtype=dtype,
                                                      device=dev)
            A, AT = op.make_operator(t(psf), shape, 'auto')
            A_c, AT_c = op.make_operator(t(psf, 'cpu'), shape, 'auto')
            ga, gat = A(t(x)), AT(t(x))
            check(ga.dtype == dtype and tuple(ga.shape) == x.shape,
                  "'linear' keeps dtype and shape")
            ca = rel(ga.cpu(), A_c(t(x, 'cpu')))
            cat = rel(gat.cpu(), AT_c(t(x, 'cpu')))
            # the direct sum, float64 on the card: a correlation with the
            # flipped unit-sum kernel, zero padding of half the kernel
            k = torch.as_tensor(psf / psf.sum(), dtype=torch.float64,
                                device='cuda')
            direct = F.conv2d(t(x).double()[:, None], k.flip(0, 1)[None, None],
                              padding=(kh // 2, kw // 2))[:, 0]
            da = rel(ga.double(), direct)
            rows = A(t(x).reshape(2, -1))
            check(torch.equal(rows, ga.reshape(2, -1)),
                  "'linear' on rows equals 'linear' on images")
            print(f'operator linear 410x410 psf {label} {name}: A vs direct '
                  f'convolution {da:.3e}, card vs cpu A {ca:.3e} AT '
                  f'{cat:.3e} (limit {tol:.0e})')
            check(da <= max(tol, 1e-11), "'linear' equals the direct "
                  'zero-padded convolution')
            check(max(ca, cat) <= tol, "'linear' on the card equals the CPU")

    psf = torch.as_tensor(gaussian_psf(31, 2.8), dtype=torch.float32,
                          device='cuda')
    xs = torch.as_tensor(rng.uniform(0.0, 100.0, (64, N_PIX)),
                         dtype=torch.float32, device='cuda')
    exact = op.make_operator(psf.double(), (N_PIX,), 'matmul_flat')
    split = op.make_operator(psf, (N_PIX,), 'matmul_split')
    errs = [rel(s_(xs).double(), e_(xs.double()))
            for s_, e_ in zip(split, exact)]
    flat = op.make_operator(psf, (N_PIX,), 'matmul_flat')
    ms_split = time_ms(torch, lambda: split[1](split[0](xs)))
    ms_flat = time_ms(torch, lambda: flat[1](flat[0](xs)))
    print(f'operator matmul_split vs matmul_flat (64, {N_PIX}) float32: A '
          f'{errs[0]:.3e} AT {errs[1]:.3e} (limit 2^-15 = {2 ** -15:.3e}); '
          f'pair {ms_split:.4f} ms against {ms_flat:.4f} ms')
    check(max(errs) <= 2.0 ** -15, "'matmul_split' within 2^-15")

    # the padded size: 410 + 31 - 1 = 440 is the least, 448 the 7-smooth
    # size the operator takes
    psf = torch.as_tensor(gaussian_psf(31, 3.0), dtype=torch.float32,
                          device='cuda')
    x1 = torch.as_tensor(img[None], dtype=torch.float32, device='cuda')
    parts, base = [], None
    for size in (440, 448, 480, 512):
        A, AT = op.make_linear_operator(psf, shape, pad_to=(size, size))
        ms = time_ms(torch, lambda: AT(A(x1)), reps=50)
        got = AT(A(x1))
        base = got if base is None else base
        check(rel(got, base) <= 1e-5, 'the padded size leaves the result')
        parts.append(f'{size}: {ms:.4f} ms')
    check(op._good_fft_size(440) == 448, 'the 7-smooth rule takes 448')
    print("operator pair time 'linear' (1, 410, 410) float32 psf 31x31, "
          'AT(A(x)) by padded size: ' + ', '.join(parts))


def phase_frame(torch, card: str) -> int:
    """Phase 15: the whole-frame path. Returns the launches of K1 (all on
    the grid path) in one 200-iteration ``solve`` with 'pallas'."""
    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch.kernels.flux_projection import project_rows
    img, psf = frame_inputs()

    # the facade: numpy in, numpy out, the card by default, cold 'bisect'
    kw = dict(init_recon=2, proj_type=1, stop_criterion=3, MAXIT=500,
              tol_convergence=1e-5)
    tsgp.sgp(img, psf, FRAME_BKG, **dict(kw, MAXIT=3))          # warm-up
    x, iters, discr, times, err = tsgp.sgp(img, psf, FRAME_BKG, **kw)
    check(isinstance(x, np.ndarray) and x.dtype == np.float32
          and err is None and discr.shape == times.shape == (iters + 1,),
          'sgp returns the reference\'s tuple')
    flux = check_frame(torch, x, img, 'sgp 410x410')
    print(f'frame sgp 410x410 psf 31x31 float32 (linear, cold bisect, stop '
          f'3 at 1e-5): iters={iters} wall={times[-1]:.4f} s '
          f'({times[-1] * 1e3 / max(iters, 1):.3f} ms an iteration) flux rel '
          f'err={flux:.3e} [{card}]')

    launches = None
    for method in ('bisect', 'pallas'):
        cfg_t = tsgp.SGPConfig(**FRAME_TIMED, projection_method=method)
        cfg_c = tsgp.SGPConfig(**FRAME_CONVERGED, projection_method=method)
        solve_frame(torch, img, psf, cfg_t.replace(max_iter=3))  # warm-up
        project_rows.launches = project_rows.grid_launches = 0
        res_t, wall_t = solve_frame(torch, img, psf, cfg_t)
        counts = project_rows.launches, project_rows.grid_launches
        res_c, wall_c = solve_frame(torch, img, psf, cfg_c)
        it_t, it_c = int(res_t.iters[0]), int(res_c.iters[0])
        check(res_t.x.is_cuda and it_t == 200, f'{method}: 200 iterations on '
              f'the card')
        flux = max(check_frame(torch, res_t.x, img, f'frame {method} timed'),
                   check_frame(torch, res_c.x, img, f'frame {method} '
                               f'converged'))
        if method == 'pallas':
            launches = counts[0]
            check(counts == (it_t + 1, it_t + 1),
                  f'the kernel ran once a projection, each on the grid path '
                  f'(launches, grid launches = {counts})')
        else:
            check(counts == (0, 0), "'bisect' launches no kernel")
        print(f'frame solve 410x410 float32 {method} (warm={method == "bisect"}'
              f'): {wall_t * 1e3 / it_t:.3f} ms an iteration at 200 fixed '
              f'iterations (wall {wall_t:.4f} s); stop 3 at 1e-5: iters='
              f'{it_c} wall={wall_c:.4f} s; K1 launches={counts[0]} (grid '
              f'path {counts[1]}); flux rel err={flux:.3e} [{card}]')

    cfg_p = tsgp.SGPConfig(**dict(FRAME_TIMED, max_iter=50),
                           projection_method='pallas')
    for method in ('pallas', 'bisect'):
        cfg = cfg_p.replace(projection_method=method)
        wall, busy, events, top = profile_call(
            torch, lambda: solve_frame(torch, img, psf, cfg))
        print(f'frame {method} profile 410x410, 50 iterations: wall '
              f'{wall:.4f} s (profiled), card busy {busy:.3f} ms '
              f'({100 * busy / (wall * 1e3):.1f} % of the wall), {events} '
              f'device events ({events / 50:.1f} an iteration); most device '
              f'time: {top}')

    oimg, opsf = otf_frame_inputs()
    kw = dict(init_recon=2, proj_type=1, stop_criterion=3, MAXIT=500,
              tol_convergence=1e-5)
    tsgp.sgp(oimg, opsf, FRAME_BKG, **dict(kw, MAXIT=3))        # warm-up
    x, iters, _, times, _ = tsgp.sgp(oimg, opsf, FRAME_BKG, **kw)
    flux = check_frame(torch, x, oimg, 'sgp 256x256 otf')
    x1, it1, _, t1, _ = tsgp.sgp(oimg, opsf, FRAME_BKG,
                                 **dict(kw, stop_criterion=1, MAXIT=200))
    check_frame(torch, x1, oimg, 'sgp 256x256 otf timed')
    print(f'frame sgp 256x256 psf 256x256 float32 (otf, cold bisect): '
          f'{t1[-1] * 1e3 / it1:.3f} ms an iteration at {it1} fixed '
          f'iterations; stop 3 at 1e-5: iters={iters} wall={times[-1]:.4f} s '
          f'flux rel err={flux:.3e} [{card}]')

    x, iters, _, times, _ = tsgp.sgp_beta_div(img, psf, FRAME_BKG,
                                              schedule_lr=True, **kw)
    flux = check_frame(torch, x, img, 'sgp_beta_div 410x410')
    print(f'frame sgp_beta_div 410x410 float32 (linear, cold bisect, beta0 '
          f'1.005, stop 3 at 1e-5): iters={iters} wall={times[-1]:.4f} s '
          f'flux rel err={flux:.3e} [{card}]')
    return launches


def phase_frame_vs_cpu(torch) -> None:
    """Phase 16: the 410x410 solve on the card against the CPU. float64,
    stop rule 3 at 1e-5: equal iterations, x within 1e-7 of max|x|, with
    the warm 'bisect' (plain PyTorch on both) and with 'pallas' (the kernel
    against its plain version). float32 against float64 on the card at
    fixed iteration counts, in relative L2: within 1e-3 after 10
    iterations; the distance after 25 and 50 is printed and not held,
    because the iteration amplifies a rounding difference about tenfold
    every ten iterations in the JAX package too (PERF.md), and float32
    stop-rule-3 counts move with roundoff (bench.py:390-393), so none is
    compared."""
    import tpu_sgp_torch as tsgp
    img, psf = frame_inputs()
    for method in ('bisect', 'pallas'):
        cfg = tsgp.SGPConfig(**dict(FRAME_CONVERGED, dtype='float64'),
                             projection_method=method)
        gpu, _ = solve_frame(torch, img, psf, cfg)
        cpu, wall = solve_frame(torch, img, psf, cfg, device='cpu')
        rel = float((gpu.x.cpu() - cpu.x).abs().max() / cpu.x.abs().max())
        check_frame(torch, gpu.x, img, f'float64 {method}', 'float64')
        print(f'frame card vs cpu 410x410 float64 {method} stop 3: iters '
              f'{int(gpu.iters[0])} vs {int(cpu.iters[0])}, max|dx|/max|x|='
              f'{rel:.3e} (limit 1e-07); cpu wall {wall:.2f} s')
        check(int(gpu.iters[0]) == int(cpu.iters[0]),
              f'float64 {method}: equal iterations on card and CPU')
        check(rel <= 1e-7, f'float64 {method}: x agrees to 1e-7')
        parts = []
        for iters in F32_ITERS:
            cfg_n = tsgp.SGPConfig(**dict(FRAME_TIMED, max_iter=iters),
                                   projection_method=method)
            x32 = solve_frame(torch, img, psf, cfg_n)[0].x.double()
            x64 = solve_frame(torch, img, psf,
                              cfg_n.replace(dtype='float64'))[0].x
            l2 = float(((x32 - x64) ** 2).sum().sqrt()
                       / (x64 ** 2).sum().sqrt())
            parts.append(f'{iters}: {l2:.3e}')
            if iters == F32_ITERS[0]:
                check(l2 <= 1e-3, f'float32 {method} within 1e-3 of float64 '
                      f'after {iters} iterations')
        print(f'frame float32 vs float64 410x410 {method}, relative L2 by '
              f'fixed iterations (limit 1e-03 at {F32_ITERS[0]}): '
              + ', '.join(parts))


def phase_classic_checkpoint(torch) -> None:
    """Phase 17: Richardson-Lucy (30 updates) and Wiener on the 410x410 and
    256x256 frames, card against CPU in float64 (1e-10 of max|x|) and
    timed in float32; ``solve_checkpointed`` on the card, a checkpoint
    every 7 iterations, equal to the uninterrupted solve."""
    import tempfile

    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch.solvers.checkpoint import (load_state,
                                                  solve_checkpointed)
    img, psf = frame_inputs()
    oimg, opsf = otf_frame_inputs()
    rl = lambda dev, dt: tsgp.richardson_lucy(img, psf, FRAME_BKG, 30,
                                              dtype=dt, device=dev)
    wi = lambda dev, dt: tsgp.wiener(oimg, opsf, 1e-3, dtype=dt, device=dev)
    for name, fn in (('richardson_lucy 410x410 (linear, 30 updates)', rl),
                     ('wiener 256x256', wi)):
        got, want = fn('cuda', torch.float64), fn('cpu', torch.float64)
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        check(got.is_cuda and bool(torch.isfinite(got).all()),
              f'{name}: finite on the card')
        ms = time_ms(torch, lambda: fn('cuda', torch.float32), reps=5)
        print(f'{name}: card vs cpu float64 max|dx|/max|x|={rel:.3e} (limit '
              f'1e-10); float32 {ms:.3f} ms a call on the card')
        check(rel <= 1e-10, f'{name}: card agrees with the CPU')

    cfg = tsgp.SGPConfig(**dict(FRAME_CONVERGED, dtype='float64',
                                max_iter=40))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device='cuda')
    gn = t(img[None])
    z = torch.zeros_like(gn)
    args = (gn, t(psf), torch.full_like(gn, FRAME_BKG), z, 0.0, z, 1.0, 1e-3,
            0.0)
    want = tsgp.solve(*args, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        res, state = solve_checkpointed(*args, cfg, path=f'{tmp}/frame',
                                        every=7)
        saved = load_state(f'{tmp}/frame')
    rel = float((res.x - want.x).abs().max() / want.x.abs().max())
    print(f'solve_checkpointed 410x410 float64 every=7: iters '
          f'{int(res.iters[0])} vs {int(want.iters[0])} uninterrupted, '
          f'max|dx|/max|x|={rel:.3e}; last checkpoint at it='
          f'{int(saved.it[0])} on {saved.x.device.type}')
    check(int(res.iters[0]) == int(want.iters[0]) and rel <= 1e-12,
          'chunked equals uninterrupted')
    check(saved.x.is_cuda and int(saved.it[0]) == int(state.it[0])
          and tuple(saved.x.shape) == (1,) + img.shape,
          'the last checkpoint is the final state, in the frame\'s shape')


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

    first = int(sys.argv[2]) if sys.argv[1:2] == ['--from'] else 2
    phase_build()
    if first > 2:
        for number, phase in ((13, lambda: phase_long_rows(torch)),
                              (14, lambda: phase_operators(torch)),
                              (15, lambda: phase_frame(torch, card)),
                              (16, lambda: phase_frame_vs_cpu(torch)),
                              (17, lambda: phase_classic_checkpoint(torch))):
            if number >= first:
                phase()
        print(f'partial run from phase {first}: no result')
        return 0

    # 3-8
    kernel = phase_kernel(torch, 'cuda')
    launches, unfused_wall, unfused_iters = phase_main_path(torch, card)
    phase_card_vs_cpu(torch)
    phase_k2_vs_plain(torch)
    k2, applications = phase_k2_full(torch, card, unfused_wall,
                                     unfused_iters)
    phase_operator(torch, k2['ms'], applications)

    # 9-12
    phase_methods(torch)
    for path in ('kl bisect', 'beta section'):
        phase_path(torch, card, path, unfused_wall)
    for path in ('kl bisect', 'beta section'):
        phase_card_vs_cpu(torch, path)

    # 13-17
    long_row = phase_long_rows(torch)
    phase_operators(torch)
    frame_launches = phase_frame(torch, card)
    phase_frame_vs_cpu(torch)
    phase_classic_checkpoint(torch)

    k1 = {'route': 'cuda', 'source': 'tpu_sgp_torch/csrc/flux_projection.cu',
          'replaces': 'tpu_sgp/experimental/pallas_projection.py:40'}
    print(json.dumps({'kernels': [{
        'name': 'flux_projection', **k1, 'launches': launches, **kernel}, {
        'name': 'flux_projection_long_row', **k1,
        'launches': frame_launches, **long_row}, {
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
