#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--from N]

With ``--from N`` (13 to 28) phases 3 to N - 1 are skipped and no result is
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
     solve;
 18. serving, one request: ``RestorationSession(psf)`` (its default
     configuration) warmed for bucket 256, 25 calls of ``restore`` on 256
     stamps (p50, min, max), bit-equal to ``restore_stamps``; the same with
     ``projection_method='pallas'``, the projection kernel's launches for
     one request and for four requests coalesced into one 1024-stamp call;
     the kernel against its plain version at those two shapes;
 19. serving, a stream: 16 requests of 256 through ``restore_stream`` at
     coalesce 1 and 4, as float32, with uint16 ingest, and with uint16
     ingest and egress (stamps/s, best of 3; bytes a request each way);
     every result against ``restore`` of its request or of its group;
 20. ``MicroBatchServer``: 64 client threads of 16 stamps each, every
     result against ``session.restore`` of the client's own stamps;
 21. one 12288-stamp request through ``session.restore`` with compaction,
     bit-equal to phase 10's ``restore_stamps``;
 22. ``beta_init_search`` with its default ``'catalog'`` scorer on 256
     stamps: the host catalog's seconds beside the solve's, which
     deblender ran, and the card's choice against the CPU's in float64;
 23. ``save=True`` on a 64x64 frame: the FITS files of three iterations;
 24. the star-stamp application, ``workloads.star_stamps.run`` at its
     defaults (256 stamps, KL and beta): its wall split into the host
     catalog's and the card's seconds, iterations, flux, the metric arrays;
     64 stamps in float64 on the card against the CPU;
 25. the subdivision application, ``workloads.subdivisions.run()`` at its
     defaults (the crowded 410x410 frame, KL and the beta candidate
     search), the same split; float64 at ``maxit=20`` against the CPU;
 26. the spatial-PSF application, ``restore_with_spatial_psf`` on a
     2048x2048 frame in 100x100 tiles, a local PSF each from a seeded DIAPL
     model, one batch: tiles, renderer, peak device memory; a 256x256 cut
     in float64 against the CPU;
 27. the simulation application, ``workloads.simulation.run_all`` on
     seeded 255x255 fixtures in the SGP-dec layout, card against CPU;
 28. the ``sgp`` command line, ``cli.main`` on a 410x410 FITS pair with a
     TAN WCS header, whole-image and ``--use_subdiv``.

Then a JSON line of the kernels, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It exits non-zero without a GPU.
"""
from __future__ import annotations

import functools
import json
import os
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
    for rows in (MAIN_B, COMPACTION['tail_bucket']):
        timed = k1_times(torch, rows, device)
        if rows == MAIN_B:
            main = dict(max_abs_err=main_err, **timed, library_ms=None)
    return main


def k1_times(torch, rows: int, device='cuda') -> dict:
    """K1 and its plain version timed at (rows, 961) float32 with
    saturation, beside the bound for that shape."""
    from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                       project_rows_plain)
    from tpu_sgp_torch.projection.flux_projection import section_steps
    steps = section_steps(torch.float32)
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
    return dict(ms=ms, plain_ms=plain_ms, **k1_bound)


@functools.lru_cache(maxsize=2)
def main_path_inputs(b: int):
    """Seeded stamps of the main path (cached: callers only read them)."""
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


def phase_path(torch, card: str, path: str, pallas_wall: float) -> tuple:
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
    return res, wall


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


# phases 18-21: the JAX bench's serving shapes (bench.py:44-45, :454-533):
# 256-stamp requests, 16 a stream, coalesce 1 and 4, buckets 256 and 1024
SERVE_B = 256
STREAM_REQUESTS = 16
COALESCE = (1, 4)
SERVER_CLIENTS, CLIENT_B = 64, 16


def lane_rel(got, want) -> np.ndarray:
    """Per-lane max|got - want| / max|want| of two (B, ...) arrays."""
    axes = tuple(range(1, want.ndim))
    return (np.abs(got - want).max(axis=axes)
            / np.abs(want).max(axis=axes))


def results_equal(a, b) -> bool:
    """Two host-side SGPResults equal bit for bit in x, iterations and the
    scalars a request gets back."""
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ('x', 'iters', 'fv', 'beta', 'scaling'))


def iters_close(got, want, what: str) -> str:
    """float32 iteration counts of two runs whose sums round differently,
    held as distributions (equal medians, mean |diters| <= 1)."""
    got, want = np.asarray(got, int), np.asarray(want, int)
    diff = np.abs(got - want)
    check(np.median(got) == np.median(want), f'{what}: equal median iterations')
    check(diff.mean() <= 1.0, f'{what}: mean |diters| <= 1')
    return (f'iters median {np.median(got):g} vs {np.median(want):g}, mean '
            f'|diters|={diff.mean():.4f}, lanes of equal iterations '
            f'{int((diff == 0).sum())}/{diff.size}')


def serving_requests(n_requests: int, size: int):
    """``n_requests`` requests of ``size`` stamps cut from the main path's
    stamps: (stamps, bkgs, fluxes) tuples in float64, as float32 and as
    uint16 (the stamps are Poisson counts below 65536, so all three hold
    the same values)."""
    stamps, psf, bkgs, fluxes = main_path_inputs(MAIN_B)
    check(stamps.max() < 65536 and bool((stamps == np.floor(stamps)).all()),
          'the stamps are counts that fit uint16')
    cut = lambda a, i: a[i * size:(i + 1) * size]
    out = {}
    for name, dtype in (('float64', np.float64), ('float32', np.float32),
                        ('uint16', np.uint16)):
        out[name] = [(cut(stamps, i).astype(dtype), cut(bkgs, i),
                      cut(fluxes, i)) for i in range(n_requests)]
    return psf, out


def phase_session(torch, card: str) -> dict:
    """Phase 18: one 256-stamp request through ``RestorationSession``: the
    default configuration (cold 'bisect'), then 'pallas'. 25 calls of
    ``restore`` after ``warmup(buckets=(256,))``: p50, min and max of the
    host's wall; finite, flux within 1e-4, and bit-equal to
    ``restore_stamps(bucket=True, flatten=True)`` on the same stamps. On
    the 'pallas' session the kernel's launches are counted for one request
    and for four requests coalesced into one 1024-stamp call; the kernel
    is held against its plain version and timed at both shapes."""
    from tpu_sgp_torch import SGPConfig, restore_stamps
    from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                       project_rows_plain)
    from tpu_sgp_torch.parallel.session import RestorationSession
    from tpu_sgp_torch.projection.flux_projection import section_steps
    psf, reqs = serving_requests(4, SERVE_B)
    stamps, bkgs, fluxes = reqs['float64'][0]
    launches = {}
    for method, cfg in (('bisect', None), ('pallas', SGPConfig(**BENCH_CFG))):
        sess = RestorationSession(psf, cfg)
        check(sess.device.type == 'cuda' and sess.psf.is_cuda
              and sess.flatten, 'the session lies on the card, flat rows')
        sess.warmup(buckets=(SERVE_B, 4 * SERVE_B))
        walls = []
        for i in range(25):
            if i == 0:
                project_rows.launches = 0
            t0 = time.perf_counter()
            res = sess.restore(stamps, bkgs, fluxes)
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches[SERVE_B] = project_rows.launches
        want = restore_stamps(stamps, psf, bkgs, sess.cfg, fluxes=fluxes,
                              beta0=sess.beta0, sat_level=SAT_LEVEL,
                              bucket=True, flatten=True)
        check(bool(np.isfinite(res.x).all()) and res.x.dtype == np.float32
              and res.x.shape == stamps.shape, 'finite float32 stamps')
        flux_err = float(np.abs(res.x.sum(axis=(1, 2), dtype=np.float64)
                                / fluxes - 1).max())
        check(flux_err <= FLUX_RTOL['float32'], 'every stamp conserves flux')
        same = (np.array_equal(res.x, want.x.cpu().numpy())
                and np.array_equal(res.iters, want.iters.cpu().numpy()))
        extra = ''
        if method == 'pallas':
            project_rows.launches = 0
            outs = list(sess.restore_stream(reqs['float64'], coalesce=4))
            launches[4 * SERVE_B] = project_rows.launches
            check(len(outs) == 4 and launches[SERVE_B] > 0
                  and launches[4 * SERVE_B] > 0,
                  'the serving path launched the projection kernel')
            extra = (f', kernel launches {launches[SERVE_B]} a request, '
                     f'{launches[4 * SERVE_B]} a coalesced call of '
                     f'{4 * SERVE_B}')
        else:
            check(launches[SERVE_B] == 0, "'bisect' launches no kernel")
        print(f'session p50 B={SERVE_B} float32 {method}: p50='
              f'{np.median(walls):.3f} ms min={min(walls):.3f} max='
              f'{max(walls):.3f} over 25 calls, iters median='
              f'{np.median(res.iters):g} max={res.iters.max()}, flux rel '
              f'err={flux_err:.3e}, bit-equal to restore_stamps: {same}'
              f'{extra} [{card}]')
        check(same, 'the session equals restore_stamps bit for bit')

    # the kernel at the serving path's two shapes, against its plain version
    entries = {}
    steps = section_steps(torch.float32)
    for rows in (SERVE_B, 4 * SERVE_B):
        b, c, dia, cap = projection_case(torch, rows, N_PIX, torch.float32,
                                         True, 'cuda', 180 + rows)
        got = project_rows(b, c, dia, cap, steps, True)
        want = project_rows_plain(b, c, dia, cap, steps, True)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        print(f'kernel ({rows}, {N_PIX}) float32 has_sat=True: max|dx|/max|x|'
              f'={rel:.3e} (limit {KERNEL_TOL["float32"]:.0e})')
        check(rel <= KERNEL_TOL['float32'], 'kernel agrees with plain')
        entries[rows] = dict(launches=launches[rows], max_abs_err=abs_err,
                             **k1_times(torch, rows), library_ms=None)
    return entries


def phase_stream(torch, card: str) -> None:
    """Phase 19: 16 requests of 256 through ``restore_stream`` at coalesce
    1 and 4, on three wires: float32 both ways, uint16 ingest, uint16
    ingest and egress. Stamps/s is the best of 3 walls around the whole
    stream. Each result is held against ``restore`` through the same
    bucket: at coalesce 1 the request alone, at coalesce 4 its group of
    four in one call (bit for bit; with uint16 egress every pixel within
    max(x)/131070 plus float32 roundoff, iterations equal). A coalesced
    request against the same request alone is held as a distribution:
    cuBLAS rounds a row differently in another batch size. Also: the
    stream against a plain loop of ``restore`` calls, and lookahead 1
    against 2."""
    from tpu_sgp_torch.parallel.session import RestorationSession, \
        _split_result
    psf, reqs = serving_requests(STREAM_REQUESTS, SERVE_B)
    n_stamps = STREAM_REQUESTS * SERVE_B
    exact = RestorationSession(psf, ingest_dtypes=('float32', 'uint16'))
    packed = RestorationSession(psf, ingest_dtypes=('uint16',),
                                egress_dtype='uint16')
    buckets = tuple(c * SERVE_B for c in COALESCE)
    exact.warmup(buckets=buckets)
    packed.warmup(buckets=buckets)

    # references through the same bucket, fed float32
    ref = {1: [exact.restore(*r) for r in reqs['float32']]}
    ref[4] = []
    for g in range(0, STREAM_REQUESTS, 4):
        sizes, stamps, bkgs, fluxes, beta0 = exact._coalesce_group(
            reqs['float32'][g:g + 4])
        ref[4] += _split_result(exact.restore(stamps, bkgs, fluxes, beta0),
                                sizes)
    print('stream coalesced vs alone float32: ' + iters_close(
        np.concatenate([r.iters for r in ref[4]]),
        np.concatenate([r.iters for r in ref[1]]), 'coalesced vs alone')
        + f', requests bit-equal '
        f'{sum(results_equal(a, b) for a, b in zip(ref[4], ref[1]))}'
        f'/{STREAM_REQUESTS}')

    t0 = time.perf_counter()
    for r in reqs['float32']:
        exact.restore(*r)
    loop_wall = time.perf_counter() - t0

    for wire, sess, kind in (('float32', exact, 'float32'),
                             ('u16 ingest', exact, 'uint16'),
                             ('u16 ingest+egress', packed, 'uint16')):
        up = sess._pack_request(*reqs[kind][0], None)[0].nbytes
        down = SERVE_B * ((N_PIX + 10) * 2 if sess.egress_dtype == 'uint16'
                          else (N_PIX + 4) * 4)
        for coalesce in COALESCE:
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                outs = list(sess.restore_stream(iter(reqs[kind]),
                                                coalesce=coalesce))
                walls.append(time.perf_counter() - t0)
            check(len(outs) == STREAM_REQUESTS, 'one result a request')
            worst = 0.0
            for got, want in zip(outs, ref[coalesce]):
                if sess.egress_dtype == 'uint16':
                    top = want.x.reshape(SERVE_B, -1).max(axis=1)
                    err = np.abs(got.x - want.x).reshape(SERVE_B, -1).max(1)
                    worst = max(worst, float((err / top).max()))
                    check(bool((err <= top / 131070.0 + 1e-6 * top).all())
                          and np.array_equal(got.iters, want.iters),
                          'u16 egress within max(x)/131070 a pixel')
                else:
                    check(results_equal(got, want),
                          f'{wire} coalesce {coalesce}: bit-equal to restore')
            held = (f'max err/max(x)={worst:.3e} (limit 7.63e-06 + 1e-06)'
                    if sess.egress_dtype == 'uint16' else 'bit-equal')
            print(f'stream {wire} coalesce={coalesce}: {STREAM_REQUESTS} x '
                  f'{SERVE_B} stamps, best wall {min(walls):.4f} s of '
                  f'{", ".join(f"{w:.4f}" for w in walls)}, stamps/s='
                  f'{n_stamps / min(walls):.1f}; {up} B up, {down} B down a '
                  f'request; against restore through the same bucket: {held} '
                  f'[{card}]')
    walls = {}
    for lookahead in (1, 2):
        t0 = time.perf_counter()
        list(exact.restore_stream(iter(reqs['float32']), lookahead=lookahead))
        walls[lookahead] = time.perf_counter() - t0
    print(f'stream float32 coalesce=1: a loop of restore() {loop_wall:.4f} s, '
          f'lookahead=1 {walls[1]:.4f} s, lookahead=2 {walls[2]:.4f} s')


def phase_server(torch, card: str) -> None:
    """Phase 20: 64 client threads, released together, each submitting 16
    stamps to a ``MicroBatchServer`` (max_batch 1024, 2 ms window). Every
    future's result against ``session.restore`` of the client's own 16
    stamps: float32 as distributions over all 1024 lanes (a row of the
    dense product rounds differently in a batch of 16 than in one of 1024
    on cuBLAS, so bit-equality is reported, not required); the first 16
    clients again on a float64 session, lane for lane (equal iterations,
    x within 1e-7)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.parallel.session import (MicroBatchServer,
                                                RestorationSession)
    psf, reqs = serving_requests(SERVER_CLIENTS, CLIENT_B)
    for dtype, clients in (('float32', SERVER_CLIENTS), ('float64', 16)):
        sess = RestorationSession(psf, SGPConfig(**dict(KL_CFG, dtype=dtype)))
        sess.warmup(max_batch=clients * CLIENT_B)
        gate = threading.Barrier(clients + 1)

        def client(i):
            gate.wait()
            return srv.restore(*reqs['float64'][i])

        with MicroBatchServer(sess, max_batch=1024, max_delay_s=0.002) as srv:
            with ThreadPoolExecutor(clients) as pool:
                futs = [pool.submit(client, i) for i in range(clients)]
                gate.wait()
                t0 = time.perf_counter()
                outs = [f.result(timeout=300) for f in futs]
                wall = time.perf_counter() - t0
            served, batches = srv.requests_served, srv.batches_served
        check(served == clients and batches < clients,
              'every request served, in shared device calls')
        alone = [sess.restore(*reqs['float64'][i]) for i in range(clients)]
        it_got = np.concatenate([o.iters for o in outs])
        it_want = np.concatenate([a.iters for a in alone])
        rel = np.concatenate([lane_rel(o.x, a.x)
                              for o, a in zip(outs, alone)])
        equal = sum(results_equal(o, a) for o, a in zip(outs, alone))
        if dtype == 'float64':
            check(np.array_equal(it_got, it_want) and rel.max() <= 1e-7,
                  'float64: equal iterations, x within 1e-7')
            held = f'iterations equal, max rel |dx|={rel.max():.3e}'
        else:
            held = (iters_close(it_got, it_want, 'server vs alone')
                    + f', rel |dx| median={np.median(rel):.3e} '
                    f'p95={np.percentile(rel, 95):.3e}')
        print(f'server {dtype}: {clients} clients x {CLIENT_B} stamps in '
              f'{batches} device calls, wall {wall:.4f} s, requests/s='
              f'{clients / wall:.1f}, stamps/s={clients * CLIENT_B / wall:.1f}'
              f'; against session.restore alone: requests bit-equal {equal}/'
              f'{clients}, {held} [{card}]')


def phase_big_request(torch, card: str, ref=None) -> None:
    """Phase 21: all 12288 stamps as one request through
    ``session.restore`` with phase 10's configuration and compaction
    (26/2048): iterations and x equal to phase 10's ``restore_stamps``
    result bit for bit (``ref``; computed here when not given), and the
    wall (median of 3) beside phase 10's."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.parallel.session import RestorationSession
    inputs = main_path_inputs(MAIN_B)
    stamps, psf, bkgs, fluxes = inputs
    if ref is None:
        restore(torch, inputs, 'cuda', path='kl bisect')     # warm-up
        t0 = time.perf_counter()
        want = restore(torch, inputs, 'cuda', path='kl bisect')
        ref = (want, time.perf_counter() - t0)
    want, want_wall = ref
    sess = RestorationSession(psf, SGPConfig(**KL_CFG), beta0=1.0,
                              **COMPACTION)
    sess.warmup(buckets=(MAIN_B,))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = sess.restore(stamps, bkgs, fluxes)
        walls.append(time.perf_counter() - t0)
    same_it = np.array_equal(res.iters, want.iters.cpu().numpy())
    same_x = np.array_equal(res.x, want.x.cpu().numpy())
    print(f'session one request B={MAIN_B} kl bisect compaction 26/2048: wall '
          f'median={np.median(walls):.4f} s (runs '
          f'{", ".join(f"{w:.4f}" for w in walls)}) stamps/s='
          f'{MAIN_B / np.median(walls):.1f}; restore_stamps wall '
          f'{want_wall:.4f} s; iterations equal: {same_it}, x bit-equal: '
          f'{same_x} [{card}]')
    check(same_it and same_x, 'the session equals restore_stamps')


def phase_catalog(torch, card: str) -> None:
    """Phase 22: ``beta_init_search`` with its default arguments (the
    'catalog' scorer, the five seeded candidates) on 256 stamps, phase
    11's beta configuration with ``max_iter`` cut to 25. Prints the call's
    wall, the host seconds of ``brightest_catalog_fluxes`` over the 1280
    restorations, and which deblender ran. Then the same call in float64
    on the card and on the CPU."""
    from tpu_sgp_torch import (SGPConfig, beta_init_search,
                               default_beta_candidates)
    from tpu_sgp_torch.catalog import brightest_catalog_fluxes, native
    psf, reqs = serving_requests(1, SERVE_B)
    stamps, bkgs, fluxes = reqs['float64'][0]
    cfg = dict(BETA_CFG, max_iter=25)
    search = lambda dtype, **kw: beta_init_search(
        stamps, psf, bkgs, SGPConfig(**dict(cfg, dtype=dtype)),
        fluxes=fluxes, sat_level=SAT_LEVEL, **kw)
    deblender = 'C++' if native.available() else 'NumPy'
    search('float32')                                        # warm-up
    t0 = time.perf_counter()
    best, best_x, grid = search('float32')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cands = default_beta_candidates().astype(np.float32)
    check(best.is_cuda and bool(np.isin(best.cpu().numpy(), cands).all())
          and bool(torch.isfinite(best_x).all()),
          'beta from the five candidates, finite winners')
    x_host = grid.x.cpu().numpy()
    t0 = time.perf_counter()
    scores = brightest_catalog_fluxes(x_host)
    host_s = time.perf_counter() - t0
    picks = np.bincount(np.searchsorted(np.sort(cands), best.cpu().numpy()),
                        minlength=5).tolist()
    print(f'beta_init_search catalog B={SERVE_B} x 5 float32 max_iter=25: '
          f'wall {wall:.4f} s; brightest_catalog_fluxes alone over '
          f'{x_host.shape[0]} restorations {host_s:.4f} s on the host '
          f'({100 * host_s / wall:.1f} % of that wall), deblender '
          f'{deblender}, '
          f'{int(np.isnan(scores).sum())} undetected; picks by candidate '
          f'(ascending beta) {picks} [{card}]')
    # float64, card against CPU. With a flux-conserving projection a single
    # star's brightest segment holds the whole flux under every candidate,
    # so such a stamp's five scores are 0 to rounding and its argmin is a
    # tie: the card's pick is held to score within 1e-6 of the CPU's best
    # on the CPU's own restorations, and the scores themselves to agree.
    gpu_best, _, gpu_grid = search('float64')
    cpu_best, _, cpu_grid = search('float64', device='cpu')
    gpu_best, cpu_best = gpu_best.cpu().numpy(), cpu_best.numpy()
    f_gpu = brightest_catalog_fluxes(gpu_grid.x.cpu().numpy())
    f_cpu = brightest_catalog_fluxes(cpu_grid.x.numpy())
    rel = np.abs(f_gpu - f_cpu) / np.abs(f_cpu)
    ffd = 1.0 - f_cpu.reshape(SERVE_B, 5) / fluxes[:, None]
    pick = np.searchsorted(np.sort(default_beta_candidates()), gpu_best)
    order = np.argsort(default_beta_candidates())
    regret = ffd[np.arange(SERVE_B), order[pick]] - ffd.min(axis=1)
    print(f'beta_init_search catalog card vs cpu float64: same beta on '
          f'{int((gpu_best == cpu_best).sum())}/{SERVE_B} stamps; the '
          f"card's pick scores at most {regret.max():.3e} above the CPU's "
          f'best (limit 1e-06); scores differ by more than 1e-06 relative '
          f'on {int((rel > 1e-6).sum())}/{rel.size} restorations (max '
          f'{rel.max():.3e})')
    check(np.array_equal(gpu_grid.iters.cpu().numpy(),
                         cpu_grid.iters.numpy()),
          'float64: equal per-lane iterations')
    check(regret.max() <= 1e-6, "the card's pick is the CPU's up to ties")
    check((rel > 1e-6).mean() <= 0.01, 'catalog scores agree')


def phase_save(torch) -> None:
    """Phase 23: ``sgp(..., save=True)`` on a 64x64 frame, three fixed
    iterations, in a temporary directory: ``orig.fits`` and one ``rec`` /
    ``res`` pair an iteration (numbered 1 to 3, as the JAX package numbers
    them); the second reconstruction, in working units, is the returned
    x (the solver returns the iterate before its last)."""
    import os
    import tempfile

    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch.image import read_fits
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(64, 64, n_stars=8, psf_size=9,
                                       fwhm=2.5, seed=5)
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            x, iters, *_ = tsgp.sgp(img, psf, FRAME_BKG, init_recon=2,
                                    proj_type=1, stop_criterion=1, MAXIT=3,
                                    save=True, verbose=False)
        finally:
            os.chdir(here)
        names = sorted(os.listdir(os.path.join(tmp, tsgp.solvers.sgp.SAVE_DIR)))
        rec, _ = read_fits(os.path.join(tmp, tsgp.solvers.sgp.SAVE_DIR,
                                        'rec_2.fits'))
    want = ['orig.fits'] + [f'{k}_{i}.fits' for k in ('rec', 'res')
                            for i in (1, 2, 3)]
    rel = float(np.abs(rec * img.max() - x).max() / np.abs(x).max())
    print(f'save=True 64x64 float32, {iters} iterations: {len(names)} files '
          f'({", ".join(names)}); rec_2 * max(gn) against the returned x: '
          f'max|dx|/max|x|={rel:.3e} (limit 1e-06)')
    check(names == want and iters == 3, 'orig and three rec/res pairs')
    check(rec.dtype == np.float32 and rel <= 1e-6,
          'rec_2 is the returned x in working units')


# ---- phases 24-28: the applications -------------------------------------------

class SplitTimer:
    """Exclusive host seconds a category of calls takes inside one
    application run: each wrapped name is replaced in its module for the
    run, a call into the card ends in ``torch.cuda.synchronize()``, and a
    wrapped call inside another is counted to its own category only."""

    def __init__(self, torch, patches):
        self.torch, self.patches = torch, patches
        self.seconds = {kind: 0.0 for _, _, kind in patches}
        self._stack, self._saved = [], []

    def _wrap(self, fn, kind):
        def timed(*args, **kwargs):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if kind == 'card':
                    self.torch.cuda.synchronize()
                return out
            finally:
                total = time.perf_counter() - t0
                self.seconds[kind] += total - self._stack.pop()
                if self._stack:
                    self._stack[-1] += total
        return timed

    def __enter__(self):
        for module, name, kind in self.patches:
            self._saved.append((module, name, getattr(module, name)))
            setattr(module, name, self._wrap(getattr(module, name), kind))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self._saved):
            setattr(module, name, fn)

    def line(self, wall: float) -> str:
        return ', '.join(f'{kind} {s:.4f} s ({100 * s / wall:.1f} %)'
                         for kind, s in self.seconds.items())


def catalog_patches(module) -> list:
    """The host catalog's entry points as ``module`` and the library reach
    them: ``source_info`` / ``source_info_batch`` by the module's own names,
    and ``beta_init_search``'s scorer in its own module."""
    from tpu_sgp_torch.catalog import batched
    return ([(module, name, 'host catalog')
             for name in ('source_info', 'source_info_batch')
             if hasattr(module, name)]
            + [(batched, 'brightest_catalog_fluxes', 'host catalog')])


def iters_line(iters) -> str:
    it = np.asarray(iters)
    return (f'iterations median {np.median(it):g}, p90 '
            f'{np.percentile(it, 90):g}, max {it.max()}, n {it.size}')


def f64_workload(module):
    """``module._workload_cfg`` in float64 (a patch for this run only)."""
    orig = module._workload_cfg
    module._workload_cfg = lambda *a, **k: orig(*a, **k).replace(
        dtype='float64')
    return orig


# phase 24, float64 card against CPU: the catalog metrics within 1e-7 on
# 95 % of the lanes (a catalog is not continuous in x: a pixel at the
# detection threshold moves a segment, 3.5e-4 of FFD on one of 64 lanes
# for restorations 1.5e-11 apart), the radial-profile distance by its
# median (a least-squares fit that stops at its own tolerance)
APP_METRICS = ('FLUX_FRACTIONAL_DIFFERENCE', 'FWHM_RATIO',
               'ELLIPTICITY_RATIO', 'ORIG_FLUX', 'RESTORED_FLUX')


def phase_star_stamps(torch, card: str) -> None:
    """Phase 24: ``star_stamps.run`` at its defaults (256 synthetic stamps,
    ``max_iter=500``, compaction 32, buckets), KL and beta, on the card.
    Its wall split into the host catalog's seconds and the card's
    (gather, scorer, metrics); every restoration finite, flux kept to
    1e-4, the metric arrays written. Then 64 stamps in float64 on the card
    and on the CPU: equal iterations lane for lane, restorations within
    1e-7, the metrics as ``APP_METRICS`` says."""
    import os
    import tempfile

    from tpu_sgp_torch.parallel import batch
    from tpu_sgp_torch.workloads import star_stamps as ss
    for use_beta in (False, True):
        name = 'beta' if use_beta else 'kl'
        seen = {}

        def keep(key, fn):
            def kept(*a, **k):
                seen[key] = fn(*a, **k)
                return seen[key]
            return kept
        gather, info_batch = ss.gather_synthetic, ss.source_info_batch
        ss.gather_synthetic = keep('sset', gather)
        ss.source_info_batch = lambda frames, **kw: (
            seen.__setitem__('x', np.stack(frames)) or info_batch(frames, **kw))
        patches = catalog_patches(ss) + [
            (ss, 'restore_stamps', 'card'), (batch, 'restore_stamps', 'card')]
        try:
            with tempfile.TemporaryDirectory() as out:
                with SplitTimer(torch, patches) as split:
                    t0 = time.perf_counter()
                    metrics = ss.run(use_beta_div=use_beta, out_dir=out)
                    wall = time.perf_counter() - t0
                files = sorted(os.listdir(out))
        finally:
            ss.gather_synthetic, ss.source_info_batch = gather, info_batch
        x, sset = seen['x'], seen['sset']
        flux_err = np.abs(x.sum(axis=(1, 2)) - sset.fluxes) / sset.fluxes
        suffix = '_BETA' if use_beta else ''
        print(f'star_stamps {name} B={len(sset.fluxes)} float32: wall '
              f'{wall:.4f} s; {split.line(wall)}; '
              f'{iters_line(metrics["NUM_ITERS"])}; median FWHM ratio '
              f'{np.median(metrics["FWHM_RATIO"]):.4f}, FFD '
              f'{np.median(metrics["FLUX_FRACTIONAL_DIFFERENCE"]):.4e}; '
              f'max flux error {flux_err.max():.3e}; {len(files)} arrays '
              f'[{card}]')
        check(bool(np.isfinite(x).all()), f'{name}: finite restorations')
        check(flux_err.max() <= FLUX_RTOL['float32'], f'{name}: flux kept')
        check(files == sorted(f'{k}{suffix}.npy' for k in metrics)
              and len(files) == 9, f'{name}: the metric arrays written')
        check(len(metrics['NUM_ITERS']) == len(sset.fluxes) >= 200,
              f'{name}: a metric for every stamp')

        # float64, 64 stamps: the card against the CPU
        orig = f64_workload(ss)
        xs = []
        ss.source_info_batch = lambda frames, **kw: (
            xs.append(np.stack(frames)) or info_batch(frames, **kw))
        try:
            runs = [ss.run(use_beta_div=use_beta, n_synthetic=64, save=False,
                           device=dev) for dev in ('cuda', 'cpu')]
        finally:
            ss._workload_cfg, ss.source_info_batch = orig, info_batch
        (gpu, cpu), (xg, xc) = runs, xs
        rel_x = float(np.abs(xg - xc).max() / np.abs(xc).max())
        lane = {k: np.abs(np.subtract(gpu[k], cpu[k]))
                / np.maximum(np.abs(cpu[k]), 1e-300)
                for k in APP_METRICS + ('WD_RADIAL_PROFILE_DISTANCE',)}
        off = {k: int((lane[k] > 1e-7).sum()) for k in APP_METRICS}
        wd = float(np.median(lane['WD_RADIAL_PROFILE_DISTANCE']))
        print(f'star_stamps {name} card vs cpu float64 B={len(xc)}: '
              f'iterations equal {gpu["NUM_ITERS"] == cpu["NUM_ITERS"]}, x '
              f'{rel_x:.3e}; lanes over 1e-7 by metric {off}, worst '
              + ', '.join(f'{k} {lane[k].max():.3e}' for k in APP_METRICS)
              + f'; radial profile distance median {wd:.3e} (limits: x '
              f'1e-7, 95 % of lanes 1e-7, median 1e-5)')
        check(gpu['NUM_ITERS'] == cpu['NUM_ITERS'],
              f'{name} float64: equal iterations lane for lane')
        check(rel_x <= 1e-7, f'{name} float64: x within 1e-7')
        check(max(off.values()) <= 0.05 * len(xc) and wd <= 1e-5,
              f'{name} float64: the metrics')


def recorded_subdivisions(module, **kw) -> tuple:
    """``module.run(**kw)`` with each solve's (beta, x, iterations) and
    each restoration's catalog flux kept, in call order."""
    solves, fluxes = [], []
    saved = {n: getattr(module, n) for n in ('sgp', 'sgp_beta_div',
                                             'source_info')}

    def solve(fn):
        def kept(*a, **k):
            out = fn(*a, **k)
            solves.append((k.get('betaParam'), out[0], out[1]))
            return out
        return kept

    def info(*a, **k):
        scat, bkg = saved['source_info'](*a, **k)
        if k.get('n_pixels') == 1 and scat is not None:
            fluxes.append(float(np.sum(scat.to_table(['segment_flux'])[
                'segment_flux'].value)))
        return scat, bkg
    module.sgp, module.sgp_beta_div = (solve(saved['sgp']),
                                       solve(saved['sgp_beta_div']))
    module.source_info = info
    try:
        return module.run(**kw), solves, fluxes
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def phase_subdivisions(torch, card: str) -> None:
    """Phase 25: ``subdivisions.run()`` at its defaults (the crowded
    410x410 frame, 400 stars, ``maxit=500``, warm), KL and beta (the
    five-candidate search), on the card: wall, host catalog and card
    seconds, detections. Then ``maxit=20`` in float64 on the card and on
    the CPU: every solve's iterations equal and x within 1e-7. Several
    candidates' catalog fluxes are equal to rounding (the projection
    conserves flux), so the card's pick is held to score within 1e-9 of
    the CPU's best."""
    import os
    import tempfile

    from tpu_sgp_torch.workloads import subdivisions as sd
    for use_beta in (False, True):
        name = 'beta' if use_beta else 'kl'
        patches = catalog_patches(sd) + [(sd, 'sgp', 'card'),
                                         (sd, 'sgp_beta_div', 'card')]
        with tempfile.TemporaryDirectory() as out:
            with SplitTimer(torch, patches) as split:
                t0 = time.perf_counter()
                res = sd.run(use_beta_div=use_beta, out_dir=out)
                wall = time.perf_counter() - t0
            files = sorted(os.listdir(out))
        x = res['restored']
        print(f'subdivisions {name} 410x410 crowded float32: wall '
              f'{wall:.4f} s; {split.line(wall)}; {res["iters"]} '
              f'iterations in {res["wall"]:.4f} s (the timed solve); '
              f'detections {res["n_orig_detections"]} -> '
              f'{res["n_restored_detections"]}, beta {res["best_beta"]}; '
              f'{len(files)} files [{card}]')
        check(bool(np.isfinite(x).all()) and res['n_restored_detections'] > 0,
              f'subdivisions {name}: finite, detections')
        check(len(files) == (7 if use_beta else 6),
              f'subdivisions {name}: the files written')
        kw = dict(use_beta_div=use_beta, dtype='float64', maxit=20,
                  save=False, warm=False)
        (gpu, g_solves, g_flux), (cpu, c_solves, c_flux) = (
            recorded_subdivisions(sd, device=dev, **kw)
            for dev in ('cuda', 'cpu'))
        # every card solve against the CPU's solve at the same beta (the
        # final solve is the pick's, which ties may make another beta)
        on_cpu = {b: (x, it) for b, x, it in c_solves}
        rel = max(float(np.abs(x - on_cpu[b][0]).max()
                        / np.abs(on_cpu[b][0]).max()) for b, x, _ in g_solves)
        same = all(it == on_cpu[b][1] for b, _, it in g_solves) and [
            b for b, _, _ in g_solves[:-1]] == [b for b, _, _ in c_solves[:-1]]
        ffd = 1.0 - np.array(c_flux[:-1]) / float(np.sum(cpu['orig_fluxes']))
        regret = (ffd[[c[0] for c in c_solves[:-1]].index(gpu['best_beta'])]
                  - ffd.min()) if use_beta else 0.0
        print(f'subdivisions {name} card vs cpu float64 maxit=20: '
              f'{len(g_solves)} solves, iterations equal {same}, x '
              f'{rel:.3e} (limit 1e-7); picks {gpu["best_beta"]} / '
              f'{cpu["best_beta"]}, the card\'s scores {regret:.3e} above '
              f'the best (limit 1e-9)')
        check(len(g_solves) == len(c_solves) == (6 if use_beta else 1)
              and same and rel <= 1e-7 and regret <= 1e-9,
              f'subdivisions {name}: card equals CPU in float64')


def seeded_psf_model(origin: float):
    """A two-Gaussian DIAPL model (local degree 2, spatial degree 1) with
    seeded coefficients, whose second component's weight and asymmetry
    drift across the frame, centred on ``origin``."""
    from tpu_sgp_torch.psf import DiaplPSFModel
    rng = np.random.default_rng(0)
    base = np.zeros(12)            # per Gaussian: 1, y, y^2, x, xy, x^2
    base[[0, 6]] = 1.0, 0.3
    base[[1, 3, 7, 9]] = rng.normal(0.0, 2e-3, 4)
    base[[2, 4, 5, 8, 10, 11]] = np.abs(rng.normal(0.0, 1e-4, 6))
    grad_y, grad_x = np.zeros(12), np.zeros(12)
    grad_y[[1, 6]] = 2e-6, -5e-5
    grad_x[[3, 6]] = -3e-6, 1e-4
    return DiaplPSFModel(
        hw=15, ndeg_spat=1, ndeg_local=2, ngauss=2, recenter=1.0,
        cos=float(np.cos(0.3)), sin=float(np.sin(0.3)), ax=-0.32, ay=-0.26,
        sigma_inc=0.7, sigma_mscale=1.0, fitrad=15.0, x_orig=origin,
        y_orig=origin, vec_coeffs=np.concatenate([base, grad_y, grad_x]))


def phase_spatial_psf(torch, card: str) -> None:
    """Phase 26: ``restore_with_spatial_psf`` on a 2048x2048 star field,
    100x100 tiles with overlap 10, a local PSF a tile from a seeded DIAPL
    model, all tiles one batch on the card (its default configuration):
    the tile count, which renderer ran and its seconds, the host
    catalog's and the card's seconds, the peak device memory. Then a
    256x256 cut in float64, ``max_iter=25``, on the card and on the CPU:
    equal iterations, mosaic within 1e-7."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.psf import native
    from tpu_sgp_torch.simulate import synthetic_star_field
    from tpu_sgp_torch.workloads import spatial_psf as sp
    check(native.available(), 'the C++ PSF renderer builds (g++)')
    image, _, _ = synthetic_star_field(2048, 2048, n_stars=2500, seed=26,
                                       flux_range=(3e4, 9e4))
    model = seeded_psf_model(1024.0)
    patches = catalog_patches(sp) + [(sp, 'render_tile_psfs', 'render'),
                                     (sp, 'restore_stamps', 'card')]
    torch.cuda.reset_peak_memory_stats()
    with SplitTimer(torch, patches) as split:
        t0 = time.perf_counter()
        mosaic, info = sp.restore_with_spatial_psf(image, model)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cover = info['footprint'] > 0
    n = len(info['origins'])
    print(f'spatial_psf 2048x2048 {n} tiles of 100x100 (overlap 10), a '
          f'local PSF each, float32: wall {wall:.4f} s; {split.line(wall)}; '
          f'renderer {"C++" if native.available() else "NumPy"}; '
          f'{iters_line(info["iters"])}; peak device memory {peak:.3f} GiB; '
          f'PSFs differ across the field by '
          f'{np.abs(info["psfs"][0] - info["psfs"][-1]).max():.3e} [{card}]')
    check(n >= 400 and bool(cover.all()) and
          bool(np.isfinite(mosaic).all()), 'every tile, a finite mosaic')
    cut = image[:256, :256]
    cfg = SGPConfig(max_iter=25, stop_criterion=3, tol_convergence=1e-4,
                    init_recon=2, proj_type=1, has_flux=True,
                    has_sat_level=True, dtype='float64', operator='linear')
    (gm, gi), (cm, ci) = (sp.restore_with_spatial_psf(cut, model, cfg,
                                                      device=dev)
                          for dev in ('cuda', 'cpu'))
    rel = float(np.abs(gm - cm).max() / np.abs(cm).max())
    print(f'spatial_psf card vs cpu float64 256x256 max_iter=25: '
          f'{len(gi["origins"])} tiles, iterations equal '
          f'{np.array_equal(gi["iters"], ci["iters"])}, mosaic {rel:.3e} '
          f'(limit 1e-7)')
    check(np.array_equal(gi['iters'], ci['iters']) and rel <= 1e-7,
          'spatial_psf: card equals CPU in float64')


def write_sgp_dec_fixtures(path: str, n: int = 255, seed: int = 27) -> None:
    """Seeded ``.mat`` fixtures in the SGP-dec layout (gn, psf, bg, obj),
    n x n, a PSF of the image's own shape: an extended nebula of Gaussian
    blobs with point sources for NGC7027, a compact bright object on a
    dark sky for the satellite."""
    from scipy.io import savemat
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n] - n // 2
    psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * 2.0 ** 2))
    psf /= psf.sum()
    blob = lambda y, x, s, a: a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                         / (2 * s ** 2))
    nebula = sum(blob(*rng.uniform(-40, 40, 2), rng.uniform(5, 20),
                      rng.uniform(50, 300)) for _ in range(12))
    for _ in range(20):
        nebula[tuple(rng.integers(20, n - 20, 2))] += rng.uniform(1e3, 5e3)
    satellite = np.zeros((n, n))
    satellite[n // 2 - 6:n // 2 + 6, n // 2 - 20:n // 2 + 20] = 4e3
    satellite[n // 2 - 15:n // 2 + 15, n // 2 - 3:n // 2 + 3] = 6e3
    otf = np.fft.fft2(np.fft.ifftshift(psf))
    for name, obj, bg in (('NGC7027_255.mat', nebula, 10.0),
                          ('satellite_25500.mat', satellite, 2.0)):
        gn = np.real(np.fft.ifft2(np.fft.fft2(obj) * otf)) + bg
        gn = rng.poisson(np.maximum(gn, 0.0)).astype(np.float64)
        savemat(os.path.join(path, name), {'gn': gn, 'psf': psf,
                                           'bg': np.array([[bg]]),
                                           'obj': obj})


def phase_simulation(torch, card: str) -> None:
    """Phase 27: ``simulation.run_all`` (NGC7027 27 iterations, satellite
    332, KL and beta with the frozen beta inits, float32) on seeded 255x255
    fixtures in the SGP-dec layout, on the card and on the CPU: each
    rel_err finite and below 1; the 27-iteration runs within 1e-3 of the
    CPU's (past about 60 iterations two runs that round differently part,
    so the satellite's are printed beside each other); ``run_kl`` on the
    NGC fixture in float64 within 1e-7."""
    import contextlib
    import io
    import tempfile

    from tpu_sgp_torch.workloads import simulation as sim
    with tempfile.TemporaryDirectory() as data:
        write_sgp_dec_fixtures(data)
        walls, out = {}, {}
        for dev in ('cuda', 'cpu'):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                out[dev] = sim.run_all(data, device=dev)
                walls[dev] = time.perf_counter() - t0
        f64 = [sim.run_kl('NGC7027_255.mat', data_dir=data, dtype='float64',
                          device=dev)[1] for dev in ('cuda', 'cpu')]
    rel = {k: abs(out['cuda'][k] - v) / v for k, v in out['cpu'].items()}
    print('simulation run_all 255x255 float32, rel_err card / cpu: '
          + ', '.join(f'{k} {out["cuda"][k]:.6f} / {v:.6f}'
                      for k, v in out['cpu'].items())
          + f'; wall card {walls["cuda"]:.4f} s, cpu {walls["cpu"]:.4f} s; '
          f'run_kl NGC float64 card vs cpu {abs(f64[0] - f64[1]) / f64[1]:.3e}'
          f' (limits 1e-3 at 27 iterations, 1e-7 in float64) [{card}]')
    check(all(np.isfinite(v) and 0.0 < v < 1.0 for d in out.values()
              for v in d.values()), 'finite rel_err below 1')
    check(rel['ngc_kl'] <= 1e-3 and rel['ngc_beta'] <= 1e-3,
          'NGC: card within 1e-3 of the CPU')
    check(abs(f64[0] - f64[1]) <= 1e-7 * f64[1], 'float64: card equals CPU')


def write_cli_inputs(path: str):
    """A 410x410 science frame with a TAN WCS header and its PSF, as FITS
    files: the CLI's own inputs."""
    from tpu_sgp_torch.image import Header, write_fits
    from tpu_sgp_torch.simulate import synthetic_star_field
    image, psf, _ = synthetic_star_field(410, 410, n_stars=120, seed=28)
    hdr = Header({'GAIN': 1.22, 'SATURATE': 65000.0, 'CRPIX1': 205.0,
                  'CRPIX2': 205.0, 'CRVAL1': 250.42, 'CRVAL2': 36.46,
                  'CD1_1': -1.1e-4, 'CD1_2': 1e-6, 'CD2_1': 1e-6,
                  'CD2_2': 1.1e-4, 'CTYPE1': 'RA---TAN',
                  'CTYPE2': 'DEC--TAN'})
    sci, psf_path = os.path.join(path, 'sci.fits'), os.path.join(path,
                                                                 'psf.fits')
    write_fits(sci, image, hdr)
    write_fits(psf_path, psf)
    return sci, psf_path


def phase_cli(torch, card: str) -> None:
    """Phase 28: the ``sgp`` command line (``tpu_sgp_torch.cli.main``) on
    a 410x410 FITS pair with a TAN WCS header, whole-image and
    ``--use_subdiv`` (100/10), on the card: the files it writes, finite
    world coordinates, catalogs that are not empty; its wall split into
    the host catalog's and the card's seconds."""
    import contextlib
    import io
    import tempfile

    from tpu_sgp_torch import cli
    from tpu_sgp_torch.parallel import batch
    with tempfile.TemporaryDirectory() as tmp:
        sci, psf = write_cli_inputs(tmp)
        for mode, extra in (('whole', []), ('subdiv', [
                '--use_subdiv', '--subdivision_size', '100',
                '--subdiv_overlap', '10'])):
            out_dir = os.path.join(tmp, mode)
            patches = catalog_patches(cli) + [
                (cli, 'sgp', 'card'), (cli, 'sgp_beta_div', 'card'),
                (cli, 'restore_stamps', 'card'),
                (batch, 'restore_stamps', 'card')]
            with SplitTimer(torch, patches) as split, \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                res = cli.main(['--data_path_sciimg', sci, '--data_path_psf',
                                psf, '--output_dir', out_dir, *extra])
                wall = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            orig, deconv = res['orig_catalog'], res['deconv_catalog']
            world = deconv[['X_WORLD', 'Y_WORLD']].to_numpy(np.float64)
            print(f'cli {mode} 410x410 float32: wall {wall:.4f} s; '
                  f'{split.line(wall)}; {res["iters"]} iterations (the '
                  f'slowest tile); objects {len(orig)} -> {len(deconv)}; '
                  f'{len(files)} files [{card}]')
            prefix = 'subdiv_' if mode == 'subdiv' else ''
            check(f'{prefix}deconvolved_sci.fits' in files and
                  'deconv_sci.fits_scat.csv' in files and len(files) == 7,
                  f'cli {mode}: the files written')
            check(len(orig) > 0 and len(deconv) > 0 and
                  bool(np.isfinite(world).all()) and
                  bool(np.isfinite(res['deconvolved']).all()),
                  f'cli {mode}: catalogs with world coordinates')


def main() -> int:
    started = time.perf_counter()
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
                              (17, lambda: phase_classic_checkpoint(torch)),
                              (18, lambda: phase_session(torch, card)),
                              (19, lambda: phase_stream(torch, card)),
                              (20, lambda: phase_server(torch, card)),
                              (21, lambda: phase_big_request(torch, card)),
                              (22, lambda: phase_catalog(torch, card)),
                              (23, lambda: phase_save(torch)),
                              (24, lambda: phase_star_stamps(torch, card)),
                              (25, lambda: phase_subdivisions(torch, card)),
                              (26, lambda: phase_spatial_psf(torch, card)),
                              (27, lambda: phase_simulation(torch, card)),
                              (28, lambda: phase_cli(torch, card))):
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
    kl_ref = phase_path(torch, card, 'kl bisect', unfused_wall)
    phase_path(torch, card, 'beta section', unfused_wall)
    for path in ('kl bisect', 'beta section'):
        phase_card_vs_cpu(torch, path)

    # 13-17
    long_row = phase_long_rows(torch)
    phase_operators(torch)
    frame_launches = phase_frame(torch, card)
    phase_frame_vs_cpu(torch)
    phase_classic_checkpoint(torch)

    # 18-23
    serving = phase_session(torch, card)
    phase_stream(torch, card)
    phase_server(torch, card)
    phase_big_request(torch, card, kl_ref)
    phase_catalog(torch, card)
    phase_save(torch)

    # 24-28
    apps = time.perf_counter()
    phase_star_stamps(torch, card)
    phase_subdivisions(torch, card)
    phase_spatial_psf(torch, card)
    phase_simulation(torch, card)
    phase_cli(torch, card)
    done = time.perf_counter()
    print(f'wall: phases 1-23 {apps - started:.1f} s, the applications '
          f'(24-28) {done - apps:.1f} s, all {done - started:.1f} s')

    k1 = {'route': 'cuda', 'source': 'tpu_sgp_torch/csrc/flux_projection.cu',
          'replaces': 'tpu_sgp/experimental/pallas_projection.py:40'}
    print(json.dumps({'kernels': [{
        'name': 'flux_projection', **k1, 'launches': launches, **kernel}, {
        'name': 'flux_projection_long_row', **k1,
        'launches': frame_launches, **long_row}, {
        'name': 'flux_projection_serving_request', **k1,
        **serving[SERVE_B]}, {
        'name': 'flux_projection_serving_coalesced', **k1,
        **serving[4 * SERVE_B]}, {
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
