#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or a few):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; TF32
     off for matrix products and convolutions;
  2. build: nvcc compiles ``tpu_sgp_torch/csrc/flux_projection.cu``;
  3. the projection kernel against its plain PyTorch version on the same
     CUDA tensors, float32 and float64, with and without saturation, at the
     main path's (12288, 961) and at a ragged (7, 256); their times;
  4. the main path at full size: 12288 synthetic 31x31 stamps through
     ``restore_stamps(..., flatten=True)`` with the bench configuration and
     ``projection_method='pallas'``; the kernel's launch count in that run;
  5. the same solve at B=256 on the card and on the CPU (plain projection),
     float64 lane for lane, float32 as distributions.

Then a JSON line of the kernels, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It exits non-zero without a GPU.
"""
from __future__ import annotations

import json
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

    b, c, dia, cap = projection_case(torch, MAIN_B, N_PIX, torch.float32,
                                     True, device, 99)
    steps = section_steps(torch.float32)
    ms = time_ms(torch, lambda: project_rows(b, c, dia, cap, steps, True))
    plain_ms = time_ms(torch, lambda: project_rows_plain(b, c, dia, cap,
                                                         steps, True))
    print(f'kernel time ({MAIN_B}, {N_PIX}) float32 has_sat=True: '
          f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
    return dict(max_abs_err=main_err, ms=ms, plain_ms=plain_ms)


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


def phase_main_path(torch, card: str) -> int:
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
    return launches


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

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build('flux_projection')
    print(f'build: {lib.name} in {time.perf_counter() - t0:.2f} s')
    log = lib.with_name(lib.name + '.log').read_text().strip()
    if log:
        print('ptxas: ' + ' | '.join(ln.strip() for ln in log.splitlines()
                                     if 'registers' in ln or 'spill' in ln))

    # 3-5
    kernel = phase_kernel(torch, 'cuda')
    launches = phase_main_path(torch, card)
    phase_card_vs_cpu(torch)

    print(json.dumps({'kernels': [{
        'name': 'flux_projection', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/flux_projection.cu',
        'replaces': 'tpu_sgp/experimental/pallas_projection.py:40',
        'launches': launches, **kernel}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
