#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_sgp_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--from N]

With ``--from N`` (13 to 45) phases 3 to N - 1 are skipped and no result is
printed: a short run for work on the later phases. ``--rank ...`` is the
entry of one rank of phases 31-33 (``rank_main``), which the script starts
itself.

Phases, one line of output each (or a few):
  1. environment: torch, CUDA, nvcc, the card's name and power limit; TF32
     off for matrix products and convolutions;
  2. build: nvcc compiles ``tpu_sgp_torch/csrc/flux_projection.cu`` and
     ``tpu_sgp_torch/csrc/stamp_solver.cu`` (and
     ``compensated_sum.cu`` and ``beta_divergence.cu``) side by side;
     their ptxas reports (registers, spills) and resident blocks an SM,
     for every instantiation;
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
     against each other at this shape; its bound with the operator on the
     tensor cores (three TF32 products) and with everything on the FP32
     pipes;
  8. the whole-solver kernel's operator alone against the dense circulant
     product, float32 (on the tensor cores) and float64; the tensor cores'
     instructions (HMMA) in every TcPatch instantiation and in no Patch one
     (float32 on the FP32 pipes, float64); its time at phase 7's count of
     operator applications, as a share of the kernel's time, beside
     cuBLAS's float32 GEMM of the same count;
  9. each projection method ('bisect', on the card the guided kernel;
     the plain-PyTorch 'section', 'sort', 'secant' and warm 'bisect') on
     the card against the CPU at (12288, 961),
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
     ``tpu_sgp_torch.sgp`` (cold 'bisect': the guided kernel's launches
     counted, one a projection) and through ``solve`` with the JAX bench's two
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
     TAN WCS header, whole-image and ``--use_subdiv``;
 29. the reference's raw-frame chain on seeded data at survey size:
     ``preprocess.cull_frames`` on five 2048x2048 uint16 bias frames and
     three flats (and ``python -m tpu_sgp_torch.preprocess`` on a copy);
     a 2048x2048 uint16 star field with saturated stars written as fpack
     RICE_1 and read back bit for bit (the C++ and pure-Python codecs
     equal on a 256-row slice); ``psf.pipeline.psf_estimation`` over the
     reference's 2x5 sub-frame grid; the 410x410 centre cut restored on the
     card with its sub-frame's PSF under ``observability.timed``, and
     through ``solve`` with 'pallas' under ``observability.profiled`` (the
     trace names the projection kernel's grid path); the restoration
     written as GZIP_2 and as quantised RICE_1;
 30. ``observability.nan_guard`` on CUDA tensors: log(-1) raises under it,
     a disabled guard changes no bit of phase 29's solve, the solve raises
     under an enabled guard, the guard is off afterwards;
 31-33. multi-rank worlds, each rank a process of its own started by the
     script (``--rank``), every world held to a time limit: one NCCL rank,
     and four gloo ranks sharing the card. 31: the main path's 12288 stamps
     through ``restore_stamps(mesh=...)`` on a ('batch',) mesh with the JAX
     multi-chip bench call (flatten, compaction 31/512), default 'bisect'
     and 'pallas' (K1 on every rank's shard, its launches counted a rank),
     float64 at B=256 lane for lane and float32 at full width as
     distributions against one device; then a ``MicroBatchServer`` over a
     session on that mesh, every request submitted on the first rank,
     which ships each batch to the others, per path: phase 20's 64 client
     threads x 16 stamps in float32 (requests/s, device calls a rank, K1's
     launches a rank, the iterations against one device as distributions,
     phase 20's one-device server beside), one full batch's shipping timed
     (the header and the packed buffer: bytes, ms), and 4 requests of 16
     stamps from 4 threads in float64 against a session on one device,
     lane for lane (1e-9, 'pallas' 1e-7); 32: a 2048x2048 field under a 31x31
     PSF through ``solve_distributed`` on a 1x1 and a 2x2 mesh, float64 at
     20 fixed iterations against the 'linear' solve on one device, float32
     ms an iteration, stop rule 3, the collectives an iteration and the
     time of one all-reduce and one halo exchange; 33 (the four gloo
     ranks): ``solve_distributed_batch`` of four 1024x1024 fields on
     (batch 2, ty 1, tx 2) against one device an image, float64;
     ``make_multiprocess_mesh``'s placement; phase 32's frame checkpointed
     on 2x2 and resumed on 4x1, against the uninterrupted solve.
 34-41. the example scripts (``examples_torch/``), each through its own
     ``run`` at the JAX example's sizes. 34: ``deconvolve_demo`` (the
     256x256 field, KL and beta, 128 stamps; finite, flux within 1e-4);
     35: ``serving_demo`` (three warmed buckets, five requests, two
     streams, eight clients of a ``MicroBatchServer``); 36:
     ``build_allsky_map`` at 96x96 tiles; 37: ``time_halo_operator`` in
     phase 31's NCCL rank, the halo operator's local apply on a 1x1 mesh
     against the linear operator at 410x410 (within 1e-5 in float32); 38:
     ``scan_compaction``, the KL and beta grids at B=12288, best of 2;
     39: ``determinism_check``, six fresh processes, stable_sums True and
     False under three perturbations (the stable arm must agree), after a
     probe of what a batch of two changes; 40, beside 39's six runs:
     ``serving_recycle_soak`` for about 75-90 s with a limit of 40 device
     calls a process (zero loss, at least two recycles, the RSS curves);
     41: ``distributed_demo`` in phase 31's two worlds. They launch
     neither kernel.
 42. K2's shapes: the whole-solver kernel on each route of its launch plan
     past the main path's (TcPatch on 31x31), 64 stamps of one shape a
     route: float32 240x17 (TcPatch on the transposes), 4x1024
     (Patch<float> on the FP32 pipes) and 2048x2 (Patch<float> on the
     transposes), float64 31x31 and 240x17 (Patch<double>, the second on
     the transposes); each through ``solve_stamps_pallas`` with its launch
     counted on its route, against its plain version with phase 6's
     limits (two of them widened at one shape each, ``K2_ROUTE_LIMITS``)
     and, in float32 stop rule 1, against the float64 truth as phase 6;
     its block (threads, shared bytes, blocks an SM) as the card reports
     it against the plan's, its time beside its bound; float64 4x1024,
     which fits no block, raises ``ValueError`` before any launch; and the
     plan's block of each design against the card's for every shape up to
     4096 pixels;
 43. the cold guided secant ('bisect') on long rows as one grid kernel:
     at (1, 168100) (pixels in registers) and (1, 2048 * 2048) (streamed
     by every block the card holds), float32 and float64, with and
     without saturation, the route and plan, its x against the plain ladder
     (``_guided_root``) on the card (1e-5 / 1e-12 of max|x|) and both flux
     errors; then its time (CUDA events) against the plain ladder's, the
     launches a call of each (the kernel's counter, ``torch.profiler``'s
     launch calls and device kernels), its bound, and its ptxas line
     beside K1's grid kernel's. The launches of the guided kernel in the
     kernels line are phase 15's, in the facade's cold-'bisect' solve.
 44. the compensated row sum (``gsum_ff``) as one kernel: at (1, 168100)
     float32 and float64 (a frame's row), (12288, 961) float32 (a stamp
     batch) and (1, 2048 * 2048) float32 and float64 (a whole exposure's
     row), the kernel against the plain tree on the card bit for
     bit; the kernel's device time (calls replayed in a CUDA graph, so
     neither the host's work nor the profiler enters) and its time a call
     through the wrapper (CUDA events) against its bound (bytes) and the
     plain tree's time, the launches a call of each (the kernel's counter;
     the profiler's launch calls and device kernels), and its ptxas line
     (registers, spills, blocks an SM). The launches and iterations of
     the compensated sum in the kernels line are phase 15's, in the
     float32 facade solve.
 45. the beta objective with its d/dbeta row sums as one kernel
     (``kernels.beta_divergence.beta_div_rows``) at the beta stamp cell's
     (12288, 961) and the beta frame cell's (1, 2048 * 2048), float32 with
     the compensated tree (the cells' case) and float64 without: against
     its plain version on the card (float32's
     objective bit for bit, the rest within 1e-5 / 1e-12 of the sums of
     |term|); its device time and the plain version's (calls in a CUDA
     graph), its time a call through the wrapper (CUDA events), the
     launches a call of each, its bound (bytes) and its ptxas line; then
     the kernel's launches in one beta ``restore_stamps`` of phase 4's
     12288 stamps on the 'beta section' path, against its objective
     evaluations, and in a traced beta ``restore_stamps`` of a 256x256
     frame with the frame cell's settings, ``beta_div.pixels`` against
     its launches x N.

Then a JSON line of the kernels (K2's entry lists the routes it launched,
each with its launches, time and bound), the ``nvidia-smi`` line, and last
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
# the projections of phase 9 ('warm' is 'bisect' warm-started)
METHODS = ('bisect', 'section', 'sort', 'secant', 'warm')
# phase 9: card against CPU, float64 max|dx|/max|x|
METHOD_TOL_F64 = 1e-10
# max|kernel - plain| / max|plain|: the two sum a row in different orders,
# so a sign census can differ by one section at the last step
KERNEL_TOL = {'float32': 1e-5, 'float64': 1e-10}
FLUX_RTOL = {'float32': 1e-4, 'float64': 1e-9}
LIBRARIES = ('flux_projection', 'stamp_solver', 'compensated_sum',
             'beta_divergence')
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
# Phase 42's float32 stamps (one star in up to 4096 pixels) are less well
# conditioned than the main path's: at two shapes two float32 summation
# orders part past one of phase 6's limits. On the H100, 4x1024 stop rule
# 1: the kernel against the plain version per-lane p95 3.961e-03 and max
# 2.387e-02, the plain version against itself on the stamps' transposes
# 3.431e-03 and 4.057e-02; 2048x2 stop rule 3: median iterations 22.5 and
# 21, mean |diters| 1.3281, the plain version against itself 1 and 1.8125
# (PERF.md). There those limits are about twice the kernel's readings;
# phase 6's hold elsewhere:
K2_ROUTE_LIMITS = {(4, 1024): {'p95': 8e-3, 'max': 5e-2},
                   (2048, 2): {'d_median_iters': 3.0, 'mean_d_iters': 2.7}}
# Stop rule 3 at full width (phase 7), where a lane may also stop some
# iterations earlier or later on one side (the iteration counts are held
# as distributions), so x is held over all lanes by median and 95th
# percentile, and by its max on the lanes of equal iterations; about twice
# the readings on the H100 (PERF.md):
K2_FULL_REL = {'median': 1e-3, 'p95': 2e-2}
K2_FULL_REL_SAME = {'median': 5e-4, 'p95': 6e-3, 'max': 7e-2}
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, dense TF32 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
# float64 FLOP/s outside the tensor cores and dense on them (the same
# data sheet); a float64 bound takes the tensor cores' rate for the
# operator's products, the card's best for the type
F64_FLOP_S = 34e12
F64_TC_FLOP_S = 67e12
# K2's float32 operator: three TF32 products a multiply-add (hi*hi + hi*lo
# + lo*hi) keep float32 accuracy
TF32_PASSES = 3
# phase 42: one stamp shape a route of K2's plan past the main path's
# (TcPatch on 31x31): TcPatch transposed, Patch<float>, Patch<float>
# transposed, Patch<double>, Patch<double> transposed; B stamps each
K2_ROUTES = (('float32', (240, 17)), ('float32', (4, 1024)),
             ('float32', (2048, 2)), ('float64', (31, 31)),
             ('float64', (240, 17)))
K2_ROUTE_B = 64
# phase 13: the long rows, (rows, pixels): one 410x410 frame, four 256x256
LONG_ROWS = ((1, 410 * 410), (4, 256 * 256))
# a whole 2048x2048 exposure as one row, the beta frame cell's
FRAME_ROW = 2048 * 2048
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


def bound(bytes_moved: float, ops: float, tc_ops: float = 0.0,
          ops_rate: float = F32_FLOP_S, tc_rate: float = TF32_FLOP_S) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peaks, the operations
    ``ops`` over the pipes' ``ops_rate`` (float32 unless given) and the
    products ``tc_ops`` over the tensor cores' ``tc_rate`` (TF32 unless
    given)."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = (ops / ops_rate + tc_ops / tc_rate) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def instance_name(line: str):
    """``kernel<type,threads,...>`` of the mangled kernel instantiation
    named in a line of a compiler's report, or None."""
    m = re.search(r"([a-z_]+_kernel)I([fd])((?:Li\d+E)*)", line)
    if not m:
        return None
    return f'{m[1]}<' + ','.join([m[2]] + re.findall(r'Li(\d+)E', m[3])) \
        + '>'


def ptxas_summary(log: str) -> dict:
    """Registers, spills and static shared memory of every kernel
    instantiation in a ptxas report, by name ``kernel<type,threads,...>``,
    as ``R regs spill S/L B smem M B``."""
    out, name, spill = {}, None, ''
    for ln in log.splitlines():
        if 'Compiling entry function' in ln and instance_name(ln):
            name = instance_name(ln)
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


def sass_count(lib_path, opcode: str) -> dict:
    """Instructions of ``opcode`` (e.g. ``HMMA``, the tensor cores'
    matrix product) in every kernel instantiation of a built library, from
    ``cuobjdump -sass``, by name as ``ptxas_summary`` names them."""
    from pathlib import Path
    from tpu_sgp_torch.kernels import _build
    sass = run([str(Path(_build.nvcc()).with_name('cuobjdump')), '-sass',
                str(lib_path)])
    out, name = {}, None
    for ln in sass.splitlines():
        if 'Function :' in ln:
            name = instance_name(ln)
            if name:
                out[name] = 0
        elif name and re.search(rf'\b{opcode}\b', ln):
            out[name] += 1
    return out


def occupancy(name: str) -> dict:
    """Resident blocks an SM of each instantiation the library of
    ``csrc/<name>.cu`` reports
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through its
    ``tpu_sgp_<name>_occupancy`` entry), by name."""
    import ctypes
    from tpu_sgp_torch.kernels import _build
    fn = _build.entry(name, f'tpu_sgp_{name}_occupancy',
                      (ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)))
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
        resident = occupancy(name)
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
    from tpu_sgp_torch.kernels import launches as kernel_launches
    inputs = main_path_inputs(MAIN_B)
    restore(torch, inputs, 'cuda')           # warm-up
    walls = []
    for i in range(3):
        if i == 0:
            kernel_launches['project_rows'] = 0
        t0 = time.perf_counter()
        res = restore(torch, inputs, 'cuda')
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = kernel_launches['project_rows']
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


K2_CASES = (('float64 stop 3', dict(dtype='float64')),
            ('float32 stop 3', {}),
            ('float32 stop 1 max_iter=20',
             dict(stop_criterion=1, max_iter=20)))


def k2_spread(x, it, xp, ip) -> dict:
    """How far one solve of (B, N) rows, ``(x, it)``, lies from another,
    ``(xp, ip)``: |difference of the median iterations|, mean |diters|
    and the median, 95th percentile and max of the per-lane
    max|dx|/max|x|."""
    it, ip = it.cpu().numpy().astype(int), ip.cpu().numpy().astype(int)
    rel = ((x - xp).abs().amax(1) / xp.abs().amax(1)).cpu().numpy()
    return {'d_median_iters': abs(float(np.median(it) - np.median(ip))),
            'mean_d_iters': float(np.abs(it - ip).mean()),
            'median': float(np.median(rel)),
            'p95': float(np.percentile(rel, 95)), 'max': float(rel.max())}


def k2_against_plain(torch, what: str, cfg, x, it, xp, ip, fluxes,
                     limits=None) -> float:
    """Phase 6's limits of one kernel solve of (B, N) rows, ``(x, it)``,
    against its plain version's ``(xp, ip)`` on the same CUDA tensors:
    finite, every row's flux kept within ``FLUX_RTOL``; float64 equal
    per-lane iterations and x to 1e-7 relative; float32 stop rule 3 equal
    medians, mean |diters| <= 1 (see phase 5); float32 stop rule 1 per-lane
    max|dx|/max|x| within ``K2_F32_REL``. ``limits`` replaces some of the
    float32 limits (``K2_ROUTE_LIMITS``). Prints the readings; returns
    max|dx|."""
    check(bool(torch.isfinite(x).all()), f'{what}: finite kernel x')
    flux = float(np.abs(x.double().sum(1).cpu().numpy() / fluxes - 1).max())
    check(flux <= FLUX_RTOL[cfg.dtype], f'{what}: kernel conserves flux')
    got = k2_spread(x, it, xp, ip)
    it, ip = it.cpu().numpy().astype(int), ip.cpu().numpy().astype(int)
    print(f'{what}: iters median {np.median(it):g} vs {np.median(ip):g}, '
          f'max {it.max()} vs {ip.max()}, mean |diters|='
          f'{got["mean_d_iters"]:.4f}, per-lane max|dx|/max|x| median '
          f'{got["median"]:.3e} p95 {got["p95"]:.3e} max {got["max"]:.3e}, '
          f'flux rel err={flux:.3e}')
    if cfg.dtype == 'float64':
        check(np.array_equal(it, ip), f'{what}: equal per-lane iterations')
        check(got['max'] <= 1e-7, f'{what}: x agrees to 1e-7')
        return float((x - xp).abs().max())
    limit = {'d_median_iters': 0.0, 'mean_d_iters': 1.0, **K2_F32_REL,
             **(limits or {})}
    keys = (('d_median_iters', 'mean_d_iters') if cfg.stop_criterion == 3
            else tuple(K2_F32_REL))
    for k in keys:
        check(got[k] <= limit[k], f'{what}: {k} {got[k]:.4g} within '
              f'{limit[k]:.4g}')
    return float((x - xp).abs().max())


def k2_against_truth(torch, what: str, x, xp, x64) -> None:
    """Phase 6's second yardstick of a float32 kernel solve ``x`` and its
    plain version's ``xp``: their per-lane max|dx|/max|x| from the plain
    version in float64 on the same stamps, ``x64``; the kernel's median
    and 95th percentile within ``TRUTH_RATIO`` times the plain version's."""
    truth = {}
    for who, got in (('kernel', x), ('plain', xp)):
        r = ((got.double() - x64).abs().amax(1)
             / x64.abs().amax(1)).cpu().numpy()
        truth[who] = (float(np.median(r)), float(np.percentile(r, 95)),
                      float(r.max()))
    print(f'{what} float32 vs float64 truth, per-lane max|dx|/max|x| '
          f'median / p95 / max: kernel ' + ' / '.join(
              f'{v:.3e}' for v in truth['kernel']) + ', plain '
          + ' / '.join(f'{v:.3e}' for v in truth['plain']))
    for i, stat in ((0, 'median'), (1, 'p95')):
        check(truth['kernel'][i] <= TRUTH_RATIO * truth['plain'][i],
              f'{what}: float32 {stat} distance to float64 truth within '
              f'{TRUTH_RATIO}x the plain version\'s')


def phase_k2_vs_plain(torch) -> None:
    """Phase 6: the whole-solver kernel against its plain version on the
    same CUDA tensors, B=256 main-path stamps, bench configuration, with
    ``k2_against_plain``'s limits; float32 stop rule 1 at max_iter=20,
    where every lane runs 20 iterations, also against the plain version in
    float64: the kernel's median and 95th percentile within
    ``TRUTH_RATIO`` times the plain version's."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels.stamp_solver import solve_rows, solve_rows_plain
    inputs = main_path_inputs(K2_B)
    fluxes = inputs[3]
    for label, over in K2_CASES:
        cfg = SGPConfig(**{**BENCH_CFG, **over})
        args = stamp_rows(*inputs, SAT_LEVEL, cfg.torch_dtype, 'cuda')
        x, it = solve_rows(*args, cfg)
        xp, ip = solve_rows_plain(*args, cfg)
        torch.cuda.synchronize()
        k2_against_plain(torch, f'K2 kernel vs plain B={K2_B} {label}', cfg,
                         x, it, xp, ip, fluxes)
        if cfg.stop_criterion == 1:
            # both float32 results against float64 truth (the plain version
            # in float64 on the same stamps): the kernel's sum order may
            # stray from the truth no further than the plain version's
            cfg64 = SGPConfig(**{**BENCH_CFG, **over, 'dtype': 'float64'})
            x64, _ = solve_rows_plain(*stamp_rows(*inputs, SAT_LEVEL,
                                                  torch.float64, 'cuda'),
                                      cfg64)
            k2_against_truth(torch, f'K2 B={K2_B} stop 1 max_iter=20', x,
                             xp, x64)


def k2_full_width_agree(torch, x, it, xp, ip, what: str) -> float:
    """Phase 7's limits of one float32 stop-rule-3 solve of the main path's
    (B, N) rows, ``(x, it)``, against another, ``(xp, ip)``: finite, equal
    median iterations, mean |diters| <= 1, per-lane max|dx|/max|x| within
    ``K2_FULL_REL`` over all lanes and ``K2_FULL_REL_SAME`` over the lanes
    of equal iterations. Prints the readings; returns max|dx|."""
    it, ip = it.cpu().numpy().astype(int), ip.cpu().numpy().astype(int)
    diff = np.abs(it - ip)
    rel = ((x - xp).abs().amax(1) / xp.abs().amax(1)).cpu().numpy()
    same = rel[diff == 0]
    max_abs = float((x - xp).abs().max())
    print(f'{what} B={x.shape[0]} float32 stop 3: iters median '
          f'{np.median(it):g} vs {np.median(ip):g}, max {it.max()} vs '
          f'{ip.max()}, mean |diters|={diff.mean():.4f}, |diters| histogram '
          f'{np.bincount(diff).tolist()}, per-lane max|dx|/max|x| median '
          f'{np.median(rel):.3e} p95 {np.percentile(rel, 95):.3e} max '
          f'{rel.max():.3e} (lanes of equal iterations: median '
          f'{np.median(same):.3e} p95 {np.percentile(same, 95):.3e} max '
          f'{same.max():.3e}), max|dx|={max_abs:.4f}')
    check(bool(torch.isfinite(x).all()), f'{what}: finite x')
    check(np.median(it) == np.median(ip), f'{what}: median iterations equal')
    check(diff.mean() <= 1.0, f'{what}: mean |diters| <= 1')
    check(np.median(rel) <= K2_FULL_REL['median']
          and np.percentile(rel, 95) <= K2_FULL_REL['p95'],
          f'{what}: x within {K2_FULL_REL}')
    check(np.median(same) <= K2_FULL_REL_SAME['median']
          and np.percentile(same, 95) <= K2_FULL_REL_SAME['p95']
          and same.max() <= K2_FULL_REL_SAME['max'],
          f'{what}, lanes of equal iterations: x within {K2_FULL_REL_SAME}')
    return max_abs


def k2_routes(launches) -> dict:
    """K2's launches by route (``'TcPatch'``, ...) in the port's launch
    counter."""
    return {k.removeprefix('solve_rows/'): v for k, v in launches.items()
            if k.startswith('solve_rows/') and v}


def phase_k2_full(torch, card: str, unfused_wall: float,
                  unfused_iters) -> dict:
    """Phase 7: ``solve_stamps_pallas`` at full width on phase 4's inputs,
    after one warm-up call; the wall is the median of three calls, each
    ending in a synchronize, with the kernel's launches counted from 0 in
    each, every one on the TcPatch route. Then the kernel alone and its plain version, CUDA events, on the
    same operands; their last results are held against each other with
    phase 6's stop-rule-3 limits on the iterations and ``K2_FULL_REL``
    and ``K2_FULL_REL_SAME`` on x, and give the kernel's max_abs_err."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import (solve_stamps_pallas,
                                                         stamp_rows)
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.kernels.stamp_solver import (device_plan, solve_rows,
                                                    solve_rows_plain)
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
        kernel_launches.clear()
        t0 = time.perf_counter()
        x, iters = run()
        walls.append(time.perf_counter() - t0)
        counts.append(kernel_launches['solve_rows'])
        check(k2_routes(kernel_launches) == {'TcPatch': 1},
              f'the main path\'s stamps take the TcPatch route: '
              f'{k2_routes(kernel_launches)}')
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
    max_abs = k2_full_width_agree(torch, xk, ik, xp, ip,
                                  'K2 kernel vs plain')
    ik = ik.cpu().numpy().astype(int)
    # two bounds: everything on the FP32 pipes, and the kernel's own split
    n = N_PIX
    op_flop, rest, moved = k2_work(torch, it, n, torch.float32)
    pipes = bound(moved, op_flop + rest)
    k2_bound = bound(moved, rest, TF32_PASSES * op_flop)
    print(f'K2 kernel time ({MAIN_B}, {n}) float32: kernel {ms:.4f} ms, '
          f'plain {plain_ms:.4f} ms, bound {k2_bound["bound_ms"]:.4f} ms '
          f'({k2_bound["bound_by"]}: the operator\'s {op_flop / 1e12:.4f} '
          f'TFLOP as {TF32_PASSES} TF32 products on the tensor cores, '
          f'{rest / 1e12:.4f} TFLOP on the FP32 pipes), '
          f'{pipes["bound_ms"]:.4f} ms all on the FP32 pipes')
    block = route_block(device_plan(31, 31, torch.float32,
                                    torch.device('cuda')), 31, 31)
    route = dict(route='TcPatch', shape=[31, 31], dtype='float32',
                 launches=counts[0], **block, ms=ms,
                 ms_per_stamp_iteration=ms / float(it.sum()),
                 plain_ms=plain_ms, max_abs_err=max_abs, **k2_bound)
    return dict(launches=counts[0], max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, **k2_bound, library_ms=None,
                routes=[route]), int((3 + 2 * ik).sum())


def k2_work(torch, it, n: int, dtype) -> tuple:
    """K2's work on (B, n) stamps whose lanes ran ``it`` iterations, as
    (operator FLOP, other FLOP, bytes): each lane applies the n-tap
    operator 3 + 2 * iters times (n^2 multiply-adds of 2 operations each)
    and projects 1 + iters times (per bisection step and pixel an add, a
    divide, a max, a min and the sum's add, and about 8 operations around
    the bisection); it reads the stamps, backgrounds, fluxes, levels and
    taps once and writes x and the int32 iterations."""
    from tpu_sgp_torch.projection.flux_projection import bracket_bits
    it = np.asarray(it, dtype=np.float64)
    size = torch.finfo(dtype).bits // 8
    op_flop = float(((3 + 2 * it) * 2 * n * n).sum())
    rest = float(((1 + it) * (bracket_bits(dtype) * 5 + 8) * n).sum())
    rows = it.size
    return op_flop, rest, (3 * rows * n + 2 * rows + n) * size + 4 * rows


def phase_operator(torch, k2_ms: float, applications: int) -> None:
    """Phase 8: K2's operator alone (``apply_operator``, the solver's own
    device code) against its plain twin, the dense circulant product, on
    main-path rows and taps: ``(AT A) x`` to ``OPERATOR_TOL`` of max|x|
    (float32 on the tensor cores in three TF32 products, float64 on the
    FP64 pipes; the sums' order differs). The tensor cores' matrix products
    (``HMMA``) in each instantiation of the built library: some in every
    TcPatch one, none in a Patch one (float32 or float64). Then the
    operator's time at phase 7's own count of applications (``3 + 2 *
    iters`` a lane, summed), as a share of the kernel's ``k2_ms``, beside
    the plain twin's time and one
    dense float32 GEMM a product (``torch.matmul``, cuBLAS) as the
    library's yardstick for the same count."""
    from tpu_sgp_torch.experimental.pallas_batch import stamp_rows
    from tpu_sgp_torch.kernels import _build
    from tpu_sgp_torch.kernels.stamp_solver import (apply_operator,
                                                    apply_operator_plain)
    from tpu_sgp_torch.ops.psf_operator import build_circulant_matrix
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
    hmma = sass_count(_build.library_path('stamp_solver'), 'HMMA')
    print('K2 HMMA instructions (cuobjdump -sass): ' + ', '.join(
        f'{k} {v}' for k, v in hmma.items()))
    # the last template argument is the design: 1 TcPatch, 0 Patch
    for kernel in ('solve_stamps_kernel', 'apply_operator_kernel'):
        for t, design, on in (('f', 1, True), ('f', 0, False),
                              ('d', 0, False)):
            counts = [v for k, v in hmma.items()
                      if k.startswith(f'{kernel}<{t},')
                      and k.endswith(f',{design}>')]
            check(bool(counts) and all((v > 0) == on for v in counts),
                  f'{kernel}<{t},...,{design}>: tensor-core products '
                  f'{"in every" if on else "in no"} instantiation')
    gn, _, _, _, taps = stamp_rows(*inputs, SAT_LEVEL, torch.float32, 'cuda')
    gn = gn / gn.amax(1, keepdim=True)
    reps = max(1, round(applications / (2 * MAIN_B)))
    scale = applications / (2 * MAIN_B * reps)
    cmat = build_circulant_matrix(torch.fft.ifftshift(taps))

    def library():
        y = gn
        for _ in range(reps):
            y = torch.matmul(torch.matmul(y, cmat.T), cmat)
        return y

    ms = time_ms(torch, lambda: apply_operator(gn, taps, reps), reps=3) * scale
    plain_ms = time_ms(torch, lambda: apply_operator_plain(gn, taps, reps),
                       reps=3) * scale
    library_ms = time_ms(torch, library, reps=3) * scale
    flop = 2.0 * N_PIX * N_PIX * applications
    print(f'K2 operator time ({MAIN_B}, {N_PIX}) float32 at phase 7\'s '
          f'{applications} applications ({reps} x (AT A) a row, scaled by '
          f'{scale:.4f}, {apply_operator.resident} blocks/SM as the '
          f'solver): {ms:.4f} ms, {flop / ms / 1e9:.2f} TFLOP/s '
          f'({100 * flop / ms / 1e-3 / F32_FLOP_S:.1f} % of the float32 '
          f'peak, {100 * TF32_PASSES * flop / ms / 1e-3 / TF32_FLOP_S:.1f} '
          f'% of the TF32 peak in its {TF32_PASSES} products), '
          f'{100 * ms / k2_ms:.1f} % of the kernel\'s {k2_ms:.4f} ms; the '
          f'rest {k2_ms - ms:.4f} ms; plain {plain_ms:.4f} ms; cuBLAS '
          f'float32 GEMM (torch.matmul) {library_ms:.4f} ms')


def route_block(plan, h: int, w: int) -> dict:
    """The card's own account of a K2 route's block (``card_block``:
    threads, dynamic shared bytes, resident blocks an SM and the
    instantiation), checked against the plan's threads and bytes."""
    from tpu_sgp_torch.kernels.stamp_solver import card_block
    bh, bw = (w, h) if plan.transposed else (h, w)
    block = card_block(plan.design, bh, bw, plan.dtype)
    check(block is not None, f'{plan.route} on {h}x{w}: the card takes the '
          f'block')
    check((block['threads'], block['smem']) == (plan.threads, plan.smem),
          f'{plan.route} on {h}x{w}: the plan\'s block ({plan.threads} '
          f'threads, {plan.smem} B) is the card\'s ({block["threads"]}, '
          f'{block["smem"]} B)')
    return block


def k2_plan_sweep(torch) -> None:
    """Every (H, W) with H*W <= 4096 and each design (float32 TcPatch and
    Patch, float64 Patch): the plan's block (``route_plan`` under the
    card's shared memory) has the threads and bytes of the C entries' own
    (``card_block``), or both refuse it."""
    from tpu_sgp_torch.kernels.stamp_solver import (MAX_PIXELS, _smem_limit,
                                                    card_block, route_plan)
    t0 = time.perf_counter()
    limit = _smem_limit(torch.cuda.current_device())
    kinds = (('TcPatch', torch.float32), ('Patch', torch.float32),
             ('Patch', torch.float64))
    blocks = refused = 0
    for h in range(1, MAX_PIXELS + 1):
        for w in range(1, MAX_PIXELS // h + 1):
            for design, dtype in kinds:
                plan = route_plan(design, False, h, w, dtype, limit)[0]
                card = card_block(design, h, w, dtype)
                check((plan is None) == (card is None) and (
                    plan is None or (plan.threads, plan.smem)
                    == (card['threads'], card['smem'])),
                    f'{design} {dtype} {h}x{w}: the plan\'s block is the '
                    f'card\'s')
                blocks += 1
                refused += card is None
    print(f'K2 shapes plan vs card: {blocks} blocks of {len(kinds)} designs '
          f'on every shape to {MAX_PIXELS} pixels agree ({refused} refused '
          f'by both, {limit} B of shared memory a block), '
          f'{time.perf_counter() - t0:.2f} s')


def phase_k2_shapes(torch, card: str) -> list:
    """Phase 42: K2 on every route of its plan past the main path's, B=64
    stamps of one shape each (``K2_ROUTES``). The route's operator alone,
    (AT A) x, against the dense product (``OPERATOR_TOL``, as phase 8).
    Then ``solve_stamps_pallas`` with the launches counted from 0 by
    route: each call one launch on the planned route, its result against
    the plain version on the same CUDA tensors with ``k2_against_plain``'s
    limits (float64 stop rule 3; float32 stop rule 3 and stop rule 1 at
    max_iter=20, with ``K2_ROUTE_LIMITS`` at its shapes), and float32 stop
    rule 1 against the float64 truth as in phase 6. float64 4x1024, which
    fits no block, raises ``ValueError`` before any launch. Each route's
    kernel timed (CUDA events, stop rule 3) beside its plain version and
    its bound at the card's best rate for the type: the operator as
    TF32_PASSES TF32 products in float32, on the FP64 tensor cores in
    float64, the rest on the pipes (the operator all on the pipes is
    printed beside it). Last ``k2_plan_sweep``. Returns the routes for the
    kernels line."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.experimental.pallas_batch import (solve_stamps_pallas,
                                                         stamp_rows)
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.kernels.stamp_solver import (apply_operator,
                                                    apply_operator_plain,
                                                    solve_rows,
                                                    device_plan,
                                                    solve_rows_plain)
    from tpu_sgp_torch.simulate import shaped_star_stamps
    b = K2_ROUTE_B
    cfg64 = SGPConfig(**{**BENCH_CFG, 'dtype': 'float64'})
    kernel_launches['solve_rows'] = 0
    try:
        solve_stamps_pallas(*shaped_star_stamps(b, 4, 1024, 41), SAT_LEVEL,
                            cfg64)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and kernel_launches['solve_rows'] == 0,
          'float64 4x1024 raises ValueError before any launch')
    print(f'K2 shapes float64 4x1024: ValueError before any launch: '
          f'{refused}')
    routes = []
    for seed, (name, (h, w)) in enumerate(K2_ROUTES, 42):
        dtype = getattr(torch, name)
        plan = device_plan(h, w, dtype, torch.device('cuda'))
        block = route_block(plan, h, w)
        inputs = shaped_star_stamps(b, h, w, seed)
        args = stamp_rows(*inputs, SAT_LEVEL, dtype, 'cuda')
        gn, taps = args[0], args[4]
        op = float((apply_operator(gn, taps, 1)
                    - apply_operator_plain(gn, taps, 1)).abs().max()
                   / gn.abs().max())
        print(f'K2 shapes operator {plan.route} {h}x{w} (AT A) x: '
              f'max|dy|/max|x|={op:.3e} (limit {OPERATOR_TOL[name]:.0e})')
        check(op <= OPERATOR_TOL[name], f'{plan.route} on {h}x{w}: the '
              f'operator agrees with the dense product')
        max_abs, launches = 0.0, 0
        for label, over in K2_CASES:
            if over.get('dtype', 'float32') != name:
                continue
            cfg = SGPConfig(**{**BENCH_CFG, **over})
            kernel_launches.clear()
            x, it = solve_stamps_pallas(*inputs, SAT_LEVEL, cfg)
            torch.cuda.synchronize()
            counted = k2_routes(kernel_launches)
            check(counted == {plan.route: 1},
                  f'{h}x{w} {name}: one launch on {plan.route}: {counted}')
            launches += counted[plan.route]
            xp, ip = solve_rows_plain(*args, cfg)
            torch.cuda.synchronize()
            what = f'K2 shapes {plan.route} B={b} {h}x{w} {label}'
            x = x.reshape(b, -1)
            max_abs = max(max_abs, k2_against_plain(
                torch, what, cfg, x, it, xp, ip, inputs[3],
                K2_ROUTE_LIMITS.get((h, w))))
            if name == 'float32' and cfg.stop_criterion == 1:
                truth = SGPConfig(**{**BENCH_CFG, **over, 'dtype': 'float64'})
                x64, _ = solve_rows_plain(*stamp_rows(
                    *inputs, SAT_LEVEL, torch.float64, 'cuda'), truth)
                k2_against_truth(torch, what, x, xp, x64)
            if cfg.stop_criterion == 3:
                cfg3, iters = cfg, it.cpu().numpy()
        ms = time_ms(torch, lambda: solve_rows(*args, cfg3), reps=5)
        plain_ms = time_ms(torch, lambda: solve_rows_plain(*args, cfg3),
                           reps=1)
        op_flop, rest, moved = k2_work(torch, iters, h * w, dtype)
        if name == 'float32':
            k2_bound = bound(moved, rest, TF32_PASSES * op_flop)
            pipes = bound(moved, op_flop + rest)
        else:
            k2_bound = bound(moved, rest, op_flop, ops_rate=F64_FLOP_S,
                             tc_rate=F64_TC_FLOP_S)
            pipes = bound(moved, op_flop + rest, ops_rate=F64_FLOP_S)
        per_iter = ms / float(iters.sum())
        print(f'K2 shapes route {plan.route} {h}x{w} {name} B={b}: '
              f'{block["threads"]} threads, {block["smem"]} B shared, '
              f'{block["blocks_per_sm"]} blocks/SM ({block["instance"]}), '
              f'kernel {ms:.4f} ms, {per_iter * 1e3:.4f} us a '
              f'stamp-iteration ({int(iters.sum())} stamp-iterations), '
              f'plain {plain_ms:.4f} ms, bound {k2_bound["bound_ms"]:.4f} '
              f'ms ({k2_bound["bound_by"]}, the operator on the '
              f'{"TF32" if name == "float32" else "FP64"} tensor cores), '
              f'{pipes["bound_ms"]:.4f} ms all on the '
              f'{"FP32" if name == "float32" else "FP64"} pipes [{card}]')
        routes.append(dict(route=plan.route, shape=[h, w], dtype=name,
                           launches=launches, **block, ms=ms,
                           ms_per_stamp_iteration=per_iter,
                           plain_ms=plain_ms, max_abs_err=max_abs,
                           **k2_bound))
    k2_plan_sweep(torch)
    return routes


def count_launches(torch, fn) -> tuple:
    """Kernels the card ran during one call of ``fn`` (``torch.profiler``'s
    device events, memory copies and sets left out) and the host's
    ``cudaLaunchKernel`` and ``cudaLaunchCooperativeKernel`` calls in it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(('Memcpy', 'Memset'))]
    host = [e for e in prof.events()
            if e.name.startswith(('cudaLaunchKernel',
                                  'cudaLaunchCooperativeKernel'))]
    return len(device), len(host)


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Mean milliseconds of the card's work a call of ``fn``: ``reps``
    calls captured in one CUDA graph, the graph replayed between CUDA
    events, so that neither the host's work a call (which bounds a loop of
    calls of a short kernel) nor the profiler (which drops events late in
    a long process) enters the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_methods(torch) -> None:
    """Phase 9: each projection method on the card (cold 'bisect' there
    the guided kernel, the rest plain PyTorch) against the same call on
    the CPU, at the main path's (12288, 961), float32 and
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
              f'({host} launch calls)')


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
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.kernels.flux_projection import (launch_plan,
                                                       project_rows,
                                                       project_rows_plain,
                                                       section_steps)
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
                before = kernel_launches['project_rows.grid']
                got = project_rows(*args, steps, has_sat)
                check(kernel_launches['project_rows.grid'] == before + 1,
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


GUIDED_TOL = {'float32': 1e-5, 'float64': 1e-12}


def phase_guided_rows(torch) -> dict:
    """Phase 43: the cold guided secant of 'bisect' as one grid kernel on
    a whole frame's row, (1, 168100) with its pixels in registers and
    (1, 2048 * 2048) streamed by every block the card holds: the route
    must take the kernel by itself; x against the plain ladder on the card
    to ``GUIDED_TOL`` of max|x|, both flux errors. Then, float32 and
    float64 without saturation, the kernel's time against the plain
    ladder's, the launches a call of each (the kernel's counter; the
    profiler's launch calls and device kernels), and the bound. Prints the
    guided kernel's ptxas lines beside K1's grid kernel's. Returns the
    (1, 168100) numbers."""
    from tpu_sgp_torch.kernels import _build
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.kernels.flux_projection import (guided_plan,
                                                       guided_route)
    from tpu_sgp_torch.projection import flux_projection as tproj
    lib = _build.build('flux_projection')
    report = ptxas_summary(lib.with_name(lib.name + '.log').read_text())
    resident = occupancy('flux_projection')
    print('ptxas guided: ' + '; '.join(
        f'{k} {v}, {resident.get(k, "?")}' for k, v in report.items()
        if k.startswith(('project_rows_guided_grid_kernel',
                         'project_rows_grid_kernel'))))
    out, seed = {}, 430
    for rows, n in (LONG_ROWS[0], (1, FRAME_ROW)):
        for name in ('float32', 'float64'):
            dtype = getattr(torch, name)
            blocks, _, n_launches, _, _, streamed = guided_plan(rows, n,
                                                                dtype, 0)
            check(guided_route(dtype, 'cuda') == 'kernel'
                  and n_launches == 1 and streamed == (n == FRAME_ROW),
                  f'({rows}, {n}) {name}: the kernel takes the row in one '
                  f'launch')
            layout = (f'{blocks} blocks, '
                      f'{"streamed" if streamed else "in registers"}')
            for has_sat in (True, False):
                seed += 1
                b, c, dia, cap = projection_case(torch, rows, n, dtype,
                                                 has_sat, 'cuda', seed)
                scaling = torch.ones_like(b)
                sat = cap if has_sat else None
                before = kernel_launches['project_guided_rows']
                x = tproj.project('bisect', b, c, dia, scaling,
                                  sat_level=sat, has_sat=has_sat)
                check(kernel_launches['project_guided_rows'] == before + 1,
                      'the call took the guided kernel')
                xp = tproj._guided_root(b, c, dia, scaling, sat, has_sat,
                                        None)[0]
                torch.cuda.synchronize()
                rel = float((x - xp).abs().max() / xp.abs().max())
                flux = float(((x.double().sum(-1) - b) / b).abs().max())
                flux_p = float(((xp.double().sum(-1) - b) / b).abs().max())
                print(f'guided long row ({rows}, {n}) {name} has_sat='
                      f'{has_sat}: kernel ({layout}) vs plain ladder '
                      f'max|dx|/max|x|={rel:.3e} (limit '
                      f'{GUIDED_TOL[name]:.0e}) flux rel err kernel '
                      f'{flux:.3e} plain {flux_p:.3e}')
                check(bool(torch.isfinite(x).all()), 'finite kernel x')
                check(rel <= GUIDED_TOL[name],
                      'guided kernel agrees with plain')
                check(flux <= FLUX_RTOL[name] and flux <= flux_p + 1e-6,
                      'guided kernel conserves flux')
            b, c, dia, _ = projection_case(torch, rows, n, dtype, False,
                                           'cuda', 439)
            scaling = torch.ones_like(b)
            kern = lambda: tproj._guided_root_kernel(b, c, dia, scaling,
                                                     None, False, None)
            plain = lambda: tproj._guided_root(b, c, dia, scaling, None,
                                               False, None)
            ms = time_ms(torch, kern, reps=50)
            plain_ms = time_ms(torch, plain, reps=10)
            ms2 = time_ms(torch, kern, reps=50)
            before = kernel_launches['project_guided_rows']
            kern()
            counted = kernel_launches['project_guided_rows'] - before
            k_dev, k_host = count_launches(torch, kern)
            p_dev, p_host = count_launches(torch, plain)
            points = 4 + 3 * (tproj.newton_passes(dtype) + 1)
            size = 4 if name == 'float32' else 8
            # c and dia read once and x written (the kernel reads dia again
            # for x, and a streamed block c and dia in every phase, which is
            # not counted); per pixel 5 operations a residual point, 8 for
            # the bracket and the anchors, 4 for x
            work = bound(3 * rows * n * size, rows * n * (5 * points + 12),
                         ops_rate=F32_FLOP_S if size == 4 else F64_FLOP_S)
            print(f'guided long row time ({rows}, {n}) {name}: kernel '
                  f'{ms:.4f} ms (again {ms2:.4f}; {layout}), {counted} '
                  f'launch a call (counter), {k_host} launch calls and '
                  f'{k_dev} device kernels in the profiler; plain ladder '
                  f'{plain_ms:.4f} ms, {p_host} launch calls and {p_dev} '
                  f'device kernels in the profiler; bound '
                  f'{work["bound_ms"]:.5f} ms ({work["bound_by"]})')
            check(counted == 1, 'one launch a call')
            if n == LONG_ROWS[0][1]:
                out[name] = dict(ms=ms, plain_ms=plain_ms,
                                 plain_launches=p_host, **work)
    return out


# phase 44: the compensated row sum's shapes, (rows, pixels, dtype): a
# frame's row in both types, a stamp batch, and a 2048x2048 frame's row in
# both types
FF_SUM_SHAPES = ((1, 410 * 410, 'float32'), (1, 410 * 410, 'float64'),
                 (MAIN_B, N_PIX, 'float32'), (1, FRAME_ROW, 'float32'),
                 (1, FRAME_ROW, 'float64'))


def phase_compensated_sum(torch) -> dict:
    """Phase 44: the compensated row sum as one launch
    (``kernels.compensated_sum.ff_sum_rows``) against the plain tree
    (``ops.reduce.tree_sum_ff``) on the card, bit for bit, at
    ``FF_SUM_SHAPES``, on rows whose bits depend on the order of the sums;
    then the kernel's device time (calls in a CUDA graph) and its time a
    call through
    the wrapper (CUDA events: the larger of the kernel and the wrapper's
    host work), the plain tree's, the launches a call of each and the
    bound (each value read once, each sum written once). Prints
    the kernel's ptxas line. Returns the frame's float32 numbers."""
    from tpu_sgp_torch.kernels import _build
    from tpu_sgp_torch.kernels import compensated_sum as cs
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.ops.reduce import tree_sum_ff
    lib = _build.build('compensated_sum')
    report = ptxas_summary(lib.with_name(lib.name + '.log').read_text())
    resident = occupancy('compensated_sum')
    print('ptxas compensated_sum: ' + '; '.join(
        f'{k} {v}, {resident.get(k, "?")}' for k, v in report.items()))
    out = {}
    for rows, n, name in FF_SUM_SHAPES:
        dtype = getattr(torch, name)
        rng = np.random.default_rng(n + rows)
        k = n // 3
        big = rng.normal(0.0, 1.0, (rows, k)) * 10.0 ** rng.uniform(
            0, 8 if name == 'float32' else 24, (rows, k))
        vals = np.concatenate([big, -big, rng.normal(0.0, 1e-2,
                                                     (rows, n - 2 * k))], 1)
        x = torch.as_tensor(rng.permuted(vals, axis=1), dtype=dtype,
                            device='cuda')
        before = kernel_launches['ff_sum_rows']
        got = cs.ff_sum_rows(x)
        check(kernel_launches['ff_sum_rows'] == before + 1,
              'one launch a call')
        want = tree_sum_ff(x)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32 if name == 'float32'
                                else torch.int64)
        check(torch.equal(bits(got), bits(want)),
              f'({rows}, {n}) {name}: kernel bit-equal to the tree')
        reps = 50 if n < FRAME_ROW else 10
        ms = graph_ms(torch, lambda: cs.ff_sum_rows(x), reps=reps)
        ms2 = graph_ms(torch, lambda: cs.ff_sum_rows(x), reps=reps)
        wrapper_ms = time_ms(torch, lambda: cs.ff_sum_rows(x), reps=4 * reps)
        plain_ms = time_ms(torch, lambda: tree_sum_ff(x), reps=20)
        k_dev, k_host = count_launches(torch, lambda: cs.ff_sum_rows(x))
        p_dev, p_host = count_launches(torch, lambda: tree_sum_ff(x))
        size = 4 if name == 'float32' else 8
        # per value a read; per node (p - 1 of them) 8 operations
        p = 1 << (n - 1).bit_length()
        work = bound(size * rows * (n + 1), 8 * rows * p,
                     ops_rate=F32_FLOP_S if size == 4 else F64_FLOP_S)
        cols, levels, chunk = cs.ff_sum_plan(n, dtype)
        print(f'compensated sum ({rows}, {n}) {name}: bit-equal to the '
              f'plain tree; plan one block a row, {cols} columns x '
              f'2^{levels} read 2^{chunk} at a time; kernel '
              f'{ms:.4f} ms on the device (CUDA graph; again {ms2:.4f}), '
              f'{wrapper_ms:.4f} ms a call back to back through the wrapper '
              f'(CUDA events), {k_host} launch calls and '
              f'{k_dev} device kernels in the profiler; plain tree '
              f'{plain_ms:.4f} ms, {p_host} launch calls and {p_dev} device '
              f'kernels; bound {work["bound_ms"]:.5f} ms '
              f'({work["bound_by"]})')
        out[(rows, n, name)] = dict(ms=ms, wrapper_ms=wrapper_ms,
                                    plain_ms=plain_ms,
                                    plain_launches=p_host, **work)
    return out[FF_SUM_SHAPES[0]]


# phase 45: the beta objective's shapes, (rows, pixels, dtype, stable): the
# beta stamp cell's batch and the beta frame cell's row, each in float32
# with the compensated tree (the cells' case) and in float64 without (the
# solver's float64 case)
BETA_DIV_SHAPES = ((MAIN_B, N_PIX, 'float32', True),
                   (MAIN_B, N_PIX, 'float64', False),
                   (1, FRAME_ROW, 'float32', True),
                   (1, FRAME_ROW, 'float64', False))
# phase 45: kernel against plain version, max|d sum| over the row's sum of
# |term| (float32's objective with the tree: bit for bit)
BETA_DIV_TOL = {'float32': 1e-5, 'float64': 1e-12}


def beta_div_inputs(torch, rows: int, n: int, dtype):
    """den, gn, log gn and beta of phase 45: gn photon counts over five
    decades, den = gn e^d with d in [-0.6, 0.6] (|beta d| on both sides of
    the series switch at 0.25), den == gn on every seventh pixel, beta
    drawn from [0.9, 1.2] (the cell's start 1.005 in row 0)."""
    rng = np.random.default_rng(45)
    gn = rng.lognormal(np.log(300.0), 1.5, (rows, n))
    den = gn * np.exp(rng.uniform(-0.6, 0.6, (rows, n)))
    beta = rng.uniform(0.9, 1.2, rows)
    beta[0] = 1.005
    t = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    gn, den = t(gn), t(den)
    den[:, ::7] = gn[:, ::7]
    return den, gn, torch.log(gn), t(beta)


def phase_beta_objective(torch) -> dict:
    """Phase 45: the beta objective with its d/dbeta row sums as one launch
    (``kernels.beta_divergence.beta_div_rows``) against its plain version
    (``ops.divergence.beta_div_with_dbeta_plain``) on the card at
    ``BETA_DIV_SHAPES``; the kernel's and the plain version's device times
    (calls in a CUDA graph), the kernel's time a call through the wrapper
    (CUDA events), the launches a call of each and the bound (den, gn and
    log gn read once, beta read and two sums written once). Then one beta
    ``restore_stamps`` of phase 4's stamps: the kernel's launches against
    the objective's evaluations (one a line-search trial; a fresh solve's
    set-up evaluates the objective alone). Prints the kernel's ptxas line.
    Returns the float32 numbers."""
    from tpu_sgp_torch import SGPConfig, observability
    from tpu_sgp_torch.kernels import _build
    from tpu_sgp_torch.kernels import beta_divergence as bk
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.ops.divergence import beta_div_with_dbeta_plain
    from tpu_sgp_torch.parallel.batch import restore_stamps
    from tpu_sgp_torch.simulate import synthetic_star_field
    lib = _build.build('beta_divergence')
    report = ptxas_summary(lib.with_name(lib.name + '.log').read_text())
    resident = occupancy('beta_divergence')
    print('ptxas beta_divergence: ' + '; '.join(
        f'{k} {v}, {resident.get(k, "?")}' for k, v in report.items()))
    out = {}
    for rows, n, name, stable in BETA_DIV_SHAPES:
        dtype = getattr(torch, name)
        den, gn, lg, beta = beta_div_inputs(torch, rows, n, dtype)
        kernel = lambda: bk.beta_div_rows(den, gn, beta, lg, stable)
        plain = lambda: beta_div_with_dbeta_plain(den, gn, beta, lg,
                                                  stable=stable)
        before = kernel_launches['beta_div_rows']
        fv, dsum = kernel()
        check(kernel_launches['beta_div_rows'] == before + 1,
              'one launch a call')
        pf, pd = plain()
        one = lambda a: a.reshape(-1, 1)
        terms = beta_div_with_dbeta_plain(one(den), one(gn),
                                          beta.repeat_interleave(n), one(lg))
        f_scale, d_scale = (t.abs().reshape(rows, n).sum(-1) for t in terms)
        torch.cuda.synchronize()
        f_err = float(((fv - pf).abs() / f_scale).max())
        d_err = float(((dsum - pd).abs() / d_scale).max())
        bits = lambda t: t.view(torch.int32 if name == 'float32'
                                else torch.int64)
        same = bool(torch.equal(bits(fv), bits(pf)))
        if stable and name == 'float32':
            check(same, f'({rows}, {n}) {name}: objective bit-equal to the '
                        f'plain version')
        check(max(f_err, d_err) <= BETA_DIV_TOL[name],
              f'({rows}, {n}) {name}: kernel agrees with plain')
        reps = 50 if n < FRAME_ROW else 5
        ms = graph_ms(torch, kernel, reps=reps)
        ms2 = graph_ms(torch, kernel, reps=reps)
        wrapper_ms = time_ms(torch, kernel, reps=4 * reps)
        plain_ms = graph_ms(torch, plain, reps=3)
        plain_events_ms = time_ms(torch, plain, reps=20)
        k_dev, k_host = count_launches(torch, kernel)
        p_dev, p_host = count_launches(torch, plain)
        size = 4 if name == 'float32' else 8
        work = bound(size * rows * (3 * n + 3), 0.0)
        cols, levels, chunk = bk.beta_div_plan(n)
        print(f'beta objective ({rows}, {n}) {name} stable={stable}: '
              f'objective {"bit-equal to" if same else "not bit-equal to"} '
              f'the plain version, max |d fv| {f_err:.3e} and |d dsum| '
              f'{d_err:.3e} of the sums of |term| (limit '
              f'{BETA_DIV_TOL[name]:.0e}); plan one block a row, {cols} '
              f'columns x 2^{levels} read 2^{chunk} at a time; kernel '
              f'{ms:.4f} ms on the device (CUDA graph; again {ms2:.4f}), '
              f'{wrapper_ms:.4f} ms a call back to back through the wrapper '
              f'(CUDA events), {k_host} launch calls and {k_dev} device '
              f'kernels in the profiler; plain version {plain_ms:.4f} ms '
              f'(CUDA graph; {plain_events_ms:.4f} ms by CUDA events), '
              f'{p_host} launch calls and {p_dev} device kernels; bound '
              f'{work["bound_ms"]:.5f} ms ({work["bound_by"]})')
        out[(rows, n, name)] = dict(ms=ms, wrapper_ms=wrapper_ms,
                                    plain_ms=plain_ms,
                                    plain_launches=p_host, **work)
        del den, gn, lg, beta, terms, fv, dsum, pf, pd

    inputs = main_path_inputs(MAIN_B)
    restore(torch, inputs, 'cuda', path='beta section')      # warm-up
    before = kernel_launches['beta_div_rows']
    with observability.tracing() as trace:
        t0 = time.perf_counter()
        res = restore(torch, inputs, 'cuda', path='beta section')
        wall = time.perf_counter() - t0
    launched = kernel_launches['beta_div_rows'] - before
    passes = trace.get('beta.objective').count
    alone = sum(st.count for path, st in trace.by_path().items()
                if path[-2:] == ('solver.setup', 'beta.objective'))
    check(launched == passes - alone > 0,
          'one launch an objective evaluation with d/dbeta')
    print(f'beta objective in a beta restore_stamps of {MAIN_B} stamps '
          f'(traced, {wall:.3f} s): {launched} launches of beta_div_rows, '
          f'{passes} objective evaluations, {alone} of them in a set-up '
          f'(the objective alone), '
          f'{trace.get("beta.rows").count / MAIN_B:.2f} rows a stamp, '
          f'iterations median {float(res.iters.float().median()):g}')

    # the frame cell's path at 256x256: beta_div.pixels is launches x N
    img, psf, _ = synthetic_star_field(256, 256, n_stars=40, psf_size=31,
                                       fwhm=3.0, seed=46)
    cfg = SGPConfig(**dict(FRAME_BASE, max_iter=500, stop_criterion=3,
                           tol_convergence=1e-4, divergence='beta',
                           adapt_beta=True, schedule_lr=True,
                           lr_exp_param=0.1, projection_method='bisect',
                           operator='linear', stable_sums=True,
                           warm_projection=False))
    before = kernel_launches['beta_div_rows']
    with observability.tracing() as trace:
        res = restore_stamps(img[None], psf, np.array([FRAME_BKG]), cfg,
                             beta0=1.005, lr0=1e-3, device='cuda')
    frame_launched = kernel_launches['beta_div_rows'] - before
    pixels = trace.get('beta_div.pixels').count
    check(trace.get('beta_div.launches').count == frame_launched > 0
          and pixels == frame_launched * 256 * 256,
          'beta_div.pixels is beta_div.launches x N')
    print(f'beta frame 256x256 through restore_stamps (traced): '
          f'{frame_launched} launches of beta_div_rows, beta_div.pixels '
          f'{pixels} = launches x {256 * 256}, {int(res.iters[0])} '
          f'iterations, beta {float(res.beta[0]):.6f}')
    return dict(out[BETA_DIV_SHAPES[0][:3]], launches=launched)


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


def phase_frame(torch, card: str) -> tuple:
    """Phase 15: the whole-frame path. Returns the launches of K1 (all on
    the grid path) in one 200-iteration ``solve`` with 'pallas', and those
    of the guided kernel and of the compensated sum, each with the
    iterations, in one float32 facade ``sgp`` with cold 'bisect'."""
    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch.kernels import launches as kernel_launches
    img, psf = frame_inputs()

    # the facade: numpy in, numpy out, the card by default, cold 'bisect',
    # whose projection is the guided kernel, once a projection: the
    # initial one and one an iteration
    kw = dict(init_recon=2, proj_type=1, stop_criterion=3, MAXIT=500,
              tol_convergence=1e-5)
    tsgp.sgp(img, psf, FRAME_BKG, **dict(kw, MAXIT=3))          # warm-up
    kernel_launches.clear()
    x, iters, discr, times, err = tsgp.sgp(img, psf, FRAME_BKG, **kw)
    guided = dict(launches=kernel_launches['project_guided_rows'],
                  iters=int(iters))
    ff_sum = dict(launches=kernel_launches['ff_sum_rows'], iters=int(iters))
    check(isinstance(x, np.ndarray) and x.dtype == np.float32
          and err is None and discr.shape == times.shape == (iters + 1,),
          'sgp returns the reference\'s tuple')
    check(guided['launches'] == iters + 1, f'the guided kernel ran once a '
          f'projection ({guided["launches"]} launches in {iters} '
          f'iterations)')
    # the float32 objective's two compensated sums, at set-up and at each
    # line-search trial (at least one an iteration)
    check(ff_sum['launches'] >= 2 * (iters + 1)
          and ff_sum['launches'] % 2 == 0, f'the compensated sum ran twice '
          f'an objective ({ff_sum["launches"]} launches in {iters} '
          f'iterations)')
    flux = check_frame(torch, x, img, 'sgp 410x410')
    print(f'frame sgp 410x410 psf 31x31 float32 (linear, cold bisect, stop '
          f'3 at 1e-5): iters={iters} wall={times[-1]:.4f} s '
          f'({times[-1] * 1e3 / max(iters, 1):.3f} ms an iteration), guided '
          f'kernel launches={guided["launches"]}, compensated sum '
          f'launches={ff_sum["launches"]}, flux rel err={flux:.3e} '
          f'[{card}]')

    launches = None
    for method in ('bisect', 'pallas'):
        cfg_t = tsgp.SGPConfig(**FRAME_TIMED, projection_method=method)
        cfg_c = tsgp.SGPConfig(**FRAME_CONVERGED, projection_method=method)
        solve_frame(torch, img, psf, cfg_t.replace(max_iter=3))  # warm-up
        kernel_launches.clear()
        res_t, wall_t = solve_frame(torch, img, psf, cfg_t)
        counts = (kernel_launches['project_rows'],
                  kernel_launches['project_rows.grid'])
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
            check(counts == (0, 0), "'bisect' launches no K1")
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
    return launches, guided, ff_sum


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
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                       project_rows_plain,
                                                       section_steps)
    from tpu_sgp_torch.parallel.session import RestorationSession
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
                kernel_launches['project_rows'] = 0
            t0 = time.perf_counter()
            res = sess.restore(stamps, bkgs, fluxes)
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches[SERVE_B] = kernel_launches['project_rows']
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
            kernel_launches['project_rows'] = 0
            outs = list(sess.restore_stream(reqs['float64'], coalesce=4))
            launches[4 * SERVE_B] = kernel_launches['project_rows']
            check(len(outs) == 4 and launches[SERVE_B] > 0
                  and launches[4 * SERVE_B] > 0,
                  'the serving path launched the projection kernel')
            extra = (f', kernel launches {launches[SERVE_B]} a request, '
                     f'{launches[4 * SERVE_B]} a coalesced call of '
                     f'{4 * SERVE_B}')
        else:
            check(launches[SERVE_B] == 0, "'bisect' launches no K1")
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


def phase_server(torch, card: str) -> dict:
    """Phase 20: 64 client threads, released together, each submitting 16
    stamps to a ``MicroBatchServer`` (max_batch 1024, 2 ms window). Every
    future's result against ``session.restore`` of the client's own 16
    stamps: float32 as distributions over all 1024 lanes (a row of the
    dense product rounds differently in a batch of 16 than in one of 1024
    on cuBLAS, so bit-equality is reported, not required); the first 16
    clients again on a float64 session, lane for lane (equal iterations,
    x within 1e-7). Returns the float32 run's wall and device calls."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.parallel.session import (MicroBatchServer,
                                                RestorationSession)
    psf, reqs = serving_requests(SERVER_CLIENTS, CLIENT_B)
    runs = {}
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
        runs[dtype] = {'wall': wall, 'batches': batches}
    return runs['float32']


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
# detection threshold moves a segment, 1.454e-03 of FFD on one of 64 beta
# lanes on an H100 for restorations 1.5e-11 apart, ROADMAP.md), the
# radial-profile distance by its median (a least-squares fit that stops at
# its own tolerance)
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


# phases 29-30: the reference's raw-frame chain on seeded data at survey
# size (a 2048x2048 uint16 frame), then the NaN guard on the card
RAW_SIZE, RAW_STARS, RAW_SEED = 2048, 2000, 29
RAW_SATURATED = 5                 # stars bright enough to clip at 65535
CALIBRATION_SEED = 30
CUT = 410                         # the whole-frame workload's size
PSF_GRID = (2, 5)                 # nx, ny: the reference's sub-frame grid
# the PSF fit's settings: at most 6 stars a sub-frame (``max_stars``,
# default 100) and one flux-scale pass (``scale_iters``, default up to 3).
# The fit recentres every star, so its cost grows with the square of their
# number: 64 stars took minutes a sub-frame on a host CPU, 6 take 1-3 s,
# and one scale pass halves that with models as close to the truth
PSF_FIT = dict(max_stars=6, scale_iters=1)
QUANTIZE = 1.0                    # RICE_1 quantisation step of the result


def write_calibration_frames(directory: str, seed: int) -> None:
    """Five 2048x2048 uint16 bias frames (EXPTIME 0, the last with twice the
    others' noise) and three flats (IMAGETYP 'flat', the last with a mean
    above 50000), none with a FILTER card."""
    from tpu_sgp_torch.image import Header, write_fits
    rng = np.random.default_rng(seed)
    shape = (RAW_SIZE, RAW_SIZE)

    def u16(a):
        return np.clip(np.rint(a), 0, 65535).astype(np.uint16)
    for i, noise in enumerate((5.0, 5.5, 4.5, 5.2, 10.0)):
        write_fits(os.path.join(directory, f'bias_{i}.fits'),
                   u16(rng.normal(1000.0, noise, shape)),
                   Header({'EXPTIME': 0.0}))
    for i, level in enumerate((30000.0, 32000.0, 58000.0)):
        write_fits(os.path.join(directory, f'flat_{i}.fits'),
                   u16(rng.normal(level, 150.0, shape)),
                   Header({'EXPTIME': 2.0, 'IMAGETYP': 'flat'}))


def raw_frame() -> tuple:
    """The seeded raw frame: ``synthetic_star_field`` at 2048x2048 (2000
    stars, 31x31 PSF, FWHM 2.8) with five stars of 3e6 counts added,
    rounded and clipped to uint16. Returns (frame, the true PSF)."""
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(RAW_SIZE, RAW_SIZE, n_stars=RAW_STARS,
                                       psf_size=31, fwhm=2.8, seed=RAW_SEED)
    rng = np.random.default_rng(RAW_SEED)
    for y, x in rng.integers(64, RAW_SIZE - 64, (RAW_SATURATED, 2)):
        img[y - 15:y + 16, x - 15:x + 16] += 3e6 * psf
    return np.clip(np.rint(img), 0, 65535).astype(np.uint16), psf


def centre_cut(frame: np.ndarray) -> tuple:
    """The CUT x CUT cut at the frame's centre, as float64, and the key
    (ix, iy) of the PSF grid's sub-frame that holds its centre."""
    c0 = (RAW_SIZE - CUT) // 2
    cut = frame[c0:c0 + CUT, c0:c0 + CUT].astype(np.float64)
    nx, ny = PSF_GRID
    centre = RAW_SIZE // 2
    key = (min(centre // (RAW_SIZE // nx), nx - 1) + 1,
           min(centre // (RAW_SIZE // ny), ny - 1) + 1)
    return cut, key


def solver_psf(mat: np.ndarray) -> np.ndarray:
    """A fitted PSF matrix as the solver takes it: its negative wing pixels
    (a DIAPL model fitted to a few stars dips below 0) set to 0, then
    normalised to sum 1. Fed as is, a PSF with negative pixels stops the
    KL iteration after one step with a NaN discrepancy, in the JAX package
    too."""
    psf = np.maximum(mat, 0.0)
    return psf / psf.sum()


def restore_cut(cut, psf, sky):
    """The façade on the cut with the whole-frame workload's settings."""
    import tpu_sgp_torch as tsgp
    return tsgp.sgp(cut, psf, sky, init_recon=2, proj_type=1,
                    stop_criterion=3, MAXIT=500, tol_convergence=1e-5)


def trace_kernels(logdir: str) -> tuple:
    """The Chrome trace that ``profiled`` wrote into ``logdir``: (total
    microseconds by CUDA kernel name, device microseconds of every kernel,
    copy and set)."""
    names = [n for n in os.listdir(logdir) if n.endswith('.pt.trace.json')]
    check(len(names) == 1, f'one trace file in {logdir} ({names})')
    with open(os.path.join(logdir, names[0])) as f:
        events = json.load(f)['traceEvents']
    kernels: dict = {}
    device_us = 0.0
    for e in events:
        if e.get('ph') != 'X':
            continue
        if e.get('cat') == 'kernel':
            kernels[e['name']] = kernels.get(e['name'], 0.0) + e['dur']
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            device_us += e['dur']
    return kernels, device_us


class Beside:
    """One command run in the background beside a block of work, from the
    checkout's root: ``start`` it, read ``result`` later; leaving the
    block kills it if it still runs."""

    def __init__(self):
        self.proc = None
        self.done: list = []

    def start(self, cmd: list) -> None:
        import threading
        started = time.perf_counter()
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        self.waiter = threading.Thread(target=lambda: self.done.append(
            (self.proc.communicate(), time.perf_counter() - started)))
        self.waiter.start()

    def result(self, timeout: float) -> tuple:
        """(exit code, stdout, stderr, seconds from start to exit)."""
        self.waiter.join(timeout)
        check(bool(self.done), f'{self.proc.args} ended in {timeout} s')
        (stdout, stderr), seconds = self.done[0]
        return self.proc.returncode, stdout, stderr, seconds

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.waiter.join()


def phase_raw_frame(torch, card: str) -> dict:
    """Phase 29: the reference's raw-frame chain, seeded, at survey size.
    (a) ``preprocess.cull_frames`` on five bias frames and three flats,
    and ``python -m tpu_sgp_torch.preprocess`` on a fresh copy; (b) the raw
    frame written as fpack RICE_1 and read back bit for bit, the native and
    pure-Python codecs equal on a 256-row slice; (c) ``psf_estimation``
    over the 2x5 grid: every written PSF 31x31, finite, of sum 1, every
    ``.coo`` readable; (d) the centre cut restored on the card with the
    PSF of its sub-frame under ``observability.timed``; (e) the same cut
    through ``solve`` with 'pallas' under ``observability.profiled``: the
    trace names the projection kernel's grid path; (f) the restoration
    written compressed, GZIP_2 bit for bit and RICE_1 within half a
    quantisation step. Returns what phase 30 needs."""
    import shutil
    import tempfile

    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch import observability, preprocess
    from tpu_sgp_torch.image import (getheader, read_fits,
                                     write_fits_compressed)
    from tpu_sgp_torch.image import tile_compression as tc
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.psf import pipeline, read_coo
    from tpu_sgp_torch.solvers.sgp import solve
    from tpu_sgp_torch.utils import sigma_clipped_stats
    with tempfile.TemporaryDirectory() as tmp, Beside() as cli:
        # (a) calibration frames
        frames, fresh = os.path.join(tmp, 'cal'), os.path.join(tmp, 'cal2')
        os.makedirs(frames)
        t0 = time.perf_counter()
        write_calibration_frames(frames, CALIBRATION_SEED)
        shutil.copytree(frames, fresh)
        made = time.perf_counter() - t0
        cli.start([sys.executable, '-m', 'tpu_sgp_torch.preprocess', fresh,
                   '--default-filter', 'R'])
        t0 = time.perf_counter()
        rep = preprocess.cull_frames(frames, default_filter='R')
        cull_s = time.perf_counter() - t0
        moved = sorted(os.listdir(os.path.join(frames, 'BadFrames')))
        kept = sorted(n for n in os.listdir(frames) if n.endswith('.fits'))
        check(moved == ['bias_4.fits', 'flat_2.fits'] and
              [os.path.basename(p) for p in rep.bad_biases + rep.bad_flats]
              == moved and len(rep.biases) == 5 and len(rep.flats) == 3,
              f'cull: the noisy bias and the bright flat rejected ({moved})')
        check(all(('FILTER' in getheader(os.path.join(frames, n))) ==
                  n.startswith('flat') for n in kept) and
              len(rep.filter_fixed) == 3, 'cull: FILTER written into the '
              'flats')
        print(f'raw chain cull 5 bias + 3 flat {RAW_SIZE}x{RAW_SIZE} uint16: '
              f'cull_frames {cull_s:.4f} s, rejected {moved}, FILTER fixed '
              f'on {len(rep.filter_fixed)}; frames made in {made:.4f} s')

        # (b) the compressed raw frame
        t0 = time.perf_counter()
        frame, true_psf = raw_frame()
        made = time.perf_counter() - t0
        raw = os.path.join(tmp, 'raw.fits.fz')
        t0 = time.perf_counter()
        write_fits_compressed(raw, frame, compression='RICE_1')
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, hdr = read_fits(raw)
        read_s = time.perf_counter() - t0
        ratio = frame.nbytes / os.path.getsize(raw)
        check(back.dtype == np.uint16 and np.array_equal(back, frame),
              'RICE_1 raw frame read back bit for bit')
        native = tc.rice_native_available()
        check(native, 'the C++ Rice codec builds with g++')
        rows = (frame[:256].astype(np.int32) - 32768).astype(np.int16).ravel()
        t0 = time.perf_counter()
        enc = tc.rice_encode(rows)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc_py = tc._rice_encode_py(rows, 32)
        py_s = time.perf_counter() - t0
        check(enc == enc_py and np.array_equal(
            tc.rice_decode(enc, rows.size, 2).view(np.int16), rows),
            'native and pure-Python Rice codecs: equal bytes')
        saturated = int((frame == 65535).sum())
        print(f'raw chain RICE_1 {RAW_SIZE}x{RAW_SIZE} uint16 ({saturated} '
              f'saturated pixels): native codec {native}; ratio {ratio:.4f}; '
              f'write {write_s:.4f} s, read {read_s:.4f} s, bit-equal; 256-row '
              f'slice native {native_s:.4f} s, pure Python {py_s:.4f} s, equal '
              f'bytes; frame made in {made:.4f} s')

        # (c) PSF estimation over the reference's 2x5 grid
        psf_dir = os.path.join(tmp, 'psf')
        nx, ny = PSF_GRID
        t0 = time.perf_counter()
        models = pipeline.psf_estimation(back.astype(np.float64), nx=nx,
                                         ny=ny, out_dir=psf_dir, name='raw',
                                         **PSF_FIT)
        psf_s = time.perf_counter() - t0
        files = sorted(os.listdir(psf_dir))
        mats = {}
        for key in models:
            stem = f'raw_{key[0]}_{key[1]}'
            mat, _ = read_fits(os.path.join(psf_dir, f'psf{stem}_img.fits'))
            check(mat.shape == (31, 31) and bool(np.isfinite(mat).all()) and
                  abs(float(mat.sum()) - 1.0) <= 1e-6,
                  f'psf{stem}_img.fits: 31x31, finite, sum 1')
            check(len(read_coo(os.path.join(psf_dir, f'{stem}.coo'))) > 0,
                  f'{stem}.coo reads back')
            mats[key] = mat
        check(len(files) == 3 * len(models) and len(models) >= 1,
              f'psf_estimation wrote its files ({len(files)})')
        dist = [float(np.linalg.norm(m - true_psf) / np.linalg.norm(true_psf))
                for m in mats.values()]
        negative = [int((m < 0).sum()) for m in mats.values()]
        print(f'raw chain psf_estimation {nx}x{ny} grid, {PSF_FIT}: '
              f'{len(models)} of {nx * ny} sub-frames with a model, host '
              f'{psf_s:.4f} s; PSF vs the true Gaussian relative L2 median '
              f'{np.median(dist):.4f} max {max(dist):.4f}; negative pixels '
              f'a model {negative}')

        # the command line, run beside (a)-(c) on the fresh copy
        returncode, stdout, stderr, cli_s = cli.result(timeout=300)
        counts = [line for line in stdout.splitlines()
                  if not line.startswith('  moved')]
        check(returncode == 0 and counts == [
            'biases: 5 (rejected 1)', 'flats: 3 (rejected 1)',
            'FILTER fixed on 3 frames'], f'python -m '
            f'tpu_sgp_torch.preprocess: {stdout!r} {stderr[-300:]!r}')
        print(f'raw chain python -m tpu_sgp_torch.preprocess on a copy of the '
              f'frames: the same counts, {cli_s:.4f} s (a fresh interpreter, '
              f'run beside the cull, the compressed frame and psf_estimation)')

        # (d) restore the centre cut on the card
        cut, key = centre_cut(back)
        check(key in mats, f'a PSF model for the centre sub-frame {key}')
        psf = solver_psf(mats[key])
        sky = sigma_clipped_stats(cut)[1]
        (x, iters, _, _, _), best = observability.timed(
            restore_cut, cut, psf, sky, repeats=3)
        flux = float((cut - sky).sum())
        err = abs(float(x.astype(np.float64).sum()) - flux) / flux
        check(bool(np.isfinite(x).all()) and x.shape == cut.shape and
              iters > 1 and err <= FLUX_RTOL['float32'], f'restored cut '
              f'finite, {iters} iterations, flux kept ({err:.3e})')
        print(f'raw chain sgp {CUT}x{CUT} centre cut, PSF of sub-frame {key} '
              f'({int((mats[key] < 0).sum())} negative pixels set to 0), sky '
              f'{sky:.4f}, float32 (linear, cold bisect, stop 3 at 1e-5): '
              f'iters={iters} best wall of 3 {best:.4f} s (timed) flux rel '
              f'err={err:.3e} [{card}]')

        # (e) profile the 'pallas' solve
        cfg = tsgp.SGPConfig(**FRAME_CONVERGED, projection_method='pallas')
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device='cuda')
        gn, psf_d = t(cut[None]), t(psf)
        bkg, z = torch.full_like(gn, sky), torch.zeros_like(gn)
        run_solve = lambda: solve(gn, psf_d, bkg, z, 0.0, z, 1.0, 1e-3, 0.0,
                                  cfg)
        run_solve()                                           # warm-up
        torch.cuda.synchronize()
        logdir = os.path.join(tmp, 'trace')
        launches = kernel_launches['project_rows.grid']
        with observability.profiled(logdir):
            t0 = time.perf_counter()
            res = run_solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_launches['project_rows.grid'] - launches
        kernels, device_us = trace_kernels(logdir)
        grid = [n for n in kernels if 'project_rows_grid_kernel' in n]
        it = int(res.iters[0])
        check(bool(grid) and launches == it + 1, f'the trace names the '
              f'projection kernel\'s grid path ({grid}), {launches} '
              f'launches for {it} iterations')
        check(bool(torch.isfinite(res.x).all()), "'pallas' cut finite")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f'raw chain profile {CUT}x{CUT} float32 pallas: {it} iterations'
              f', wall {wall:.4f} s (profiled), card busy '
              f'{device_us / 1e3:.3f} ms ({100 * device_us / 1e6 / wall:.1f} '
              f'% of the wall); grid-path launches {launches}; top kernels: '
              + '; '.join(f'{n[:60]} {us / 1e3:.3f} ms' for n, us in top)
              + f' [{card}]')

        # (f) write the restoration compressed
        out_gz = os.path.join(tmp, 'restored_gzip.fits')
        out_rice = os.path.join(tmp, 'restored_rice.fits')
        write_fits_compressed(out_gz, x, compression='GZIP_2')
        gz, _ = read_fits(out_gz)
        check(gz.dtype == x.dtype and np.array_equal(gz, x),
              'GZIP_2 restoration read back bit for bit')
        write_fits_compressed(out_rice, x, compression='RICE_1',
                              quantize_scale=QUANTIZE)
        rice, _ = read_fits(out_rice)
        # the read-back value is rounded to float32 once more
        limit = QUANTIZE / 2 + float(np.spacing(np.abs(x).max()))
        q_err = float(np.abs(rice.astype(np.float64) - x).max())
        check(q_err <= limit, f'RICE_1 quantised within q/2 ({q_err})')
        print(f'raw chain write restored {CUT}x{CUT} float32: GZIP_2 '
              f'{os.path.getsize(out_gz)} bytes bit-equal; RICE_1 q='
              f'{QUANTIZE} {os.path.getsize(out_rice)} bytes, max error '
              f'{q_err:.6f} (limit {limit:.6f})')
    return dict(cut=cut, psf=psf, sky=sky, x=x)


def centre_inputs() -> dict:
    """Phase 29's solve inputs when phase 30 runs alone: the raw frame's
    centre cut and the PSF fitted to its sub-frame (``psf_estimation``
    fits each sub-frame alone, so this is the same model)."""
    from tpu_sgp_torch.psf import pipeline
    from tpu_sgp_torch.utils import sigma_clipped_stats
    frame, _ = raw_frame()
    cut, key = centre_cut(frame)
    nx, ny = PSF_GRID
    sub = dict((k, c) for c, k in pipeline.cut_subframes(
        frame, nx=nx, ny=ny))[key]
    model, _ = pipeline.estimate_psf_model(np.asarray(sub.data, np.float64),
                                           **PSF_FIT)
    sky = sigma_clipped_stats(cut)[1]
    psf = solver_psf(model.normalized_matrix(31))
    return dict(cut=cut, psf=psf, sky=sky, x=restore_cut(cut, psf, sky)[0])


def phase_nan_guard(torch, inputs: dict) -> None:
    """Phase 30: ``observability.nan_guard`` on CUDA tensors. log(-1)
    raises under the guard and not outside it; a disabled guard around
    phase 29's solve changes no bit of x; phase 29's solve under the guard
    raises (the port's solver makes Inf by design, and every operation is
    checked); the guard is off afterwards."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from tpu_sgp_torch import observability
    minus_one = torch.tensor(-1.0, device='cuda')
    try:
        with observability.nan_guard():
            torch.log(minus_one)
        raised = False
    except FloatingPointError:
        raised = True
    check(raised, 'log(-1) on the card raises under the guard')
    check(bool(torch.isnan(torch.log(minus_one))), 'and not outside it')
    with observability.nan_guard(enable=False):
        x = restore_cut(inputs['cut'], inputs['psf'], inputs['sky'])[0]
    check(np.array_equal(x, inputs['x']), 'a disabled guard changes no bit')
    t0 = time.perf_counter()
    try:
        with observability.nan_guard():
            restore_cut(inputs['cut'], inputs['psf'], inputs['sky'])
        message = None
    except FloatingPointError as exc:
        message = str(exc)
    raised_s = time.perf_counter() - t0
    check(message is not None, 'the solve raises under the guard')
    check(not _get_current_dispatch_mode_stack() and
          bool(torch.isnan(torch.log(minus_one))), 'the guard is off again')
    print(f'nan_guard on the card: log(-1) raises under it, NaN outside; '
          f'disabled around the {CUT}x{CUT} solve: x bit-equal; enabled: '
          f'raised after {raised_s:.4f} s ({message}); off afterwards')


# ---- phases 31-33: multi-rank worlds, one process a rank ------------------

# the JAX multi-chip bench call (bench.py:668-674)
MESH_COMPACTION = dict(flatten=True, phase1_iters=31, tail_bucket=512)
MESH_PATHS = ('kl bisect', 'pallas')
MESH_F64_B = 256
# phase 32: a 2048x2048 field under a 31x31 PSF (phases 26 and 29's size)
MESH_FRAME = dict(height=2048, width=2048, n_stars=2500, psf_size=31,
                  fwhm=3.0, seed=26)
MESH_F64_ITERS = 20                # f64 fixed iterations, held to 'linear'
MESH_F32_ITERS = 20                # f32 fixed iterations, ms an iteration
# float64 held lane for lane takes the default cold 'bisect': its guided
# secant ends at the root to rounding, where the warm sectioning ends at a
# bracket whose points differ under mesh axes (7 a step, not 3)
MESH_F64 = dict(FRAME_BASE, dtype='float64', stop_criterion=1,
                warm_projection=False)
# phase 33: four 1024x1024 fields on (batch 2, ty 1, tx 2), stop rule 3
MESH_BATCH = dict(height=1024, width=1024, n_stars=600, psf_size=31,
                  fwhm=3.0)
MESH_BATCH_SEEDS = (31, 32, 33, 34)
# (one field stops at 18 iterations, three run to 25: one batch group's
# lanes part and the groups run in lockstep)
MESH_BATCH_CFG = dict(MESH_F64, max_iter=25, stop_criterion=3,
                      tol_convergence=3e-3)
MESH_RESUME_AT = 10                # phase 33's checkpoint, of phase 32's 20
MESH_RTOL = 1e-9                   # f64 sharded against one device
# ... but K1 in float64 ends its sectioning at a bracket of width * 8^-18:
# a sign census that one ulp of input flips moves lambda by a whole
# section, and a shard's GEMM rounds otherwise than the whole batch's
# (cuBLAS picks its algorithm by the row count), so 'pallas' stamps are
# held to the card's float64 bar of phase 5
MESH_RTOL_STAMPS = {'kl bisect': MESH_RTOL, 'pallas': 1e-7}
MESH_TIMEOUT = 420                 # seconds a world's ranks may take
MESH_SHIPS = 20                    # timed shippings of one full batch
# two worlds: NCCL, one rank, as a user with one card a rank runs it; and
# four gloo ranks sharing the card, the only way one card exchanges halos.
# The gloo ranks play two hosts of two ranks each (as torchrun sets
# LOCAL_WORLD_SIZE), for make_multiprocess_mesh's placement.
MESH_WORLDS = (('nccl', 1, {}), ('gloo', 4, {'LOCAL_WORLD_SIZE': '2'}))


@functools.lru_cache(maxsize=1)
def mesh_frame():
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(**MESH_FRAME)
    return img, psf


def mesh_batch():
    from tpu_sgp_torch.simulate import synthetic_star_field
    fields = [synthetic_star_field(**MESH_BATCH, seed=s)
              for s in MESH_BATCH_SEEDS]
    return np.stack([f[0] for f in fields]), fields[0][1]


def rank_stamps(torch, dist, n: int) -> dict:
    """Phase 31 in a rank: the main path's stamps sharded over a
    ('batch',) mesh of the world, default 'bisect' and 'pallas': float64
    at B=256, then float32 at full width, counted (K1's launches set to 0
    just before, read just after) and then timed."""
    from torch.distributed.device_mesh import DeviceMesh
    from tpu_sgp_torch import SGPConfig, restore_stamps
    from tpu_sgp_torch.kernels import launches as kernel_launches
    mesh = DeviceMesh('cuda', torch.arange(n), mesh_dim_names=('batch',))
    stamps, psf, bkgs, fluxes = main_path_inputs(MAIN_B)
    out = {}
    for path in MESH_PATHS:
        cfg = PATHS[path][0]
        r64 = restore_stamps(stamps[:MESH_F64_B], psf, bkgs[:MESH_F64_B],
                             SGPConfig(**{**cfg, 'dtype': 'float64'}),
                             fluxes=fluxes[:MESH_F64_B], sat_level=SAT_LEVEL,
                             mesh=mesh, **MESH_COMPACTION)
        out[f'{path}/f64_x'] = r64.x.cpu().numpy()
        out[f'{path}/f64_iters'] = r64.iters.cpu().numpy()
        walls = []
        for i in range(2):
            torch.cuda.synchronize()
            dist.barrier()
            if i == 0:
                kernel_launches['project_rows'] = 0
            t0 = time.perf_counter()
            res = restore_stamps(stamps, psf, bkgs, SGPConfig(**cfg),
                                 fluxes=fluxes, sat_level=SAT_LEVEL,
                                 mesh=mesh, **MESH_COMPACTION)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches = kernel_launches['project_rows']
                check(res.x.is_cuda and tuple(res.x.shape) == stamps.shape
                      and bool(torch.isfinite(res.x).all()),
                      'finite stamps of the batch\'s shape on the card')
                flux = (res.x.double().sum((1, 2)).cpu().numpy() - fluxes)
                out[f'{path}/flux_err'] = float(np.abs(flux / fluxes).max())
        out[f'{path}/iters'] = res.iters.cpu().numpy()
        every = [None] * n
        dist.all_gather_object(every, (launches, walls[1]))
        out[f'{path}/launches'] = np.array([e[0] for e in every])
        out[f'{path}/walls'] = np.array([e[1] for e in every])
    out.update({f'server/{k}': v
                for k, v in rank_server(torch, dist, mesh).items()})
    return out


def rank_server(torch, dist, mesh) -> dict:
    """Phase 31's server: a ``MicroBatchServer`` over a session on the
    ('batch',) mesh on every rank, every request submitted on the first
    rank, for each path. float32: phase 20's 64 client threads of 16
    stamps, released together (max_batch 1024, 2 ms window, every bucket
    warmed), K1's launches counted on every rank (set to 0 just before,
    read just after); then one full batch's shipping, the header and the
    packed buffer broadcast from the first rank, timed. float64: 4
    requests of 16 stamps from 4 threads at once, against a session on
    one device."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.kernels import launches as kernel_launches
    from tpu_sgp_torch.parallel.session import (MicroBatchServer,
                                                RestorationSession)
    first = dist.get_rank() == 0
    psf, reqs = serving_requests(SERVER_CLIENTS, CLIENT_B)
    reqs = reqs['float64']

    def serve(session, clients, **kw):
        """Every rank serves; the first rank's clients submit together.
        Returns (results, wall seconds) on the first rank, ([], 0)
        elsewhere, and the server."""
        got, wall = [], 0.0
        with MicroBatchServer(session, **kw) as server:
            if first:
                gate = threading.Barrier(clients + 1)

                def client(i):
                    gate.wait()
                    return server.restore(*reqs[i])

                with ThreadPoolExecutor(clients) as pool:
                    futs = [pool.submit(client, i) for i in range(clients)]
                    gate.wait()
                    t0 = time.perf_counter()
                    got = [f.result(timeout=MESH_TIMEOUT) for f in futs]
                    wall = time.perf_counter() - t0
        return got, wall, server

    out = {}
    for path in MESH_PATHS:
        cfg = PATHS[path][0]
        session = RestorationSession(psf, SGPConfig(**cfg), mesh=mesh)
        session.warmup(max_batch=SERVER_CLIENTS * CLIENT_B)
        torch.cuda.synchronize()
        dist.barrier()
        kernel_launches['project_rows'] = 0
        got, wall, server = serve(session, SERVER_CLIENTS, max_batch=1024,
                                  max_delay_s=0.002)
        launches = kernel_launches['project_rows']
        if first:
            out[f'{path}/f32_x'] = np.concatenate([g.x for g in got])
            out[f'{path}/f32_iters'] = np.concatenate([g.iters for g in got])
            out[f'{path}/f32_wall'] = wall
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (server.batches_served,
                                       server.requests_served, launches))
        out[f'{path}/f32_served'] = np.array(every)
        if path == MESH_PATHS[0]:
            # one full batch's shipping, in turns on every rank
            sizes = [CLIENT_B] * SERVER_CLIENTS
            wire = torch.zeros((len(sizes) * CLIENT_B, N_PIX + 3),
                               dtype=torch.float32,
                               device=server.session.device)
            head = (sizes, 'packed', tuple(wire.shape))
            ship = (lambda: server._ship(head, wire)) if first \
                else server._ship
            ship()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(MESH_SHIPS):
                ship()
            torch.cuda.synchronize()
            out['ship_ms'] = (time.perf_counter() - t0) / MESH_SHIPS * 1e3
            out['ship_bytes'] = wire.nbytes

        cfg64 = SGPConfig(**{**cfg, 'dtype': 'float64'})
        session = RestorationSession(psf, cfg64, mesh=mesh)
        session.warmup(buckets=(16, 32, 64))
        got, wall, server = serve(session, 4, max_batch=64)
        if first:
            alone = RestorationSession(psf, cfg64)
            alone.warmup(buckets=(CLIENT_B,))
            want = [alone.restore(*reqs[i]) for i in range(4)]
            out[f'{path}/f64_wall'] = wall
            out[f'{path}/f64_iters_equal'] = all(
                np.array_equal(g.iters, w.iters) for g, w in zip(got, want))
            out[f'{path}/f64_rel'] = max(float(lane_rel(g.x, w.x).max())
                                         for g, w in zip(got, want))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, server.batches_served)
        out[f'{path}/f64_batches'] = np.array(every)
    return out


def rank_frame(torch, dist, n: int) -> dict:
    """Phase 32 in a rank: the 2048x2048 field through
    ``solve_distributed`` on a 1x1 or 2x2 mesh: float64 at 20 fixed
    iterations; float32 at 20 fixed iterations (ms an iteration, the
    collectives an iteration) and by stop rule 3 at 1e-5; a bare
    all-reduce of one value and a halo exchange of one strip, timed."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.ops import mesh as mesh_ops
    from tpu_sgp_torch.parallel.distributed import (make_image_mesh,
                                                    solve_distributed)
    mesh = make_image_mesh((1, 1) if n == 1 else (2, 2))
    img, psf = mesh_frame()
    out = {}
    cfg = SGPConfig(**MESH_F64, max_iter=MESH_F64_ITERS)
    res = solve_distributed(img, psf, FRAME_BKG, cfg, mesh)
    out['f64_x'], out['f64_iters'] = res.x.cpu().numpy(), int(res.iters)
    fixed = SGPConfig(**{**FRAME_BASE, 'max_iter': MESH_F32_ITERS,
                         'stop_criterion': 1})
    solve_distributed(img, psf, FRAME_BKG, fixed.replace(max_iter=2), mesh)
    for name, cfg in (('fixed', fixed),
                      ('converged', SGPConfig(**FRAME_CONVERGED))):
        torch.cuda.synchronize()
        dist.barrier()
        calls = dict.fromkeys(mesh_ops.CALLS, 0)
        mesh_ops.CALLS.update(calls)
        t0 = time.perf_counter()
        res = solve_distributed(img, psf, FRAME_BKG, cfg, mesh)
        torch.cuda.synchronize()
        out[f'{name}_wall'] = time.perf_counter() - t0
        out[f'{name}_iters'] = int(res.iters)
        out[f'{name}_calls'] = np.array([mesh_ops.CALLS[k]
                                         for k in sorted(calls)])
        check(bool(torch.isfinite(res.x).all()), 'a finite frame')
    out['call_kinds'] = np.array(sorted(calls))
    axes = mesh_ops.MeshAxes(mesh, ('ty', 'tx'))
    one = torch.ones(1, device='cuda')
    strip = torch.ones((1, MESH_FRAME['height'] // axes.shape[0], 15),
                       device='cuda')
    for name, fn, reps in (('all_reduce', lambda: axes.all_reduce(one), 50),
                           ('exchange', lambda: axes.exchange(
                               'tx', strip, strip), 20)):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[f'{name}_ms'] = (time.perf_counter() - t0) / reps * 1e3
    return out


def rank_combined(torch, dist, outdir: str) -> dict:
    """Phase 33 in a rank of the four: ``solve_distributed_batch`` on
    (batch 2, ty 1, tx 2); ``make_multiprocess_mesh`` over the same ranks;
    phase 32's frame checkpointed on the 2x2 mesh and resumed on 4x1."""
    from torch.distributed.device_mesh import DeviceMesh
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.ops.mesh import MeshAxes
    from tpu_sgp_torch.parallel.distributed import (
        make_batch_image_mesh, make_image_mesh, resume_distributed,
        solve_distributed, solve_distributed_batch)
    from tpu_sgp_torch.parallel.multiprocess import make_multiprocess_mesh
    from tpu_sgp_torch.solvers.checkpoint import load_state, save_state
    out = {}
    mesh3 = make_batch_image_mesh(2)
    placed = make_multiprocess_mesh((1, 2))
    out['batch_mesh'] = mesh3.mesh.numpy()
    out['mp_mesh'] = placed.mesh.numpy()
    out['mp_spatial'] = np.array(MeshAxes(placed, ('ty', 'tx')).ranks)
    imgs, psf = mesh_batch()
    t0 = time.perf_counter()
    res = solve_distributed_batch(imgs, psf, FRAME_BKG,
                                  SGPConfig(**MESH_BATCH_CFG), mesh3)
    torch.cuda.synchronize()
    out['batch_wall'] = time.perf_counter() - t0
    out['batch_x'] = res.x.cpu().numpy()
    out['batch_iters'] = res.iters.cpu().numpy()

    img, psf = mesh_frame()
    cfg = MESH_F64
    _, state = solve_distributed(img, psf, FRAME_BKG,
                                 SGPConfig(**cfg, max_iter=MESH_RESUME_AT),
                                 make_image_mesh((2, 2)), return_state=True)
    path = os.path.join(outdir, 'frame_ckpt')
    if dist.get_rank() == 0:
        save_state(path, state)
    dist.barrier()
    tall = DeviceMesh('cuda', torch.arange(4).reshape(4, 1),
                      mesh_dim_names=('ty', 'tx'))
    res, _ = resume_distributed(img, psf, FRAME_BKG, load_state(path),
                                SGPConfig(**cfg, max_iter=MESH_F64_ITERS),
                                tall)
    out['resume_x'], out['resume_iters'] = res.x.cpu().numpy(), \
        int(res.iters)
    return out


def rank_main(args: list) -> int:
    """A rank of a phase 31-33 world: ``--rank <backend> <rank> <world>
    <port> <dir> <parts>``. Joins the group on the card, runs its phases
    (``parts`` 'all': phases 31-33 and the examples of phases 37 and 41;
    'examples': those alone), and rank 0 writes the results to
    ``<dir>/results.npz``."""
    import torch
    import torch.distributed as dist
    from tpu_sgp_torch.parallel.multiprocess import init_distributed
    backend, rank, n, port, outdir, parts = args
    rank, n = int(rank), int(n)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the world's ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_distributed(f'127.0.0.1:{port}', n, rank, local_device_ids=[0],
                     backend=backend)
    out = {}
    if parts == 'all':
        out.update({f'stamps/{k}': v
                    for k, v in rank_stamps(torch, dist, n).items()})
        out.update({f'frame/{k}': v
                    for k, v in rank_frame(torch, dist, n).items()})
        if n == 4:
            out.update({f'combined/{k}': v for k, v in
                        rank_combined(torch, dist, outdir).items()})
    out.update({f'examples/{k}': v
                for k, v in rank_examples(torch, dist, n).items()})
    every = [None] * n
    dist.all_gather_object(every, str(torch.cuda.current_device()))
    out['devices'] = np.array(every)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(outdir, 'results.npz'), **out)
    dist.destroy_process_group()
    return 0


def run_world(backend: str, n: int, env: dict, outdir: str,
              parts: str = 'all') -> tuple:
    """Start the ``n`` ranks of one world as processes of their own and
    wait for them all, at most MESH_TIMEOUT seconds. A rank that exits
    non-zero or runs past the limit fails the phase; every rank still
    running is killed. Returns (results, wall seconds)."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    os.makedirs(outdir, exist_ok=True)
    logs = [open(os.path.join(outdir, f'rank{r}.log'), 'w')
            for r in range(n)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--rank', backend,
         str(r), str(n), str(port), outdir, parts], stdout=logs[r],
        stderr=subprocess.STDOUT, env=dict(os.environ, **env))
        for r in range(n)]
    try:
        deadline = t0 + MESH_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        with open(os.path.join(outdir, f'rank{r}.log')) as f:
            print(f'rank {r} of {backend} x{n} exited {procs[r].returncode}'
                  f':\n{f.read()[-3000:]}', file=sys.stderr)
    check(not failed, f'every rank of the {backend} x{n} world exits 0 '
          f'within {MESH_TIMEOUT} s')
    with np.load(os.path.join(outdir, 'results.npz'),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}, wall


def restore_on_card(torch, stamps, psf, bkgs, cfg, fluxes) -> tuple:
    """``restore_stamps`` on one device with phase 31's call, timed after
    one warm-up call: (the result as numpy arrays, wall seconds)."""
    from tpu_sgp_torch import SGPResult, restore_stamps
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                             sat_level=SAT_LEVEL, **MESH_COMPACTION)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return SGPResult(*(f.cpu().numpy() for f in res)), wall


def phase_mesh(torch, card: str, phase20=None) -> tuple:
    """Phases 31-33: each world's ranks run their phases (``rank_main``);
    here, the single-device results on the card they are held to, and the
    lines, with phase 20's one-device server (``phase20``, when it ran)
    beside the meshed server's. Returns K1's kernels entries at a rank's
    shard of the gloo world, of the main path's stamps and of a served
    batch, and the worlds' results (phases 37 and 41 read their
    examples')."""
    import tempfile
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                       project_rows_plain)
    from tpu_sgp_torch.projection.flux_projection import section_steps
    worlds = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        for backend, n, env in MESH_WORLDS:
            worlds[backend, n] = run_world(backend, n, env,
                                           os.path.join(tmp, f'{backend}{n}'))
    for backend, n, _ in MESH_WORLDS:
        res, wall = worlds[backend, n]
        print(f'mesh world {backend} x{n}: ranks on cuda:'
              f'{",".join(res["devices"])} of one card, phases 31-'
              f'{33 if n == 4 else 32} in {wall:.1f} s with start-up '
              f'[{card}]')

    # 31: against restore_stamps on one device, same stamps and call
    stamps, psf, bkgs, fluxes = main_path_inputs(MAIN_B)
    for path in MESH_PATHS:
        cfg = PATHS[path][0]
        one64, _ = restore_on_card(
            torch, stamps[:MESH_F64_B], psf, bkgs[:MESH_F64_B],
            SGPConfig(**{**cfg, 'dtype': 'float64'}), fluxes[:MESH_F64_B])
        one32, one32_wall = restore_on_card(torch, stamps, psf, bkgs,
                                            SGPConfig(**cfg), fluxes)
        for backend, n, _ in MESH_WORLDS:
            r = worlds[backend, n][0]
            got_it = r[f'stamps/{path}/f64_iters']
            lanes = lane_rel(r[f'stamps/{path}/f64_x'], one64.x)
            rel, limit = float(lanes.max()), MESH_RTOL_STAMPS[path]
            same = bool(np.array_equal(got_it, one64.iters))
            print(f'mesh stamps B={MESH_F64_B} float64 {path} {backend} x{n}'
                  f': per-lane iterations equal {same}, lane max|dx|/max|x| '
                  f'max {rel:.3e} median {float(np.median(lanes)):.3e} '
                  f'(limit {limit:.0e}) against one device [{card}]')
            check(same and rel <= limit,
                  f'{path} {backend} x{n} float64 equals one device')
            it = r[f'stamps/{path}/iters']
            d = float(np.abs(it - one32.iters).mean())
            launches = r[f'stamps/{path}/launches']
            walls = r[f'stamps/{path}/walls']
            ranks = ', '.join(f'{w:.4f}' for w in walls)
            print(f'mesh stamps B={MAIN_B} float32 {path} {backend} x{n} '
                  f'({MAIN_B // n} a rank, compaction 31/512): wall '
                  f'{walls.max():.4f} s (ranks {ranks}) against one device '
                  f'{one32_wall:.4f} s, iters median '
                  f'{np.median(it):g} (one device {np.median(one32.iters):g}) '
                  f'max {it.max()}, mean |diters| {d:.4f}, flux rel err '
                  f'{float(r[f"stamps/{path}/flux_err"]):.3e}, K1 launches '
                  f'a rank {launches.tolist()} [{card}]')
            check(np.median(it) == np.median(one32.iters) and d <= 1.0,
                  f'{path} {backend} x{n} float32 as distributions')
            check(float(r[f'stamps/{path}/flux_err']) <= FLUX_RTOL['float32'],
                  'every sharded stamp conserves its flux')
            if path == 'pallas':
                check(bool((launches > 0).all()),
                      'every rank launched K1 on its shard')
            else:
                check(bool((launches == 0).all()),
                      "'bisect' launches no K1")

    # 31's server: every request on the first rank, each batch shipped
    from tpu_sgp_torch import restore_stamps
    nb = SERVER_CLIENTS * CLIENT_B
    for path in MESH_PATHS:
        one = restore_stamps(stamps[:nb], psf, bkgs[:nb],
                             SGPConfig(**PATHS[path][0]), fluxes=fluxes[:nb],
                             sat_level=SAT_LEVEL, flatten=True)
        one_iters = one.iters.cpu().numpy()
        for backend, n, _ in MESH_WORLDS:
            r = worlds[backend, n][0]
            key = f'stamps/server/{path}'
            batches, requests, launches = r[f'{key}/f32_served'].T
            wall = float(r[f'{key}/f32_wall'])
            x = r[f'{key}/f32_x']
            flux = np.abs(x.astype(np.float64).sum((1, 2)) - fluxes[:nb]) \
                / fluxes[:nb]
            held = iters_close(r[f'{key}/f32_iters'], one_iters,
                               f'{path} {backend} x{n} server')
            beside = ('phase 20 not run' if phase20 is None else
                      f'phase 20\'s server on one device {phase20["wall"]:.4f}'
                      f' s, requests/s={SERVER_CLIENTS / phase20["wall"]:.1f}'
                      f' ({phase20["batches"]} device calls)')
            print(f'mesh server float32 {path} {backend} x{n}: '
                  f'{SERVER_CLIENTS} clients x {CLIENT_B} stamps on the first '
                  f'rank in {batches[0]} device calls (a rank '
                  f'{batches.tolist()}), wall {wall:.4f} s, requests/s='
                  f'{SERVER_CLIENTS / wall:.1f}, stamps/s={nb / wall:.1f}; '
                  f'{beside}; against restore_stamps of the {nb} stamps on '
                  f'one device: {held}; flux rel err max {flux.max():.3e}; '
                  f'K1 launches a rank {launches.tolist()} [{card}]')
            check(bool((batches == batches[0]).all()
                       and (requests == SERVER_CLIENTS).all()),
                  'every rank served the same batches and every request')
            check(flux.max() <= FLUX_RTOL['float32'],
                  'every served stamp conserves its flux')
            check(bool((launches > 0).all()) if path == 'pallas'
                  else bool((launches == 0).all()),
                  'K1 on every rank\'s shard under \'pallas\' only')
        for backend, n, _ in MESH_WORLDS:
            r = worlds[backend, n][0]
            key = f'stamps/server/{path}'
            rel, limit = float(r[f'{key}/f64_rel']), MESH_RTOL_STAMPS[path]
            batches = r[f'{key}/f64_batches']
            same = bool(r[f'{key}/f64_iters_equal'])
            print(f'mesh server float64 {path} {backend} x{n}: 4 requests of '
                  f'16 stamps from 4 threads on the first rank in '
                  f'{batches[0]} device calls (a rank {batches.tolist()}), '
                  f'{float(r[f"{key}/f64_wall"]):.4f} s, per-lane iterations '
                  f'equal {same}, lane max|dx|/max|x| {rel:.3e} (limit '
                  f'{limit:.0e}) against a session on one device [{card}]')
            check(same and rel <= limit and bool((batches == batches[0]).all()),
                  f'the server over a meshed session, {path} {backend} x{n}')
    for backend, n, _ in MESH_WORLDS:
        r = worlds[backend, n][0]
        print(f'mesh server ship {backend} x{n}: one batch of {nb} float32 '
              f'stamps, the header and the ({nb}, {N_PIX + 3}) packed buffer '
              f'of {int(r["stamps/server/ship_bytes"])} B broadcast from the '
              f'first rank: {float(r["stamps/server/ship_ms"]):.4f} ms a '
              f'batch (mean of {MESH_SHIPS}) [{card}]')

    # 32: against the 'linear' solve on one device
    img, fpsf = mesh_frame()
    f64 = SGPConfig(**MESH_F64, operator='linear', max_iter=MESH_F64_ITERS)
    ref64, _ = solve_frame(torch, img, fpsf, f64)
    ref64_x = ref64.x[0].cpu().numpy()
    fixed = SGPConfig(**{**FRAME_BASE, 'operator': 'linear',
                         'max_iter': MESH_F32_ITERS, 'stop_criterion': 1})
    solve_frame(torch, img, fpsf, fixed.replace(max_iter=2))
    _, one_fixed = solve_frame(torch, img, fpsf, fixed)
    one_conv, one_conv_wall = solve_frame(
        torch, img, fpsf, SGPConfig(**{**FRAME_CONVERGED,
                                       'operator': 'linear'}))
    print(f'mesh frame 2048x2048 float32 on one device (linear): '
          f'{one_fixed / MESH_F32_ITERS * 1e3:.3f} ms an iteration at '
          f'{MESH_F32_ITERS} fixed; stop rule 3 at 1e-5: '
          f'{int(one_conv.iters[0])} iterations in {one_conv_wall:.4f} s '
          f'[{card}]')
    for backend, n, _ in MESH_WORLDS:
        r = worlds[backend, n][0]
        rel = float(np.abs(r['frame/f64_x'] - ref64_x).max()
                           / np.abs(ref64_x).max())
        grid = '1x1' if n == 1 else '2x2'
        print(f'mesh frame 2048x2048 float64 {grid} {backend}: '
              f'{int(r["frame/f64_iters"])} iterations (one device '
              f'{int(ref64.iters[0])}), max|dx|/max|x| {rel:.3e} (limit '
              f'{MESH_RTOL:.0e}) against the linear solve on one device '
              f'[{card}]')
        check(int(r['frame/f64_iters']) == int(ref64.iters[0])
              and rel <= MESH_RTOL, f'{grid} {backend} float64 frame')
        kinds = r['frame/call_kinds'].tolist()
        it_fixed = int(r['frame/fixed_iters'])
        per = ', '.join(f'{k} {c / it_fixed:.1f}' for k, c in
                        zip(kinds, r['frame/fixed_calls']))
        print(f'mesh frame 2048x2048 float32 {grid} {backend}: '
              f'{float(r["frame/fixed_wall"]) / it_fixed * 1e3:.3f} ms an '
              f'iteration at {it_fixed} fixed; stop rule 3 at 1e-5: '
              f'{int(r["frame/converged_iters"])} iterations in '
              f'{float(r["frame/converged_wall"]):.4f} s; collectives an '
              f'iteration: {per}; one all_reduce of one value '
              f'{float(r["frame/all_reduce_ms"]):.4f} ms, one exchange of a '
              f'15-column strip {float(r["frame/exchange_ms"]):.4f} ms '
              f'[{card}]')
        check(it_fixed == MESH_F32_ITERS, 'the fixed run ran its iterations')

    # 33: the combined mode, the placement, the resume
    r = worlds['gloo', 4][0]
    check(np.array_equal(r['combined/batch_mesh'], [[[0, 1]], [[2, 3]]])
          and np.array_equal(r['combined/mp_mesh'],
                             r['combined/batch_mesh'])
          and set(r['combined/mp_spatial'].tolist()) == {0, 1},
          'make_multiprocess_mesh: one host a batch step, spatial axes '
          'inside a host')
    imgs, bpsf = mesh_batch()
    cfg = SGPConfig(**{**MESH_BATCH_CFG, 'operator': 'linear'})
    worst, iters = 0.0, []
    for i, im in enumerate(imgs):
        one, _ = solve_frame(torch, im, bpsf, cfg)
        iters.append(int(one.iters[0]))
        worst = max(worst, float(
            np.abs(r['combined/batch_x'][i] - one.x[0].cpu().numpy()).max()
            / float(one.x.abs().max())))
    got = r['combined/batch_iters'].tolist()
    print(f'mesh batch 4x1024x1024 float64 (batch 2, ty 1, tx 2) gloo: '
          f'iterations {got} (one device {iters}), max|dx|/max|x| '
          f'{worst:.3e} (limit {MESH_RTOL:.0e}), wall '
          f'{float(r["combined/batch_wall"]):.4f} s; make_multiprocess_mesh'
          f' {r["combined/mp_mesh"].tolist()} [{card}]')
    check(got == iters and worst <= MESH_RTOL and max(got) <= 25,
          'the batched distributed solve equals one device an image')
    rel = float(np.abs(r['combined/resume_x'] - r['frame/f64_x']).max()
                / np.abs(r['frame/f64_x']).max())
    print(f'mesh resume 2048x2048 float64: checkpoint at '
          f'{MESH_RESUME_AT} on 2x2, resumed on 4x1 to '
          f'{int(r["combined/resume_iters"])}: max|dx|/max|x| {rel:.3e} '
          f'against the uninterrupted 2x2 solve (limit {MESH_RTOL:.0e}) '
          f'[{card}]')
    check(int(r['combined/resume_iters']) == MESH_F64_ITERS
          and rel <= MESH_RTOL, 'the resume equals the uninterrupted solve')

    # K1 at a rank's shard of the gloo world, against its plain version
    rows = MAIN_B // 4
    b, c, dia, cap = projection_case(torch, rows, N_PIX, torch.float32,
                                     True, 'cuda', 310)
    steps = section_steps(torch.float32)
    got = project_rows(b, c, dia, cap, steps, True)
    want = project_rows_plain(b, c, dia, cap, steps, True)
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    print(f'kernel ({rows}, {N_PIX}) float32 has_sat=True (a rank\'s shard):'
          f' max|dx|/max|x|={rel:.3e} (limit {KERNEL_TOL["float32"]:.0e})')
    check(rel <= KERNEL_TOL['float32'], 'kernel agrees with plain')
    launches = worlds['gloo', 4][0]['stamps/pallas/launches']
    shard = dict(launches=int(launches[0]), max_abs_err=abs_err,
                 **k1_times(torch, rows), library_ms=None)
    # ... and at a rank's shard of the server's batch in the gloo world
    rows = SERVER_CLIENTS * CLIENT_B // 4
    b, c, dia, cap = projection_case(torch, rows, N_PIX, torch.float32,
                                     True, 'cuda', 311)
    got = project_rows(b, c, dia, cap, steps, True)
    want = project_rows_plain(b, c, dia, cap, steps, True)
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    print(f'kernel ({rows}, {N_PIX}) float32 has_sat=True (a rank\'s shard '
          f'of a served batch): max|dx|/max|x|={rel:.3e} (limit '
          f'{KERNEL_TOL["float32"]:.0e})')
    check(rel <= KERNEL_TOL['float32'], 'kernel agrees with plain')
    served = worlds['gloo', 4][0]['stamps/server/pallas/f32_served']
    server_shard = dict(launches=int(served[0, 2]), max_abs_err=abs_err,
                        **k1_times(torch, rows), library_ms=None)
    return shard, server_shard, worlds


# ---- phases 34-41: the example scripts (examples_torch/) ------------------

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'examples_torch')
HALO_RTOL = 1e-5            # halo apply against the linear apply, float32
SCAN_REPEATS = 2
# about 75-90 s: each worker process is recycled after 40 device calls
# (RSS 250 MB over its level after warm-up recycles it too, if it comes
# first), so the soak's two or three processes recycle at least twice
SOAK = dict(minutes=1.25, rss_delta_mb=250.0, batches_per_process=40)


def example(name: str):
    """``examples_torch/<name>.py`` of this checkout, as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f'examples_torch_{name}', os.path.join(EXAMPLES_DIR, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rank_examples(torch, dist, n: int) -> dict:
    """Phases 37 and 41 in a rank: ``distributed_demo.run`` on the
    world's meshes (every rank) and, in the world of one NCCL rank,
    ``time_halo_operator.run`` on its 1x1 mesh at the script's own sizes
    (410x410, 30 repeats, a chain of 50)."""
    from tpu_sgp_torch.parallel.distributed import make_image_mesh
    out = {}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    r = example('distributed_demo').run()
    torch.cuda.synchronize()
    out['demo_wall'] = time.perf_counter() - t0
    for k in ('mesh', 'shape', 'iters', 'rel_err', 'mesh3', 'shape3',
              'batch_iters'):
        out[f'demo_{k}'] = np.asarray(r[k])
    out['demo_images'] = len(r['imgs'])
    out['demo_finite'] = bool(np.isfinite(r['x']).all()
                              and np.isfinite(r['batch_x']).all())
    if n == 1:
        t0 = time.perf_counter()
        h = example('time_halo_operator').run(make_image_mesh())
        out['halo_wall'] = time.perf_counter() - t0
        for k in ('tile', 'repeats', 'chain', 'linear_wall_s',
                  'halo_wall_s', 'ratio', 'max_rel_diff'):
            out[f'halo_{k}'] = h[k]
    return out


def example_worlds() -> dict:
    """Phase 31's worlds running the examples of phases 37 and 41 alone
    (``--from`` past 31): {(backend, ranks): (results, wall seconds)}."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        return {(backend, n): run_world(backend, n, env,
                                        os.path.join(tmp, f'{backend}{n}'),
                                        'examples')
                for backend, n, env in MESH_WORLDS}


def phase_deconvolve_demo(torch, card: str) -> None:
    """Phase 34: ``deconvolve_demo.run`` at the demo's sizes: the 256x256
    field through ``sgp`` and ``sgp_beta_div`` (float32), its FITS files,
    128 stamps through ``restore_stamps``; every restoration finite, flux
    within 1e-4."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        r = example('deconvolve_demo').run(out_dir=tmp)
        files = sorted(os.listdir(tmp))
    wall = time.perf_counter() - t0
    print(f'example deconvolve_demo 256x256 float32: {r["n_sources"]} '
          f'sources, flux {r["flux"]:.0f}; KL-SGP {r["kl_iters"]} iterations,'
          f' rel_err {r["kl_rel_err"]:.4f}; beta-SGP {r["beta_iters"]} '
          f'iterations, rel_err {r["beta_rel_err"]:.4f}; {r["stamps"]} stamps '
          f'in {r["stamps_wall_s"] * 1e3:.1f} ms (median '
          f'{r["stamps_median_iters"]} iterations); flux rel err max '
          f'{r["flux_err"]:.3e}; {len(files)} FITS files; {wall:.1f} s '
          f'[{card}]')
    check(r['finite'] and bool(np.isfinite([r['kl_rel_err'],
                                            r['beta_rel_err']]).all()),
          "the demo's restorations are finite")
    check(r['flux_err'] <= FLUX_RTOL['float32'], 'the demo conserves flux')
    check(files == ['field_beta.fits', 'field_kl.fits', 'field_orig.fits'],
          'the demo writes its three FITS files')


def phase_serving_demo(torch, card: str) -> None:
    """Phase 35: ``serving_demo.run``: buckets 32/64/256 warmed, five
    request sizes, two streams of 8 x 64 stamps (coalesce 1 and 4), 8
    client threads x 32 stamps through a ``MicroBatchServer``; finite,
    flux within 1e-4."""
    t0 = time.perf_counter()
    r = example('serving_demo').run()
    wall = time.perf_counter() - t0
    reqs = ', '.join(f'{n}: {w * 1e3:.1f} ms ({m})'
                     for n, w, m in r['batches'])
    streams = ', '.join(f'coalesce {c}: {n} stamps in {w * 1e3:.1f} ms'
                        for c, n, w in r['streams'])
    print(f'example serving_demo float32: warmup of buckets 32/64/256 '
          f'{r["warmup_s"]:.2f} s; requests (stamps: wall, median '
          f'iterations) {reqs}; streams {streams}; 8 clients x 32 stamps '
          f'in {r["server_s"] * 1e3:.1f} ms, {r["server_calls"]} device '
          f'calls; flux rel err max {r["flux_err"]:.3e}; {wall:.1f} s '
          f'[{card}]')
    check(r['finite'] and r['flux_err'] <= FLUX_RTOL['float32'],
          "the demo's requests are finite and conserve flux")
    check([n for _, n, _ in r['streams']] == [512, 512]
          and r['server_calls'] >= 1, 'every stream and client served')


def phase_allsky_map(torch, card: str) -> None:
    """Phase 36: ``build_allsky_map.run(96)``: four 96x96 TAN tiles,
    their backgrounds, one ``restore_stamps`` batch (float32) and the HPX
    coadd; finite tiles and figures."""
    t0 = time.perf_counter()
    r = example('build_allsky_map').run(96)
    wall = time.perf_counter() - t0
    print(f'example build_allsky_map 4x96x96 float32: backgrounds '
          f'{np.round(r["est_bkg"], 2).tolist()}, iterations '
          f'{r["iters"].tolist()}, {r["core_px"]} full-footprint px, '
          f'source-free level {r["resid_median"]:+.3f} +- '
          f'{r["resid_std"]:.3f} ADU, aperture flux map/true '
          f'{r["flux_ratio"]:.4f}; {wall:.1f} s [{card}]')
    check(bool(np.isfinite(r['restored']).all()) and bool(np.isfinite(
        [r['resid_median'], r['resid_std'], r['flux_ratio']]).all()),
        'the all-sky chain is finite')


def phase_halo_timing(card: str, worlds: dict) -> None:
    """Phase 37: ``time_halo_operator.run`` in the world of one NCCL rank
    (phase 31's): A+AT of the halo operator's local apply on the 1x1 mesh
    against the linear operator, a chain of 50 in a Python loop, best of
    30; one apply of each within 1e-5 relative in float32."""
    r = worlds['nccl', 1][0]
    chain = int(r['examples/halo_chain'])
    lin, halo = (float(r[f'examples/halo_{k}_wall_s'])
                 for k in ('linear', 'halo'))
    rel = float(r['examples/halo_max_rel_diff'])
    print(f'example time_halo_operator {int(r["examples/halo_tile"])}x'
          f'{int(r["examples/halo_tile"])} float32, one NCCL rank, 1x1 mesh '
          f'(best of {int(r["examples/halo_repeats"])}, chain {chain}): '
          f'linear A+AT {lin * 1e3 / chain:.4f} ms/apply, halo A+AT '
          f'{halo * 1e3 / chain:.4f} ms/apply, ratio '
          f'{float(r["examples/halo_ratio"]):.3f}x, max rel diff {rel:.3e} '
          f'(limit {HALO_RTOL:.0e}); {float(r["examples/halo_wall"]):.1f} s '
          f'[{card}]')
    check(rel <= HALO_RTOL, 'the halo apply equals the linear apply')


def phase_scan_compaction(torch, card: str) -> None:
    """Phase 38: ``scan_compaction.run`` for KL and beta at B=12288 over
    the JAX script's grids, best of 2 walls a point; findings only (the
    pinned 26/2048 and 28/2048 stay)."""
    mod = example('scan_compaction')
    pinned = {'kl': (PATHS['kl bisect'][1]['phase1_iters'],
                     PATHS['kl bisect'][1]['tail_bucket']),
              'beta': (PATHS['beta section'][1]['phase1_iters'],
                       PATHS['beta section'][1]['tail_bucket'])}
    for which in ('kl', 'beta'):
        t0 = time.perf_counter()
        points = mod.run(which, repeats=SCAN_REPEATS)
        wall = time.perf_counter() - t0
        for p in points:
            print(f'example scan_compaction {which} B={p["n"]} p1={p["p1"]} '
                  f'tail={p["tail"]}: {p["stamps_s"]:.1f} stamps/s (wall '
                  f'{p["wall_s"] * 1e3:.1f} ms, best of {SCAN_REPEATS}), '
                  f'unconverged@p1={p["unconverged"]}, iterations median '
                  f'{p["iters_median"]:g} max {p["iters_max"]} [{card}]')
            check(np.isfinite(p['wall_s']) and p['wall_s'] > 0,
                  'a finite wall')
        best = max(points, key=lambda p: p['stamps_s'])
        held = [p['stamps_s'] for p in points
                if (p['p1'], p['tail']) == pinned[which]]
        beside = (f'{held[0]:.1f} ({held[0] / best["stamps_s"]:.3f} of the '
                  f'best)' if held else 'not on the grid')
        print(f'example scan_compaction {which}: best p1={best["p1"]} '
              f'tail={best["tail"]} {best["stamps_s"]:.1f} stamps/s; the '
              f'pinned {pinned[which][0]}/{pinned[which][1]} {beside}; '
              f'{wall:.1f} s [{card}]')


def batch_shape_probe(torch) -> str:
    """What solving the 410x410 frame as lane 0 of a batch of two changes
    on the card, against the frame alone: max|diff| of the 'linear'
    operator's A and AT, of a plain row sum, of a plain sum over (B, 7, N)
    rows (the warm projection's seven section points a lane) and of the
    compensated sum (``gsum_ff``); x after fixed iterations of the
    stable-sums solve (stop rule 1), relative; and the stop-rule-3
    iterations at 1e-5 of both shapes with stable_sums on and off."""
    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.ops.psf_operator import make_linear_operator
    from tpu_sgp_torch.ops.reduce import gsum_ff
    from tpu_sgp_torch.solvers.sgp import solve
    img, psf = frame_inputs()
    one = torch.as_tensor(img, dtype=torch.float32, device='cuda')[None]
    two = torch.cat([one, one])
    kern = torch.as_tensor(psf, dtype=torch.float32, device='cuda')
    A, AT = make_linear_operator(kern, one.shape[1:])
    parts = []
    for name, fn in (
            ('A', A), ('AT', AT),
            ('row sum', lambda x: x.reshape(x.shape[0], -1).sum(-1)),
            ('(B, 7, N) sum', lambda x: (x.reshape(x.shape[0], 1, -1)
                                         * torch.linspace(0.5, 1.5, 7,
                                                          device='cuda')
                                         [:, None]).sum(-1)),
            ('gsum_ff', lambda x: gsum_ff(x.reshape(x.shape[0], -1)))):
        d = float((fn(one)[0] - fn(two)[0]).abs().max())
        parts.append(f'{name} {d:.3e}')

    def frame(gn, **kw):
        z = torch.zeros_like(gn)
        return solve(gn, kern, torch.full_like(gn, FRAME_BKG), z, 0.0, z,
                     1.0, 1e-3, 0.0, SGPConfig(**{**FRAME_BASE, **kw}))

    for k in (1, 2, 5, 10, 20, 40):
        xs = [frame(gn, max_iter=k, stop_criterion=1, stable_sums=True).x[0]
              for gn in (one, two)]
        rel = float((xs[0] - xs[1]).abs().max() / xs[0].abs().max())
        parts.append(f'x after {k} {rel:.3e}')
    for stable in (True, False):
        it = [int(frame(gn, **{**FRAME_CONVERGED, 'stable_sums': stable})
                  .iters[0]) for gn in (one, two)]
        parts.append(f'stop rule 3 stable_sums={stable} {it[0]} alone, '
                     f'{it[1]} in two')
    return ', '.join(parts)


def phase_determinism(card: str, beside=None) -> None:
    """Phase 39: what a batch of two changes against the frame alone
    (``batch_shape_probe``); then ``determinism_check.orchestrate`` at
    410x410: six fresh processes side by side on the card, stable_sums
    True and False, each under three perturbations; the stable arm must
    agree. ``beside`` (phase 40's soak) runs in this thread while the six
    runs go on: the runs compare iteration counts and the soak counts
    requests, recycles and RSS, so neither reads a time that the other
    moves."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    print(f'example determinism_check batch of two against one, lane 0: '
          f'{batch_shape_probe(torch)} [{card}]')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        runs = pool.submit(example('determinism_check').orchestrate)
        if beside is not None:
            beside()
        r = runs.result()
    wall = time.perf_counter() - t0
    for (stable, name), line in r['lines'].items():
        print(f'example determinism_check stable={stable} perturb={name}: '
              f'{line} [{card}]')
    for line in r['verdict']:
        print(f'example determinism_check: {line.splitlines()[0]}')
    if r['code'] == 1:
        print('\n'.join(r['verdict']), file=sys.stderr)
    print(f'example determinism_check: the six runs and phase 40 beside '
          f'them in {wall:.1f} s [{card}]' if beside is not None else
          f'example determinism_check: the six runs in {wall:.1f} s '
          f'[{card}]')
    check(r['code'] == 0, 'stable_sums=True agrees across fresh processes '
          'and perturbations')


def phase_soak(card: str) -> None:
    """Phase 40: ``serving_recycle_soak.supervise`` for about 75-90 s:
    worker processes of 6 client threads each against a
    ``MicroBatchServer(max_batch=1024)`` recycled by its watchdog (40
    device calls, or RSS 250 MB over its level after warm-up); zero loss,
    at least two recycles; each process's RSS curve."""
    t0 = time.perf_counter()
    r = example('serving_recycle_soak').supervise(**SOAK)
    wall = time.perf_counter() - t0
    for i, c in enumerate(r['cycles'], 1):
        if 'died' in c:
            print(f'example serving_recycle_soak cycle {i}: the worker died:'
                  f'\n{c["died"]}', file=sys.stderr)
            continue
        growth = ((c['end_rss_mb'] - c['base_rss_mb'])
                  / max(c['batches'], 1) * 1e3)
        print(f'example serving_recycle_soak cycle {i}: '
              f'{c["completed"]}/{c["submitted"]} requests, {c["batches"]} '
              f'device calls, recycled={c["recycled"]}, rss '
              f'{c["base_rss_mb"]} -> {c["end_rss_mb"]} MB '
              f'({growth:+.1f} MB per 1000 device calls) in {c["wall_s"]} s;'
              f' rss every 2 s {c["rss_curve_mb"]} [{card}]')
    print(f'example serving_recycle_soak: {"SOAK OK" if r["ok"] else "FAIL"}'
          f', {len(r["cycles"])} processes, {r["recycles"]} recycles, '
          f'{r["completed"]}/{r["submitted"]} requests; {wall:.1f} s '
          f'[{card}]')
    check(r['code'] == 0 and r['recycles'] >= 2,
          'the soak loses no request and recycles at least twice')


def phase_distributed_demo(card: str, worlds: dict) -> None:
    """Phase 41: ``distributed_demo.run`` in phase 31's worlds (an NCCL
    rank, four gloo ranks sharing the card): the sharded frame and the
    batch of frames, float32; finite, within the demo's 60 iterations."""
    for backend, n, _ in MESH_WORLDS:
        r = worlds[backend, n][0]
        (h, w), mesh = r['examples/demo_shape'], r['examples/demo_mesh']
        (h3, w3), mesh3 = (r['examples/demo_shape3'],
                           r['examples/demo_mesh3'])
        iters = int(r['examples/demo_iters'])
        biters = r['examples/demo_batch_iters']
        print(f'example distributed_demo {backend} x{n}: {h}x{w} on '
              f'{"x".join(map(str, mesh.tolist()))}: {iters} iterations, '
              f'rel_err vs truth {float(r["examples/demo_rel_err"]):.4f}; '
              f'{int(r["examples/demo_images"])} images of {h3}x{w3} on '
              f'{"x".join(map(str, mesh3.tolist()))}: iterations '
              f'{biters.tolist()}; {float(r["examples/demo_wall"]):.2f} s on '
              f'rank 0 [{card}]')
        check(bool(r['examples/demo_finite']) and 0 < iters <= 60
              and bool((biters <= 60).all()),
              f'the distributed demo on {backend} x{n}')


def main() -> int:
    if sys.argv[1:2] == ['--rank']:
        return rank_main(sys.argv[2:])
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
        raw: dict = {}
        served: dict = {}
        worlds: dict = {}

        def ran_worlds() -> dict:
            # phases 37 and 41 read phase 31's worlds, or run them alone
            if not worlds:
                worlds.update(example_worlds())
            return worlds
        for number, phase in ((13, lambda: phase_long_rows(torch)),
                              (14, lambda: phase_operators(torch)),
                              (15, lambda: phase_frame(torch, card)),
                              (16, lambda: phase_frame_vs_cpu(torch)),
                              (17, lambda: phase_classic_checkpoint(torch)),
                              (18, lambda: phase_session(torch, card)),
                              (19, lambda: phase_stream(torch, card)),
                              (20, lambda: served.update(
                                  phase_server(torch, card))),
                              (21, lambda: phase_big_request(torch, card)),
                              (22, lambda: phase_catalog(torch, card)),
                              (23, lambda: phase_save(torch)),
                              (24, lambda: phase_star_stamps(torch, card)),
                              (25, lambda: phase_subdivisions(torch, card)),
                              (26, lambda: phase_spatial_psf(torch, card)),
                              (27, lambda: phase_simulation(torch, card)),
                              (28, lambda: phase_cli(torch, card)),
                              (29, lambda: raw.update(
                                  phase_raw_frame(torch, card))),
                              (30, lambda: phase_nan_guard(
                                  torch, raw or centre_inputs())),
                              (31, lambda: worlds.update(phase_mesh(
                                  torch, card, served or None)[2])),
                              (34, lambda: phase_deconvolve_demo(torch,
                                                                 card)),
                              (35, lambda: phase_serving_demo(torch, card)),
                              (36, lambda: phase_allsky_map(torch, card)),
                              (37, lambda: phase_halo_timing(
                                  card, ran_worlds())),
                              (38, lambda: phase_scan_compaction(torch,
                                                                 card)),
                              (39, lambda: phase_determinism(
                                  card, beside=lambda: phase_soak(card))),
                              (40, lambda: phase_soak(card)
                               if first == 40 else None),
                              (41, lambda: phase_distributed_demo(
                                  card, ran_worlds())),
                              (42, lambda: phase_k2_shapes(torch, card)),
                              (43, lambda: phase_guided_rows(torch)),
                              (44, lambda: phase_compensated_sum(torch)),
                              (45, lambda: phase_beta_objective(torch))):
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
    frame_launches, frame_guided, frame_ff_sum = phase_frame(torch, card)
    phase_frame_vs_cpu(torch)
    phase_classic_checkpoint(torch)

    # 18-23
    serving = phase_session(torch, card)
    phase_stream(torch, card)
    served = phase_server(torch, card)
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

    # 29-30
    chain = time.perf_counter()
    phase_nan_guard(torch, phase_raw_frame(torch, card))

    # 31-33
    meshes = time.perf_counter()
    shard, server_shard, worlds = phase_mesh(torch, card, served)

    # 34-41 (37 and 41 ran in phase 31's worlds)
    examples = time.perf_counter()
    phase_deconvolve_demo(torch, card)
    phase_serving_demo(torch, card)
    phase_allsky_map(torch, card)
    phase_halo_timing(card, worlds)
    phase_scan_compaction(torch, card)
    phase_determinism(card, beside=lambda: phase_soak(card))
    phase_distributed_demo(card, worlds)

    # 42-45
    shapes = time.perf_counter()
    k2['routes'] += phase_k2_shapes(torch, card)
    guided = phase_guided_rows(torch)['float32']
    ff_sum = phase_compensated_sum(torch)
    beta_div = phase_beta_objective(torch)
    done = time.perf_counter()
    in_worlds = sum(float(w[0].get('examples/demo_wall', 0.0))
                    + float(w[0].get('examples/halo_wall', 0.0))
                    for w in worlds.values())
    print(f'wall: phases 1-23 {apps - started:.1f} s, the applications '
          f'(24-28) {chain - apps:.1f} s, the raw-frame chain and the NaN '
          f'guard (29-30) {meshes - chain:.1f} s, the multi-rank worlds '
          f'(31-33, with the examples of 37 and 41) '
          f'{examples - meshes:.1f} s, the examples (34-41) '
          f'{shapes - examples:.1f} s and {in_worlds:.1f} s in the worlds, '
          f'K2\'s shapes, the guided kernel, the compensated sum and the '
          f'beta objective (42-45) '
          f'{done - shapes:.1f} s, all '
          f'{done - started:.1f} s')

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
        'name': 'flux_projection_rank_shard', **k1, **shard}, {
        'name': 'flux_projection_server_shard', **k1, **server_shard}, {
        'name': 'flux_projection_guided_long_row', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/flux_projection.cu',
        'replaces': 'tpu_sgp_torch/projection/flux_projection.py:'
                    '_guided_root', **frame_guided, **guided}, {
        'name': 'stamp_solver', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/stamp_solver.cu',
        'replaces': 'tpu_sgp/experimental/pallas_batch.py:57', **k2}, {
        'name': 'compensated_sum_frame_row', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/compensated_sum.cu',
        'replaces': 'tpu_sgp_torch/ops/reduce.py:tree_sum_ff', **ff_sum,
        **frame_ff_sum}, {
        'name': 'beta_divergence', 'route': 'cuda',
        'source': 'tpu_sgp_torch/csrc/beta_divergence.cu',
        'replaces': 'tpu_sgp_torch/ops/divergence.py:'
                    'beta_div_with_dbeta_plain', **beta_div}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
