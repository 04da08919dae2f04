"""Whole KL-SGP solve of a batch of stamps: CUDA kernel wrapper and plain
twin.

Replaces the Pallas kernel ``_kernel`` (``tpu_sgp/experimental/
pallas_batch.py:57-314``), which solves a tile of stamps that share one PSF
to completion inside one ``pallas_call``: data scaling, the initial
projection, the operator, Armijo backtracking, the Barzilai-Borwein
steplengths, the stop rule and revert-on-exit. Rows are independent, so
here a row's whole solve is one thread block and a batch is one launch.

The operator is the dense circulant of ``ops.psf_operator.
build_circulant_matrix``: ``A(x) = C x`` is a circular convolution by the
H*W taps ``k = fftshift(psf)`` and ``AT(x) = C^T x`` a circular
correlation. The kernel takes the taps; the plain version builds C from
them. The kernel has two designs of the operator, and
``stamp_solver_plan`` picks one from the stamp's shape before the launch:

- ``TcPatch`` (float32): the tensor cores, three TF32 products a
  multiply-add (hi*hi + hi*lo + lo*hi of each value's TF32 split), which
  keeps float32 accuracy as the reference's ``Precision.HIGHEST`` does; one
  warp a 16 x 16 tile of the stamp padded to multiples of 16,
  32 * ceil(H/16) * ceil(W/16) threads;
- ``Patch`` (float32 on the FP32 pipes, float64 on the FP64 pipes):
  ceil(H/2) * ceil(W/4) threads, each owning a 2 x 4 patch of pixels.

A block holds at most 1024 threads and the card's per-block shared
memory (the tap tables and the staged input, beside the solver's
reduction buffer), read from the card at the launch (the H100's 227 KB
where no card is asked). float32 takes the first of ``TcPatch`` on the H x W
stamp, ``TcPatch`` on its W x H transpose, ``Patch`` on H x W, ``Patch`` on
W x H that fits: every shape up to 4096 pixels has one. float64 takes
``Patch`` in the first orientation that fits; the skinny shapes that fit
neither (every one has a side of 5 or less, e.g. 4 x 1024) raise
``ValueError`` before anything reaches the card. A transposed route solves
the transposed stamps with the transposed taps and transposes x back: a
circular convolution commutes with transposing both, and every sum of the
solve runs over all pixels, so only the order of those sums changes.

``solve_rows`` launches ``csrc/stamp_solver.cu`` for CUDA tensors and calls
``solve_rows_plain`` for CPU tensors; a CUDA call that cannot launch
raises, it never falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..config import SGPConfig
from ..ops.psf_operator import build_circulant_matrix
from . import _build
from .flux_projection import bracket_bits

# the dense operator's own limit (tpu_sgp/ops/psf_operator.py:38-40)
MAX_PIXELS = 4096
# a block's threads, and its shared memory on an H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB): the plan's limit
# where it is given no card's own
MAX_THREADS = 1024
SMEM_PER_BLOCK = 232448
# the solver's static shared memory, red[2][kMaxVals][kMaxWarps] of T
_STATIC_VALUES = 2 * 8 * 32
# the designs' codes in csrc/stamp_solver.cu (kPipes, kTensorCores)
_DESIGN_CODE = {'Patch': 0, 'TcPatch': 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _block(design: str, h: int, w: int) -> tuple:
    """``(threads, shared elements, tap row pitch)`` of a design's block for
    an h x w stamp: ``TcLayout`` and ``Layout`` of csrc/stamp_solver.cu."""
    if design == 'TcPatch':
        m, p = 16 * _cdiv(h, 16), 16 * _cdiv(w, 16)
        return 32 * (m // 16) * (p // 16), 2 * h * 2 * p + 4 * h * (p + 4), p
    groups, pairs = _cdiv(w, 4), _cdiv(h, 2)
    pitch = 4 * groups
    xrows, xcols = 2 * pairs + h, 4 * groups + pitch
    stride = (xcols + 1 + 3) // 4 * 4
    return (32 * _cdiv(pairs * groups, 32),
            2 * (h + 2) * pitch + xrows * stride, pitch)


@dataclasses.dataclass(frozen=True)
class StampPlan:
    """The kernel's block for one stamp shape: the operator's ``design``
    (``'TcPatch'`` or ``'Patch'``), whether the stamps are solved
    ``transposed``, the block's ``threads``, its dynamic shared bytes
    ``smem`` and its tap row length ``pitch`` (``by_shape`` in
    csrc/stamp_solver.cu fixes a pitch of 32 at compile time in a block of
    up to 128 threads)."""
    design: str
    transposed: bool
    dtype: torch.dtype
    threads: int
    smem: int
    pitch: int

    @property
    def route(self) -> str:
        """e.g. ``'TcPatch'``, ``'Patch<float> transposed'``."""
        name = self.design if self.design == 'TcPatch' else \
            f'Patch<{"float" if self.dtype == torch.float32 else "double"}>'
        return name + (' transposed' if self.transposed else '')


def route_plan(design: str, transposed: bool, h: int, w: int,
               dtype: torch.dtype, smem_limit: int = SMEM_PER_BLOCK):
    """``(plan, '')`` of ``design`` on an h x w stamp (on its w x h
    transpose if ``transposed``), or ``(None, reason)`` where its block
    cannot run on a card of ``smem_limit`` shared bytes a block."""
    if design == 'TcPatch' and dtype != torch.float32:
        return None, 'TcPatch is float32 only'
    bh, bw = (w, h) if transposed else (h, w)
    threads, elems, pitch = _block(design, bh, bw)
    size = torch.finfo(dtype).bits // 8
    smem = elems * size
    if threads > MAX_THREADS:
        return None, f'{threads} threads'
    if smem + _STATIC_VALUES * size > smem_limit:
        return None, (f'{smem + _STATIC_VALUES * size} B of shared memory '
                      f'(limit {smem_limit})')
    return StampPlan(design, transposed, dtype, threads, smem, pitch), ''


def stamp_solver_plan(h: int, w: int, dtype: torch.dtype,
                      smem_limit: int = SMEM_PER_BLOCK) -> StampPlan:
    """The kernel's route for h x w stamps of ``dtype``, from the shape
    alone: float32 takes the first of ``TcPatch``, ``TcPatch`` transposed,
    ``Patch``, ``Patch`` transposed whose block fits ``MAX_THREADS`` and
    ``smem_limit`` shared bytes; float64 the first of ``Patch``, ``Patch``
    transposed. Raises ``ValueError`` where none fits."""
    if h * w > MAX_PIXELS:
        raise ValueError(f'stamps of {h}x{w} = {h * w} pixels exceed the '
                         f'dense operator\'s {MAX_PIXELS}')
    designs = ('TcPatch', 'Patch') if dtype == torch.float32 else ('Patch',)
    reasons = []
    for design in designs:
        for transposed in (False, True):
            plan, why = route_plan(design, transposed, h, w, dtype,
                                   smem_limit)
            if plan is not None:
                return plan
            side = f'{w}x{h}' if transposed else f'{h}x{w}'
            reasons.append(f'{design} on {side} needs {why}')
    raise ValueError(f'{str(dtype).removeprefix("torch.")} stamps of '
                     f'{h}x{w} fit no block of the whole-solver kernel: '
                     + '; '.join(reasons))


def transpose_rows(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h*w) rows of h x w stamps as contiguous (B, w*h) rows of their
    w x h transposes."""
    return v.reshape(v.shape[0], h, w).transpose(1, 2).reshape(
        v.shape).contiguous()


def solve_transposed(solve, gn, bkg, flux, sat, taps, cfg):
    """``solve`` (``solve_rows_plain``'s arguments and result) on the
    stamps' transposes with the transposed taps, x transposed back: the
    same solve as on the stamps, summed in another order."""
    h, w = taps.shape
    x, iters = solve(transpose_rows(gn, h, w), transpose_rows(bkg, h, w),
                     flux, sat, taps.T.contiguous(), cfg)
    return transpose_rows(x, w, h), iters


def check_scope(cfg: SGPConfig) -> None:
    """Raise ``ValueError`` for a configuration outside the kernel's scope
    (the asserts of ``pallas_batch.py:325-328``)."""
    for ok, what in ((cfg.divergence == 'kl', "divergence='kl'"),
                     (cfg.init_recon == 2, 'init_recon=2'),
                     (cfg.proj_type == 1, 'proj_type=1'),
                     (cfg.has_flux, 'has_flux=True'),
                     (cfg.has_sat_level, 'has_sat_level=True'),
                     (cfg.scale_data, 'scale_data=True'),
                     (cfg.m_mem == 1, 'm_mem=1'),
                     (cfg.m_alpha == 3, 'm_alpha=3'),
                     (cfg.stop_criterion in (1, 3), 'stop_criterion 1 or 3')):
        if not ok:
            raise ValueError(f'the whole-solver kernel needs {what}; use '
                             f'the general solver for this configuration')


def solve_rows_plain(gn: torch.Tensor, bkg: torch.Tensor,
                     flux: torch.Tensor, sat: torch.Tensor,
                     taps: torch.Tensor, cfg: SGPConfig):
    """The kernel's solve in plain PyTorch over (B, N) rows
    (``pallas_batch.py:57-314``). ``gn`` and ``bkg`` are (B, N), ``flux``
    and ``sat`` (B,), ``taps`` the (H, W) fftshift(psf) with H*W = N.
    Returns ``(x (B, N), iters (B,) int32)``."""
    dt = gn.dtype
    dev = gn.device
    eps = torch.finfo(dt).eps
    nb = gn.shape[0]
    cmat = build_circulant_matrix(torch.fft.ifftshift(taps))

    def A(v):
        return v @ cmat.T

    def AT(v):
        return v @ cmat

    def col(v):
        return v[:, None]

    # preamble (:111-118)
    scaling = gn.amax(-1)
    gn = gn / col(scaling)
    bkg = bkg / col(scaling)
    vmin = torch.where(gn > 0, gn, torch.inf).amin(-1)
    gn = torch.where(gn <= 0, col(vmin * eps * eps), gn)
    flux = flux / scaling
    cap = col(sat / scaling - eps)
    steps = bracket_bits(dt)

    def project(point, dia):
        """1-bit bisection on the dual of sum(x) = flux (:120-149)."""
        def xval(lam):
            return torch.minimum(
                cap, torch.clamp_min((point + col(lam)) / dia, 0.0))

        lo = (-point).amin(-1)
        hi = torch.maximum((col(flux) * dia - point).amax(-1), lo + 1.0)
        for _ in range(steps):
            mid = 0.5 * (lo + hi)
            below = xval(mid).sum(-1) - flux < 0
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return xval(0.5 * (lo + hi))

    def objective(x_tf):
        """KL objective (:151-154)."""
        return ((gn * torch.log(gn / (x_tf + bkg))).sum(-1) + x_tf.sum(-1)
                - flux)

    # init_recon == 2, then a projection with the identity metric (:156-160)
    x = project(gn, torch.ones_like(gn))
    x_tf = A(x)
    g = 1.0 - AT(gn / (x_tf + bkg))
    fv = objective(x_tf)

    # scaling-matrix bounds with the x10 widening (:162-167)
    y_b = col(flux) / (col(flux) + bkg) * AT(gn)
    x_lb = torch.where(y_b > 0, y_b, torch.inf).amin(-1)
    x_ub = y_b.amax(-1)
    widen = x_ub / x_lb < 50.0
    x_lb = col(torch.where(widen, x_lb / 10.0, x_lb))
    x_ub = col(torch.where(widen, x_ub * 10.0, x_ub))

    def lanes(v):
        return torch.full((nb,), v, dtype=dt, device=dev)

    x_prev = x
    x_mat = torch.clamp(x, x_lb, x_ub)
    alpha, tau = lanes(cfg.alpha_init), lanes(cfg.tau_init)
    v1 = v2 = lanes(cfg.alpha_max)        # the last two alpha2 memories
    it = torch.ones(nb, dtype=torch.int32, device=dev)
    keep = torch.ones(nb, dtype=torch.bool, device=dev)
    ones = lanes(1.0)

    # per iteration (:199-299); a lane leaves when its stop rule fires
    while bool(keep.any()):
        d_metric = 1.0 / x_mat
        y = project((x - col(alpha) * x_mat * g) * d_metric, d_metric)
        d = y - x
        gd = (d * g).sum(-1)
        d_tf = A(d)

        # Armijo backtracking (:210-241); fr = fv since m_mem == 1
        lam = ones
        if cfg.max_backtracks == 0:
            fv_new = objective(x_tf + d_tf)
        else:
            fv_new = fv
            acc = ~keep
            for _ in range(cfg.max_backtracks):
                if bool(acc.all()):
                    break
                fv_try = objective(x_tf + col(lam) * d_tf)
                ok = (fv_try <= fv + cfg.gamma * lam * gd) | (lam < 1e-12)
                fv_new = torch.where(acc, fv_new, fv_try)
                lam = torch.where(acc | ok, lam, lam * cfg.bt_factor)
                acc = acc | ok
            # cap exit: back to the last evaluated lam, at most 1
            lam = torch.where(acc, lam,
                              torch.clamp_max(lam / cfg.bt_factor, 1.0))

        sk = col(lam) * d
        x_new = x + sk
        x_tf_new = x_tf + col(lam) * d_tf
        g_new = 1.0 - AT(gn / (x_tf_new + bkg))
        yk = g_new - g

        # BB steplengths (:251-272)
        x_mat_new = torch.clamp(x_new, x_lb, x_ub)
        sk2 = sk * (1.0 / x_mat_new)
        yk2 = yk * x_mat_new
        bk = (sk2 * yk).sum(-1)
        ck = (yk2 * sk).sum(-1)
        grow = torch.clamp_max(10.0 * alpha, cfg.alpha_max)
        alpha1 = torch.where(
            bk <= 0, grow, torch.clamp((sk2 * sk2).sum(-1) / bk,
                                       cfg.alpha_min, cfg.alpha_max))
        alpha2 = torch.where(
            ck <= 0, grow, torch.clamp(ck / (yk2 * yk2).sum(-1),
                                       cfg.alpha_min, cfg.alpha_max))
        early = it <= 20
        ratio_lt = alpha2 / alpha1 < tau
        alpha_new = torch.where(early | ratio_lt,
                                torch.minimum(torch.minimum(v1, v2), alpha2),
                                alpha1)
        tau_new = torch.where(early, tau,
                              torch.where(ratio_lt, tau * 0.9, tau * 1.1))

        # stop rule 3 or 1 (:274-280)
        it_new = it + 1
        rule = it_new <= cfg.max_iter
        if cfg.stop_criterion == 3:
            reld = (fv - fv_new) / fv_new
            rule = rule & (reld > cfg.tol_convergence) & (reld >= 0)

        # commit the lanes that ran; x_prev trails x by one (:285-299)
        kc = col(keep)
        x_prev = torch.where(kc, x, x_prev)
        x = torch.where(kc, x_new, x)
        x_mat = torch.where(kc, x_mat_new, x_mat)
        g = torch.where(kc, g_new, g)
        x_tf = torch.where(kc, x_tf_new, x_tf)
        fv = torch.where(keep, fv_new, fv)
        alpha = torch.where(keep, alpha_new, alpha)
        tau = torch.where(keep, tau_new, tau)
        v1 = torch.where(keep, v2, v1)
        v2 = torch.where(keep, alpha2, v2)
        it = torch.where(keep, it_new, it)
        keep = keep & rule

    # revert-on-exit (:313-314)
    return x_prev * col(scaling), it - 1


class _Params(ctypes.Structure):
    """``SolveParams`` of ``csrc/stamp_solver.cu``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        'n', 'h', 'w', 'max_iter', 'stop_rule', 'max_backtracks',
        'proj_steps')] + [(name, ctypes.c_double) for name in (
            'tol', 'gamma', 'bt_factor', 'alpha_init', 'alpha_min',
            'alpha_max', 'tau_init')]


_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.POINTER(_Params),
                                  ctypes.c_int)
_OPERATOR_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (
    ctypes.POINTER(ctypes.c_int),)
_ROUTE_ARGS = (ctypes.c_int,) * 5 + (ctypes.POINTER(ctypes.c_int),) * 3 + (
    ctypes.c_char_p, ctypes.c_int)


@functools.cache
def _smem_limit(device: int) -> int:
    """The card's shared bytes a block may opt in to, as the C entries
    read it (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def device_plan(h: int, w: int, dtype: torch.dtype,
                device: torch.device) -> StampPlan:
    """``stamp_solver_plan`` under the shared memory of the card that
    holds ``device``."""
    return stamp_solver_plan(h, w, dtype, _smem_limit(device.index))


def card_block(design: str, h: int, w: int, dtype: torch.dtype,
               device: int = 0):
    """The card's own account of ``design``'s block for h x w stamps of
    ``dtype``, from the C entries' own layouts (``by_shape`` in
    csrc/stamp_solver.cu), launching nothing: a dict of ``threads``,
    dynamic shared bytes ``smem``, resident ``blocks_per_sm`` and the
    kernel's ``instance``, or None where the C entries refuse the block.
    The card's checks hold ``route_plan`` to it."""
    threads, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    name = ctypes.create_string_buffer(128)
    fn = _build.entry('stamp_solver', 'tpu_sgp_stamp_solver_route',
                      _ROUTE_ARGS)
    err = fn(int(dtype == torch.float64), _DESIGN_CODE[design], h, w,
             device, ctypes.byref(threads), ctypes.byref(smem),
             ctypes.byref(blocks), name, len(name))
    if err == 1:                                # cudaErrorInvalidValue
        return None
    if err != 0:
        raise RuntimeError(f'{design} block query for {h}x{w} failed: '
                           f'CUDA error {err}')
    return dict(threads=threads.value, smem=smem.value,
                blocks_per_sm=blocks.value, instance=name.value.decode())


def _check_stamps(ref: str, taps: torch.Tensor, **rows) -> None:
    """``_build.check_operands`` on ``rows`` and the (H, W) ``taps``, and
    the dense operator's limit: H * W = N <= ``MAX_PIXELS``."""
    n = _build.check_operands(ref, **rows, taps=(taps, 'HW'))['N']
    if taps.numel() != n:
        raise ValueError(f'taps {tuple(taps.shape)} do not cover N={n}')
    if n > MAX_PIXELS:
        raise ValueError(f'stamps of {n} pixels exceed the dense '
                         f'operator\'s {MAX_PIXELS}')


def solve_rows(gn: torch.Tensor, bkg: torch.Tensor, flux: torch.Tensor,
               sat: torch.Tensor, taps: torch.Tensor, cfg: SGPConfig):
    """Solve every row of ``gn`` (B, N) to completion; see
    ``solve_rows_plain`` for the arguments. Returns
    ``(x (B, N), iters (B,) int32)``.

    CPU tensors take ``solve_rows_plain``. CUDA tensors launch the kernel,
    one thread block per row and the whole batch in one launch, on the
    route ``stamp_solver_plan`` picks from the taps' shape and the card's
    shared memory; ``launches['solve_rows']`` counts the launches and
    ``launches['solve_rows/<route>']`` them by route."""
    check_scope(cfg)
    _check_stamps('gn', taps, gn=(gn, 'BN'), bkg=(bkg, 'BN'),
                  flux=(flux, 'B'), sat=(sat, 'B'))
    if not gn.is_cuda:
        return solve_rows_plain(gn, bkg, flux, sat, taps, cfg)
    plan = device_plan(*taps.shape, gn.dtype, gn.device)
    launch = functools.partial(_launch, plan=plan)
    if plan.transposed:
        return solve_transposed(launch, gn, bkg, flux, sat, taps, cfg)
    return launch(gn, bkg, flux, sat, taps, cfg)


def _launch(gn, bkg, flux, sat, taps, cfg, *, plan):
    rows, n = gn.shape
    h, w = taps.shape
    x = torch.empty_like(gn)
    iters = torch.empty(rows, dtype=torch.int32, device=gn.device)
    if rows == 0:
        return x, iters
    prm = _Params(n, h, w, cfg.max_iter, cfg.stop_criterion,
                  cfg.max_backtracks, bracket_bits(gn.dtype),
                  cfg.tol_convergence, cfg.gamma, cfg.bt_factor,
                  cfg.alpha_init, cfg.alpha_min, cfg.alpha_max, cfg.tau_init)
    _build.launch(_build.kernel('stamp_solver', 'tpu_sgp_solve_stamps',
                                gn.dtype, _ARGS), gn.device,
                  gn.data_ptr(), bkg.data_ptr(), flux.data_ptr(),
                  sat.data_ptr(), taps.data_ptr(), x.data_ptr(),
                  iters.data_ptr(), rows, ctypes.byref(prm),
                  _DESIGN_CODE[plan.design],
                  what=f'stamp solver kernel launch failed on route '
                       f'{plan.route} ({h}x{w})',
                  count=('solve_rows', f'solve_rows/{plan.route}'))
    return x, iters


def apply_operator_plain(x: torch.Tensor, taps: torch.Tensor,
                         reps: int) -> torch.Tensor:
    """``(AT A)^reps`` applied to every row of ``x`` (B, N), with A and AT
    the dense circulant of the (H, W) ``taps``, as ``solve_rows_plain``
    builds them."""
    cmat = build_circulant_matrix(torch.fft.ifftshift(taps))
    for _ in range(reps):
        x = (x @ cmat.T) @ cmat
    return x


def apply_operator(x: torch.Tensor, taps: torch.Tensor,
                   reps: int) -> torch.Tensor:
    """The whole-solver kernel's operator alone: ``(AT A)^reps`` on every
    row of ``x`` (B, N), through the same device code and on the same route
    as ``solve_rows``'s kernel, one block a row, with no more blocks an SM
    than the solver keeps (``apply_operator.resident`` holds that count
    after a launch). It measures the operator's share of the kernel's time;
    the solver never calls it. CPU tensors take ``apply_operator_plain``."""
    _check_stamps('x', taps, x=(x, 'BN'))
    if reps < 0:
        raise ValueError(f'unsupported reps={reps}')
    if not x.is_cuda:
        return apply_operator_plain(x, taps, reps)
    h, w = taps.shape
    plan = device_plan(h, w, x.dtype, x.device)
    if plan.transposed:
        x, taps = transpose_rows(x, h, w), taps.T.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    resident = ctypes.c_int()
    _build.launch(_build.kernel('stamp_solver', 'tpu_sgp_apply_operator',
                                x.dtype, _OPERATOR_ARGS), x.device,
                  x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                  x.shape[0], *taps.shape, reps, _DESIGN_CODE[plan.design],
                  ctypes.byref(resident),
                  what=f'operator kernel launch failed on route '
                       f'{plan.route}')
    apply_operator.resident = resident.value
    return transpose_rows(out, w, h) if plan.transposed else out


apply_operator.resident = 0
