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
them. In float32 the kernel runs the operator on the tensor cores, as
three TF32 products a multiply-add (hi*hi + hi*lo + lo*hi of each value's
TF32 split), which keeps float32 accuracy as the reference's
``Precision.HIGHEST`` does: a block has one warp a 16 x 16 tile of the
stamp padded to multiples of 16, 32 * ceil(H/16) * ceil(W/16) threads. In
float64 it runs on the FP64 pipes: ceil(H/2) * ceil(W/4) threads, each
owning a 2 x 4 patch of pixels. A stamp shape past 1024 threads (in
float32, a side under 8 pixels against one over 512), or whose tap tables
and staged input exceed the card's shared memory, fails to launch.

``solve_rows`` launches ``csrc/stamp_solver.cu`` for CUDA tensors and calls
``solve_rows_plain`` for CPU tensors; a CUDA call that cannot launch
raises, it never falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..config import SGPConfig
from ..ops.psf_operator import build_circulant_matrix
from ..projection.flux_projection import bracket_bits

# the dense operator's own limit (tpu_sgp/ops/psf_operator.py:38-40)
MAX_PIXELS = 4096


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


_ENTRY = {torch.float32: 'tpu_sgp_solve_stamps_f32',
          torch.float64: 'tpu_sgp_solve_stamps_f64'}
_OPERATOR_ENTRY = {torch.float32: 'tpu_sgp_apply_operator_f32',
                   torch.float64: 'tpu_sgp_apply_operator_f64'}


@functools.cache
def _entry(dtype: torch.dtype):
    from ._build import load_library
    fn = getattr(load_library('stamp_solver'), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                           ctypes.POINTER(_Params),
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _operator_entry(dtype: torch.dtype):
    from ._build import load_library
    fn = getattr(load_library('stamp_solver'), _OPERATOR_ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_rows(gn, bkg, flux, sat, taps) -> None:
    if gn.dim() != 2 or taps.dim() != 2:
        raise ValueError(f'gn must be (B, N) and taps (H, W), got '
                         f'{tuple(gn.shape)} and {tuple(taps.shape)}')
    rows, n = gn.shape
    if taps.numel() != n:
        raise ValueError(f'taps {tuple(taps.shape)} do not cover N={n}')
    if n > MAX_PIXELS:
        raise ValueError(f'stamps of {n} pixels exceed the dense '
                         f'operator\'s {MAX_PIXELS}')
    for name, t, shape in (('bkg', bkg, (rows, n)), ('flux', flux, (rows,)),
                           ('sat', sat, (rows,))):
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must have shape {shape}, got '
                             f'{tuple(t.shape)}')


def solve_rows(gn: torch.Tensor, bkg: torch.Tensor, flux: torch.Tensor,
               sat: torch.Tensor, taps: torch.Tensor, cfg: SGPConfig):
    """Solve every row of ``gn`` (B, N) to completion; see
    ``solve_rows_plain`` for the arguments. Returns
    ``(x (B, N), iters (B,) int32)``.

    CPU tensors take ``solve_rows_plain``. CUDA tensors launch the kernel,
    one thread block per row and the whole batch in one launch;
    ``solve_rows.launches`` counts the launches."""
    check_scope(cfg)
    _check_rows(gn, bkg, flux, sat, taps)
    if not gn.is_cuda:
        return solve_rows_plain(gn, bkg, flux, sat, taps, cfg)
    if gn.dtype not in _ENTRY:
        raise TypeError(f'the kernel takes float32 or float64, got '
                        f'{gn.dtype}')
    for name, t in (('bkg', bkg), ('flux', flux), ('sat', sat),
                    ('taps', taps)):
        if t.device != gn.device or t.dtype != gn.dtype:
            raise TypeError(f'{name} is {t.dtype} on {t.device}; gn is '
                            f'{gn.dtype} on {gn.device}')
    for name, t in (('gn', gn), ('bkg', bkg), ('flux', flux), ('sat', sat),
                    ('taps', taps)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
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
    stream = torch.cuda.current_stream(gn.device)
    err = _entry(gn.dtype)(gn.data_ptr(), bkg.data_ptr(), flux.data_ptr(),
                           sat.data_ptr(), taps.data_ptr(), x.data_ptr(),
                           iters.data_ptr(), rows, ctypes.byref(prm),
                           gn.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'stamp solver kernel launch failed: CUDA error '
                           f'{err}')
    solve_rows.launches += 1
    return x, iters


solve_rows.launches = 0


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
    row of ``x`` (B, N), through the same device code as ``solve_rows``'s
    kernel (float32 on the tensor cores, float64 on the FP64 pipes), one
    block a row, with no more blocks an SM than the solver keeps
    (``apply_operator.resident`` holds that count after a launch).
    It measures the operator's share of the kernel's time; the solver never
    calls it. CPU tensors take ``apply_operator_plain``."""
    if x.dim() != 2 or taps.dim() != 2 or taps.numel() != x.shape[1]:
        raise ValueError(f'x must be (B, N) and taps (H, W) with H*W = N, '
                         f'got {tuple(x.shape)} and {tuple(taps.shape)}')
    if x.shape[1] > MAX_PIXELS or reps < 0:
        raise ValueError(f'unsupported N={x.shape[1]} or reps={reps}')
    if not x.is_cuda:
        return apply_operator_plain(x, taps, reps)
    if x.dtype not in _OPERATOR_ENTRY or taps.dtype != x.dtype \
            or taps.device != x.device:
        raise TypeError(f'x and taps must be float32 or float64 on one '
                        f'device, got {x.dtype} and {taps.dtype} on '
                        f'{taps.device}')
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise ValueError('x and taps must be contiguous')
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    h, w = taps.shape
    stream = torch.cuda.current_stream(x.device)
    resident = ctypes.c_int()
    err = _operator_entry(x.dtype)(x.data_ptr(), taps.data_ptr(),
                                   out.data_ptr(), x.shape[0], h, w, reps,
                                   ctypes.byref(resident), x.device.index,
                                   stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f'operator kernel launch failed: CUDA error {err}')
    apply_operator.resident = resident.value
    return out


apply_operator.resident = 0
