"""Plain reference for the KL-SGP solve that the benchmark's cells time.

Written from the published algorithm (Bonettini, Zanella and Zanni 2009;
the beta-SGP paper, arXiv:2207.10973) in the form the repository's float64
test oracle gives it: scaled gradient projection on the Kullback-Leibler
divergence, the flux-conserving projection under the scaling metric, a
monotone Armijo backtracking line search, and Barzilai-Borwein steplengths
alternated by the tau rule. It imports nothing of the program under test:
the operator, the scaling, the fluxes and the projection are worked out
here again from the inputs the benchmark made.

Every lane runs the same number of iterations here (a lane that has met
its stop rule just goes on, and its result is kept from the iteration at
which the rule fired), so one batched loop serves lanes of any length.

Precision: float64 is the reference. ``control='tf32'`` runs it in float32
with the operator's matrix products in TF32 (the card's TF32 mode; on the
CPU the operands are rounded to TF32's 10-bit mantissa), and
``control='bf16'`` keeps every array in bfloat16 (the FFTs take float32
copies and round their results back): the lower precisions that the
benchmark's controls use.
"""
from __future__ import annotations

import contextlib

import torch

# the solver settings this reference knows: every cell's configuration
# must give these, and only these values where one is fixed
KNOWN = dict(init_recon=2, proj_type=1, stop_criterion=3, divergence='kl',
             m_mem=1, scale_data=True)
DEFAULTS = dict(gamma=1e-4, bt_factor=0.4, alpha_init=1.3, alpha_min=1e-5,
                alpha_max=1e5, m_alpha=3, tau_init=0.5, max_backtracks=60)


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest, ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def circulant(psf: torch.Tensor) -> torch.Tensor:
    """The (N, N) matrix of circular convolution with the centred PSF on
    raveled H x W images: y[i, j] = sum_pq k[(i - p) % H, (j - q) % W]
    x[p, q], k the PSF rolled forward by half its size on each axis (as
    NumPy's fftshift rolls it; for an odd size that puts the centre at
    index -1, not 0: the reference code's own operator)."""
    h, w = psf.shape
    k = torch.roll(psf, shifts=(h // 2, w // 2), dims=(0, 1))
    i = torch.arange(h, device=psf.device)
    j = torch.arange(w, device=psf.device)
    di = (i[:, None] - i[None, :]) % h          # (out row, in row)
    dj = (j[:, None] - j[None, :]) % w
    m = k[di[:, None, :, None], dj[None, :, None, :]]  # (h, w, h, w)
    return m.reshape(h * w, h * w)


def make_operator(psf: torch.Tensor, shape, dtype, control):
    """(A, AT) on (B, N) rows of H x W images.

    A PSF of the image's shape convolves circularly (a dense matrix
    product); a smaller PSF convolves linearly with zero padding, cropped
    at the kernel's centre, through an FFT on the full linear grid: the
    forward kernel is the PSF over its sum, the adjoint its axis transpose
    (the reference code's own choice)."""
    h, w = shape
    if tuple(psf.shape) == (h, w):
        c = circulant(psf.double()).to(dtype)
        ct = c.T.contiguous()
        if control == 'tf32' and c.device.type == 'cpu':
            c, ct = _round_tf32(c), _round_tf32(ct)

            def mm(x, m):
                return _round_tf32(x) @ m
        else:
            def mm(x, m):
                return x @ m
        return (lambda x: mm(x, ct)), (lambda x: mm(x, c))

    kern = (psf / psf.sum()).double()
    kh, kw = kern.shape
    grid = (h + kh - 1, w + kw - 1)
    fft_dt = torch.float64 if dtype == torch.float64 else torch.float32

    def conv_with(k):
        fk = torch.fft.rfft2(k.to(fft_dt), s=grid)
        oy, ox = k.shape[0] // 2, k.shape[1] // 2

        def op(x):
            img = x.reshape(x.shape[0], h, w).to(fft_dt)
            full = torch.fft.irfft2(torch.fft.rfft2(img, s=grid) * fk, s=grid)
            return full[:, oy:oy + h, ox:ox + w].reshape(
                x.shape[0], -1).to(dtype)
        return op

    return conv_with(kern), conv_with(kern.T)


def project(flux, c, dia, cap, steps):
    """Per row, x = min(max((c + lam) / dia, 0), cap) with sum(x) = flux:
    bisection on lam over a bracket in which sum(x) goes from 0 to at
    least the flux, ``steps`` halvings (the sum is nondecreasing in lam)."""
    def xval(lam):
        x = torch.clamp_min((c + lam[:, None]) / dia, 0.0)
        return x if cap is None else torch.minimum(x, cap[:, None])

    lo = (-c).amin(-1)                  # every x is 0 here
    top = flux[:, None] if cap is None else cap[:, None]
    hi = (top * dia - c).amax(-1)       # every x is at least top here
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        low = xval(mid).sum(-1) < flux
        lo = torch.where(low, mid, lo)
        hi = torch.where(low, hi, mid)
    return xval(0.5 * (lo + hi))


def solve(gn, psf, bkg, settings: dict, *, flux=None, sat=None,
          control=None, check_every: int = 8):
    """KL-SGP on a (B, H, W) batch with one shared PSF, float64 unless a
    ``control`` asks for less.

    ``bkg`` is a (B,) background level a lane; ``flux`` (B,) the flux each
    restoration must hold, or None for sum(gn - bkg); ``sat`` the
    saturation level or None. ``settings`` gives ``max_iter`` and
    ``tol_convergence``, may give the line-search and steplength settings
    of ``DEFAULTS``, and agrees with ``KNOWN``.

    Returns ``(x, iters)``: each lane's result as the solver returns it,
    the iterate before the one at which the stop rule fired (or the
    ``max_iter``-th), in the input's units, and its iteration count."""
    for key, val in KNOWN.items():
        if settings.get(key, val) != val:
            raise ValueError(f'the reference solves {key}={val!r} only, '
                             f'not {settings[key]!r}')
    p = dict(DEFAULTS, **{k: v for k, v in settings.items() if k in DEFAULTS})
    max_iter = int(settings['max_iter'])
    tol = float(settings['tol_convergence'])
    dtype = torch.float64
    ctx = contextlib.nullcontext()
    if control == 'tf32':
        dtype = torch.float32
        if gn.is_cuda:
            ctx = _tf32_on()
    elif control == 'bf16':
        dtype = torch.bfloat16
    elif control is not None:
        raise ValueError(f'unknown control {control!r}')
    with ctx:
        return _solve(gn, psf, bkg, p, max_iter, tol, flux, sat, dtype,
                      control, check_every)


@contextlib.contextmanager
def _tf32_on():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _solve(gn, psf, bkg, p, max_iter, tol, flux, sat, dtype, control,
           check_every):
    dev = gn.device
    b, h, w = gn.shape
    n = h * w
    steps = 64 if dtype == torch.float64 else 40
    eps = torch.finfo(dtype).eps
    gn = gn.reshape(b, n).to(dtype)
    bkg = torch.as_tensor(bkg, device=dev).to(dtype).reshape(b, 1)
    A, AT = make_operator(psf.to(dev), (h, w), dtype, control)
    x = gn.clone()                                     # init_recon=2
    scaling = gn.amax(-1, keepdim=True)                # scale_data
    gn, bkg, x = gn / scaling, bkg / scaling, x / scaling
    vmin = torch.where(gn > 0, gn, torch.inf).amin(-1, keepdim=True)
    gn = torch.where(gn <= 0, vmin * eps * eps, gn)
    if flux is None:
        fl = (gn - bkg).sum(-1)
    else:
        fl = torch.as_tensor(flux, device=dev).to(dtype).reshape(b) \
            / scaling[:, 0]
    cap = None
    if sat is not None:
        cap = float(sat) / scaling[:, 0] - eps

    def objective(x_tf, den):
        return (gn * torch.log(gn / den)).sum(-1) + x_tf.sum(-1) - fl

    def gradient(den):
        return 1.0 - AT(gn / den)

    yb = (fl[:, None] / (fl[:, None] + bkg)) * AT(gn)
    x_lb = torch.where(yb > 0, yb, torch.inf).amin(-1, keepdim=True)
    x_ub = yb.amax(-1, keepdim=True)
    widen = x_ub / x_lb < 50
    x_lb = torch.where(widen, x_lb / 10, x_lb)
    x_ub = torch.where(widen, x_ub * 10, x_ub)

    x = project(fl, x, torch.ones_like(x), cap, steps)
    x_tf = A(x)
    g = gradient(x_tf + bkg)
    fv = objective(x_tf, x_tf + bkg)
    alpha = torch.full((b,), p['alpha_init'], dtype=dtype, device=dev)
    tau = torch.full((b,), p['tau_init'], dtype=dtype, device=dev)
    valpha = torch.full((b, p['m_alpha']), p['alpha_max'], dtype=dtype,
                        device=dev)
    xmat = torch.clamp(x, x_lb, x_ub)

    out = torch.zeros_like(x)
    own = torch.zeros(b, dtype=torch.long, device=dev)
    it = 1
    while True:
        x_prev = x
        fold = fv
        valpha = torch.cat([valpha[:, 1:], valpha[:, -1:]], 1)
        dmet = 1.0 / xmat
        y = project(fl, (x - alpha[:, None] * xmat * g) * dmet, dmet, cap,
                    steps)
        d = y - x
        gd = (d * g).sum(-1)
        d_tf = A(d)

        lam = torch.ones(b, dtype=dtype, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        fv_new = fv
        for _ in range(p['max_backtracks']):
            x_try = x_tf + lam[:, None] * d_tf
            fv_t = objective(x_try, x_try + bkg)
            ok = (fv_t <= fold + p['gamma'] * lam * gd) | (lam < 1e-12)
            fv_new = torch.where(done, fv_new, fv_t)
            lam = torch.where(done | ok, lam, lam * p['bt_factor'])
            done = done | ok
            if bool(done.all()):
                break
        lam = torch.where(done, lam,
                          torch.clamp_max(lam / p['bt_factor'], 1.0))

        x = x + lam[:, None] * d
        sk = lam[:, None] * d
        x_tf = x_tf + lam[:, None] * d_tf
        g_new = gradient(x_tf + bkg)
        yk = g_new - g
        g = g_new
        fv = fv_new

        xmat = torch.clamp(x, x_lb, x_ub)
        sk2, yk2 = sk / xmat, yk * xmat
        bk, ck = (sk2 * yk).sum(-1), (yk2 * sk).sum(-1)
        grow = torch.clamp_max(10 * alpha, p['alpha_max'])
        a1 = torch.where(bk <= 0, grow, torch.clamp(
            (sk2 * sk2).sum(-1) / torch.where(bk <= 0, 1.0, bk),
            p['alpha_min'], p['alpha_max']))
        a2 = torch.where(ck <= 0, grow, torch.clamp(
            ck / torch.where(ck <= 0, 1.0, (yk2 * yk2).sum(-1)),
            p['alpha_min'], p['alpha_max']))
        valpha = torch.cat([valpha[:, :-1], a2[:, None]], 1)
        low = a2 / a1 < tau
        pick = (it <= 20) | low
        alpha = torch.where(pick, valpha.amin(-1), a1)
        if it > 20:
            tau = torch.where(low, tau * 0.9, tau * 1.1)

        # a lane whose rule fires here returns the iterate before
        rd = (fold - fv) / fv
        fired = ~((rd > tol) & (rd >= 0)) | (it >= max_iter)
        first = fired & (own == 0)
        out = torch.where(first[:, None], x_prev, out)
        own = torch.where(first, torch.full_like(own, it), own)
        it += 1
        if it > max_iter or (it % check_every == 0 and bool((own > 0).all())):
            break
    return (out * scaling).reshape(b, h, w).to(torch.float64), own
