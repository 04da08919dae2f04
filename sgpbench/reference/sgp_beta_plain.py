"""Plain reference for the beta-SGP solve that the benchmark's beta cells
time.

Written from the reference code's ``sgp_betaDiv`` (Yash-10/beta-sgp,
``restoration/sgp.py:506-895``; arXiv:2207.10973): scaled gradient
projection on the beta-divergence D_beta(gn || A(x) + bkg), the
flux-conserving projection under the scaling metric, a monotone Armijo
backtracking line search in which every rejected trial moves beta, and
Barzilai-Borwein steplengths alternated by the tau rule. Every lane runs
the same number of iterations, and each keeps its result from the
iteration at which its own stop rule fired, as in ``sgp_plain.py``, whose
operator, scaling, projection and precision controls it loads by path. It
imports nothing of the program under test.

What it computes, as the reference code does:

- the objective, per lane, the sum over the pixels of
  (gn^b + (b - 1) den^b - b gn den^(b-1)) / (b (b - 1)), the reference
  code's betaDiv (``sgp.py:441-458``), written as
  gn^b (E(b) - E(b - 1)), E(t) = expm1(t d) / t, d = log(den / gn), so
  that it stays exact near b = 1 (the 1/(b (b - 1)) form loses about five
  digits at b = 1.005);
- the gradient den^(b-1) - A^T(gn den^(b-2)), as ``betaDivDerivwrtY``
  (``sgp.py:498-499``) computes it. This is not the exact gradient of the
  objective, A^T(den^(b-1)) - A^T(gn den^(b-2)): the reference code leaves
  A^T off the first term, and so does this file;
- d D / d b, averaged over the pixels (``betaDivDeriv``, ``sgp.py:462-495``,
  derived here again from the form above);
- on each rejected backtracking trial, b <- b - lr mean(dD/db) at that
  trial (``sgp.py:797-801``); an accepted trial leaves b;
- with ``schedule_lr``, lr = lr0 exp(-k epoch) after each iteration, the
  epoch being the iteration's number (``sgp.py:842-844``).

Where it departs from the program (``restore_stamps`` with
``divergence='beta'``):

- the projection is exact (``sgp_plain.project``'s bisection to the
  bottom of the precision), where the program runs its cold sectioning
  (``'section'``) or another method to its own tolerance;
- no compaction: one batched loop over every lane;
- the divergence and its d/db are written as above and not as the
  program's routines; no compensated sums;
- only the settings of ``KNOWN`` (init 2, ``proj_type`` 1, stop rule 3,
  one memory of the objective).

``control='tf32'`` and ``control='bf16'`` compute it one precision down,
as ``sgp_plain`` does.
"""
from __future__ import annotations

import contextlib
import importlib.util
import math
import os

import torch


def _load_plain():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'sgp_plain.py')
    spec = importlib.util.spec_from_file_location('sgpbench_sgp_plain_base',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_plain = _load_plain()

KNOWN = dict(init_recon=2, proj_type=1, stop_criterion=3, divergence='beta',
             m_mem=1, scale_data=True)
DEFAULTS = dict(_plain.DEFAULTS)
# the beta settings, which every configuration of a beta cell gives
BETA = ('beta0', 'lr0', 'adapt_beta', 'schedule_lr', 'lr_exp_param')
TAKES = ('max_iter', 'tol_convergence') + BETA

# 1 / (m + 2)!, the Taylor coefficients of
# P(u) = (exp(u) - 1 - u) / u**2 = sum_m u**m / (m + 2)!
_P_COEFFS = tuple(1.0 / math.factorial(m + 2) for m in range(16))


def _expm1_over(t: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """E(t) = expm1(t d) / t, and d where t is 0."""
    zero = t == 0
    return torch.where(zero, d, torch.expm1(t * d)
                       / torch.where(zero, torch.ones_like(t), t))


def _p(u: torch.Tensor) -> torch.Tensor:
    """P(u) = (exp(u) - 1 - u) / u**2: the series below |u| = 1/2, else
    the closed form."""
    small = u.abs() < 0.5
    series = torch.zeros_like(u) + _P_COEFFS[-1]
    for c in _P_COEFFS[-2::-1]:
        series = series * u + c
    safe = torch.where(small, torch.ones_like(u), u)
    return torch.where(small, series, (torch.expm1(safe) - safe)
                       / (safe * safe))


def _dexpm1_over(t: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dE/dt = (t d exp(t d) - expm1(t d)) / t**2 = d**2 exp(s) P(-s),
    s = t d: free of cancellation at small t d."""
    s = t * d
    return d * d * torch.exp(s) * _p(-s)


def divergence(den, gn, log_gn, b):
    """Per lane, D_b(gn || den) and the pixels' mean of dD/db; ``b`` is a
    (B, 1) column."""
    d = torch.log(den / gn)
    gn_b = torch.exp(b * log_gn)
    diff = _expm1_over(b, d) - _expm1_over(b - 1.0, d)
    fv = (gn_b * diff).sum(-1)
    ddb = gn_b * (log_gn * diff + _dexpm1_over(b, d)
                  - _dexpm1_over(b - 1.0, d))
    return fv, ddb.mean(-1)


def solve(gn, psf, bkg, settings: dict, *, flux=None, sat=None,
          control=None, check_every: int = 8):
    """beta-SGP on a (B, H, W) batch with one shared PSF, float64 unless a
    ``control`` asks for less; the arguments as ``sgp_plain.solve``'s, and
    ``settings`` also gives every key of ``TAKES``.

    Returns ``(x, iters)`` as ``sgp_plain.solve`` does."""
    x, iters, _ = solve_with_beta(gn, psf, bkg, settings, flux=flux, sat=sat,
                                  control=control, check_every=check_every)
    return x, iters


def solve_with_beta(gn, psf, bkg, settings: dict, *, flux=None, sat=None,
                    control=None, check_every: int = 8):
    """As ``solve``, and each lane's beta after the iteration at which its
    stop rule fired (what the program returns as ``SGPResult.beta``)."""
    for key, val in KNOWN.items():
        if settings.get(key, val) != val:
            raise ValueError(f'the reference solves {key}={val!r} only, '
                             f'not {settings[key]!r}')
    missing = [k for k in TAKES if k not in settings]
    if missing:
        raise ValueError(f'the beta reference needs {missing}')
    p = dict(DEFAULTS, **{k: v for k, v in settings.items() if k in DEFAULTS})
    p.update({k: settings[k] for k in BETA})
    max_iter = int(settings['max_iter'])
    tol = float(settings['tol_convergence'])
    dtype = torch.float64
    ctx = contextlib.nullcontext()
    if control == 'tf32':
        dtype = torch.float32
        if gn.is_cuda:
            ctx = _plain._tf32_on()
    elif control == 'bf16':
        dtype = torch.bfloat16
    elif control is not None:
        raise ValueError(f'unknown control {control!r}')
    with ctx:
        return _solve(gn, psf, bkg, p, max_iter, tol, flux, sat, dtype,
                      control, check_every)


def _solve(gn, psf, bkg, p, max_iter, tol, flux, sat, dtype, control,
           check_every):
    dev = gn.device
    b, h, w = gn.shape
    n = h * w
    steps = 64 if dtype == torch.float64 else 40
    eps = torch.finfo(dtype).eps
    gn = gn.reshape(b, n).to(dtype)
    bkg = torch.as_tensor(bkg, device=dev).to(dtype).reshape(b, 1)
    A, AT = _plain.make_operator(psf.to(dev), (h, w), dtype, control)
    x = gn.clone()                                     # init_recon=2
    scaling = gn.amax(-1, keepdim=True)                # scale_data
    gn, bkg, x = gn / scaling, bkg / scaling, x / scaling
    vmin = torch.where(gn > 0, gn, torch.inf).amin(-1, keepdim=True)
    gn = torch.where(gn <= 0, vmin * eps * eps, gn)
    log_gn = torch.log(gn)
    if flux is None:
        fl = (gn - bkg).sum(-1)
    else:
        fl = torch.as_tensor(flux, device=dev).to(dtype).reshape(b) \
            / scaling[:, 0]
    cap = None
    if sat is not None:
        cap = float(sat) / scaling[:, 0] - eps

    def gradient(den, beta):
        bc = beta[:, None]
        return den ** (bc - 1.0) - AT(gn * den ** (bc - 2.0))

    yb = (fl[:, None] / (fl[:, None] + bkg)) * AT(gn)
    x_lb = torch.where(yb > 0, yb, torch.inf).amin(-1, keepdim=True)
    x_ub = yb.amax(-1, keepdim=True)
    widen = x_ub / x_lb < 50
    x_lb = torch.where(widen, x_lb / 10, x_lb)
    x_ub = torch.where(widen, x_ub * 10, x_ub)

    full = lambda v: torch.full((b,), v, dtype=dtype, device=dev)
    beta = full(p['beta0'])
    lr0 = full(p['lr0'])
    lr = lr0
    x = _plain.project(fl, x, torch.ones_like(x), cap, steps)
    x_tf = A(x)
    g = gradient(x_tf + bkg, beta)
    fv, _ = divergence(x_tf + bkg, gn, log_gn, beta[:, None])
    alpha = full(p['alpha_init'])
    tau = full(p['tau_init'])
    valpha = torch.full((b, p['m_alpha']), p['alpha_max'], dtype=dtype,
                        device=dev)
    xmat = torch.clamp(x, x_lb, x_ub)

    out = torch.zeros_like(x)
    beta_out = torch.zeros_like(beta)
    own = torch.zeros(b, dtype=torch.long, device=dev)
    it = 1
    while True:
        x_prev = x
        fold = fv
        valpha = torch.cat([valpha[:, 1:], valpha[:, -1:]], 1)
        dmet = 1.0 / xmat
        y = _plain.project(fl, (x - alpha[:, None] * xmat * g) * dmet, dmet,
                           cap, steps)
        d = y - x
        gd = (d * g).sum(-1)
        d_tf = A(d)

        lam = torch.ones(b, dtype=dtype, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        fv_new = fv
        for _ in range(p['max_backtracks']):
            x_try = x_tf + lam[:, None] * d_tf
            fv_t, dmean = divergence(x_try + bkg, gn, log_gn, beta[:, None])
            ok = (fv_t <= fold + p['gamma'] * lam * gd) | (lam < 1e-12)
            fv_new = torch.where(done, fv_new, fv_t)
            step = ~done & ~ok
            lam = torch.where(step, lam * p['bt_factor'], lam)
            if p['adapt_beta']:
                beta = torch.where(step, beta - lr * dmean, beta)
            done = done | ok
            if bool(done.all()):
                break
        lam = torch.where(done, lam,
                          torch.clamp_max(lam / p['bt_factor'], 1.0))

        x = x + lam[:, None] * d
        sk = lam[:, None] * d
        x_tf = x_tf + lam[:, None] * d_tf
        g_new = gradient(x_tf + bkg, beta)
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
        if p['schedule_lr']:
            lr = lr0 * math.exp(-p['lr_exp_param'] * it)

        # a lane whose rule fires here returns the iterate before, and the
        # beta of this iteration
        rd = (fold - fv) / fv
        fired = ~((rd > tol) & (rd >= 0)) | (it >= max_iter)
        first = fired & (own == 0)
        out = torch.where(first[:, None], x_prev, out)
        beta_out = torch.where(first, beta, beta_out)
        own = torch.where(first, torch.full_like(own, it), own)
        it += 1
        if it > max_iter or (it % check_every == 0 and bool((own > 0).all())):
            break
    return ((out * scaling).reshape(b, h, w).to(torch.float64), own,
            beta_out.to(torch.float64))
