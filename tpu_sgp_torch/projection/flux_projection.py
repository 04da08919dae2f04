"""Flux-conserving projection for a (B, N) batch: every method of the JAX
package, and the dispatch between them.

Port of ``tpu_sgp/projection/flux_projection.py`` and of the per-row
arithmetic around the Pallas kernel's call
(``tpu_sgp/experimental/pallas_projection.py:68-108``). Each method returns,
for every row of ``c`` under the metric ``dia`` (both (B, N)),

    x = min(max((c + lam) / dia, 0), cap)        (cap only with has_sat)

where lam is the root of sum(x) = b; ``b``, ``scaling`` and ``sat_level``
are (B,), and cap = sat_level / scaling - eps. The JAX functions project one
image and are batched by ``vmap``; here every tensor carries the batch as
its leading axis. The methods with a static trip count ('bisect',
'section', 'sort', 'pallas') never synchronise with the host; the loops
whose trip count differs per lane (warm bisect, 'secant') keep a per-lane
mask, as a vmapped ``while_loop`` freezes a lane that has finished, and ask
the host once a trip whether any lane still runs.

On a card, 'bisect' runs as a grid kernel with the same schedule
(``kernels.flux_projection.project_guided_rows``), one launch for a stamp
batch or a whole frame; CPU tensors and rows sharded over mesh axes keep
the plain ladder (``guided_route``).

``axes`` (an ``ops.mesh.MeshAxes``) projects an image sharded over mesh
axes, as the JAX functions' ``axes`` do: every global quantity (the bracket,
the anchors, each residual) is one collective over the axes, so every rank
takes the same branches. 'sort' and 'pallas' need the whole row on one
device and take no ``axes``; the solver remaps them to 'bisect'
(``tpu_sgp/solvers/sgp.py:225-226``).
"""
from __future__ import annotations

import math

import torch

from ..kernels.flux_projection import (bracket_bits, guided_route,
                                       newton_passes, project_guided_rows,
                                       project_rows, section_steps)
from ..observability import host_flag, span
from ..ops.reduce import gmax, gmin, gsum

METHODS = ('bisect', 'section', 'sort', 'secant', 'pallas')
_K_PTS = 3  # interior points per step of 'section' (flux_projection.py:241)
# under mesh axes: one collective a step, so fewer, wider steps
# (flux_projection.py:297)
_K_PTS_SHARDED = 7


def check_method(method: str) -> None:
    """Raise ``ValueError`` for a projection method that does not exist."""
    if method not in METHODS:
        raise ValueError(f'unknown projection_method {method!r}')


def _per_row(v, like: torch.Tensor) -> torch.Tensor:
    """A per-row argument as a (B,) tensor in ``like``'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device
                           ).reshape(-1).expand(like.shape[0])


def _cap(sat_level, scaling, like: torch.Tensor) -> torch.Tensor:
    """The saturation ceiling sat/scaling - eps per row
    (``flux_projection.py:291-292``)."""
    return (_per_row(sat_level, like) / _per_row(scaling, like)
            - torch.finfo(like.dtype).eps)


class _Rows:
    """What every bracketing method shares (``_sectioning_machinery``,
    ``flux_projection.py:255-324``, and ``_ladder_machinery``, ``:383-448``):
    the primal recovery, the guaranteed global bracket lo = min(-c),
    hi = max(max(b*dia - c), lo + 1), and the residual of K points a row at
    once. The residual multiplies by a hoisted 1/dia and, with saturation,
    clips in the dia-scaled domain: min(cap, z/dia) == min(cap*dia, z)/dia.
    Under mesh axes the bracket and every residual are global.
    """

    def __init__(self, b, c, dia, scaling, sat_level, has_sat, axes=()):
        self.c = c
        self.axes = axes
        self.dia = torch.as_tensor(dia, dtype=c.dtype,
                                   device=c.device).expand_as(c)
        self.b = _per_row(b, c)
        self.has_sat = has_sat
        self.inv = 1.0 / self.dia
        if has_sat:
            self.cap = _cap(sat_level, scaling, c)
            self.cap_term = self.cap[:, None] * self.dia
        self.lo = gmin(-c, axes)
        self.hi = torch.maximum(gmax(self.b[:, None] * self.dia - c, axes),
                                self.lo + 1.0)

    def xval(self, lam: torch.Tensor) -> torch.Tensor:
        """x at one lam a row, (B,) -> (B, N)."""
        x = torch.clamp_min((self.c + lam[:, None]) / self.dia, 0.0)
        if self.has_sat:
            x = torch.minimum(self.cap[:, None], x)
        return x

    def evalr(self, lams: torch.Tensor) -> torch.Tensor:
        """The residual sum(x) - b at K points a row, (B, K) -> (B, K): one
        (B, K, N) broadcast and one reduction."""
        xs = self.c[:, None, :] + lams[:, :, None]
        xs.clamp_(min=0.0)
        if self.has_sat:
            torch.minimum(xs, self.cap_term[:, None, :], out=xs)
        xs.mul_(self.inv[:, None, :])
        return gsum(xs, self.axes) - self.b[:, None]


# ---- 'section': cold K-way sectioning ------------------------------------

def _sectioning(b, c, dia, scaling, sat_level, has_sat, n_iters, axes):
    """The machinery of ``_sectioning_machinery``
    (``flux_projection.py:255-324``): K = 3 interior points a step (7
    under mesh axes), ``sweep(lo, width)`` counting the points whose
    residual is < 0. Returns ``(rows, sweep, k, n_steps)``."""
    rows = _Rows(b, c, dia, scaling, sat_level, has_sat, axes)
    if n_iters is None:
        n_iters = bracket_bits(c.dtype)
    k = _K_PTS_SHARDED if axes else _K_PTS
    n_steps = int(math.ceil(n_iters / math.log2(k + 1)))
    fracs = torch.arange(1, k + 1, dtype=c.dtype, device=c.device) / (k + 1)

    def sweep(lo, width):
        mids = lo[:, None] + width[:, None] * fracs
        return (rows.evalr(mids) < 0).sum(-1).to(c.dtype)

    return rows, sweep, k, n_steps


def project_df_section(b, c, dia, scaling, sat_level=None,
                       has_sat: bool | None = None,
                       n_iters: int | None = None, axes=()) -> torch.Tensor:
    """Cold K-way sectioned bisection on the dual variable
    (``flux_projection.py:327-358``): ``ceil(bracket_bits / 2)`` steps of
    3 interior points from the global bracket."""
    if has_sat is None:
        has_sat = sat_level is not None
    rows, sweep, k, n_steps = _sectioning(b, c, dia, scaling, sat_level,
                                          has_sat, n_iters, axes)
    lo, hi = rows.lo, rows.hi
    for _ in range(n_steps):
        width = hi - lo
        seg = width / (k + 1)
        lo = lo + sweep(lo, width) * seg
        hi = lo + seg
    return rows.xval(0.5 * (lo + hi))


def project_df_bisect_warm(b, c, dia, scaling, sat_level=None,
                           has_sat: bool | None = None,
                           n_iters: int | None = None, axes=(),
                           lam_prev=None, dlam_prev=None):
    """K-way sectioning from a warm bracket around the previous dual root
    (``flux_projection.py:626-701``); returns ``(x, lam)``.

    One probe sweep sections a window of half-width 4|dlam_prev| + target
    around ``lam_prev``, falling back to the global endpoints on a miss;
    then sweeps run per lane until the bracket is below the cold path's
    final width (or the dtype's resolution where it sits), at most
    n_steps + 2 of them. A lane that has finished stays frozen while the
    others run."""
    if has_sat is None:
        has_sat = sat_level is not None
    eps = torch.finfo(c.dtype).eps
    rows, sweep, k, n_steps = _sectioning(b, c, dia, scaling, sat_level,
                                          has_sat, n_iters, axes)
    cold_lo, cold_hi = rows.lo, rows.hi
    lam_prev = _per_row(lam_prev, c)
    dlam_prev = _per_row(dlam_prev, c)
    width_cold = cold_hi - cold_lo
    target = width_cold * (k + 1.0) ** (-n_steps)

    ok = (torch.isfinite(lam_prev) & torch.isfinite(dlam_prev)
          & (dlam_prev < width_cold))
    w = 4.0 * dlam_prev.abs() + torch.maximum(target,
                                              2.0 * eps * lam_prev.abs())
    w_lo = torch.where(ok, torch.clamp(lam_prev - w, cold_lo, cold_hi),
                       cold_lo)
    w_hi = torch.where(ok, torch.clamp(lam_prev + w, w_lo, cold_hi), cold_hi)
    w_width = w_hi - w_lo
    nb = sweep(w_lo, w_width)
    seg = w_width / (k + 1)
    lo = torch.where(nb == 0, cold_lo, w_lo + nb * seg)
    hi = torch.where(nb == k, cold_hi,
                     torch.where(nb == 0, w_lo + seg, w_lo + (nb + 1.0) * seg))

    t = 0
    while True:
        floor = 0.75 * eps * (lo.abs() + hi.abs())
        run = hi - lo > torch.maximum(target, floor)
        if t >= n_steps + 2 or not host_flag(run.any()):
            break
        width = hi - lo
        seg = width / (k + 1)
        new_lo = lo + sweep(lo, width) * seg
        lo = torch.where(run, new_lo, lo)
        hi = torch.where(run, new_lo + seg, hi)
        t += 1
    lam = 0.5 * (lo + hi)
    return rows.xval(lam), lam


# ---- 'bisect': guided-secant sectioning (the default) ---------------------

def _ladder_update(qs: torch.Tensor, vs: torch.Tensor,
                   sl_lo_prev: torch.Tensor, sl_hi_prev: torch.Tensor):
    """Root-segment selection over a sorted residual ladder
    (``flux_projection.py:451-489``), as gathers over (B, L) rows instead
    of the JAX version's scalar where-chains.

    ``qs`` are ascending lambdas and ``vs`` their nondecreasing residuals.
    The new lo is the last inner point (1..L-2) with r < 0, else point 0;
    the new hi the first inner point with r >= 0, else point L-1. The chord
    slopes of the segments next to them become the slope surrogates of the
    next pass; a side that kept its end point keeps its previous slope.
    Returns (lo, hi, r_lo, r_hi, sl_lo, sl_hi)."""
    n = qs.shape[1]
    dl = qs[:, 1:] - qs[:, :-1]
    rising = dl > 0
    slope = torch.where(rising, (vs[:, 1:] - vs[:, :-1])
                        / torch.where(rising, dl, 1.0), 0.0)
    idx = torch.arange(n, device=qs.device)
    inner = (idx >= 1) & (idx <= n - 2)
    i_lo = torch.where(inner & (vs < 0), idx, 0).amax(-1, keepdim=True)
    i_hi = torch.where(inner & (vs >= 0), idx, n - 1).amin(-1, keepdim=True)
    sl_lo = torch.where(i_lo[:, 0] > 0,
                        slope.gather(1, (i_lo - 1).clamp_min(0))[:, 0],
                        sl_lo_prev)
    sl_hi = torch.where(i_hi[:, 0] < n - 1,
                        slope.gather(1, i_hi.clamp_max(n - 2))[:, 0],
                        sl_hi_prev)
    return (qs.gather(1, i_lo)[:, 0], qs.gather(1, i_hi)[:, 0],
            vs.gather(1, i_lo)[:, 0], vs.gather(1, i_hi)[:, 0], sl_lo, sl_hi)


def _anchors(rows: _Rows):
    """The analytic root anchors of ``_ladder_machinery``
    (``flux_projection.py:423-437``): the all-active upper probe
    max(-c) + b/sum(1/dia) and the guaranteed lower bound
    (b - sum(max(0, c)/dia)) / sum(1/dia)."""
    axes = rows.axes
    inv_sum = gsum(rows.inv, axes)
    anl_hi = gmax(-rows.c, axes) + rows.b / inv_sum
    anl_lo = (rows.b - gsum(torch.clamp_min(rows.c, 0.0) * rows.inv, axes)
              ) / inv_sum
    return anl_lo, anl_hi


def _candidates(state, with_mid: bool, eps: float) -> torch.Tensor:
    """A pass's three sorted candidates, (B, 3) (``flux_projection.py:
    570-602``): the endpoint chord, Newton from hi (or a deep geometric
    point when it leaves the bracket), and the midpoint in a main pass or
    Newton from lo in the finish pass; clipped into the open bracket."""
    lo, hi, r_lo, r_hi, sl_lo, sl_hi = state
    w = hi - lo
    mid = lo + 0.5 * w
    den = r_hi - r_lo
    chord = torch.where(den > 0, lo - r_lo * w / torch.where(den > 0, den,
                                                             1.0), mid)
    nh_raw = torch.where(sl_hi > 0,
                         hi - r_hi / torch.where(sl_hi > 0, sl_hi, 1.0), mid)
    nh = torch.where((nh_raw > lo) & (nh_raw < hi), nh_raw, lo + w / 16.0)
    if with_mid:
        third = mid
    else:
        third = torch.where(sl_lo > 0,
                            lo - r_lo / torch.where(sl_lo > 0, sl_lo, 1.0),
                            mid)
    a, b2 = torch.minimum(chord, nh), torch.maximum(chord, nh)
    srt = (torch.minimum(a, third),
           torch.minimum(b2, torch.maximum(a, third)),
           torch.maximum(b2, third))
    eps_w = eps * w
    return torch.stack([torch.clamp(p, lo + eps_w, hi - eps_w) for p in srt],
                       1)


def _guided_root(b, c, dia, scaling, sat_level, has_sat, n_iters, axes=()):
    """``_guided_root`` (``flux_projection.py:538-623``): a probe pass, the
    main passes, then a finish pass and a secant inside the tightest
    sign-changing segment. Returns ``(x, lam)``."""
    s_main = newton_passes(c.dtype) if n_iters is None else int(n_iters)
    rows = _Rows(b, c, dia, scaling, sat_level, has_sat, axes)
    anl_lo, anl_hi = _anchors(rows)
    eps = torch.finfo(c.dtype).eps
    lo, hi = rows.lo, rows.hi
    zero = torch.zeros_like(lo)

    def ladder(lo, hi, r_lo, r_hi, pts):
        qs = torch.cat([lo[:, None], pts, hi[:, None]], 1)
        vs = torch.cat([r_lo[:, None], rows.evalr(pts), r_hi[:, None]], 1)
        return qs, vs

    # probe: the anchors, the midpoint and hi (r(lo) = -b is known)
    w = hi - lo
    eps_w = eps * w
    ql = torch.clamp(anl_lo, lo + eps_w, hi - eps_w)
    qh = torch.clamp(anl_hi, ql, hi - eps_w)
    mid = lo + 0.5 * w
    pts = torch.stack([torch.minimum(ql, mid),
                       torch.minimum(qh, torch.maximum(ql, mid)),
                       torch.maximum(qh, mid), hi], 1)
    qs = torch.cat([lo[:, None], pts], 1)
    vs = torch.cat([-rows.b[:, None], rows.evalr(pts)], 1)
    state = _ladder_update(qs, vs, zero, zero)

    for _ in range(s_main):
        lo, hi, r_lo, r_hi, sl_lo, sl_hi = state
        qs, vs = ladder(lo, hi, r_lo, r_hi, _candidates(state, True, eps))
        state = _ladder_update(qs, vs, sl_lo, sl_hi)

    lo, hi, r_lo, r_hi, _, _ = state
    qs, vs = ladder(lo, hi, r_lo, r_hi, _candidates(state, False, eps))
    l0, l1, v0, v1, _, _ = _ladder_update(qs, vs, zero, zero)
    den = v1 - v0
    lam = torch.where(den > 0,
                      torch.clamp(l0 - v0 * (l1 - l0)
                                  / torch.where(den > 0, den, 1.0), l0, l1),
                      l1)
    return rows.xval(lam), lam


def _guided_root_kernel(b, c, dia, scaling, sat_level, has_sat, n_iters):
    """``_guided_root`` as one launch of the guided grid kernel
    (``kernels.flux_projection.project_guided_rows``), the same schedule:
    returns ``(x, lam)``."""
    s_main = newton_passes(c.dtype) if n_iters is None else int(n_iters)
    b = _per_row(b, c).contiguous()
    dia = torch.as_tensor(dia, dtype=c.dtype, device=c.device
                          ).expand_as(c).contiguous()
    cap = _cap(sat_level, scaling, c).contiguous() if has_sat else None
    with span('projection.kernel'):
        return project_guided_rows(b, c.contiguous(), dia, cap, s_main,
                                   has_sat)


def project_df_bisect(b, c, dia, scaling, sat_level=None,
                      has_sat: bool | None = None,
                      n_iters: int | None = None, axes=()) -> torch.Tensor:
    """Guided-secant sectioning on the dual variable, the JAX package's
    default projection (``flux_projection.py:492-535``): a static schedule
    of a probe pass (4 points), ``newton_passes`` main passes and a finish
    pass (3 points each).

    ``kernels.flux_projection.guided_route`` picks the route: the guided
    grid kernel (``_guided_root_kernel``) for CUDA tensors, whatever their
    shape; the plain ``_guided_root``, every step a few (B, K, N)
    broadcasts in PyTorch, for CPU tensors and under mesh ``axes``."""
    if has_sat is None:
        has_sat = sat_level is not None
    if guided_route(c.dtype, c.device, sharded=bool(axes)) == 'kernel':
        return _guided_root_kernel(b, c, dia, scaling, sat_level, has_sat,
                                   n_iters)[0]
    return _guided_root(b, c, dia, scaling, sat_level, has_sat, n_iters,
                        axes)[0]


# ---- 'sort': exact breakpoint sweep ---------------------------------------

def project_df_sort(b, c, dia, scaling, sat_level=None,
                    has_sat: bool | None = None) -> torch.Tensor:
    """Exact projection by a sweep over the sorted knots of the piecewise
    linear residual (``flux_projection.py:704-775``): a stable sort of the
    activation (and saturation) knots, prefix sums of the slopes, and a
    linear interpolation in the first segment where r crosses zero."""
    if has_sat is None:
        has_sat = sat_level is not None
    dia = torch.as_tensor(dia, dtype=c.dtype, device=c.device).expand_as(c)
    b = _per_row(b, c)
    inv = 1.0 / dia
    act = -c
    if has_sat:
        cap = _cap(sat_level, scaling, c)[:, None]
        knots = torch.cat([act, cap * dia - c], 1)
        dslope = torch.cat([inv, -inv], 1)
    else:
        knots = act
        dslope = inv
    order = torch.argsort(knots, dim=1, stable=True)
    t = knots.gather(1, order)
    slope = torch.cumsum(dslope.gather(1, order), 1)
    r = torch.cat([torch.zeros_like(b)[:, None],
                   torch.cumsum(slope[:, :-1] * torch.diff(t, dim=1), 1)],
                  1) - b[:, None]
    k = torch.searchsorted(r, torch.zeros_like(r[:, :1]), right=False)
    k = k.clamp(1, t.shape[1] - 1)
    r0, r1 = r.gather(1, k - 1)[:, 0], r.gather(1, k)[:, 0]
    t0, t1 = t.gather(1, k - 1)[:, 0], t.gather(1, k)[:, 0]
    denom = r1 - r0
    lam = torch.where(denom.abs() > 0,
                      t0 - r0 * (t1 - t0) / torch.where(denom == 0, 1.0,
                                                        denom), t0)
    if has_sat:
        lam_past = t[:, -1]
    else:
        lam_past = t[:, -1] - r[:, -1] / slope[:, -1]
    lam = torch.where(r[:, -1] < 0, lam_past, lam)
    lam = torch.where(r[:, 0] >= 0, t[:, 0], lam)
    x = torch.clamp_min((c + lam[:, None]) * inv, 0.0)
    if has_sat:
        x = torch.minimum(cap, x)
    return x


# ---- 'secant': the reference's bracket and secant iteration ---------------

def project_df(b, c, dia, scaling, sat_level=None, max_projs: int = 1000,
               tol_lam: float = 1e-11,
               has_sat: bool | None = None, axes=()) -> torch.Tensor:
    """The reference's dual method (``flux_projection.py:34-232``): a
    geometric bracketing phase, then the asymmetric safeguarded secant, to
    |r| <= 1e-11 b or a step below 1e-11 (1 + |lam|), at most ``max_projs``
    evaluations.

    It computes in float64, as the reference does
    (``flux_conserve_proj.py:14-16``), and returns the input's dtype. The
    ``lax.cond`` branches become per-lane selects, and each data-dependent
    loop keeps a per-lane mask with one host check a trip."""
    if has_sat is None:
        has_sat = sat_level is not None
    in_dtype = c.dtype
    dt = torch.float64
    c = c.to(dt)
    dia = torch.as_tensor(dia, device=c.device).to(dt).expand_as(c)
    b = _per_row(b, c)
    eps = torch.finfo(dt).eps
    tol_r = max(1e-11, 100.0 * eps) * b
    tol_lam = max(tol_lam, 100.0 * eps)
    if has_sat:
        cap = _cap(sat_level, scaling, c)[:, None]

    def xval(lam):
        x = torch.clamp_min((c + lam[:, None]) / dia, 0.0)
        return torch.minimum(cap, x) if has_sat else x

    def rval(lam):
        return gsum(xval(lam), axes) - b

    zero = torch.zeros_like(b)
    one = torch.ones_like(b)
    r0 = rval(zero)
    done0 = r0.abs() < tol_r

    # bracketing (:102-150): lanes with r0 < 0 grow lam until r >= 0
    # (bracket_up), the others shrink it until r <= 0 (bracket_down, which
    # stops where dlam overflows); lam_a / r_a is the far end
    up = r0 < 0
    lam = torch.where(up, one, -one)
    lam_a, r_a, dlam, r = zero, r0, one, rval(lam)
    biter = torch.zeros_like(b, dtype=torch.int32)
    broke = torch.zeros_like(up)
    while True:
        run = torch.where(up, (r < 0) & torch.isfinite(dlam),
                          (r > 0) & ~broke) & (biter < max_projs) & ~done0
        if not host_flag(run.any()):
            break
        s = torch.clamp_min(r_a / r - 1.0, 0.1)
        dn = dlam + dlam / s
        ok = up | torch.isfinite(dn)
        new_lam = torch.where(up, lam + dn, torch.where(ok, lam - dn, lam))
        new_r = torch.where(ok, rval(new_lam), r)
        lam_a = torch.where(run, lam, lam_a)
        r_a = torch.where(run & ok, r, r_a)
        lam = torch.where(run, new_lam, lam)
        dlam = torch.where(run & ok, dn, dlam)
        r = torch.where(run, new_r, r)
        broke = torch.where(run, ~ok, broke)
        biter = torch.where(run, biter + 1, biter)
    lambdal = torch.where(up, lam_a, lam)
    rl = torch.where(up, r_a, r)
    lambdau = torch.where(up, lam, lam_a)
    ru = torch.where(up, r, r_a)

    doneu = ru.abs() < tol_r
    donel = rl.abs() < tol_r
    early = done0 | doneu | donel

    # secant phase (:156-224)
    s = 1.0 - rl / ru
    dlam = dlam / s
    lam = lambdau - dlam
    r = rval(lam)
    maxit_s = max_projs - biter
    siter = torch.zeros_like(biter)
    while True:
        run = ((r.abs() > tol_r) & (dlam > tol_lam * (1.0 + lam.abs()))
               & (siter < maxit_s) & ~early)
        if not host_flag(run.any()):
            break
        # r > 0, s <= 2: plain secant through the upper bracket
        u1_s = 1.0 - rl / r
        u1_dlam = (lam - lambdal) / u1_s
        u1_lam = lam - u1_dlam
        # r > 0, s > 2: safeguarded step, s = max(ru/r - 1, 0.1)
        u2_s = torch.clamp_min(ru / r - 1.0, 0.1)
        u2_dlam = (lambdau - lam) / u2_s
        u2_lam = torch.maximum(lam - u2_dlam, 0.75 * lambdal + 0.25 * lam)
        pos_hi = s <= 2.0
        p_s = torch.where(pos_hi, u1_s, u2_s)
        p_dlam = torch.where(pos_hi, u1_dlam, u2_dlam)
        p_lam = torch.where(pos_hi, u1_lam, u2_lam)
        # r <= 0, s >= 2: plain secant through the lower bracket
        l1_s = 1.0 - r / ru
        l1_dlam = (lambdau - lam) / l1_s
        l1_lam = lambdau - l1_dlam
        # r <= 0, s < 2: safeguarded step, s from the new bracket
        l2_dlam = (lam - lambdal) / torch.clamp_min(rl / r - 1.0, 0.1)
        l2_lam = torch.minimum(lam + l2_dlam, 0.75 * lambdau + 0.25 * lam)
        l2_s = (lambdau - lam) / (lambdau - l2_lam)
        neg_hi = s >= 2.0
        n_s = torch.where(neg_hi, l1_s, l2_s)
        n_dlam = torch.where(neg_hi, l1_dlam, l2_dlam)
        n_lam = torch.where(neg_hi, l1_lam, l2_lam)

        pos = r > 0
        up_l = run & ~pos
        up_u = run & pos
        lambdal = torch.where(up_l, lam, lambdal)
        rl = torch.where(up_l, r, rl)
        lambdau = torch.where(up_u, lam, lambdau)
        ru = torch.where(up_u, r, ru)
        s = torch.where(run, torch.where(pos, p_s, n_s), s)
        dlam = torch.where(run, torch.where(pos, p_dlam, n_dlam), dlam)
        new_lam = torch.where(pos, p_lam, n_lam)
        r = torch.where(run, rval(new_lam), r)
        lam = torch.where(run, new_lam, lam)
        siter = torch.where(run, siter + 1, siter)

    lam_sel = torch.where(doneu, lambdau, torch.where(donel, lambdal, lam))
    lam_sel = torch.where(done0, zero, lam_sel)
    return xval(lam_sel).to(in_dtype)


# ---- 'pallas': the kernel K1 ----------------------------------------------

def project_df_pallas(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                      scaling: torch.Tensor,
                      sat_level: torch.Tensor | None = None,
                      has_sat: bool | None = None,
                      n_steps: int | None = None) -> torch.Tensor:
    """Batched ``project_df_pallas`` (``pallas_projection.py:68-122``).

    ``c`` and ``dia`` are (B, N); ``b``, ``scaling`` and ``sat_level`` are
    (B,). The cap is sat/scaling - eps per row (``:101-103``). ``n_steps``
    sectioning steps of 7 points (default ``section_steps``)."""
    if has_sat is None:
        has_sat = sat_level is not None
    if n_steps is None:
        n_steps = section_steps(c.dtype)
    cap = _cap(sat_level, scaling, c) if has_sat else torch.zeros_like(b)
    return project_rows(b.contiguous(), c.contiguous(),
                        dia.expand_as(c).contiguous(), cap.contiguous(),
                        n_steps, has_sat)


def project(method: str, b, c, dia, scaling, sat_level=None,
            has_sat: bool | None = None,
            max_projs: int = 1000, axes=()) -> torch.Tensor:
    """Project with the named method, as the solver's ``proj`` does
    (``tpu_sgp/solvers/sgp.py:232-260``)."""
    check_method(method)
    if axes and method in ('sort', 'pallas'):
        raise ValueError(f'projection_method {method!r} needs the whole '
                         f"row on one device; under mesh axes use 'bisect'")
    if method == 'pallas':
        return project_df_pallas(b, c, dia, scaling, sat_level, has_sat)
    if method == 'bisect':
        return project_df_bisect(b, c, dia, scaling, sat_level, has_sat,
                                 axes=axes)
    if method == 'section':
        return project_df_section(b, c, dia, scaling, sat_level, has_sat,
                                  axes=axes)
    if method == 'sort':
        return project_df_sort(b, c, dia, scaling, sat_level, has_sat)
    return project_df(b, c, dia, scaling, sat_level, max_projs=max_projs,
                      has_sat=has_sat, axes=axes)
