"""Minimal FITS WCS: linear CD/CDELT transforms + sky projections + SIP.

Replaces the reference's astropy.wcs usage (pixel_to_skycoord in the CLI,
Cutout2D-carried WCS — reference sgp.py:957, 1041-1060) for the headers this
framework reads/writes. Supports CRPIX/CRVAL/CD (or CDELT+PC / CDELT-only),
the zenithal projection family of Calabretta & Greisen (2002) — TAN
(gnomonic), SIN (orthographic, incl. the SLANT orthographic PV2_1/PV2_2
form AIPS/CASA write — NCP headers), ARC (equidistant), STG
(stereographic), ZEA (equal-area), ZPN (polynomial, PV2_m), AZP
(untilted perspective, PV2_1), SZP (slant zenithal perspective,
PV2_1..3) — the cylindrical and pseudo-cylindrical families — CAR
(plate carree), CEA (cylindrical equal area, PV2_1), MER (Mercator),
SFL/GLS (Sanson-Flamsteed), AIT (Hammer-Aitoff), MOL (Mollweide),
CYP (cylindrical perspective, PV2_1/PV2_2), PAR (Craster parabolic) —
the all-sky grid projections — HPX (HEALPix, Calabretta & Roukema 2007)
and TSC (tangential spherical cube) — the conic family — COP
(perspective), COE (equal area), COD (equidistant), COO (conformal),
all with PV2_1/PV2_2 standard parallels — the pseudo-conics — BON
(Bonne, PV2_1) and PCO (polyconic) — via the general native↔celestial
spherical rotation (CG02
section 2.3-2.4, with the celestial-pole solution of eq. 8-10 for
non-polar fiducials),
TPV distorted gnomonic (the SCAMP/SWarp convention: degree-7 PVi_m
plane polynomials incl. radial terms before the TAN deprojection, also
honored on legacy CTYPE-TAN headers carrying PV keys),
and SIP distortion polynomials (Shupe et al. 2005: A_p_q/B_p_q forward
terms applied to intermediate pixel offsets; AP/BP inverse terms used when
present, Newton fixed-point inversion otherwise) — the cases used by
survey imaging; falls back to linear world coordinates for other CTYPEs
with a loud warning.
"""
# Host code (NumPy/SciPy), kept equal to tpu_sgp/image/wcs.py:1
from __future__ import annotations

import warnings

import numpy as np

_WARNED_CTYPES: set = set()

_D2R = np.pi / 180.0

# tpu_sgp/image/wcs.py:42
def _arccos_or_nan(s):
    """arccos that NaNs out-of-domain points like astropy/wcslib,
    instead of silently clipping onto the limb."""
    with np.errstate(invalid='ignore'):
        return np.arccos(np.where(np.abs(np.asarray(s, np.float64))
                                  <= 1.0, s, np.nan))


# tpu_sgp/image/wcs.py:50
def _arc_inv(r):
    r = np.asarray(r, np.float64)
    with np.errstate(invalid='ignore'):
        return np.pi / 2 - np.where(r <= np.pi + 1e-12, r, np.nan)


# Zenithal projections: R(theta) and theta(R), both with R in RADIANS of
# native-polar radius and theta the native latitude in radians
# (Calabretta & Greisen 2002, Table 13 / section 5.1). Inverses NaN
# off-projection radii (SIN R > 1, ZEA R > 2, ARC R > pi) instead of
# clipping onto the limb/antipode — clipped pixels would resolve to
# REAL sky positions and let the reprojection machinery paint phantom
# flux outside the projection footprint.
_ZENITHAL = {
    'TAN': (lambda th: np.cos(th) / np.sin(th),
            lambda r: np.arctan2(1.0, r)),
    'SIN': (lambda th: np.cos(th),
            lambda r: _arccos_or_nan(r)),
    'ARC': (lambda th: np.pi / 2 - th, _arc_inv),
    'STG': (lambda th: 2.0 * np.tan((np.pi / 2 - th) / 2.0),
            lambda r: np.pi / 2 - 2.0 * np.arctan(r / 2.0)),
    'ZEA': (lambda th: 2.0 * np.sin((np.pi / 2 - th) / 2.0),
            lambda r: np.pi / 2 - 2.0 * _arcsin_or_nan(r / 2.0)),
}

# tpu_sgp/image/wcs.py:75
def _zpn_pair(pv):
    """ZPN (zenithal polynomial, CG02 section 5.1.2): R = sum_m PV2_m
    gamma^m with gamma = pi/2 - theta the native colatitude, both in
    radians (the wcslib convention). Returns (r_of(theta), theta_of(r)).
    The inverse solves the polynomial by vectorized bisection on
    [0, gamma_max], gamma_max the first stationary point of the
    polynomial (the projection is single-valued only up to it)."""
    pv = np.asarray(pv, np.float64)
    dpv = pv[1:] * np.arange(1, len(pv))

    def p(g):
        return np.polyval(pv[::-1], g)

    def dp(g):
        return np.polyval(dpv[::-1], g) if len(dpv) else np.zeros_like(g)

    # first stationary point on (0, pi] bounds the invertible domain;
    # the grid only brackets it — refine by bisection on dp so r_max
    # and the inversion domain don't include a non-monotonic tail
    gs = np.linspace(0.0, np.pi, 4097)
    neg = np.nonzero(dp(gs[1:]) <= 0.0)[0]
    if len(neg):
        lo, hi = gs[neg[0]], gs[neg[0] + 1]
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if dp(np.array(mid)) > 0.0:
                lo = mid
            else:
                hi = mid
        g_max = 0.5 * (lo + hi)
    else:
        g_max = np.pi
    r_max = float(p(g_max))

    def r_of(theta):
        return p(np.pi / 2 - theta)

    def theta_of(r):
        r = np.asarray(r, np.float64)
        lo = np.zeros_like(r)
        hi = np.full_like(r, g_max)
        for _ in range(80):            # 80 halvings: f64-exact on [0, pi]
            mid = 0.5 * (lo + hi)
            below = p(mid) < r
            lo = np.where(below, mid, lo)
            hi = np.where(below, hi, mid)
        g = 0.5 * (lo + hi)
        with np.errstate(invalid='ignore'):
            g = np.where((r >= p(np.zeros_like(r))) & (r <= r_max), g,
                         np.nan)
        return np.pi / 2 - g

    return r_of, theta_of


# tpu_sgp/image/wcs.py:130
def _azp_pair(mu):
    """AZP (zenithal perspective, CG02 section 5.1.1, untilted
    gamma = 0): R = (mu + 1) cos(theta) / (mu + sin(theta)) — projection
    of the sphere from a point mu radii behind its center. Exact special
    cases anchor the tests: mu = 0 is TAN (center), mu = 1 is STG (far
    pole), mu -> inf approaches SIN (infinity). Inverse via
    cos(theta) - rho sin(theta) = mu rho, rho = R / (mu + 1):
    theta = arccos(mu rho / sqrt(1 + rho^2)) - arctan(rho), the branch
    through theta = 90 at R = 0."""

    def r_of(theta):
        return (mu + 1.0) * np.cos(theta) / (mu + np.sin(theta))

    def theta_of(r):
        rho = np.asarray(r, np.float64) / (mu + 1.0)
        s = mu * rho / np.sqrt(1.0 + rho * rho)
        with np.errstate(invalid='ignore'):
            s = np.where(np.abs(s) <= 1.0, s, np.nan)
        return np.arccos(s) - np.arctan(rho)

    return r_of, theta_of


# Slant zenithal projections (full 2-D plane<->native maps, unlike the
# radius-law _ZENITHAL family). Native direction cosines follow the
# zenithal plane convention x = R sin(phi), y = -R cos(phi):
#   l = cos(theta) sin(phi), m = -cos(theta) cos(phi), n = sin(theta)
# and the projection plane is z = 1 (tangent at the native pole).
# tpu_sgp/image/wcs.py:158
def _slant_sin_pair(xi_s, eta_s):
    """Slant orthographic — SIN with PV2_1 = xi, PV2_2 = eta (CG02
    section 5.1.5; the AIPS convention radio interferometry writes, NCP
    being (0, cot(delta_0))): PARALLEL projection of the sphere onto
    z = 1 along the direction (xi, eta, 1), so
    x = l + xi (1 - n), y = m + eta (1 - n). The inverse solves the
    ray-sphere quadratic for n, taking the larger root (the near
    hemisphere — the branch through theta = 90 at the origin, which is
    plain SIN's arccos choice at xi = eta = 0)."""
    a = 1.0 + xi_s * xi_s + eta_s * eta_s

    def fwd(phi, theta):
        ct, n = np.cos(theta), np.sin(theta)
        return (ct * np.sin(phi) + xi_s * (1.0 - n),
                -ct * np.cos(phi) + eta_s * (1.0 - n))

    def inv(x, y):
        u = x - xi_s
        v = y - eta_s
        b = u * xi_s + v * eta_s
        disc = b * b - a * (u * u + v * v - 1.0)
        with np.errstate(invalid='ignore'):
            n = (-b + np.sqrt(np.where(disc >= 0.0, disc, np.nan))) / a
        l = x - xi_s * (1.0 - n)
        m = y - eta_s * (1.0 - n)
        return np.arctan2(l, -m), np.arctan2(n, np.hypot(l, m))

    return fwd, inv


# tpu_sgp/image/wcs.py:188
def _szp_pair(mu, phi_c, theta_c):
    """SZP (slant zenithal perspective, CG02 section 5.1.2; PV2_1 = mu,
    PV2_2 = phi_c, PV2_3 = theta_c, angles in radians here): CENTRAL
    projection onto z = 1 from the point P at distance mu opposite the
    native position (phi_c, theta_c),
    P = -mu (cos(theta_c) sin(phi_c), -cos(theta_c) cos(phi_c),
    sin(theta_c)) — the published xp/yp/zp. theta_c = 90 recovers
    untilted AZP for every phi_c (P = (0, 0, -mu)); mu = 0 recovers TAN
    (projection from the center). The tests pin P-S-X collinearity —
    the definition — plus those special cases. Inverse: ray-sphere
    quadratic from the plane point, larger root (near hemisphere, the
    branch through theta = 90 at R = 0)."""
    xp = -mu * np.cos(theta_c) * np.sin(phi_c)
    yp = mu * np.cos(theta_c) * np.cos(phi_c)
    zp = -mu * np.sin(theta_c)

    def fwd(phi, theta):
        ct, n = np.cos(theta), np.sin(theta)
        l = ct * np.sin(phi)
        m = -ct * np.cos(phi)
        with np.errstate(divide='ignore', invalid='ignore'):
            t = (1.0 - zp) / (n - zp)
            t = np.where(t > 0.0, t, np.nan)   # behind the projection pt
        return xp + t * (l - xp), yp + t * (m - yp)

    def inv(x, y):
        dx = x - xp
        dy = y - yp
        dz = 1.0 - zp
        aa = dx * dx + dy * dy + dz * dz
        bb = xp * dx + yp * dy + zp * dz
        cc = mu * mu - 1.0
        disc = bb * bb - aa * cc
        with np.errstate(invalid='ignore'):
            u = (-bb + np.sqrt(np.where(disc >= 0.0, disc, np.nan))) / aa
        l = xp + u * dx
        m = yp + u * dy
        n = np.clip(zp + u * dz, -1.0, 1.0)
        return np.arctan2(l, -m), np.arctan2(n, np.hypot(l, m))

    return fwd, inv


# TPV distorted gnomonic (the registered FITS "TPV" convention: the
# SCAMP/SWarp distorted TAN carried by most ground-based survey
# astrometry, e.g. DECam/PTF/ZTF pipelines — headers the reference reads
# through astropy, sgp.py:957). The linear intermediate world
# coordinates are warped by degree-7 bivariate polynomials — including
# the odd RADIAL terms r, r^3, r^5, r^7 that make TPV more than SIP —
# BEFORE the standard TAN deprojection:
#   xi'  = sum_m PV1_m T_m(xi,  eta, r)
#   eta' = sum_m PV2_m T_m(eta, xi,  r)     (the axis-2 sequence swaps
#                                            the roles of xi and eta)
# with r = hypot(xi, eta) and T_m the 40-term sequence below; the
# defaults PV1_1 = PV2_1 = 1 reproduce plain TAN exactly. Each table
# entry is (a, b, d): the monomial x^a y^b when d == 0, else r^d.
# tpu_sgp/image/wcs.py:244
def _tpv_term_table():
    terms = []
    for deg in range(8):
        terms.extend((deg - k, k, 0) for k in range(deg + 1))
        if deg % 2 == 1:
            terms.append((0, 0, deg))   # r, r^3, r^5, r^7
    return tuple(terms)


_TPV_TERMS = _tpv_term_table()          # 40 terms: indices 0..39


# tpu_sgp/image/wcs.py:256
def _pow_table(v, n=8):
    """[v^0, v^1, ..., v^(n-1)] by cumulative products — one multiply per
    power instead of one exponentiation per polynomial term. Keeps the
    reprojection hot path (full image grids through _tpv_invert's Newton
    loop) cheap."""
    out = [np.ones_like(v)]
    for _ in range(n - 1):
        out.append(out[-1] * v)
    return out


# tpu_sgp/image/wcs.py:267
def _tpv_degrees(pv):
    """Highest x/y/r powers carried by nonzero coefficients — bounds the
    power tables so a typical degree-3 survey header doesn't pay for
    full-grid powers 4..7 on every Newton iteration."""
    na = nb = nd = 0
    for m, (a, b, d) in enumerate(_TPV_TERMS):
        if pv[m] != 0.0:
            na, nb, nd = max(na, a), max(nb, b), max(nd, d)
    return na, nb, nd


# tpu_sgp/image/wcs.py:278
def _tpv_eval(pv, x, y):
    """sum_m pv[m] T_m(x, y, r) for a dense length-40 coefficient array
    (zero terms skipped — real headers carry ~10 of the 40)."""
    na, nb, nd = _tpv_degrees(pv)
    xp = _pow_table(np.asarray(x, np.float64), na + 1)
    yp = _pow_table(np.asarray(y, np.float64), nb + 1)
    rp = _pow_table(np.hypot(x, y), nd + 1)
    out = np.zeros(np.broadcast(x, y).shape, np.float64)
    for m, (a, b, d) in enumerate(_TPV_TERMS):
        c = pv[m]
        if c != 0.0:
            out = out + c * (rp[d] if d else xp[a] * yp[b])
    return out


# tpu_sgp/image/wcs.py:293
def _tpv_jac(pv, x, y):
    """(d/dx, d/dy) of _tpv_eval, for the Newton inverse. Radial terms
    differentiate to d r^(d-2) (x, y) — undefined at the origin for the
    cusp term r (d = 1), where the gradient is taken as 0 (the Newton
    start never sits exactly there for distorted headers)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    r = np.hypot(x, y)
    na, nb, nd = _tpv_degrees(pv)
    xp = _pow_table(x, na + 1)
    yp = _pow_table(y, nb + 1)
    with np.errstate(divide='ignore', invalid='ignore'):
        rinv = np.where(r > 0.0, 1.0 / r, 0.0)
    rp = _pow_table(r, nd + 1)
    shape = np.broadcast(x, y).shape
    gx = np.zeros(shape, np.float64)
    gy = np.zeros(shape, np.float64)
    for m, (a, b, d) in enumerate(_TPV_TERMS):
        c = pv[m]
        if c == 0.0:
            continue
        if d:
            rm2 = rp[d - 1] * rinv      # r^(d-2), 0 at the origin cusp
            gx = gx + c * d * rm2 * x
            gy = gy + c * d * rm2 * y
        else:
            if a:
                gx = gx + c * a * xp[a - 1] * yp[b]
            if b:
                gy = gy + c * b * xp[a] * yp[b - 1]
    return gx, gy


# Cylindrical + pseudo-cylindrical projections (CG02 sections 5.2/5.4).
# All have the fiducial on the native equator (phi0 = theta0 = 0). Each
# entry maps native spherical (phi, theta) [radians] <-> intermediate
# world coordinates (xi, eta) [degrees]:
#   (native_of(xi, eta, lam) -> (phi, theta),
#    plane_of(phi, theta, lam) -> (xi, eta))
# lam is the CEA PV2_1 parameter (ignored by the others).
_R2D = 1.0 / _D2R


# tpu_sgp/image/wcs.py:336
def _arcsin_or_nan(s):
    """arcsin that NaNs out-of-domain points (off-projection pixels) like
    astropy, instead of silently clipping to the pole."""
    with np.errstate(invalid='ignore'):
        return np.arcsin(np.where(np.abs(np.asarray(s, np.float64)) <= 1.0,
                                  s, np.nan))


# tpu_sgp/image/wcs.py:344
def _car(xi, eta, lam):
    return xi * _D2R, eta * _D2R


# tpu_sgp/image/wcs.py:348
def _car_inv(phi, theta, lam):
    return phi * _R2D, theta * _R2D


# tpu_sgp/image/wcs.py:352
def _cea(xi, eta, lam):
    return xi * _D2R, _arcsin_or_nan(eta * _D2R * lam)


# tpu_sgp/image/wcs.py:356
def _cea_inv(phi, theta, lam):
    return phi * _R2D, np.sin(theta) / lam * _R2D


# tpu_sgp/image/wcs.py:360
def _mer(xi, eta, lam):
    return xi * _D2R, 2.0 * np.arctan(np.exp(eta * _D2R)) - np.pi / 2


# tpu_sgp/image/wcs.py:364
def _mer_inv(phi, theta, lam):
    return phi * _R2D, np.log(np.tan(np.pi / 4 + theta / 2.0)) * _R2D


# tpu_sgp/image/wcs.py:368
def _phi_or_nan(phi):
    """NaN native longitudes beyond +-180 deg: for the CLOSED
    pseudo-cylindrical / pseudo-conic maps, plane points past the
    bounding meridian are off-projection (astropy NaNs there) — a
    finite phi would wrap onto a second copy of far-side sky and let
    the reprojection machinery double-count flux. The unbounded
    cylinders (CAR/CEA/MER/CYP) are excluded: there x past 180 deg is
    the SAME sky by 360-deg periodicity."""
    with np.errstate(invalid='ignore'):
        return np.where(np.abs(phi) <= np.pi + 1e-9, phi, np.nan)


# tpu_sgp/image/wcs.py:380
def _sfl(xi, eta, lam):
    theta = eta * _D2R
    with np.errstate(divide='ignore', invalid='ignore'):
        phi = xi * _D2R / np.cos(theta)
    return _phi_or_nan(phi), theta


# tpu_sgp/image/wcs.py:387
def _sfl_inv(phi, theta, lam):
    return phi * np.cos(theta) * _R2D, theta * _R2D


# tpu_sgp/image/wcs.py:391
def _ait(xi, eta, lam):
    # Hammer-Aitoff inverse (CG02 section 5.4, eq. 107-108)
    x_r, y_r = xi * _D2R, eta * _D2R
    z2 = 1.0 - (x_r / 4.0) ** 2 - (y_r / 2.0) ** 2
    # the map's boundary is Z^2 = 1/2; outside is off-projection
    with np.errstate(invalid='ignore'):
        z = np.sqrt(np.where(z2 >= 0.5, z2, np.nan))
    phi = 2.0 * np.arctan2(z * x_r / 2.0, 2.0 * z * z - 1.0)
    theta = _arcsin_or_nan(y_r * z)
    return phi, theta


# tpu_sgp/image/wcs.py:403
def _ait_inv(phi, theta, lam):
    gamma = np.sqrt(2.0 / (1.0 + np.cos(theta) * np.cos(phi / 2.0)))
    xi = 2.0 * gamma * np.cos(theta) * np.sin(phi / 2.0) * _R2D
    eta = gamma * np.sin(theta) * _R2D
    return xi, eta


# tpu_sgp/image/wcs.py:410
def _mol(xi, eta, lam):
    # Mollweide inverse (CG02 eq. 113-115)
    x_r, y_r = xi * _D2R, eta * _D2R
    g = _arcsin_or_nan(y_r / np.sqrt(2.0))
    theta = _arcsin_or_nan((2.0 * g + np.sin(2.0 * g)) / np.pi)
    with np.errstate(divide='ignore', invalid='ignore'):
        phi = np.pi * x_r / (2.0 * np.sqrt(2.0) * np.cos(g))
    return _phi_or_nan(phi), theta


# tpu_sgp/image/wcs.py:420
def _mol_inv(phi, theta, lam):
    # solve 2g + sin 2g = pi sin(theta) by Newton. The root is TRIPLE at
    # the poles (f ~ -(4/3) eps^3 with eps = pi/2 - g), where Newton
    # degrades to linear convergence at factor 2/3 — so start from the
    # pole-asymptotic eps = cbrt(3 (pi - |t|) / 4) blended with g = theta,
    # and run to the f64 fixed point (60 iterations bound the worst case
    # at (2/3)^60 ~ 3e-11 of the start error; far from the poles Newton
    # is quadratic and the steps underflow long before that — this is
    # cheap vectorized host trig, not device code)
    st = np.sin(np.asarray(theta, np.float64))
    target = np.pi * st
    g0 = np.arcsin(np.clip(st, -1.0, 1.0))
    eps = np.cbrt(3.0 * np.maximum(np.pi - np.abs(target), 0.0) / 4.0)
    g_pole = np.sign(target) * (np.pi / 2 - eps)
    g = np.where(np.abs(st) > 0.9, g_pole, g0)
    for _ in range(60):
        f = 2.0 * g + np.sin(2.0 * g) - target
        df = 2.0 + 2.0 * np.cos(2.0 * g)
        step = np.where(df > 1e-12, f / np.where(df > 1e-12, df, 1.0), 0.0)
        g = g - step
        if not np.any(np.abs(step) > 1e-15):   # fixed point everywhere
            break
    g = np.where(np.abs(st) >= 1.0 - 1e-15, np.arcsin(np.clip(st, -1, 1)), g)
    xi = 2.0 * np.sqrt(2.0) / np.pi * phi * np.cos(g) * _R2D
    eta = np.sqrt(2.0) * np.sin(g) * _R2D
    return xi, eta


# tpu_sgp/image/wcs.py:448
def _cyp(xi, eta, lam):
    """CYP (cylindrical perspective, CG02 section 5.2.1): projection of
    the sphere from a point mu radii from its center onto a cylinder of
    radius lam; x = lam phi, y = (mu + lam) sin(theta) / (mu +
    cos(theta)). Defaults mu = lam = 1 (wcslib's); mu = 1,
    lam = sqrt(2)/2 is Gall's stereographic, whose y = (1 + lam)
    tan(theta / 2) law anchors the tests; mu = 0 is the central
    cylindrical y = lam tan(theta).
    Inverse via sin(theta) - p cos(theta) = p mu with p = y / (mu+lam):
    theta = asin(p mu / sqrt(1 + p^2)) + atan(p)."""
    mu, lm = lam
    phi = xi * _D2R / lm
    p = eta * _D2R / (mu + lm)
    th = _arcsin_or_nan(p * mu / np.sqrt(1.0 + p * p)) + np.arctan(p)
    return phi, th


# tpu_sgp/image/wcs.py:465
def _cyp_inv(phi, theta, lam):
    mu, lm = lam
    with np.errstate(divide='ignore', invalid='ignore'):
        y = (mu + lm) * np.sin(theta) / (mu + np.cos(theta))
    return lm * phi * _R2D, y * _R2D


# tpu_sgp/image/wcs.py:472
def _par(xi, eta, lam):
    """PAR (Craster parabolic, CG02 section 5.4): x = phi (2 cos(2
    theta / 3) - 1), y = 3 sin(theta / 3) [radians]. Equal-area by the
    identity cos(theta) = (2 cos(2 theta / 3) - 1) cos(theta / 3), which
    the tests pin numerically; meridians are parabolas."""
    th = 3.0 * _arcsin_or_nan(eta * _D2R / 3.0)
    w = 2.0 * np.cos(2.0 * th / 3.0) - 1.0
    with np.errstate(divide='ignore', invalid='ignore'):
        phi = np.where(np.abs(w) > 1e-14, xi * _D2R / w, 0.0)
    return _phi_or_nan(phi), th


# tpu_sgp/image/wcs.py:484
def _par_inv(phi, theta, lam):
    return (phi * (2.0 * np.cos(2.0 * theta / 3.0) - 1.0) * _R2D,
            3.0 * np.sin(theta / 3.0) * _R2D)


# tpu_sgp/image/wcs.py:489
def _bon(xi, eta, lam):
    """BON (Bonne equal-area pseudo-conic, CG02 section 5.3.3;
    PV2_1 = theta_1 != 0 the standard parallel): parallels are
    concentric circular arcs of radius R = y0 - theta about (0, y0),
    y0 = theta_1 + cot(theta_1), traversed at TRUE SCALE (arc speed
    cos(theta) per radian of phi) — with the central meridian also true
    scale; those two laws plus the unit area Jacobian pin the formulas.
    Southern grids (theta_1 < 0) carry R < 0 through the same algebra
    (like the conics). theta_1 = 0 is SFL and is rejected upstream."""
    y0 = lam + 1.0 / np.tan(lam)
    x_r, e_r = xi * _D2R, eta * _D2R
    r = np.sign(lam) * np.hypot(x_r, y0 - e_r)
    theta = y0 - r
    with np.errstate(divide='ignore', invalid='ignore'):
        a = np.arctan2(x_r / r, (y0 - e_r) / r)
        phi = a * r / np.cos(theta)
    phi = np.where(np.abs(np.cos(theta)) < 1e-14, 0.0, phi)
    return (_phi_or_nan(phi),
            np.where(np.abs(theta) <= np.pi / 2 + 1e-12, theta, np.nan))


# tpu_sgp/image/wcs.py:510
def _bon_inv(phi, theta, lam):
    y0 = lam + 1.0 / np.tan(lam)
    r = y0 - theta
    with np.errstate(divide='ignore', invalid='ignore'):
        a = phi * np.cos(theta) / r
    return r * np.sin(a) * _R2D, (y0 - r * np.cos(a)) * _R2D


# tpu_sgp/image/wcs.py:518
def _pco(xi, eta, lam):
    """PCO (polyconic, CG02 section 5.3.4): every parallel is an arc of
    its own tangent cone — a circle of radius cot(theta) centered at
    (0, theta + cot(theta)) — traversed at true scale, with the central
    meridian true scale too. theta is recovered from the plane point by
    vectorized bisection on f(theta) = x^2 + (y - theta)^2 -
    2 (y - theta) cot(theta) (the circle identity with cot^2 cancelled),
    which brackets sign-definitely on (0, min(y, pi/2)]; the south is
    mirrored through the (x, -y) <-> (phi, -theta) symmetry; the y = 0
    row is the exact straight equator x = phi."""
    x = np.abs(np.asarray(xi, np.float64)) * _D2R   # phi-sign restored
    y = np.asarray(eta, np.float64) * _D2R
    s = np.sign(y)
    ay = np.abs(y)
    eqt = ay < 1e-9
    lo = np.minimum(ay * 0.5, 1e-10)    # keeps lo < hi for tiny ay
    hi = np.minimum(np.where(eqt, 1.0, ay), np.pi / 2)

    def f(t):
        return (x * x + (ay - t) ** 2
                - 2.0 * (ay - t) / np.tan(np.maximum(t, 1e-300)))

    for _ in range(80):
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0          # f(lo) -> -inf, f(hi) >= 0
        lo = np.where(neg, mid, lo)
        hi = np.where(neg, hi, mid)
    th = 0.5 * (lo + hi)
    tanth = np.tan(th)
    a = np.arctan2(x * tanth, 1.0 - (ay - th) * tanth)
    with np.errstate(divide='ignore', invalid='ignore'):
        phi = a / np.sin(th)
    phi = np.where(eqt, x, phi)
    th = np.where(eqt, 0.0, th)
    sx = np.where(np.asarray(xi, np.float64) < 0.0, -1.0, 1.0)
    return _phi_or_nan(sx * phi), np.where(eqt, 0.0, s) * th


# tpu_sgp/image/wcs.py:556
def _pco_inv(phi, theta, lam):
    small = np.abs(theta) < 1e-12
    tt = np.where(small, 1.0, theta)        # placeholder, masked below
    cot = 1.0 / np.tan(tt)
    a = phi * np.sin(tt)
    x = np.where(small, phi, cot * np.sin(a))
    y = np.where(small, 0.0, tt + cot * (1.0 - np.cos(a)))
    return x * _R2D, y * _R2D


# tpu_sgp/image/wcs.py:566
def _hpx(xi, eta, lam):
    """HPX (HEALPix, Calabretta & Roukema 2007) inverse, standard
    H = 4, K = 3 grid: the equatorial zone |y| <= 45 deg is a CEA-like
    band sin(theta) = (8 / (3 pi)) y; the polar zones are the interrupted
    facet triangles with sigma = 2 - 4|y|/pi, sin(theta) =
    sign(y) (1 - sigma^2 / 3) and the longitude stretched about each
    facet center phi_c by 1/sigma. Pixels outside the facet triangles
    (|x - x_c| > 45 sigma in the polar caps) are off-projection NaN, as
    are |y| > 90."""
    x_r, y_r = xi * _D2R, eta * _D2R
    ay = np.abs(y_r)
    eq = ay <= np.pi / 4
    # facet-center longitude of the polar quadrant containing x
    k = np.floor((x_r + np.pi) * 2.0 / np.pi)
    k = np.clip(k, 0.0, 3.0)
    x_c = -np.pi + (2.0 * k + 1.0) * np.pi / 4
    sig = 2.0 - 4.0 * ay / np.pi
    with np.errstate(divide='ignore', invalid='ignore'):
        phi_pol = x_c + (x_r - x_c) / np.where(sig > 0.0, sig, 1.0)
        phi_pol = np.where(sig > 0.0, phi_pol, x_c)   # exact pole
    st_pol = np.sign(y_r) * (1.0 - sig * sig / 3.0)
    ok_pol = (ay <= np.pi / 2 + 1e-12) & (np.abs(x_r - x_c)
                                          <= sig * np.pi / 4 + 1e-12)
    # the equatorial band is bounded at |x| = 180 deg too (beyond is
    # off-map, not a periodic copy — the polar facets already enforce
    # their own bounds)
    ok_eq = eq & (np.abs(x_r) <= np.pi + 1e-9)
    phi = np.where(ok_eq, x_r, np.where(ok_pol & ~eq, phi_pol, np.nan))
    st = np.where(ok_eq, y_r * 8.0 / (3.0 * np.pi),
                  np.where(ok_pol & ~eq, st_pol, np.nan))
    return phi, _arcsin_or_nan(st)


# tpu_sgp/image/wcs.py:599
def _hpx_inv(phi, theta, lam):
    st = np.sin(theta)
    eq = np.abs(st) <= 2.0 / 3.0
    y_eq = 3.0 * np.pi / 8.0 * st
    sig = np.sqrt(np.maximum(3.0 * (1.0 - np.abs(st)), 0.0))
    y_pol = np.sign(st) * (np.pi / 2 - sig * np.pi / 4)
    k = np.floor((phi + np.pi) * 2.0 / np.pi)
    k = np.clip(k, 0.0, 3.0)
    x_c = -np.pi + (2.0 * k + 1.0) * np.pi / 4
    x_pol = x_c + (phi - x_c) * sig
    xi = np.where(eq, phi, x_pol) * _R2D
    eta = np.where(eq, y_eq, y_pol) * _R2D
    return xi, eta


# TSC (tangential spherical cube, CG02 section 5.6.1): gnomonic
# projection onto the six cube faces, laid out as the sideways cross of
# CG02 fig. 10 — equatorial faces centered at x = 0/90/180/270 (y = 0),
# the north face above face 1 at (0, +90), south below at (0, -90), each
# face spanning +-45 deg of plane. Per-face direction-cosine frames
# (zeta the face normal, xi_f rightward, eta_f upward) chosen so
# adjacent faces are continuous across shared edges (pinned by tests).
#   l = cos(theta) cos(phi), m = cos(theta) sin(phi), n = sin(theta)
_TSC_FACES = (
    # (x_c deg, y_c deg, zeta, xi_f, eta_f) as index/sign into (l, m, n)
    (0.0, 90.0, (2, +1), (1, +1), (0, -1)),    # face 0: north polar cap
    (0.0, 0.0, (0, +1), (1, +1), (2, +1)),     # face 1: phi = 0
    (90.0, 0.0, (1, +1), (0, -1), (2, +1)),    # face 2: phi = 90
    (180.0, 0.0, (0, -1), (1, -1), (2, +1)),   # face 3: phi = 180
    (270.0, 0.0, (1, -1), (0, +1), (2, +1)),   # face 4: phi = 270
    (0.0, -90.0, (2, -1), (1, +1), (0, +1)),   # face 5: south polar cap
)


# tpu_sgp/image/wcs.py:633
def _tsc_inv(phi, theta, lam):
    """(phi, theta) -> plane: gnomonic onto the cube face whose normal
    has the largest direction cosine; offsets are 45 deg * (xi_f / zeta,
    eta_f / zeta) from the face center."""
    lmn = (np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
           np.sin(theta))
    shape = np.broadcast(*lmn).shape
    xi = np.zeros(shape, np.float64)
    eta = np.zeros(shape, np.float64)
    best = np.full(shape, -np.inf)
    for x_c, y_c, (zi, zs), (ai, asn), (bi, bs) in _TSC_FACES:
        zeta = zs * lmn[zi]
        pick = zeta > best
        with np.errstate(divide='ignore', invalid='ignore'):
            fx = x_c + 45.0 * asn * lmn[ai] / zeta
            fy = y_c + 45.0 * bs * lmn[bi] / zeta
        xi = np.where(pick, fx, xi)
        eta = np.where(pick, fy, eta)
        best = np.maximum(best, zeta)
    # face 4 spans x in (225, 315]; wrap phi-near-(-pi) points positive
    return xi, eta


# tpu_sgp/image/wcs.py:656
def _tsc(xi, eta, lam):
    """Plane -> (phi, theta): locate the face from the 45-deg cross
    layout, invert the per-face gnomonic. Pixels outside the cross
    (incl. x outside [-45, 315], which _tsc_inv never emits) are
    off-projection NaN, matching wcslib's tscx2s."""
    x = np.asarray(xi, np.float64)
    y = np.asarray(eta, np.float64)
    polar = np.abs(y) > 45.0
    north = y > 45.0
    face = np.where(polar, np.where(north, 0, 5),
                    np.clip(np.floor((x + 45.0) / 90.0), 0, 3) + 1)
    shape = np.broadcast(x, y).shape
    phi = np.full(shape, np.nan)
    theta = np.full(shape, np.nan)
    for f, (x_c, y_c, (zi, zs), (ai, asn), (bi, bs)) in enumerate(
            _TSC_FACES):
        sel = face == f
        if not np.any(sel):
            continue
        a = (x - x_c) / 45.0
        b = (y - y_c) / 45.0
        ok = sel & (np.abs(a) <= 1.0 + 1e-12) & (np.abs(b) <= 1.0 + 1e-12)
        zeta = 1.0 / np.sqrt(1.0 + a * a + b * b)
        lmn = [None, None, None]
        lmn[zi] = zs * zeta
        lmn[ai] = asn * a * zeta
        lmn[bi] = bs * b * zeta
        phi = np.where(ok, np.arctan2(lmn[1], lmn[0]), phi)
        theta = np.where(ok, np.arcsin(np.clip(lmn[2], -1.0, 1.0)), theta)
    return phi, theta


# Equatorial-fiducial projections (phi0 = theta0 = 0): the cylindrical /
# pseudo-cylindrical families plus the all-sky grids (HEALPix HPX,
# quad-cube TSC) that share the same fiducial convention.
_CYLINDRICAL = {
    'CAR': (_car, _car_inv),
    'CEA': (_cea, _cea_inv),
    'MER': (_mer, _mer_inv),
    'SFL': (_sfl, _sfl_inv),
    'GLS': (_sfl, _sfl_inv),   # historical alias of SFL
    'AIT': (_ait, _ait_inv),
    'MOL': (_mol, _mol_inv),
    'HPX': (_hpx, _hpx_inv),
    'TSC': (_tsc, _tsc_inv),
    'CYP': (_cyp, _cyp_inv),
    'PAR': (_par, _par_inv),
    'BON': (_bon, _bon_inv),
    'PCO': (_pco, _pco_inv),
}


# tpu_sgp/image/wcs.py:708
def _conic_pair(code, theta_a, eta):
    """Conic projections (CG02 section 5.3): COP (perspective), COE
    (equal area), COD (equidistant), COO (orthomorphic/conformal).
    theta_a = PV2_1 (midpoint latitude, != 0), eta = PV2_2 >= 0
    (half-separation of the standard parallels theta_a -+ eta). All four
    share the plane geometry x = R sin(C phi), y = -R cos(C phi) + Y0
    with Y0 = R(theta_a) and differ in (C, R(theta)); each is true-scale
    along BOTH standard parallels: C * R(theta_1,2) = cos(theta_1,2) —
    the law the unit tests pin per type. Returns
    (r_of(theta) -> R [radians], theta_of(R), C). Southern cones
    (theta_a < 0) carry C < 0 and R < 0 through the same formulas."""
    t1, t2 = theta_a - eta, theta_a + eta
    s1, s2 = np.sin(t1), np.sin(t2)
    if code == 'COP':
        c = np.sin(theta_a)
        cos_eta = np.cos(eta)

        def r_of(th):
            return cos_eta * (1.0 / np.tan(theta_a) - np.tan(th - theta_a))

        def theta_of(r):
            return theta_a + np.arctan(1.0 / np.tan(theta_a) - r / cos_eta)
    elif code == 'COD':
        if eta == 0.0:
            c, w = np.sin(theta_a), 1.0
        else:
            c = np.sin(theta_a) * np.sin(eta) / eta
            w = eta / np.tan(eta)
        y0 = w / np.tan(theta_a)

        def r_of(th):
            return theta_a - th + y0

        def theta_of(r):
            return theta_a + y0 - r
    elif code == 'COE':
        gam = s1 + s2
        c = gam / 2.0

        def r_of(th):
            return (2.0 / gam) * np.sqrt(
                np.maximum(1.0 + s1 * s2 - gam * np.sin(th), 0.0))

        def theta_of(r):
            return _arcsin_or_nan((1.0 + s1 * s2 - (gam * r / 2.0) ** 2)
                                  / gam)
    elif code == 'COO':
        psi1 = np.tan((np.pi / 2 - t1) / 2.0)
        psi2 = np.tan((np.pi / 2 - t2) / 2.0)
        if eta == 0.0:
            c = np.sin(theta_a)
        else:
            c = np.log(np.cos(t2) / np.cos(t1)) / np.log(psi2 / psi1)
        psi = np.cos(t1) / (c * psi1 ** c)

        def r_of(th):
            return psi * np.tan((np.pi / 2 - th) / 2.0) ** c

        def theta_of(r):
            with np.errstate(invalid='ignore'):
                tau = (np.asarray(r, np.float64) / psi) ** (1.0 / c)
            return np.pi / 2 - 2.0 * np.arctan(tau)
    else:  # pragma: no cover - guarded by the caller
        raise KeyError(code)
    return r_of, theta_of, c


_CONIC = ('COP', 'COE', 'COD', 'COO')


# tpu_sgp/image/wcs.py:778
def _fiducial_pole(ra0, dec0, phi_p, latpole, theta0=0.0):
    """Celestial pole (alpha_p, delta_p) for a projection whose fiducial
    sits at native (phi0, theta0) = (0, theta0): CG02 eq. 8-10. theta0 is
    0 for the (pseudo-)cylindrical family, theta_a for conics. All
    arguments/returns in RADIANS. Raises on headers with no solution."""
    st0, ct0 = np.sin(theta0), np.cos(theta0)
    cosp, sinp = np.cos(phi_p), np.sin(phi_p)
    a = np.arctan2(st0, ct0 * cosp)
    denom = np.sqrt(max(1.0 - ct0 * ct0 * sinp * sinp, 0.0))
    if abs(np.sin(dec0)) > denom + 1e-12:
        raise ValueError(
            f'WCS: no celestial pole solution for CRVAL2={dec0 / _D2R:.3f} '
            f'deg with LONPOLE={phi_p / _D2R:.1f} deg — invalid header')
    b = np.arccos(np.clip(np.sin(dec0) / max(denom, 1e-300), -1.0, 1.0))
    # two solutions, folded into [-pi/2, pi/2]; each must still satisfy
    # the eq.-8 constraint sin(dec0) = sin(dec_p) sin(theta0) +
    # cos(dec_p) cos(theta0) cos(phi_p) — the fold flips the sign of cos
    # for candidates outside the range, so e.g. theta0 = 0, sin(dec0) < 0
    # with cos(phi_p) > 0 leaves NO valid pole (wcslib rejects such
    # headers too)
    cands = [np.arcsin(np.clip(np.sin(c), -1.0, 1.0)) for c in (a + b,
                                                                a - b)]
    cands = [c for c in cands
             if abs(np.sin(c) * st0 + np.cos(c) * ct0 * cosp
                    - np.sin(dec0)) < 1e-9]
    if not cands:
        raise ValueError(
            f'WCS: no celestial pole satisfies CRVAL2='
            f'{dec0 / _D2R:.3f} deg with LONPOLE={phi_p / _D2R:.1f} deg '
            f'— invalid header')
    # take the one nearer LATPOLE (default +90 deg)
    dec_p = min(cands, key=lambda c: abs(c - latpole))
    if abs(np.cos(dec0)) < 1e-12:       # fiducial at a celestial pole
        ra_p = ra0
    elif abs(np.cos(dec_p)) < 1e-12:    # celestial pole solution at +-90
        if dec_p > 0:
            ra_p = ra0 + phi_p - np.pi
        else:
            ra_p = ra0 - phi_p
    else:
        # CG02 eq. 9-10 (both atan2 arguments scaled by cos(dec0) > 0)
        ra_p = ra0 - np.arctan2(
            sinp * ct0,
            (st0 - np.sin(dec_p) * np.sin(dec0)) / np.cos(dec_p))
    return ra_p, dec_p


# tpu_sgp/image/wcs.py:825
def _native_to_celestial(phi, theta, pole):
    """CG02 eq. 2: native spherical (phi, theta) -> (ra, dec), radians."""
    ra_p, dec_p, phi_p = pole
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_dp, cos_dp = np.sin(dec_p), np.cos(dec_p)
    dphi = phi - phi_p
    dec = np.arcsin(np.clip(sin_t * sin_dp + cos_t * cos_dp * np.cos(dphi),
                            -1.0, 1.0))
    ra = ra_p + np.arctan2(-cos_t * np.sin(dphi),
                           sin_t * cos_dp - cos_t * sin_dp * np.cos(dphi))
    return ra, dec


# tpu_sgp/image/wcs.py:838
def _celestial_to_native(ra, dec, pole):
    """CG02 eq. 5 inverse: (ra, dec) -> native (phi, theta), radians.
    theta comes from atan2(sin theta, |cos theta|) — arcsin would lose
    half the f64 digits near theta = 90 deg (every small separation from
    a zenithal fiducial)."""
    ra_p, dec_p, phi_p = pole
    sin_d, cos_d = np.sin(dec), np.cos(dec)
    sin_dp, cos_dp = np.sin(dec_p), np.cos(dec_p)
    dra = ra - ra_p
    sin_t = sin_d * sin_dp + cos_d * cos_dp * np.cos(dra)
    y_ = -cos_d * np.sin(dra)
    x_ = sin_d * cos_dp - cos_d * sin_dp * np.cos(dra)
    h = np.hypot(y_, x_)
    theta = np.arctan2(sin_t, h)
    phi = phi_p + np.arctan2(y_, x_)
    return phi, theta, h


# tpu_sgp/image/wcs.py:856
def _read_sip_block(h, prefix: str):
    """Read one SIP polynomial block ('A', 'B', 'AP', 'BP') from a header:
    returns {(p, q): coeff} or None when <prefix>_ORDER is absent."""
    key = f'{prefix}_ORDER'
    if key not in h:
        return None
    order = int(h[key])
    coeffs = {}
    for p in range(order + 1):
        for q in range(order + 1 - p):
            k = f'{prefix}_{p}_{q}'
            if k in h:
                coeffs[(p, q)] = float(h[k])
    return coeffs


# tpu_sgp/image/wcs.py:872
def _sip_eval(coeffs, u, v):
    """Evaluate sum_pq c_pq u^p v^q (small orders: term loop fuses fine)."""
    out = np.zeros(np.broadcast(u, v).shape, np.float64)
    for (p, q), cpq in coeffs.items():
        out += cpq * (u ** p) * (v ** q)
    return out


# tpu_sgp/image/wcs.py:880
class WCS:
    # tpu_sgp/image/wcs.py:881
    def __init__(self, header=None):
        h = header or {}
        self.crpix = np.array([float(h.get('CRPIX1', 1.0)),
                               float(h.get('CRPIX2', 1.0))])
        self.crval = np.array([float(h.get('CRVAL1', 0.0)),
                               float(h.get('CRVAL2', 0.0))])
        self.ctype = (str(h.get('CTYPE1', 'RA---TAN')),
                      str(h.get('CTYPE2', 'DEC--TAN')))
        if any(f'CD{i}_{j}' in h for i in (1, 2) for j in (1, 2)):
            # FITS: once ANY CDj_i is present, absent elements default
            # to 0 (a sparse rotated header may legitimately omit the
            # diagonal) — defaulting them to 1 would corrupt the scale,
            # and keying on CD1_1 alone would silently build identity
            self.cd = np.array([[float(h.get('CD1_1', 0.0)),
                                 float(h.get('CD1_2', 0.0))],
                                [float(h.get('CD2_1', 0.0)),
                                 float(h.get('CD2_2', 0.0))]])
            if np.linalg.det(self.cd) == 0.0:
                raise ValueError(
                    'WCS: singular CD matrix (absent CDj_i elements '
                    'default to 0 per the FITS standard) — invalid '
                    'header')
        else:
            cdelt = np.array([float(h.get('CDELT1', 1.0)),
                              float(h.get('CDELT2', 1.0))])
            pc = np.array([[float(h.get('PC1_1', 1.0)),
                            float(h.get('PC1_2', 0.0))],
                           [float(h.get('PC2_1', 0.0)),
                            float(h.get('PC2_2', 1.0))]])
            self.cd = pc * cdelt[:, None]
        # latitude-first axis order (CTYPE1='DEC--xxx' — valid FITS some
        # radio/cube pipelines write): axis 1 carries the latitude
        # intermediate coordinate and the projection parameters (PV1_m)
        ct1 = self.ctype[0]
        self._latfirst = (ct1.startswith('DEC-')
                          or (len(ct1) >= 4 and ct1[1:4] == 'LAT'))
        self._pv_axis = 1 if self._latfirst else 2
        code = self.ctype[0][5:8] if len(self.ctype[0]) >= 8 else ''
        if not code and 'TAN' in self.ctype[0]:
            code = 'TAN'  # tolerate short/nonstandard TAN ctypes
        self._zen = code if code in _ZENITHAL else None
        self._cyl = code if code in _CYLINDRICAL else None
        self._con = code if code in _CONIC else None
        pva = self._pv_axis
        self._lam = float(h.get(f'PV{pva}_1', 1.0))  # CEA scale param
        if self._cyl == 'CEA' and not 0.0 < self._lam <= 1.0:
            raise ValueError(f'WCS: CEA PV2_1={self._lam} outside (0, 1] '
                             '— invalid header (lambda scales sin(theta))')
        if self._cyl == 'HPX':
            hk = (float(h.get(f'PV{pva}_1', 4.0)),
                  float(h.get(f'PV{pva}_2', 3.0)))
            if hk != (4.0, 3.0):
                raise ValueError(
                    f'WCS: HPX grid parameters (H, K)={hk} — only the '
                    'standard H=4, K=3 HEALPix grid is implemented; a '
                    'silent H=4 read would misplace every pixel')
        # parameterized projections: per-instance PVi_m read from the
        # LATITUDE axis (axis 2 normally, axis 1 for lat-first headers)
        self._pv2 = {m: float(h[f'PV{pva}_{m}']) for m in range(21)
                     if f'PV{pva}_{m}' in h}
        if self._cyl == 'CYP':
            # PV2_1 = mu, PV2_2 = lambda; both default 1 (the wcslib
            # cypset defaults); mu = 1, lambda = sqrt(2)/2 is Gall's
            # stereographic
            mu = self._pv2.get(1, 1.0)
            lm = self._pv2.get(2, 1.0)
            if lm <= 0.0 or mu + lm == 0.0:
                raise ValueError(f'WCS: CYP PV2_1={mu}, PV2_2={lm} '
                                 'degenerate (need lambda > 0, '
                                 'mu + lambda != 0) — invalid header')
            self._lam = (mu, lm)
        elif self._cyl == 'BON':
            # theta_1 = +-90 is Werner's projection (y0 = pi/2, cot = 0)
            th1 = self._pv2.get(1, 0.0)
            if th1 == 0.0 or not -90.0 <= th1 <= 90.0:
                raise ValueError(f'WCS: BON PV2_1={th1} invalid (need '
                                 'a standard parallel in [-90, 90] deg, '
                                 'non-zero; theta_1 = 0 is SFL)')
            self._lam = th1 * _D2R
        self._slant = None          # set by the SZP / slant-SIN arms
        if code in _ZENITHAL:
            self._zen_fwd, self._zen_inv = _ZENITHAL[code]
        elif code == 'ZPN':
            order = max(self._pv2, default=-1)
            pv = [self._pv2.get(m, 0.0) for m in range(order + 1)]
            if len(pv) < 2 or pv[1] <= 0.0:
                raise ValueError('WCS: ZPN requires PV2_1 > 0 '
                                 f'(got PV2_m={pv}) — invalid header')
            self._zen = 'ZPN'
            self._zen_fwd, self._zen_inv = _zpn_pair(pv)
        elif code == 'AZP':
            mu = self._pv2.get(1, 0.0)
            if self._pv2.get(2, 0.0) != 0.0:
                raise ValueError('WCS: tilted AZP (PV2_2 != 0) is not '
                                 'implemented — use astropy for tilted '
                                 'perspective headers')
            if mu == -1.0:
                raise ValueError('WCS: AZP PV2_1 = -1 is degenerate '
                                 '(projection point on the sphere surface)')
            self._zen = 'AZP'
            self._zen_fwd, self._zen_inv = _azp_pair(mu)
        elif code == 'TPV':
            self._zen = 'TPV'       # distorted gnomonic: TAN deprojection
            self._zen_fwd, self._zen_inv = _ZENITHAL['TAN']
        elif code == 'SZP':
            mu = self._pv2.get(1, 0.0)
            phi_c = self._pv2.get(2, 0.0) * _D2R
            theta_c = self._pv2.get(3, 90.0) * _D2R
            if abs(1.0 + mu * np.sin(theta_c)) < 1e-12:
                raise ValueError('WCS: SZP projection point lies in the '
                                 f'image plane (PV2_1={mu}, PV2_3='
                                 f'{theta_c / _D2R} deg) — degenerate')
            self._zen = 'SZP'
            self._zen_fwd = self._zen_inv = None
            self._slant = _szp_pair(mu, phi_c, theta_c)
        else:
            self._zen_fwd = self._zen_inv = None
        # slant orthographic: SIN carrying PV2_1/PV2_2 (AIPS/CASA radio
        # convention; NCP headers arrive this way)
        if code == 'SIN' and (self._pv2.get(1, 0.0) != 0.0
                              or self._pv2.get(2, 0.0) != 0.0):
            self._slant = _slant_sin_pair(self._pv2.get(1, 0.0),
                                          self._pv2.get(2, 0.0))
        # TPV plane distortion — also honored on legacy SCAMP headers
        # that keep CTYPE 'TAN' while carrying PVi_m distortion keys
        # (the pre-registration convention). For legacy TAN the keys must
        # describe an actual invertible TPV polynomial: a zero linear
        # term (PVi_1 = 0) or all-default coefficients mean the keys
        # follow some other convention (writers dumping defaults, old
        # ESO radial-distortion headers) — then they are IGNORED like
        # wcslib's tanset does, instead of collapsing the transform.
        self._tpv = None
        if self._latfirst and (code == 'TPV' or (code == 'TAN' and any(
                f'PV{i}_{m}' in h for i in (1, 2) for m in range(40)))):
            raise ValueError('WCS: TPV distortion with latitude-first '
                             'axes is not supported (the PV1/PV2 axis '
                             'roles would swap) — use astropy')
        if code == 'TPV' or (code == 'TAN' and any(
                f'PV{i}_{m}' in h for i in (1, 2) for m in range(40))):
            pv1 = np.zeros(40)
            pv2 = np.zeros(40)
            pv1[1] = pv2[1] = 1.0
            for m in range(40):
                if f'PV1_{m}' in h:
                    pv1[m] = float(h[f'PV1_{m}'])
                if f'PV2_{m}' in h:
                    pv2[m] = float(h[f'PV2_{m}'])
            identity = (pv1[1] == 1.0 and pv2[1] == 1.0
                        and not np.any(np.delete(pv1, 1))
                        and not np.any(np.delete(pv2, 1)))
            if code == 'TAN' and (pv1[1] == 0.0 or pv2[1] == 0.0
                                  or identity):
                if not identity and 'TAN+PV' not in _WARNED_CTYPES:
                    _WARNED_CTYPES.add('TAN+PV')
                    warnings.warn(
                        'WCS: TAN header carries PVi_m keys with a zero '
                        'linear term — not a TPV distortion; ignoring '
                        'the PV keys (plain TAN)', stacklevel=2)
            elif not identity or code == 'TPV':
                self._tpv = (pv1, pv2)
        self._con_fns = None
        if self._con is not None:
            theta_a = self._pv2.get(1, 0.0) * _D2R
            eta = abs(self._pv2.get(2, 0.0)) * _D2R
            if theta_a == 0.0:
                raise ValueError(f'WCS: {code} requires PV2_1 != 0 (the '
                                 'cone degenerates to a cylinder) — '
                                 'invalid header')
            if not (-np.pi / 2 < theta_a - eta
                    and theta_a + eta < np.pi / 2):
                raise ValueError(f'WCS: {code} standard parallels '
                                 'PV2_1 -+ PV2_2 outside (-90, 90) deg — '
                                 'invalid header')
            r_of, th_of, c_fac = _conic_pair(code, theta_a, eta)
            self._con_fns = (r_of, th_of, c_fac, float(r_of(theta_a)),
                             theta_a)
        # Loud (once per projection code) instead of silently-linear:
        # the native WCS implements the zenithal (incl. slant),
        # (pseudo-)cylindrical, conic/pseudo-conic and all-sky-grid
        # families and linear only; a header can still carry the few
        # remaining codes (quad-cube CSC/QSC, AIR, XPH) where astropy
        # (the reference path, sgp.py:957) would be correct and a
        # silent linear fallback subtly wrong.
        if (code and code not in ('LIN',) and self._zen is None
                and self._cyl is None and self._con is None):
            if code not in _WARNED_CTYPES:
                _WARNED_CTYPES.add(code)
                warnings.warn(
                    f'WCS: unsupported projection CTYPE {self.ctype[0]!r} '
                    f'— falling back to LINEAR world coordinates; use '
                    f'astropy for exact {code} transforms', stacklevel=2)
        # Native<->celestial rotation pole (CG02 sec. 2.4). Zenithal: the
        # fiducial IS the native pole, so (ra_p, dec_p) = CRVAL for any
        # LONPOLE (default 180). Cylindrical (theta0 = 0): solve eq. 8-10,
        # LONPOLE defaulting to 0 (CRVAL2 >= 0) / 180 (CRVAL2 < 0),
        # LATPOLE picking between the two pole solutions (default +90).
        if self._latfirst:
            dec0, ra0 = self.crval * _D2R
        else:
            ra0, dec0 = self.crval * _D2R
        self._lonlat0 = (ra0 / _D2R, dec0 / _D2R)
        self._latpole_deg = float(h.get('LATPOLE', 90.0))
        latpole = self._latpole_deg * _D2R
        if self._zen is not None:
            phi_p = float(h.get('LONPOLE', 180.0)) * _D2R
            self._pole = (ra0, dec0, phi_p)
        elif self._cyl is not None:
            phi_p = float(h.get('LONPOLE',
                                0.0 if dec0 >= 0.0 else 180.0)) * _D2R
            self._pole = (_fiducial_pole(ra0, dec0, phi_p, latpole)
                          + (phi_p,))
        elif self._con is not None:
            theta_a = self._con_fns[4]
            phi_p = float(h.get('LONPOLE',
                                0.0 if dec0 >= theta_a else 180.0)) * _D2R
            self._pole = (_fiducial_pole(ra0, dec0, phi_p, latpole,
                                         theta0=theta_a) + (phi_p,))
        else:
            self._pole = None
        # SIP distortion (Shupe et al. 2005; astropy reads the same keys).
        # Forward: A_p_q/B_p_q corrections on intermediate pixel offsets
        # (u, v) = (x, y) - (CRPIX - 1). Inverse: AP/BP when the header
        # carries them, Newton fixed-point otherwise (world_to_pixel).
        self.sip_a = _read_sip_block(h, 'A')
        self.sip_b = _read_sip_block(h, 'B')
        self.sip_ap = _read_sip_block(h, 'AP')
        self.sip_bp = _read_sip_block(h, 'BP')
        if (self.sip_a is None) != (self.sip_b is None):
            # tolerate one-sided headers: missing block = zero polynomial
            zero = {}
            self.sip_a = self.sip_a if self.sip_a is not None else zero
            self.sip_b = self.sip_b if self.sip_b is not None else zero
        self._sip = self.sip_a is not None

    # -- core transforms (0-based pixel convention, like astropy origin=0) --
    # tpu_sgp/image/wcs.py:1116
    def pixel_to_world(self, x, y):
        """(x, y) 0-based pixels -> (ra, dec) or linear world, degrees."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        dx = x - (self.crpix[0] - 1.0)
        dy = y - (self.crpix[1] - 1.0)
        if self._sip:
            dx, dy = (dx + _sip_eval(self.sip_a, dx, dy),
                      dy + _sip_eval(self.sip_b, dx, dy))
        xi = self.cd[0, 0] * dx + self.cd[0, 1] * dy   # deg
        eta = self.cd[1, 0] * dx + self.cd[1, 1] * dy
        if self._latfirst:                 # axis 1 carries the latitude
            xi, eta = eta, xi
        if self._pole is None:
            return self._lonlat0[0] + xi, self._lonlat0[1] + eta
        if self._tpv is not None:
            pv1, pv2 = self._tpv
            xi, eta = (_tpv_eval(pv1, xi, eta), _tpv_eval(pv2, eta, xi))
        if self._zen is not None:
            # zenithal deprojection: native polar (phi, R) -> native
            # latitude theta (CG02 eq. 14/15: x = R sin phi, y = -R cos phi)
            xi_r, eta_r = xi * _D2R, eta * _D2R
            if self._slant is not None:
                phi, theta = self._slant[1](xi_r, eta_r)
            else:
                rr = np.hypot(xi_r, eta_r)
                phi = np.arctan2(xi_r, -eta_r)
                theta = self._zen_inv(rr)
        elif self._con is not None:
            # conic deprojection (CG02 eq. 119-121): R is measured from
            # the cone point at (0, Y0); native azimuth is phi = arg / C
            _, th_of, c_fac, y0, theta_a = self._con_fns
            xi_r, eta_r = xi * _D2R, eta * _D2R
            rr = np.sign(theta_a) * np.hypot(xi_r, y0 - eta_r)
            with np.errstate(divide='ignore', invalid='ignore'):
                phi = np.arctan2(xi_r / rr, (y0 - eta_r) / rr) / c_fac
            phi = np.where(rr == 0.0, 0.0, phi)
            theta = th_of(rr)
        else:
            # cylindrical / pseudo-cylindrical plane -> native sphere
            native_of, _ = _CYLINDRICAL[self._cyl]
            phi, theta = native_of(xi, eta, self._lam)
        ra, dec = _native_to_celestial(phi, theta, self._pole)
        return (np.mod(ra / _D2R, 360.0), dec / _D2R)

    # tpu_sgp/image/wcs.py:1161
    def world_to_pixel(self, ra, dec):
        ra = np.asarray(ra, np.float64)
        dec = np.asarray(dec, np.float64)
        # NaN world input (e.g. off-projection output pixels fed back by
        # the reprojection machinery) must yield NaN pixels — the
        # zenithal branch's reference-point guard would otherwise
        # silently collapse NaN onto CRPIX-1 (phantom data)
        bad = ~(np.isfinite(ra) & np.isfinite(dec))
        if self._pole is not None:
            phi, theta, h = _celestial_to_native(ra * _D2R, dec * _D2R,
                                                 self._pole)
            if self._slant is not None:
                x_r, y_r = self._slant[0](phi, theta)
                xi, eta = x_r / _D2R, y_r / _D2R
            elif self._zen is not None:
                rr = self._zen_fwd(theta)
                # |(y_, x_)| = cos(theta) is zero exactly at the reference
                # point where R = 0 too — the plane coords are (0, 0) there
                xi = np.where(h > 0, rr * np.sin(phi), 0.0) / _D2R
                eta = np.where(h > 0, -rr * np.cos(phi), 0.0) / _D2R
            elif self._con is not None:
                r_of, _, c_fac, y0, _ = self._con_fns
                phi = np.arctan2(np.sin(phi), np.cos(phi))  # (-pi, pi]
                rr = r_of(theta)
                xi = rr * np.sin(c_fac * phi) / _D2R
                eta = (y0 - rr * np.cos(c_fac * phi)) / _D2R
            else:
                _, plane_of = _CYLINDRICAL[self._cyl]
                # wrap native longitude to (-180, 180] deg
                phi = np.arctan2(np.sin(phi), np.cos(phi))
                xi, eta = plane_of(phi, theta, self._lam)
        else:
            xi = ra - self._lonlat0[0]
            eta = dec - self._lonlat0[1]
        if self._tpv is not None:
            xi, eta = self._tpv_invert(xi, eta)
        if self._latfirst:                 # back to axis order for CD
            xi, eta = eta, xi
        inv = np.linalg.inv(self.cd)
        dx = inv[0, 0] * xi + inv[0, 1] * eta
        dy = inv[1, 0] * xi + inv[1, 1] * eta
        if self._sip:
            dx, dy = self._sip_invert(dx, dy)
        dx = np.where(bad, np.nan, dx)
        dy = np.where(bad, np.nan, dy)
        return dx + self.crpix[0] - 1.0, dy + self.crpix[1] - 1.0

    # tpu_sgp/image/wcs.py:1208
    def _tpv_invert(self, xi_t, eta_t):
        """Invert the TPV plane distortion: solve (P1(x, y), P2(y, x)) =
        (xi_t, eta_t) for the undistorted intermediate coordinates by a
        vectorized 2x2 Newton. Survey distortions are identity-dominated
        (PVi_1 ~ 1, corrections <<1 across a frame in degrees), so the
        target itself is the natural start and convergence is quadratic;
        the iteration cap only bounds pathological headers."""
        pv1, pv2 = self._tpv
        x = np.array(xi_t, np.float64, copy=True)
        y = np.array(eta_t, np.float64, copy=True)
        for _ in range(25):
            f1 = _tpv_eval(pv1, x, y) - xi_t
            f2 = _tpv_eval(pv2, y, x) - eta_t
            j11, j12 = _tpv_jac(pv1, x, y)
            j22, j21 = _tpv_jac(pv2, y, x)    # P2's first argument is y
            det = j11 * j22 - j12 * j21
            with np.errstate(divide='ignore', invalid='ignore'):
                det = np.where(np.abs(det) > 1e-300, det, np.nan)
                dx = (j22 * f1 - j12 * f2) / det
                dy = (j11 * f2 - j21 * f1) / det
            x -= dx
            y -= dy
            if not np.any(np.abs(dx) + np.abs(dy) > 1e-14):
                break
        return x, y

    # tpu_sgp/image/wcs.py:1234
    def _sip_invert(self, U, V):
        """Invert (u, v) + SIP(u, v) = (U, V) for the raw offsets (u, v).

        Uses the header's AP/BP inverse polynomials as the starting guess
        when present (often accurate enough on their own), then polishes
        with fixed-point iterations u <- U - f(u, v) — SIP distortions are
        small (|df/du| << 1 across a frame), so this contracts quickly;
        astropy's all_world2pix solves the same system iteratively."""
        if self.sip_ap is not None and self.sip_bp is not None:
            u = U + _sip_eval(self.sip_ap, U, V)
            v = V + _sip_eval(self.sip_bp, U, V)
        else:
            u, v = np.array(U, np.float64), np.array(V, np.float64)
        for _ in range(6):
            u, v = (U - _sip_eval(self.sip_a, u, v),
                    V - _sip_eval(self.sip_b, u, v))
        return u, v

    # tpu_sgp/image/wcs.py:1252
    def shifted(self, x0: float, y0: float) -> 'WCS':
        """WCS of a cutout whose (0,0) pixel is at (x0, y0) in the parent."""
        w = WCS()
        w.crpix = self.crpix - np.array([x0, y0])
        w.crval = self.crval.copy()
        w.cd = self.cd.copy()
        w.ctype = self.ctype
        w._zen = self._zen
        w._cyl = self._cyl
        w._lam = self._lam
        w._pole = self._pole
        w._latpole_deg = self._latpole_deg
        w._pv2 = self._pv2
        w._zen_fwd, w._zen_inv = self._zen_fwd, self._zen_inv
        w._con, w._con_fns = self._con, self._con_fns
        w._tpv = self._tpv
        w._slant = self._slant
        w._latfirst, w._pv_axis = self._latfirst, self._pv_axis
        w._lonlat0 = self._lonlat0
        # SIP offsets are measured from CRPIX, which shifts with the
        # cutout, so the polynomials carry over unchanged
        w.sip_a, w.sip_b = self.sip_a, self.sip_b
        w.sip_ap, w.sip_bp = self.sip_ap, self.sip_bp
        w._sip = self._sip
        return w

    # tpu_sgp/image/wcs.py:1278
    def to_header(self):
        from .fitsio import Header
        h = Header()
        h['CTYPE1'], h['CTYPE2'] = self.ctype
        h['CRPIX1'], h['CRPIX2'] = float(self.crpix[0]), float(self.crpix[1])
        h['CRVAL1'], h['CRVAL2'] = float(self.crval[0]), float(self.crval[1])
        h['CD1_1'], h['CD1_2'] = float(self.cd[0, 0]), float(self.cd[0, 1])
        h['CD2_1'], h['CD2_2'] = float(self.cd[1, 0]), float(self.cd[1, 1])
        if self._pole is not None:
            h['LONPOLE'] = float(self._pole[2] / _D2R)
            h['LATPOLE'] = float(self._latpole_deg)
        pva = self._pv_axis
        if self._cyl == 'CEA':
            h[f'PV{pva}_1'] = float(self._lam)
        elif self._cyl == 'CYP':
            h[f'PV{pva}_1'] = float(self._lam[0])
            h[f'PV{pva}_2'] = float(self._lam[1])
        elif self._cyl == 'BON':
            h[f'PV{pva}_1'] = float(self._lam / _D2R)
        if (self._zen in ('ZPN', 'AZP', 'SZP') or self._con is not None
                or (self._zen == 'SIN' and self._slant is not None)):
            for m, v in sorted(self._pv2.items()):
                h[f'PV{pva}_{m}'] = float(v)
        if self._tpv is not None:
            for i, pv in ((1, self._tpv[0]), (2, self._tpv[1])):
                for m, v in enumerate(pv):
                    if v != (1.0 if m == 1 else 0.0):   # skip defaults
                        h[f'PV{i}_{m}'] = float(v)
        if self._sip:
            for prefix, block in (('A', self.sip_a), ('B', self.sip_b),
                                  ('AP', self.sip_ap), ('BP', self.sip_bp)):
                if block is None:
                    continue
                h[f'{prefix}_ORDER'] = max((p + q for p, q in block), default=0)
                for (p, q), cpq in sorted(block.items()):
                    h[f'{prefix}_{p}_{q}'] = float(cpq)
        return h


# tpu_sgp/image/wcs.py:1317
def pixel_to_skycoord(x, y, wcs: WCS):
    """Reference-API analog (astropy.wcs.utils.pixel_to_skycoord):
    returns (ra_deg, dec_deg)."""
    return wcs.pixel_to_world(x, y)
