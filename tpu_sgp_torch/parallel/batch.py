"""Batched stamp restoration on one device.

Port of ``restore_stamps``, its helpers and the beta-init search
(``tpu_sgp/parallel/batch.py``).
The JAX package vmaps the single-image solver; the port's solver is
batch-first already, so the batch is one call. Torch tensors compute where
they lie; numpy inputs are placed on ``device`` (the card unless the caller
passes ``'cpu'``). A ``mesh`` waits for multi-device support (ROADMAP A13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SGPConfig
from ..device import resolve_device
from ..solvers.sgp import (SGPResult, SGPState, resume_from_state, solve,
                           solve_with_state)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a.index_select(0, idx)


def _batched_solve_two_phase(stamps, psf, bkgs, x0, fluxes, obj, beta0, lr0,
                             sat, cfg: SGPConfig, phase1_iters: int,
                             tail_bucket: int) -> SGPResult:
    """Convergence-compacted batched solve (``batch.py:47-135``).

    1. the full batch runs capped at ``phase1_iters``;
    2. twice, the ``tail_bucket`` lanes that can still work (a stable sort
       of ``converged | it > max_iter`` puts them first) are gathered,
       resumed to ``cfg.max_iter`` and scattered back;
    3. the full batch is resumed once more, which finishes any lanes the
       two tail rounds could not hold.

    Each lane follows the schedule of the single-phase solve."""
    cfg1 = cfg.replace(max_iter=phase1_iters)
    _, st = solve_with_state(stamps, psf, bkgs, x0, fluxes, obj, beta0, lr0,
                             sat, cfg1)

    # grow the phase-1 series buffers to the full budget so the resumed
    # tail state scatters back elementwise; disabled (B, 1) buffers stay
    pad = cfg.max_iter - phase1_iters
    if cfg.track_discr:
        st = st._replace(discr=torch.nn.functional.pad(st.discr, (0, pad)))
    if cfg.errflag:
        st = st._replace(err=torch.nn.functional.pad(st.err, (0, pad)))

    for _ in range(2):
        # workable lanes first (False sorts before True; stable ties). Not
        # just ~converged: a lane that ran to cfg.max_iter keeps
        # converged=False and would crowd out workable lanes.
        done = st.converged | (st.it > cfg.max_iter)
        idx = torch.argsort(done.to(torch.uint8), stable=True)[:tail_bucket]
        st_tail = SGPState(*(_take(a, idx) for a in st))
        args_tail = [_take(a, idx) for a in (stamps, bkgs, x0, fluxes, obj,
                                             beta0, lr0, sat)]
        # per-stamp PSFs follow their lanes: the tail builds its operators
        # from its own PSFs (batch.py:119)
        psf_tail = _take(psf, idx) if psf.dim() == 3 else psf
        _, st_tail = resume_from_state(args_tail[0], psf_tail,
                                       *args_tail[1:], st_tail, cfg)
        st = SGPState(*(full.index_copy(0, idx, part)
                        for full, part in zip(st, st_tail)))

    res, _ = resume_from_state(stamps, psf, bkgs, x0, fluxes, obj, beta0,
                               lr0, sat, st, cfg)
    return res


def _as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        # torch.as_tensor refuses negative strides (np.fliplr views)
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _prep(stamps, psf, bkgs, fluxes, x0, obj, beta0, lr0, sat_level, dtype,
          device):
    """Inputs as tensors on ``device`` (``batch.py:138-161``): per-lane
    scalars broadcast to (B,), absent images as zeros."""
    stamps = _as_tensor(stamps, dtype, device)
    b, h, w = stamps.shape
    psf = _as_tensor(psf, dtype, device)
    bkgs = _as_tensor(bkgs, dtype, device)
    if bkgs.dim() == 0:
        bkgs = bkgs.expand(b)
    lanes = lambda v: _as_tensor(v, dtype, device).expand(b).contiguous()
    fluxes = (torch.zeros(b, dtype=dtype, device=device) if fluxes is None
              else lanes(fluxes))
    x0 = (torch.zeros_like(stamps) if x0 is None
          else _as_tensor(x0, dtype, device))
    obj = (torch.zeros_like(stamps) if obj is None
           else _as_tensor(obj, dtype, device))
    return (stamps, psf, bkgs, fluxes, x0, obj, lanes(beta0), lanes(lr0),
            lanes(sat_level))


def suggest_compaction(iters, batch_size: Optional[int] = None,
                       margin: float = 1.25) -> dict:
    """Pick ``phase1_iters`` and ``tail_bucket`` from a pilot run's
    per-lane iteration counts (``batch.py:164-211``): minimise the modelled
    lane-iterations B*p1 + tails while the two tail rounds clear the
    unconverged-at-p1 count with ``margin`` headroom."""
    iters = np.asarray(iters)
    if iters.size == 0:
        raise ValueError('iters is empty — run a pilot solve first')
    n = iters.size
    b = n if batch_size is None else int(batch_size)
    scale = b / n
    max_it = int(iters.max())
    best = None
    for p1 in range(int(iters.min()), max_it + 1):
        u1 = int(np.ceil((iters > p1).sum() * scale * margin))
        if u1 == 0:
            break                      # p1 covers everything: no compaction
        # smallest power-of-two tail whose two rounds clear u1
        tb = 1
        while 2 * tb < u1:
            tb *= 2
        if tb >= b:
            continue                   # tail as big as the batch: pointless
        rounds = int(np.ceil(u1 / tb))
        cost = b * p1 + rounds * tb * (max_it - p1)
        if best is None or cost < best[0]:
            best = (cost, p1, tb)
    if best is None:
        return {'phase1_iters': None, 'tail_bucket': 1024}
    _, p1, tb = best
    return {'phase1_iters': p1, 'tail_bucket': tb}


def _bucket_size(b: int) -> int:
    """Powers of two up to 256, then multiples of 256
    (``batch.py:214-225``)."""
    if b <= 256:
        n = 1
        while n < b:
            n *= 2
        return n
    return -(-b // 256) * 256


def _bucket_target(b: int, mesh=None) -> int:
    """Bucket size for a batch (``batch.py:228-235``); one device, so no
    mesh rounding."""
    if mesh is not None:
        raise NotImplementedError('mesh is not ported yet (ROADMAP A13)')
    return _bucket_size(b)


def _pad_lead(a, pad: int, b_orig: int):
    """Pad a batch-leading array by repeating row 0 (``batch.py:238-246``);
    scalars, ``None`` and arrays whose leading axis is not the batch pass
    through."""
    if a is None or np.ndim(a) == 0 or np.shape(a)[0] != b_orig:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[:1], pad, axis=0)], axis=0)


def _pad_args_to_bucket(mesh, stamps, bkgs, fluxes=None, x0=None, obj=None,
                        beta0=None, lr0=None, sat_level=None, psf=None):
    """Pad every batch-leading argument up to the bucket size
    (``batch.py:249-263``); returns the padded arguments and the original
    batch size."""
    b = int(np.shape(stamps)[0])
    pad = _bucket_target(b, mesh) - b
    if pad:
        stamps, bkgs, fluxes, x0, obj, beta0, lr0, sat_level = (
            _pad_lead(a, pad, b)
            for a in (stamps, bkgs, fluxes, x0, obj, beta0, lr0, sat_level))
        if psf is not None and np.ndim(psf) == 3:
            psf = _pad_lead(psf, pad, b)
    return (stamps, bkgs, fluxes, x0, obj, beta0, lr0, sat_level, psf), b


def _unpad(res: SGPResult, n: int) -> SGPResult:
    """Slice bucket padding off every result field (``batch.py:397-402``)."""
    return SGPResult(*(a[:n] for a in res))


def restore_stamps(stamps, psf, bkgs, cfg: SGPConfig, *, fluxes=None,
                   x0=None, obj=None, beta0=1.0, lr0=1e-3, sat_level=0.0,
                   mesh=None, batch_axis: str = 'batch',
                   bucket: bool = False,
                   phase1_iters: Optional[int] = None,
                   tail_bucket: int = 1024,
                   flatten: bool = False,
                   device=None) -> SGPResult:
    """Restore a batch of stamps that share one PSF
    (``batch.py:266-394``).

    Args:
      stamps: (B, H, W) observed cutouts, numpy or torch.
      psf: (H, W) shared PSF, or (B, H, W) per-stamp PSFs: each stamp
        then gets its own operator (``batch.py:38-42``). For stamps up to
        64x64 that is the dense circulant, a (B, N, N) stack applied as
        one batched product: 3.7 MB a stamp at 31x31 in float32, so an
        80 GB card holds the matrices of about 20000 stamps and nothing
        else (half that in float64); larger batches go in several calls
        or with ``cfg.operator='otf'``, which keeps one (H, W/2+1)
        spectrum a stamp. The matrices are built inside each solve from
        the PSFs of the lanes it runs, so a compaction tail builds its
        own ``tail_bucket`` of them and not the whole call's.
      bkgs: scalar, (B,) or (B, H, W) background levels.
      cfg: solver configuration.
      bucket: pad the batch to a standard bucket size (repeating the first
        stamp); the padding is sliced off the result.
      phase1_iters, tail_bucket: convergence compaction for stop rules 2-4
        (``_batched_solve_two_phase``); same per-lane schedules.
      flatten: ravel each stamp to a row of the dense operator.
      device: where numpy inputs go, the card when None; a torch
        ``stamps`` computes on its own device and the other inputs follow
        it. Without a card, a call that names no device raises.

    Returns a batched SGPResult (leading axis B on every field).
    """
    if cfg.has_flux and fluxes is None:
        raise ValueError(
            'cfg.has_flux=True but fluxes=None: the flux-conserving '
            'projection would target sum(x)=0 and every reconstruction '
            'would be identically zero. Pass per-stamp fluxes (e.g. the '
            'background-subtracted sums) or use a config with '
            'has_flux=False.')
    if cfg.errflag and obj is None:
        raise ValueError('cfg.errflag=True but obj=None: the relative-'
                         'error series needs the ground truth. Pass obj '
                         'or use a config with errflag=False.')
    if cfg.has_sat_level and np.ndim(sat_level) == 0 \
            and float(sat_level) <= 0:
        raise ValueError(
            f'cfg.has_sat_level=True with sat_level={sat_level}: the '
            f'saturation cap would clamp every pixel to ~0. Pass the CCD '
            f'saturation level or use a config with has_sat_level=False.')
    if mesh is not None:
        raise NotImplementedError('mesh is not ported yet (ROADMAP A13)')
    if cfg.stable_sums == 'auto':
        # batches default to plain sums (batch.py:322-329)
        cfg = cfg.replace(stable_sums=False)
    device = resolve_device(device, stamps)
    b_orig = int(np.shape(stamps)[0])
    if bucket:
        ((stamps, bkgs, fluxes, x0, obj, beta0, lr0, sat_level, psf),
         b_orig) = _pad_args_to_bucket(mesh, stamps, bkgs, fluxes, x0, obj,
                                       beta0, lr0, sat_level, psf)
    pad = int(np.shape(stamps)[0]) - b_orig

    (stamps, psf, bkgs, fluxes, x0, obj, beta0, lr0, sat) = _prep(
        stamps, psf, bkgs, fluxes, x0, obj, beta0, lr0, sat_level,
        cfg.torch_dtype, device)

    img_shape = tuple(stamps.shape[1:])
    if flatten:
        # raveled (B, H*W) rows: the dense operator is one matrix product
        # over the batch (batch.py:343-360)
        if psf.dim() == 3:
            raise ValueError('flatten requires a shared PSF')
        if cfg.operator not in ('auto', 'matmul', 'matmul_flat',
                                'matmul_split'):
            raise ValueError('flatten requires the dense matmul operator')
        if cfg.operator != 'matmul_split':
            cfg = cfg.replace(operator='matmul_flat')
        stamps, bkgs, x0, obj = (a.reshape(a.shape[0], -1)
                                 for a in (stamps, bkgs, x0, obj))

    two_phase = (phase1_iters is not None
                 and cfg.stop_criterion not in (0, 1)
                 and phase1_iters < cfg.max_iter
                 and int(stamps.shape[0]) > tail_bucket)
    if two_phase:
        res = _batched_solve_two_phase(stamps, psf, bkgs, x0, fluxes, obj,
                                       beta0, lr0, sat, cfg, phase1_iters,
                                       tail_bucket)
    else:
        res = solve(stamps, psf, bkgs, x0, fluxes, obj, beta0, lr0, sat, cfg)
    if pad:
        res = _unpad(res, b_orig)
    if flatten:
        res = res._replace(x=res.x.reshape((res.x.shape[0],) + img_shape))
    return res


BETA_SEEDS = (0, 42, 951, 93, 810)


def default_beta_candidates() -> np.ndarray:
    """The reference's five seeded N(1, 0.05) beta-init draws
    (``batch.py:405-414``)."""
    return np.array([np.random.RandomState(s).normal(loc=1.0, scale=0.05)
                     for s in BETA_SEEDS])


def _host(a):
    """A numpy view of an array or tensor (None stays None)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return None if a is None else np.asarray(a)


def beta_init_search(stamps, psf, bkgs, cfg: SGPConfig, *, fluxes=None,
                     beta_candidates=None, lr0=1e-3, sat_level=0.0,
                     mesh=None, scorer='catalog',
                     phase1_iters: Optional[int] = None,
                     bucket: bool = False, device=None) -> tuple:
    """Vectorized beta-init selection (``batch.py:417-503``): the
    (stamp x candidate) grid is one batch of B*K solves, then an argmin
    per stamp of the flux fractional difference 1 - F_rest/F_orig, where
    F_orig is the background-subtracted stamp sum (or ``fluxes``).

    ``scorer``: ``'catalog'`` (the default and the reference's criterion:
    F_rest is the brightest source's segment flux from the batched host
    catalog pipeline, ``catalog.batched.brightest_catalog_fluxes``, one
    pass over all B*K restorations after a single download),
    ``'flux_sum'`` (F_rest the restored pixel sum, on the device; it can
    pick another beta on blended stamps) or a callable ``f(grid_x (B, K, H,
    W) np.ndarray) -> (B, K) ffd``. A non-finite score never wins.
    ``device`` as in ``restore_stamps``.

    Returns (best_beta (B,), best_x (B, H, W), result for the full grid).
    """
    if scorer not in ('catalog', 'flux_sum') and not callable(scorer):
        raise ValueError(f'unknown scorer {scorer!r}')
    device = resolve_device(device, stamps)
    if beta_candidates is None:
        beta_candidates = default_beta_candidates()
    beta_candidates = np.asarray(beta_candidates)
    k = beta_candidates.shape[0]
    stamps = _host(stamps)
    b, h, w = stamps.shape

    rep = lambda a: np.repeat(a, k, axis=0)
    bkgs = _host(bkgs)
    if bkgs.ndim == 0:
        bkgs = np.broadcast_to(bkgs, (b,))
    fluxes = _host(fluxes)
    psf = _host(psf)
    res = restore_stamps(rep(stamps), rep(psf) if psf.ndim == 3 else psf,
                         rep(bkgs), cfg,
                         fluxes=None if fluxes is None else rep(fluxes),
                         beta0=np.tile(beta_candidates, b), lr0=lr0,
                         sat_level=sat_level, mesh=mesh,
                         phase1_iters=phase1_iters, bucket=bucket,
                         device=device)

    x_g = res.x.reshape(b, k, h, w)
    if fluxes is not None:
        f_orig = np.asarray(fluxes, np.float64)[:, None]
    else:
        bkg_tot = (bkgs.sum(axis=(1, 2)) if bkgs.ndim == 3
                   else h * w * bkgs)
        f_orig = (stamps.sum(axis=(1, 2)) - bkg_tot)[:, None]
    if scorer == 'flux_sum':
        ffd = 1.0 - x_g.sum((2, 3)) / torch.as_tensor(
            f_orig, dtype=x_g.dtype, device=x_g.device)
        best = torch.where(torch.isfinite(ffd), ffd, torch.inf).argmin(1)
    else:
        if scorer == 'catalog':
            from ..catalog.batched import brightest_catalog_fluxes
            f_np = brightest_catalog_fluxes(
                res.x.cpu().numpy().reshape(b * k, h, w)).reshape(b, k)
            ffd_np = 1.0 - f_np / f_orig
        else:
            ffd_np = np.asarray(scorer(x_g.cpu().numpy()))
        ffd_np = np.where(np.isfinite(ffd_np), ffd_np, np.inf)
        best = torch.as_tensor(np.argmin(ffd_np, axis=1), device=x_g.device)
    best_beta = torch.as_tensor(beta_candidates, dtype=cfg.torch_dtype,
                                device=x_g.device)[best]
    best_x = x_g[torch.arange(b, device=x_g.device), best]
    return best_beta, best_x, res
