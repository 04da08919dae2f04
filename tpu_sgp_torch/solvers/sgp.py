"""SGP / beta-SGP solver core over a batch of images, batch-first.

Port of ``tpu_sgp/solvers/sgp.py:62-601``. The JAX core solves one image in
a ``lax.while_loop`` and batches it with ``vmap``; here every tensor carries
the batch as its leading axis and the loops are Python loops over per-lane
masks. A vmapped ``while_loop`` runs its body while any lane continues and
freezes the lanes that stopped; the outer loop below does the same with
``active`` and the backtracking loop with its own mask, so each lane
follows the trajectory it would follow alone.

Images are raveled to (B, N) rows inside the solver; results come back in
the input's image shape. The PSF operator is built for the image shape and
applied to the rows (the FFT operators reshape inside), so one image of any
size is a batch of one: a 410x410 frame is a single row of 168100 pixels.

Supported: the KL and beta divergences (beta adaptation in the line
search, the learning-rate schedule), ``proj_type`` 0 and 1 with every
projection method (``'pallas'`` runs the CUDA kernel on the card and its
plain version on the CPU) and the warm-started bisection, init modes 0-3,
stop rules 0-4, ``track_discr`` and ``errflag``, every operator, a shared
(H, W) PSF or one PSF a lane (B, H, W), and ``save`` (a FITS dump of every
iteration, a debugging aid for single images).

Mesh axes. With ``cfg.axis_names`` and a ``mesh`` (a ``DeviceMesh`` whose
``mesh_dim_names`` hold those names) each rank solves its (th, tw) tile of
every image of the batch under the ``'halo'`` operator, and every quantity
that the JAX solver ``psum``s or ``pmax``es over the names is one
collective over their process group (``ops.mesh.MeshAxes``). Every branch
the loop takes comes from such a reduced value, the same bytes on every
rank, so the ranks call the same collectives in the same order.
``cfg.sync_axes`` names axes over which groups of ranks solve different
images: the loops there OR-reduce their continue flags over those axes
(``sgp.py:322-330``, ``:377-381``), so every rank runs the same trips.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SGPConfig
from ..device import resolve_device
from ..observability import count, host_flag, span
from ..ops import divergence as dv
from ..ops.mesh import resolve_axes
from ..ops.psf_operator import make_operator
from ..ops.reduce import gmax, gmean, gmin, gsum, gsum_ff
from ..projection.flux_projection import project, project_df_bisect_warm


class SGPResult(NamedTuple):
    """Batched ``SGPResult`` (``sgp.py:62-69``): leading axis B on every
    field."""
    x: torch.Tensor          # reconstruction, unscaled, (B, *image shape)
    iters: torch.Tensor      # completed iterations, (B,) int32
    discr: torch.Tensor      # discrepancy series, (B, max_iter+1) or (B, 1)
    err: torch.Tensor        # rel-err series, (B, max_iter+1) or (B, 1)
    beta: torch.Tensor       # final beta parameter, (B,)
    fv: torch.Tensor         # final objective value, (B,)
    scaling: torch.Tensor    # data scaling that was applied, (B,)


class SGPState(NamedTuple):
    """Batched loop state (``sgp.py:72-103``), field for field the layout
    of a vmapped JAX ``SGPState``: per-lane scalars are (B,), x-like fields
    (B, N), ``valpha`` (B, m_alpha), ``fold`` (B, m_mem)."""
    keep: torch.Tensor
    it: torch.Tensor
    x: torch.Tensor
    x_prev: torch.Tensor
    converged: torch.Tensor
    g: torch.Tensor
    x_tf: torch.Tensor
    fv: torch.Tensor
    alpha: torch.Tensor
    tau: torch.Tensor
    valpha: torch.Tensor
    fold: torch.Tensor
    beta_p: torch.Tensor
    lr: torch.Tensor
    discr: torch.Tensor
    err: torch.Tensor
    lam_dual: torch.Tensor
    dlam_dual: torch.Tensor


# the fields of SGPState that hold one value a pixel
IMAGE_FIELDS = ('x', 'x_prev', 'g', 'x_tf')


SAVE_DIR = 'SGP_reconstructed_images'


def _dump_iteration(x, gn, it) -> None:
    """Per-iteration dump on the host, working units (``sgp.py:110-123``):
    the reconstruction as ``rec_<k>.fits`` and its normalised residual as
    ``res_<k>.fits``, k = it - 1."""
    import os

    import numpy as np

    from ..image import write_fits

    os.makedirs(SAVE_DIR, exist_ok=True)
    k = int(it) - 1
    x = x.detach().cpu().numpy()
    write_fits(os.path.join(SAVE_DIR, f'rec_{k}.fits'), x)
    with np.errstate(all='ignore'):
        res = (x - gn.detach().cpu().numpy()) / np.sqrt(np.maximum(x, 0.0))
    write_fits(os.path.join(SAVE_DIR, f'res_{k}.fits'),
               np.nan_to_num(res))


def _use_stable(cfg: SGPConfig) -> bool:
    """cfg.stable_sums with 'auto' resolved as ``sgp.py:127-137`` does."""
    if cfg.stable_sums == 'auto':
        return cfg.torch_dtype != torch.float64
    return cfg.stable_sums


def _lanes(v, b: int, dt, dev) -> torch.Tensor:
    """A per-lane scalar argument as a (B,) tensor."""
    return torch.as_tensor(v, dtype=dt, device=dev).reshape(-1).expand(b)


def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor
           ) -> torch.Tensor:
    """Per-lane select; ``mask`` is (B,), the fields (B, ...)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def _solve_impl(gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level,
                cfg: SGPConfig, rstate: SGPState | None = None,
                device=None, mesh=None):
    """Shared implementation (``sgp.py:155-573``); with ``rstate`` the
    preamble recomputes the constants and the loop continues from the
    checkpointed state. Returns (SGPResult, final SGPState)."""
    with span('solver.solve'):
        with span('solver.setup'):
            state, body, finish, sync = _setup(
                gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level, cfg,
                rstate, device, mesh)
        while True:
            active = state.keep
            if not (sync.any(active.any()) if sync
                    else host_flag(active.any())):
                break
            with span('solver.trip'):
                state = body(state, active)
        return finish(state), state


def _setup(gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level,
           cfg: SGPConfig, rstate, device, mesh):
    """The preamble of ``_solve_impl``: the inputs on the device, the
    constants, the operator and the first state (or the checkpointed one).
    Returns (state, body, finish, sync): ``body(state, active)`` is one
    trip of the loop, ``finish(state)`` the result, ``sync`` the loop's
    ``sync_axes``."""
    ax = resolve_axes(mesh, cfg.axis_names)
    sync = resolve_axes(mesh, cfg.sync_axes)
    dt = cfg.torch_dtype
    dev = resolve_device(device, gn)
    gn = torch.as_tensor(gn, dtype=dt, device=dev)
    nb = gn.shape[0]
    shape = tuple(gn.shape[1:])
    gn = gn.reshape(nb, -1)
    n_local = gn.shape[1]
    # the global pixel count: every rank's tile has the same size
    n = n_local * ax.size if ax else n_local
    psf = torch.as_tensor(psf, dtype=dt, device=dev)
    bkg = torch.as_tensor(bkg, dtype=dt, device=dev)
    bkg = (bkg.expand(nb) if bkg.dim() == 0 else bkg).reshape(nb, -1)
    eps = torch.finfo(dt).eps

    # built for the image shape, applied to the raveled (B, N) rows; a
    # (B, H, W) PSF gives each lane its own operator
    A, AT = make_operator(psf, shape, cfg.operator, ax)

    def col(v):
        return v[:, None]

    # ---- initialization (sgp.py:174-187) ----------------------------------
    if cfg.init_recon == 0:
        x = torch.zeros_like(gn)
    elif cfg.init_recon == 1:
        x = torch.as_tensor(x0, dtype=dt, device=dev).reshape(nb, n_local)
    elif cfg.init_recon == 2:
        x = gn
    elif cfg.has_flux:
        x = col(_lanes(flux_in, nb, dt, dev) / n).expand(nb, n_local)
    else:
        x = col(gsum(gn - bkg, ax) / n).expand(nb, n_local)

    # ---- stop tolerance (sgp.py:189-195) ----------------------------------
    if cfg.stop_criterion == 4:
        tol = 1.0 + 1.0 / gmean(gn, ax)
    else:
        tol = torch.tensor(cfg.tol_convergence, dtype=dt, device=dev)
    if cfg.stop_criterion == 2 and cfg.verbose:
        tol = tol * tol  # reference quirk: squared only under verbose

    # ---- scaling + data conditioning (sgp.py:197-212) ---------------------
    if cfg.scale_data:
        scaling = gmax(gn, ax)
        gn = gn / col(scaling)
        bkg = bkg / col(scaling)
        x = x / col(scaling)
    else:
        scaling = torch.ones(nb, dtype=dt, device=dev)

    vmin = gmin(torch.where(gn > 0, gn, torch.inf), ax)
    gn = torch.where(gn <= 0, col(vmin * eps * eps), gn)

    if cfg.has_flux:
        flux = _lanes(flux_in, nb, dt, dev) / scaling
    else:
        flux = gsum(gn - bkg, ax)

    discr_coeff = 2.0 / n * scaling
    sat = _lanes(sat_level, nb, dt, dev)
    stable = _use_stable(cfg)

    beta = cfg.divergence == 'beta'
    # the observed image is loop-invariant but its log enters every
    # beta-objective evaluation (sgp.py:285-287)
    log_gn = torch.log(gn) if beta else None
    lr0 = _lanes(lr0, nb, dt, dev)

    # The beta path's passes have spans of their own, and each objective
    # pass counts the rows it covered (every row of the batch, those of
    # lanes already done too); the KL path's stay inside their phases.
    def objective(x_tf, den, bp):
        """``_objective`` (sgp.py:140-146)."""
        if beta:
            with span('beta.objective'):
                count('beta.rows', nb)
                return dv.beta_div(den, gn, bp, ax, log_gn=log_gn,
                                   stable=stable)
        return dv.kl_objective(x_tf, den, gn, flux, ax, stable=stable)

    def objective_dbeta(den, bp):
        """The beta objective and the row sums of its d/dbeta, one pass."""
        with span('beta.objective'):
            count('beta.rows', nb)
            return dv.beta_div_with_dbeta(den, gn, bp, log_gn, ax,
                                          stable=stable)

    def gradient(den, bp):
        """``_gradient`` (sgp.py:149-152)."""
        if beta:
            with span('beta.gradient'):
                return dv.beta_grad_wrt_recon(AT, den, gn, bp)
        return dv.kl_grad_wrt_recon(AT, den, gn)

    sat_arg = sat if cfg.has_sat_level else None

    # the projection method after the mesh remaps (sgp.py:221-230): 'sort'
    # and 'pallas' need the whole row on one device, and the secant's
    # data-dependent trip count would part the device groups of sync_axes
    method = cfg.projection_method
    if method in ('sort', 'pallas') and ax:
        method = 'bisect'
    if sync and method == 'secant':
        method = 'bisect'

    def proj(point, dia):
        """``proj`` (sgp.py:232-260)."""
        with span('projection'):
            if cfg.proj_type == 0:
                return torch.clamp_min(point, 0.0)
            return project(method, flux, point, dia, scaling,
                           sat_level=sat_arg, has_sat=cfg.has_sat_level,
                           max_projs=cfg.max_projs, axes=ax)

    # the warm-started bisection carries the previous dual root across
    # iterations (sgp.py:333-340); not under sync_axes, where the sweep
    # count must be the same on every device group
    use_warm = (cfg.proj_type != 0 and method == 'bisect'
                and cfg.warm_projection and not sync)

    # ---- error tracking (sgp.py:268-280) ----------------------------------
    if cfg.errflag:
        obj_s = (torch.as_tensor(obj, dtype=dt, device=dev).reshape(
            nb, n_local) / col(scaling))
        obj_sum = gsum(obj_s * obj_s, ax)

    def rel_err(v):
        e = v - obj_s
        return torch.sqrt(gsum(e * e, ax) / obj_sum)

    # ---- scaling-matrix bounds (sgp.py:293-299) ---------------------------
    y_b = col(flux) / (col(flux) + bkg) * AT(gn)
    x_lb = gmin(torch.where(y_b > 0, y_b, torch.inf), ax)
    x_ub = gmax(y_b, ax)
    widen = x_ub / x_lb < 50.0
    x_lb = col(torch.where(widen, x_lb / 10.0, x_lb))
    x_ub = col(torch.where(widen, x_ub * 10.0, x_ub))

    def scaling_matrix(v, it):
        """X = clip(x, bounds) (sgp.py:307-314); ones on the first
        iteration of an init_recon=0 run."""
        xm = torch.clamp(v, x_lb, x_ub)
        if cfg.init_recon == 0:
            xm = torch.where(col(it == 1), torch.ones_like(xm), xm)
        return xm

    gamma = cfg.gamma
    bt = cfg.bt_factor
    series = cfg.max_iter + 1

    if rstate is None:
        # Initial projection with the identity metric (sgp.py:262-266).
        x = proj(x, torch.ones_like(x))
        if cfg.errflag:
            err = torch.zeros(nb, series, dtype=dt, device=dev)
            err[:, 0] = rel_err(x)
        else:
            err = torch.zeros(nb, 1, dtype=dt, device=dev)
        beta_p = _lanes(beta0, nb, dt, dev).clone()
        x_tf = A(x)
        den = x_tf + bkg
        g = gradient(den, beta_p)
        fv = objective(x_tf, den, beta_p)
        if cfg.track_discr:
            discr = torch.zeros(nb, series, dtype=dt, device=dev)
            discr[:, 0] = discr_coeff * fv
        else:
            discr = torch.zeros(nb, 1, dtype=dt, device=dev)
        full = lambda v: torch.full((nb,), v, dtype=dt, device=dev)
        state = SGPState(
            keep=torch.ones(nb, dtype=torch.bool, device=dev),
            it=torch.ones(nb, dtype=torch.int32, device=dev),
            x=x, x_prev=x,
            converged=torch.zeros(nb, dtype=torch.bool, device=dev),
            g=g, x_tf=x_tf, fv=fv,
            alpha=full(cfg.alpha_init), tau=full(cfg.tau_init),
            valpha=torch.full((nb, cfg.m_alpha), cfg.alpha_max, dtype=dt,
                              device=dev),
            fold=torch.full((nb, cfg.m_mem), -1e30, dtype=dt, device=dev),
            beta_p=beta_p, lr=lr0.clone(),
            discr=discr, err=err,
            lam_dual=full(float('nan')), dlam_dual=full(float('inf')))
    else:
        state = _resume_state(rstate, cfg, series)

    # ---- main loop (sgp.py:342-531) ---------------------------------------
    def body(st: SGPState, active: torch.Tensor) -> SGPState:
        with span('solver.direction'):
            it, x, g, x_tf, fv = st.it, st.x, st.g, st.x_tf, st.fv
            alpha, tau, beta_p, lr = st.alpha, st.tau, st.beta_p, st.lr
            lam_dual, dlam_dual = st.lam_dual, st.dlam_dual
            x_mat = scaling_matrix(x, it)

            # valpha.at[:-1].set(valpha[1:]): shift left, last entry kept
            valpha = torch.cat([st.valpha[:, 1:], st.valpha[:, -1:]], dim=1)
            fold = torch.cat([st.fold[:, 1:], col(fv)], dim=1)

            # Descent direction with scaled projection (D = 1/X for
            # proj_type 1)
            y = x - col(alpha) * x_mat * g
            if cfg.proj_type == 0:
                y = torch.clamp_min(y, 0.0)
            elif use_warm:
                d_metric = 1.0 / x_mat
                with span('projection'):
                    y, lam_new = project_df_bisect_warm(
                        flux, y * d_metric, d_metric, scaling,
                        sat_level=sat_arg, has_sat=cfg.has_sat_level,
                        axes=ax, lam_prev=lam_dual, dlam_prev=dlam_dual)
                dlam_dual = torch.where(torch.isfinite(lam_dual),
                                        (lam_new - lam_dual).abs(), torch.inf)
                lam_dual = lam_new
            else:
                d_metric = 1.0 / x_mat
                y = proj(y * d_metric, d_metric)
            d = y - x

            gd = gsum(d * g, ax)
            d_tf = A(d)
            fr = fold.amax(-1)

        with span('solver.linesearch'):
            # Backtracking on the linearized transform (sgp.py:375-449). A
            # lane's trial count equals the loop's while the lane runs, so
            # the max_backtracks cap is the loop bound; lanes that stopped
            # in the outer loop start out done. With beta adaptation a
            # rejected trial moves the lane's beta along the mean
            # d(betaDiv)/dbeta at that trial (sgp.py:389-406); the accepted
            # beta feeds g_new. Under sync_axes the loop runs while a lane
            # of any device group runs (sgp.py:377-381); a lane that is
            # done does not move.
            lam = torch.ones(nb, dtype=dt, device=dev)
            if cfg.max_backtracks == 0:
                # Line search disabled (sgp.py:427-436): take lam = 1 but
                # still evaluate the objective there, since fv feeds fold,
                # discr and stop rules 3/4.
                fv_new = objective(x_tf + d_tf, x_tf + d_tf + bkg, beta_p)
            else:
                fv_new = fv
                done = ~active
                for _ in range(cfg.max_backtracks):
                    if not (sync.any((~done).any()) if sync
                            else host_flag((~done).any())):
                        break
                    x_tf_try = x_tf + col(lam) * d_tf
                    den_t = x_tf_try + bkg
                    if beta and cfg.adapt_beta:
                        fv_t, dbeta = objective_dbeta(den_t, beta_p)
                        if ax:
                            dbeta = ax.all_reduce(dbeta)
                    else:
                        fv_t = objective(x_tf_try, den_t, beta_p)
                    ok = (fv_t <= fr + gamma * lam * gd) | (lam < 1e-12)
                    run = ~done
                    fv_new = torch.where(run, fv_t, fv_new)
                    lam = torch.where(run & ~ok, lam * bt, lam)
                    if beta and cfg.adapt_beta:
                        beta_p = torch.where(
                            run & ~ok, beta_p - lr * (dbeta / n), beta_p)
                    done = done | ok
                # Cap-exit fix (sgp.py:441-449): on a max_backtracks exit
                # lam was shrunk once past the last evaluated trial; undo it
                # so (x_new, fv_new) stay a consistent pair.
                lam = torch.where(done, lam, torch.clamp_max(lam / bt, 1.0))

        with span('solver.update'):
            x_new = x + col(lam) * d
            sk = col(lam) * d
            x_tf_new = x_tf + col(lam) * d_tf
            g_new = gradient(x_tf_new + bkg, beta_p)
            yk = g_new - g

            # Scaling matrix + BB steplengths (sgp.py:458-481).
            x_mat_new = torch.clamp(x_new, x_lb, x_ub)
            d_metric = 1.0 / x_mat_new
            sk2 = sk * d_metric
            yk2 = yk * x_mat_new
            bk = gsum(sk2 * yk, ax)
            ck = gsum(yk2 * sk, ax)
            grow = torch.clamp_max(10.0 * alpha, cfg.alpha_max)
            alpha1 = torch.where(
                bk <= 0, grow,
                torch.clamp(
                    gsum(sk2 * sk2, ax) / torch.where(bk <= 0, 1.0, bk),
                    cfg.alpha_min, cfg.alpha_max))
            alpha2 = torch.where(
                ck <= 0, grow,
                torch.clamp(
                    ck / torch.where(ck <= 0, 1.0, gsum(yk2 * yk2, ax)),
                    cfg.alpha_min, cfg.alpha_max))
            valpha = torch.cat([valpha[:, :-1], col(alpha2)], dim=1)

            # min(Valpha) for the first 20 iterations, then tau alternation.
            early = it <= 20
            ratio_low = alpha2 / alpha1 < tau
            alpha_new = torch.where(early | ratio_low, valpha.amin(-1), alpha1)
            tau_new = torch.where(early, tau,
                                  torch.where(ratio_low, tau * 0.9, tau * 1.1))

            if beta and cfg.schedule_lr:
                # epoch = it before the increment, from the call's lr0
                # (sgp.py:483-486)
                lr = dv.lr_schedule(lr0, cfg.lr_exp_param, it.to(dt))

            it_new = it + 1
            lanes = torch.arange(nb, device=dev)
            slot = (it_new - 1).long().clamp_max(series - 1)
            discr, err = st.discr, st.err
            if cfg.track_discr:
                discr = discr.clone()
                discr[lanes, slot] = discr_coeff * fv_new
            if cfg.errflag:
                err = err.clone()
                err[lanes, slot] = rel_err(x_new)

            # Stop rules (sgp.py:496-510).
            if cfg.stop_criterion in (0, 1):
                rule_keep = torch.ones(nb, dtype=torch.bool, device=dev)
            elif cfg.stop_criterion == 2:
                red = gsum_ff if stable else gsum
                normstep = red(sk * sk, ax) / red(x_new * x_new, ax)
                rule_keep = normstep > tol
            elif cfg.stop_criterion == 3:
                reldecrease = (fold[:, -1] - fv_new) / fv_new
                rule_keep = (reldecrease > tol) & (reldecrease >= 0)
            else:
                rule_keep = discr_coeff * fv_new > tol
            keep = rule_keep & (it_new <= cfg.max_iter)

            if cfg.save:
                # reconstruction and residual of this iteration
                # (sgp.py:512-515), a debugging aid for single images. Every
                # running lane writes the same file names in lane order, so
                # a batch leaves its last running lane's images.
                for lane in torch.nonzero(active).flatten().tolist():
                    _dump_iteration(x_new[lane].reshape(shape),
                                    gn[lane].reshape(shape), it_new[lane])

            # x stays the accepted iterate; revert-on-exit (sgp.py:568-572)
            # is applied at the end from x_prev, so the state stays
            # resumable.
            new = SGPState(keep, it_new, x_new, x, ~rule_keep, g_new,
                           x_tf_new, fv_new, alpha_new, tau_new, valpha, fold,
                           beta_p, lr, discr, err, lam_dual, dlam_dual)
            # Masked commit: lanes that stopped keep their state, as the
            # lanes of a vmapped while_loop do.
            return SGPState(*(_where(active, a, b)
                              for a, b in zip(new, st)))

    def finish(st: SGPState) -> SGPResult:
        # The reference returns the previous iterate on exit
        # (sgp.py:568-572).
        return SGPResult(
            x=(st.x_prev * col(scaling)).reshape((nb,) + shape),
            iters=st.it - 1, discr=st.discr, err=st.err,
            beta=st.beta_p, fv=st.fv, scaling=scaling)

    return state, body, finish, sync


def _resume_state(rstate: SGPState, cfg: SGPConfig, series: int
                  ) -> SGPState:
    """Resume bookkeeping (``sgp.py:538-564``): grow the tracked series
    buffers to the new budget, and continue unless a stop rule fired."""
    state = SGPState(*rstate)
    # a checkpoint may hold the image-shaped fields as (B, H, W), as a
    # vmapped JAX solve on (H, W) images keeps them: the loop works on rows
    state = state._replace(**{name: getattr(state, name).reshape(
        state.fv.shape[0], -1) for name in IMAGE_FIELDS})
    for name, flag in (('discr', cfg.track_discr), ('err', cfg.errflag)):
        buf = getattr(state, name)
        if flag and buf.shape[1] <= 1:
            raise ValueError(
                f'resume enables {name} tracking but the checkpoint was '
                f'created without it (buffer shape {tuple(buf.shape)}); '
                f'resume with the flag off or re-solve from scratch')
        if flag:
            pad = series - buf.shape[1]
            if pad < 0:
                raise ValueError(
                    'resume max_iter smaller than checkpoint buffers')
            if pad > 0:
                state = state._replace(
                    **{name: torch.nn.functional.pad(buf, (0, pad))})
    return state._replace(
        keep=(~state.converged) & (state.it <= cfg.max_iter))


def solve(gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level,
          cfg: SGPConfig, *, device=None, mesh=None) -> SGPResult:
    """Run SGP on a batch of images (``sgp.py:576-583``, vmapped).

    ``gn`` is (B, *image shape): a tensor computes on its own device, an
    array on ``device`` (the card unless the caller passes ``'cpu'``);
    ``psf`` is the shared
    (H, W) PSF or (B, H, W), one a lane; ``bkg`` is (B,) or (B, *image shape); ``flux_in``, ``beta0``,
    ``lr0`` and ``sat_level`` are (B,) or scalars; ``x0`` and ``obj`` are
    read only when ``init_recon=1`` and ``errflag`` ask for them. With
    ``cfg.axis_names`` each rank passes its tiles and the ``mesh`` the
    names belong to (see the module docstring)."""
    return _solve_impl(gn, psf, bkg, x0, flux_in, obj, beta0, lr0,
                       sat_level, cfg, device=device, mesh=mesh)[0]


def solve_with_state(gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level,
                     cfg: SGPConfig, *, device=None, mesh=None):
    """As ``solve`` but also returns the final SGPState
    (``sgp.py:586-591``)."""
    return _solve_impl(gn, psf, bkg, x0, flux_in, obj, beta0, lr0,
                       sat_level, cfg, device=device, mesh=mesh)


def resume_from_state(gn, psf, bkg, x0, flux_in, obj, beta0, lr0, sat_level,
                      rstate: SGPState, cfg: SGPConfig, *, device=None,
                      mesh=None):
    """Continue a checkpointed solve (``sgp.py:594-601``) with the original
    inputs; iteration continues until cfg.max_iter or the stop rule."""
    return _solve_impl(gn, psf, bkg, x0, flux_in, obj, beta0, lr0,
                       sat_level, cfg, rstate=rstate, device=device,
                       mesh=mesh)
