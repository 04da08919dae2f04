"""The port's batched KL-SGP solver and restore_stamps against the JAX
package, on the same seeded stamps: the JAX projection running the Pallas
kernel in interpret mode (projection_method='pallas'), and every other
projection method."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgp import SGPConfig as JaxConfig
from tpu_sgp.parallel import batch as jbatch
from tpu_sgp.solvers import sgp as jsgp
import tpu_sgp_torch as tsgp
from tpu_sgp_torch.parallel import batch as tbatch
from tpu_sgp_torch.simulate import synthetic_star_stamps

# the bench configuration (bench.py:630-633), cut to max_iter=40, with the
# projection on the kernel path
MAIN = dict(max_iter=40, stop_criterion=3, tol_convergence=1e-4,
            init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
            dtype='float64', divergence='kl', track_discr=False,
            projection_method='pallas')


def _stamps(b=8, size=16, seed=3):
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=size, seed=seed)
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - size * size * bkgs


def _rel(got, want):
    """Largest per-lane max|dx| / max|x|."""
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(range(1, want.ndim))
    return float((np.abs(got - want).max(axis=axes)
                  / np.abs(want).max(axis=axes)).max())


def _both(stamps, psf, bkgs, fluxes, **kw):
    cfg = dict(MAIN, **kw.pop('cfg', {}))
    args = dict(fluxes=fluxes, sat_level=65000.0, flatten=True, **kw)
    want = jbatch.restore_stamps(stamps, psf, bkgs, JaxConfig(**cfg), **args)
    got = tsgp.restore_stamps(stamps, psf, bkgs, tsgp.SGPConfig(**cfg),
                              device='cpu', **args)
    return got, want


@pytest.mark.parametrize('size', [16, 31])
def test_restore_stamps_f64_matches_jax(size):
    got, want = _both(*_stamps(size=size))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert _rel(got.x.numpy(), want.x) <= 1e-9
    assert got.x.shape == want.x.shape


def test_two_phase_compaction_f64_matches_jax():
    """phase1_iters below the median and tail_bucket=2 at B=8: two tail
    rounds and a catch-up pass that does real work. Same per-lane schedule
    as JAX and as the single-phase solve."""
    stamps, psf, bkgs, fluxes = _stamps()
    single, _ = _both(stamps, psf, bkgs, fluxes)
    it = single.iters.numpy()
    cap = int(np.median(it)) - 2
    assert (it > cap).sum() > 4       # more than two tail rounds can hold
    got, want = _both(stamps, psf, bkgs, fluxes, phase1_iters=cap,
                      tail_bucket=2)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.iters.numpy(), it)
    assert _rel(got.x.numpy(), want.x) <= 1e-9
    assert _rel(got.x.numpy(), single.x.numpy()) <= 1e-9


def test_restore_stamps_f32_iteration_distribution():
    got, want = _both(*_stamps(), cfg=dict(dtype='float32'))
    it_t, it_j = got.iters.numpy(), np.asarray(want.iters)
    assert got.x.dtype == torch.float32
    assert np.median(it_t) == np.median(it_j)
    assert np.abs(it_t.astype(int) - it_j).max() <= 2


def test_bucketed_and_unflattened_batches():
    """bucket=True pads B=5 to 8 and slices it off; the (B, H, W) layout
    gives the flat layout's result."""
    stamps, psf, bkgs, fluxes = _stamps(b=5)
    cfg = tsgp.SGPConfig(**MAIN)
    flat = tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                               sat_level=65000.0, flatten=True, device='cpu')
    bucketed = tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                                   sat_level=65000.0, flatten=True,
                                   bucket=True, device='cpu')
    image = tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                                sat_level=65000.0, device='cpu')
    for res in (bucketed, image):
        assert res.x.shape == (5, 16, 16)
        np.testing.assert_array_equal(res.iters.numpy(), flat.iters.numpy())
        assert _rel(res.x.numpy(), flat.x.numpy()) <= 1e-9


BRANCHES = {
    'init0': dict(init_recon=0),
    'init1': dict(init_recon=1),
    'init2': dict(init_recon=2),
    'init3': dict(init_recon=3),
    'init3_noflux': dict(init_recon=3, has_flux=False),
    'stop1': dict(stop_criterion=1, max_iter=15),
    'stop2': dict(stop_criterion=2, tol_convergence=1e-3),
    'stop2_quiet_stable': dict(stop_criterion=2, verbose=False,
                               tol_convergence=1e-5, stable_sums=True),
    'stop4': dict(stop_criterion=4),
    'clip_projection': dict(proj_type=0, max_iter=15),
    'no_backtracking': dict(max_backtracks=0, stop_criterion=1,
                            max_iter=10),
    'series_and_memory': dict(track_discr=True, errflag=True, m_mem=3,
                              scale_data=False),
}


@pytest.mark.parametrize('name', list(BRANCHES))
def test_solver_branches_match_jax(name):
    """Init modes, stop rules and the other branches of the core against
    JAX's single-image solve on one 16x16 stamp, f64."""
    cfg = dict(MAIN, **BRANCHES[name])
    stamps, psf, bkgs, fluxes = _stamps(b=1, seed=11)
    rng = np.random.default_rng(11)
    x0 = rng.uniform(50.0, 200.0, (16, 16))
    obj = np.zeros((16, 16))
    obj[8, 7] = fluxes[0]
    want = jsgp.solve(stamps[0], psf, bkgs[0], x0, fluxes[0], obj, 1.0,
                      1e-3, 65000.0, JaxConfig(**cfg))
    t = torch.as_tensor
    got = tsgp.solve(t(stamps), t(psf), t(bkgs), t(x0[None]), t(fluxes),
                     t(obj[None]), 1.0, 1e-3, 65000.0, tsgp.SGPConfig(**cfg),
                     device='cpu')
    assert int(got.iters[0]) == int(want.iters)
    assert _rel(got.x.numpy(), np.asarray(want.x)[None]) <= 1e-9
    np.testing.assert_allclose(got.fv.numpy()[0], float(want.fv), rtol=1e-9)
    np.testing.assert_allclose(got.scaling.numpy()[0], float(want.scaling),
                               rtol=1e-15)
    for field in ('discr', 'err'):
        np.testing.assert_allclose(getattr(got, field).numpy()[0],
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-9, atol=1e-12, err_msg=field)


def test_restore_stamps_argument_checks():
    """The checks of batch.py:303-321, and NotImplementedError for what the
    port does not have yet."""
    stamps, psf, bkgs, fluxes = _stamps(b=4)
    cfg = tsgp.SGPConfig(**dict(MAIN, max_iter=5))
    with pytest.raises(ValueError, match='has_flux'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg, device='cpu')
    with pytest.raises(ValueError, match='sat_level'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                            sat_level=0.0, device='cpu')
    with pytest.raises(ValueError, match='errflag'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg.replace(errflag=True),
                            fluxes=fluxes, sat_level=65000.0, device='cpu')
    with pytest.raises(ValueError, match='dense matmul'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg.replace(operator='otf'),
                            fluxes=fluxes, sat_level=65000.0, flatten=True,
                            device='cpu')
    with pytest.raises(NotImplementedError, match='A13'):
        tsgp.restore_stamps(stamps, psf, bkgs,
                            cfg.replace(axis_names=('y', 'x')),
                            fluxes=fluxes, sat_level=65000.0, device='cpu')
    with pytest.raises(NotImplementedError, match='save'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg.replace(save=True),
                            fluxes=fluxes, sat_level=65000.0, device='cpu')
    with pytest.raises(NotImplementedError, match='A13'):
        tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                            sat_level=65000.0, mesh=object(),
                            device='cpu')
    # per-stamp PSFs are ported; the flat layout still needs a shared one
    # (batch.py:352-353)
    with pytest.raises(ValueError, match='shared PSF'):
        tsgp.restore_stamps(stamps, np.stack([psf] * 4), bkgs, cfg,
                            fluxes=fluxes, sat_level=65000.0, flatten=True,
                            device='cpu')


def test_numpy_inputs_follow_device_and_tensors_stay():
    """numpy inputs go to ``device``; torch inputs compute where they
    lie."""
    stamps, psf, bkgs, fluxes = _stamps(b=2)
    cfg = tsgp.SGPConfig(**dict(MAIN, max_iter=3, stop_criterion=1))
    a = tsgp.restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                            sat_level=65000.0, device='cpu')
    b = tsgp.restore_stamps(torch.as_tensor(stamps), psf, bkgs, cfg,
                            fluxes=fluxes, sat_level=65000.0,
                            device='meta')
    assert a.x.device.type == b.x.device.type == 'cpu'
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize('method,warm', [('bisect', False), ('bisect', True),
                                         ('section', False), ('sort', False),
                                         ('secant', False)])
@pytest.mark.parametrize('has_sat', [True, False])
def test_projection_methods_solve_like_jax(method, warm, has_sat):
    """Every projection method of the JAX solver, and the warm-started
    bisection, through restore_stamps in float64 against JAX's: equal
    per-lane iterations, x within 1e-9, flux conserved."""
    stamps, psf, bkgs, fluxes = _stamps()
    kw = dict(projection_method=method, warm_projection=warm,
              has_sat_level=has_sat)
    got, want = _both(stamps, psf, bkgs, fluxes, cfg=kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert _rel(got.x.numpy(), want.x) <= 1e-9
    np.testing.assert_allclose(got.x.numpy().sum((1, 2)), fluxes, rtol=1e-9)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_suggest_compaction_matches_jax(seed):
    iters = np.random.default_rng(seed).integers(18, 45, 500)
    for bs in (None, 12288):
        assert (tbatch.suggest_compaction(iters, bs)
                == jbatch.suggest_compaction(iters, bs))
    assert ([tbatch._bucket_size(b) for b in (1, 5, 256, 257, 12288)]
            == [jbatch._bucket_size(b) for b in (1, 5, 256, 257, 12288)])
