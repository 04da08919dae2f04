"""beta-SGP in the port against the JAX package, and the JAX bench's two
stamp configurations (KL with the default 'bisect' projection, beta with
'section') through ``restore_stamps`` with compaction, on the same seeded
stamps: float64 lane for lane, float32 as distributions.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
    python -m pytest tests/test_torch_beta.py --noconftest -o addopts= -m cuda
"""
import numpy as np
import pytest
import torch

import tpu_sgp_torch as tsgp
from tpu_sgp_torch.simulate import synthetic_star_stamps

SAT = 65000.0
# bench.py:630-633, the JAX package's primary metric; projection_method
# stays at its default, 'bisect'
KL_BENCH = dict(max_iter=100, stop_criterion=3, tol_convergence=1e-4,
                init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
                dtype='float32', divergence='kl', track_discr=False)
# bench.py:215-241: the beta workload, with 'section'
BETA_BENCH = dict(KL_BENCH, divergence='beta', adapt_beta=True,
                  schedule_lr=True, projection_method='section')
BENCH = {'kl': (KL_BENCH, dict(phase1_iters=26)),
         'beta': (BETA_BENCH, dict(phase1_iters=28, beta0=1.005,
                                   lr0=1e-3))}


def _stamps(b, size, seed):
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=size, seed=seed)
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - size * size * bkgs


def _lane_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(range(1, want.ndim))
    return np.abs(got - want).max(axis=axes) / np.abs(want).max(axis=axes)


def _bench_both(name, dtype, b=64, size=16, seed=5):
    """One bench configuration through JAX's and the port's
    ``restore_stamps(flatten=True)``, compaction's tail a quarter of the
    batch (the bench: 2048 of 12288)."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.parallel import batch as jbatch
    cfg, kw = BENCH[name]
    cfg = dict(cfg, dtype=dtype)
    stamps, psf, bkgs, fluxes = _stamps(b, size, seed)
    args = dict(fluxes=fluxes, sat_level=SAT, flatten=True,
                tail_bucket=b // 4, **kw)
    want = jbatch.restore_stamps(stamps, psf, bkgs, JaxConfig(**cfg), **args)
    got = tsgp.restore_stamps(stamps, psf, bkgs, tsgp.SGPConfig(**cfg),
                              device='cpu', **args)
    return got, want, fluxes


@pytest.mark.parametrize('name', list(BENCH))
def test_bench_configuration_f64_matches_jax(name):
    """B=64 with compaction, float64: equal per-lane iterations, x and the
    final beta within 1e-9; flux conserved."""
    got, want, fluxes = _bench_both(name, 'float64')
    it = got.iters.numpy()
    np.testing.assert_array_equal(it, np.asarray(want.iters))
    assert (it > BENCH[name][1]['phase1_iters']).sum() > 0  # tails ran
    assert _lane_rel(got.x.numpy(), want.x).max() <= 1e-9
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.x.numpy().sum((1, 2)), fluxes, rtol=1e-9)
    if name == 'beta':
        assert np.abs(got.beta.numpy() - 1.005).max() > 0  # beta moved


@pytest.mark.parametrize('name', list(BENCH))
def test_bench_configuration_f32_distribution(name):
    """float32 (the bench's dtype): iteration counts move with summation
    order, so the distributions are compared (ROADMAP Queue C). JAX
    against itself on these batches (flatten=True against the (H, W)
    layout, seeds 5-7) moves the median by up to 1 and the mean |diters|
    up to 1.70; the port against JAX is held to medians within 1 and mean
    |diters| <= 2; flux to 1e-4."""
    got, want, fluxes = _bench_both(name, 'float32')
    it_t, it_j = got.iters.numpy().astype(int), np.asarray(want.iters)
    assert got.x.dtype == torch.float32
    assert abs(np.median(it_t) - np.median(it_j)) <= 1
    assert np.abs(it_t - it_j).mean() <= 2.0
    np.testing.assert_allclose(got.x.double().numpy().sum((1, 2)), fluxes,
                               rtol=1e-4)


@pytest.mark.parametrize('adapt,schedule', [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_beta_solve_matches_vmapped_jax(adapt, schedule):
    """``solve`` with beta adaptation and the lr schedule on and off,
    against JAX's solve vmapped over the lanes, float64, B=8 (two
    lanes start at beta = 1 exactly, where the expm1 switches sit):
    equal iterations, x, beta and fv within 1e-9."""
    import jax
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.solvers import sgp as jsgp
    stamps, psf, bkgs, fluxes = _stamps(8, 16, 7)
    beta0 = np.array([1.005, 0.98, 1.0, 1.03, 1.0, 0.95, 1.01, 1.1])
    lr0 = np.full(8, 2e-3)
    kw = dict(KL_BENCH, dtype='float64', divergence='beta',
              adapt_beta=adapt, schedule_lr=schedule, max_iter=60)
    cfg = JaxConfig(**kw)

    def one(g, b, f, be, lr):
        return jsgp.solve(g, psf, b, g, f, g, be, lr, SAT, cfg)

    want = jax.vmap(one)(stamps, bkgs, fluxes, beta0, lr0)
    t = torch.as_tensor
    got = tsgp.solve(t(stamps), t(psf), t(bkgs), None, t(fluxes), None,
                     t(beta0), t(lr0), SAT, tsgp.SGPConfig(**kw))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert _lane_rel(got.x.numpy(), want.x).max() <= 1e-9
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                               rtol=1e-9)
    np.testing.assert_allclose(got.fv.numpy(), np.asarray(want.fv),
                               rtol=1e-9)
    if adapt:
        assert (got.beta.numpy() != beta0).any()
    else:
        np.testing.assert_array_equal(got.beta.numpy(), beta0)


def test_beta_without_backtracking_and_resume_match_jax():
    """max_backtracks=0 (the objective at lam = 1) and a solve resumed
    from its checkpoint, beta with the default 'bisect' and its warm
    start, float64."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.parallel import batch as jbatch
    stamps, psf, bkgs, fluxes = _stamps(6, 16, 8)
    for kw in (dict(max_backtracks=0, stop_criterion=1, max_iter=12),
               dict(warm_projection=True, max_iter=60)):
        cfg = dict(BETA_BENCH, dtype='float64', projection_method='bisect',
                   **kw)
        args = dict(fluxes=fluxes, sat_level=SAT, flatten=True, beta0=1.005,
                    lr0=1e-3)
        want = jbatch.restore_stamps(stamps, psf, bkgs, JaxConfig(**cfg),
                                     **args)
        got = tsgp.restore_stamps(stamps, psf, bkgs, tsgp.SGPConfig(**cfg),
                                  device='cpu', **args)
        np.testing.assert_array_equal(got.iters.numpy(),
                                      np.asarray(want.iters))
        assert _lane_rel(got.x.numpy(), want.x).max() <= 1e-9
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta),
                                   rtol=1e-9)
    # a beta solve cut at 10 iterations and resumed: the whole solve
    t = torch.as_tensor
    c = tsgp.SGPConfig(**dict(BETA_BENCH, dtype='float64', max_iter=60))
    full = tsgp.solve(t(stamps), t(psf), t(bkgs), None, t(fluxes), None,
                      1.005, 1e-3, SAT, c)
    _, st = tsgp.solve_with_state(t(stamps), t(psf), t(bkgs), None,
                                  t(fluxes), None, 1.005, 1e-3, SAT,
                                  c.replace(max_iter=10))
    res, _ = tsgp.resume_from_state(t(stamps), t(psf), t(bkgs), None,
                                    t(fluxes), None, 1.005, 1e-3, SAT, st, c)
    np.testing.assert_array_equal(res.iters.numpy(), full.iters.numpy())
    assert torch.equal(res.x, full.x) and torch.equal(res.beta, full.beta)


def test_default_beta_candidates_equal_jax():
    from tpu_sgp.parallel import batch as jbatch
    assert tsgp.BETA_SEEDS == jbatch.BETA_SEEDS
    np.testing.assert_array_equal(tsgp.default_beta_candidates(),
                                  jbatch.default_beta_candidates())


def _search_both(stamps, psf, bkgs, cfg, **kw):
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.parallel import batch as jbatch
    want = jbatch.beta_init_search(stamps, psf, bkgs, JaxConfig(**cfg),
                                   **kw)
    got = tsgp.beta_init_search(stamps, psf, bkgs, tsgp.SGPConfig(**cfg),
                                device='cpu', **kw)
    return got, want


def test_beta_init_search_flux_sum_matches_jax():
    """The pattern of tests/test_batch.py:63-73 with scorer='flux_sum':
    the same beta picked for every stamp, its x, and the whole grid. The
    projection is the clip at 0 (proj_type=0): a flux-conserving one makes
    every candidate's restored flux equal to roundoff, and the pick
    noise."""
    stamps, psf, bkgs, fluxes = _stamps(3, 16, 6)
    cfg = dict(BETA_BENCH, dtype='float64', max_iter=8, proj_type=0)
    (bb, bx, grid), (wb, wx, wgrid) = _search_both(
        stamps, psf, bkgs, cfg, fluxes=fluxes, sat_level=SAT,
        scorer='flux_sum', beta_candidates=np.array([0.95, 1.0, 1.05]))
    np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))
    assert bx.shape == (3, 16, 16)
    assert _lane_rel(bx.numpy(), wx).max() <= 1e-9
    np.testing.assert_array_equal(grid.iters.numpy(),
                                  np.asarray(wgrid.iters))
    # the default candidates, a callable scorer, background maps and no
    # fluxes (F_orig = the stamp minus the map's pixel sum)
    maps = np.broadcast_to(bkgs[:, None, None], stamps.shape).copy()
    cfg = dict(cfg, has_flux=False)
    score = lambda xg: np.abs(xg.sum(axis=(2, 3)) - xg.sum() / xg.size)
    for kw in (dict(scorer='flux_sum'), dict(scorer=score)):
        (bb, bx, _), (wb, wx, _) = _search_both(stamps, psf, maps, cfg,
                                                sat_level=SAT, **kw)
        np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))
        assert _lane_rel(bx.numpy(), wx).max() <= 1e-9


def test_beta_init_search_ignores_nonfinite_candidates():
    """tests/test_batch.py:513-526: a pure-background stamp drives F_orig
    to 0 and its scores non-finite; the first candidate is taken, as in
    JAX."""
    stamps, psf, bkgs, _ = synthetic_star_stamps(2, size=16, seed=33)
    stamps[1] = bkgs[1]
    cfg = dict(BETA_BENCH, dtype='float64', max_iter=4, has_flux=False,
               has_sat_level=False, proj_type=0)
    cands = np.array([0.99, 1.01])
    (bb, bx, _), (wb, _, _) = _search_both(stamps, psf, bkgs, cfg,
                                           beta_candidates=cands,
                                           scorer='flux_sum')
    assert torch.isfinite(bb).all()
    assert float(bb[1]) == cands[0]
    np.testing.assert_array_equal(bb.numpy(), np.asarray(wb))


def test_beta_init_search_catalog_scorer_waits_for_the_catalog():
    stamps, psf, bkgs, fluxes = _stamps(2, 16, 6)
    cfg = tsgp.SGPConfig(**dict(BETA_BENCH, max_iter=4))
    with pytest.raises(NotImplementedError, match='A15'):
        tsgp.beta_init_search(stamps, psf, bkgs, cfg, fluxes=fluxes,
                              sat_level=SAT, device='cpu')
    with pytest.raises(ValueError, match='unknown scorer'):
        tsgp.beta_init_search(stamps, psf, bkgs, cfg, fluxes=fluxes,
                              sat_level=SAT, scorer='peak', device='cpu')


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(BENCH))
def test_bench_configuration_on_card_matches_cpu(name):
    """float64, B=32 with compaction: the card's run lane for lane against
    the CPU's (iterations equal, x and beta within 1e-7)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    cfg, kw = BENCH[name]
    cfg = tsgp.SGPConfig(**dict(cfg, dtype='float64'))
    stamps, psf, bkgs, fluxes = _stamps(32, 31, 9)
    args = dict(fluxes=fluxes, sat_level=SAT, flatten=True, tail_bucket=8,
                **kw)
    gpu = tsgp.restore_stamps(stamps, psf, bkgs, cfg, **args)
    cpu = tsgp.restore_stamps(stamps, psf, bkgs, cfg, device='cpu', **args)
    assert gpu.x.is_cuda
    np.testing.assert_array_equal(gpu.iters.cpu().numpy(),
                                  cpu.iters.numpy())
    assert _lane_rel(gpu.x.cpu().numpy(), cpu.x.numpy()).max() <= 1e-7
    np.testing.assert_allclose(gpu.beta.cpu().numpy(), cpu.beta.numpy(),
                               rtol=1e-7)
