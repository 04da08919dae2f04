"""The port's whole-solver path (``solve_stamps_pallas``, kernel K2)
against the JAX package's: the JAX kernel in interpret mode in float32, the
general solvers in float64; and the CUDA kernel against its plain version
(on a card only).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
    python -m pytest tests/test_torch_stamp_solver.py --noconftest \
        -o addopts= -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_sgp_torch as tsgp
from tpu_sgp_torch.convert import config_from_jax, state_from_numpy
from tpu_sgp_torch.experimental.pallas_batch import (solve_stamps_pallas,
                                                     stamp_rows)
from tpu_sgp_torch.kernels import launches
from tpu_sgp_torch.kernels.stamp_solver import (apply_operator,
                                                apply_operator_plain,
                                                solve_rows, solve_rows_plain,
                                                stamp_solver_plan)
from tpu_sgp_torch.simulate import shaped_star_stamps, synthetic_star_stamps

SAT = 65000.0
# the scope of the JAX kernel (pallas_batch.py:325-328) with stop rule 3
SCOPE = dict(stop_criterion=3, tol_convergence=1e-4, init_recon=2,
             proj_type=1, has_flux=True, has_sat_level=True,
             dtype='float32')


def _stamps(b, size, seed=3):
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=size, seed=seed)
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - size * size * bkgs


def _lane_rel(got, want):
    """Per-lane max|dx| / max|x|."""
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(range(1, want.ndim))
    return np.abs(got - want).max(axis=axes) / np.abs(want).max(axis=axes)


def _against_jax(b, size, **kw):
    """The same stamps through JAX's kernel (interpret mode) and the port's
    plain version, the port's config taken from the JAX one."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.experimental.pallas_batch import solve_stamps_pallas as jsp
    stamps, psf, bkgs, fluxes = _stamps(b, size)
    jcfg = JaxConfig(**dict(SCOPE, **kw))
    xj, ij = jsp(stamps, psf, bkgs, fluxes, SAT, jcfg)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    x, it = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg,
                                device='cpu')
    assert x.dtype == torch.float32 and it.dtype == torch.int32
    assert x.shape == (b, size, size)
    return x.numpy(), it.numpy(), np.asarray(xj), np.asarray(ij)


@pytest.mark.parametrize('kw', [dict(max_iter=12),
                                dict(max_iter=10, max_backtracks=0,
                                     stop_criterion=1)],
                         ids=['jax_test_case', 'no_backtracking'])
def test_small_case_matches_jax_kernel(kw):
    """tests/test_pallas_solver.py's case (16x16, B=4, max_iter=12, stop
    rule 3), and the max_backtracks == 0 branch: equal iterations, x to
    5e-4 of max|x|."""
    x, it, xj, ij = _against_jax(4, 16, **kw)
    np.testing.assert_array_equal(it, ij)
    assert np.abs(x - xj).max() / np.abs(xj).max() <= 5e-4


def test_stop_rule_1_matches_jax_kernel_lane_by_lane():
    """31x31, B=64, 20 iterations on every lane. Late iterations take their
    BB steplength from sums that cancel, so float32 rounding moves a few
    lanes' paths: on one lane of this batch the plain version lies 1.1e-2
    from its own float64 solution (1.2e-2 from JAX's kernel), while JAX's
    two float32 paths lie within 2e-4 of it and the plain version solved
    alone within 1e-4. The other lanes agree to 9e-4. Run this file as a
    script for the spread over more seeds."""
    x, it, xj, ij = _against_jax(64, 31, max_iter=20, stop_criterion=1)
    assert (it == 20).all() and (ij == 20).all()
    rel = _lane_rel(x, xj)
    assert np.median(rel) <= 2e-4
    assert np.percentile(rel, 95) <= 2e-3
    assert rel.max() <= 2e-2


def test_stop_rule_3_iteration_distribution_matches_jax_kernel():
    """31x31, B=64, bench tolerance: f32 stop points move with summation
    order, so the iteration counts compare as distributions."""
    _, it, _, ij = _against_jax(64, 31, max_iter=100)
    assert np.median(it) == np.median(ij)
    assert np.abs(it.astype(int) - ij).mean() <= 1.0


@pytest.mark.parametrize('b,size', [(8, 16), (16, 31)])
def test_float64_matches_general_solvers(b, size):
    """In float64 the whole-solver path, the port's general solve and
    JAX's restore_stamps(flatten=True) take the same per-lane schedules."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.parallel.batch import restore_stamps as jax_restore
    stamps, psf, bkgs, fluxes = _stamps(b, size)
    kw = dict(SCOPE, max_iter=40, dtype='float64', track_discr=False,
              projection_method='pallas')
    cfg = tsgp.SGPConfig(**kw)
    x, it = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg,
                                device='cpu')
    general = tsgp.solve(stamps, psf, bkgs, None, fluxes, None, 1.0, 1e-3,
                         SAT, cfg, device='cpu')
    ref = jax_restore(stamps, psf, bkgs, JaxConfig(**kw), fluxes=fluxes,
                      sat_level=SAT, flatten=True)
    np.testing.assert_array_equal(it.numpy(), general.iters.numpy())
    np.testing.assert_array_equal(it.numpy(), np.asarray(ref.iters))
    assert _lane_rel(x.numpy(), general.x.numpy()).max() <= 1e-8
    assert _lane_rel(x.numpy(), np.asarray(ref.x)).max() <= 1e-8


@pytest.mark.parametrize('bad', [
    dict(divergence='beta'), dict(init_recon=3), dict(proj_type=0),
    dict(has_flux=False), dict(has_sat_level=False), dict(scale_data=False),
    dict(m_mem=2), dict(m_alpha=2), dict(stop_criterion=2)])
def test_out_of_scope_configs_raise(bad):
    stamps, psf, bkgs, fluxes = _stamps(2, 16)
    cfg = tsgp.SGPConfig(**dict(SCOPE, max_iter=5, **bad))
    key = next(iter(bad))
    with pytest.raises(ValueError, match=key):
        solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg,
                            device='cpu')


def test_stamps_above_the_dense_limit_raise():
    stamps, psf, bkgs, fluxes = _stamps(1, 65)     # 4225 > 4096 pixels
    with pytest.raises(ValueError, match='4096'):
        solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT,
                            tsgp.SGPConfig(**SCOPE), device='cpu')


def test_backgrounds_per_pixel_and_tensors_stay_on_their_device():
    """(B, H, W) backgrounds equal broadcast (B,) ones; a CPU tensor
    computes on the CPU with no device named; the wrapper on CPU tensors
    is the plain version, bit for bit, and launches nothing."""
    stamps, psf, bkgs, fluxes = _stamps(3, 16)
    cfg = tsgp.SGPConfig(**dict(SCOPE, max_iter=8))
    before = launches['solve_rows']
    x, it = solve_stamps_pallas(torch.as_tensor(stamps), psf, bkgs, fluxes,
                                SAT, cfg)
    per_pixel = np.repeat(bkgs, 256).reshape(stamps.shape)
    x2, it2 = solve_stamps_pallas(stamps, psf, per_pixel, fluxes, SAT, cfg,
                                  device='cpu')
    assert x.device.type == 'cpu' and launches['solve_rows'] == before
    assert torch.equal(x, x2) and torch.equal(it, it2)
    rows = stamp_rows(stamps, psf, bkgs, fluxes, SAT, torch.float32,
                      torch.device('cpu'))
    got, want = solve_rows(*rows, cfg), solve_rows_plain(*rows, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0].reshape(3, 16, 16), x)


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames (so rebuilds) every library."""
    from tpu_sgp_torch.kernels import _build
    (tmp_path / 'stamp_solver.cu').write_text('#include "reduce.cuh"\n')
    (tmp_path / 'reduce.cuh').write_text('// v1\n')
    monkeypatch.setattr(_build, '_CSRC', tmp_path)
    before = _build.library_path('stamp_solver')
    (tmp_path / 'reduce.cuh').write_text('// v2\n')
    assert _build.library_path('stamp_solver') != before


def _entry_calls():
    stamps, psf, bkgs, fluxes = _stamps(2, 16)
    cfg = tsgp.SGPConfig(**dict(SCOPE, max_iter=3,
                                projection_method='pallas'))
    args = (stamps, psf, bkgs, None, fluxes, None, 1.0, 1e-3, SAT)
    state = {k: np.zeros(2) for k in tsgp.SGPState._fields}
    return {
        'restore_stamps': lambda: tsgp.restore_stamps(
            stamps, psf, bkgs, cfg, fluxes=fluxes, sat_level=SAT),
        'solve': lambda: tsgp.solve(*args, cfg),
        'solve_with_state': lambda: tsgp.solve_with_state(*args, cfg),
        'resume_from_state': lambda: tsgp.resume_from_state(
            *args, None, cfg),
        'state_from_numpy': lambda: state_from_numpy(state),
        'solve_stamps_pallas': lambda: solve_stamps_pallas(
            stamps, psf, bkgs, fluxes, SAT, cfg),
    }


@pytest.mark.parametrize('entry', ['restore_stamps', 'solve',
                                   'solve_with_state', 'resume_from_state',
                                   'state_from_numpy',
                                   'solve_stamps_pallas'])
def test_numpy_call_naming_no_device_does_not_run_on_the_cpu(entry):
    """Entry points compute on the card unless the caller asks for the
    CPU; without a card they raise rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the call would compute there')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _entry_calls()[entry]()


@pytest.mark.parametrize('h,w', [(7, 7), (16, 16), (5, 9), (31, 31)])
def test_operator_plain_matches_jax_operator(h, w):
    """The operator entry's plain twin, (AT A)^2 x over (B, N) rows, against
    JAX's dense circulant operator (make_matmul_flat_operator) on the
    same psf, float64."""
    import jax.numpy as jnp
    from tpu_sgp.ops.psf_operator import make_matmul_flat_operator
    rng = np.random.default_rng(h * w)
    psf = rng.random((h, w))
    psf /= psf.sum()
    x = rng.random((3, h * w))
    A, AT = make_matmul_flat_operator(jnp.asarray(psf))
    want = np.stack([np.asarray(AT(A(AT(A(jnp.asarray(r))))))
                     for r in x])
    taps = torch.fft.fftshift(torch.as_tensor(psf))
    got = apply_operator(torch.as_tensor(x), taps, 2)
    assert torch.equal(got, apply_operator_plain(torch.as_tensor(x), taps, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


# one stamp shape a route the plan adds to the square stamps' (TcPatch in
# float32, Patch<double> in float64): TcPatch transposed, Patch<float>,
# Patch<float> transposed, Patch<double> transposed
ROUTE_SHAPES = [('float32', (240, 17)), ('float32', (4, 1024)),
                ('float32', (2048, 2)), ('float64', (240, 17))]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize('h,w', [(7, 7), (16, 16), (5, 9), (31, 31),
                                 (40, 40), (64, 64), (63, 65), (240, 17),
                                 (4, 1024), (2048, 2)])
def test_operator_matches_dense_product_on_card(dtype, tol, h, w):
    """The kernel's operator alone, (AT A) x, against the dense circulant
    product: only the order of the sums differs (float32 on the tensor
    cores in three TF32 products). 5x9 and 7x7 leave part of a 2x4 patch
    and of a 16x16 tile outside the stamp; 40x40 and 64x64 take 256 and
    512 threads a block in float64, 288 and 512 in float32; 63x65, 4095
    pixels, pads its 16x16 tiles on both sides; 240x17, 4x1024 and 2048x2
    take the plan's other routes (float64 4x1024 and 2048x2 fit no block
    and raise before the launch)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(h + w)
    psf = rng.random((h, w))
    psf /= psf.sum()
    x = torch.as_tensor(rng.random((5, h * w)), dtype=dtype, device='cuda')
    taps = torch.fft.fftshift(torch.as_tensor(psf, dtype=dtype,
                                              device='cuda')).contiguous()
    if dtype == torch.float64 and (h, w) in ((4, 1024), (2048, 2)):
        with pytest.raises(ValueError, match='fit no block'):
            apply_operator(x, taps, 1)
        return
    got = apply_operator(x, taps, 1)
    want = apply_operator_plain(x, taps, 1)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / x.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,size,b', [
    ('float64', 31, 48), ('float32', 31, 48),
    # stamps narrower than a row of 2x4 patches, and one whose width is
    # not a multiple of 4
    ('float64', 7, 16), ('float32', 7, 16),
    ('float64', 16, 16), ('float32', 16, 16),
    # 256 and 512 threads a block, above 48 KB of dynamic shared memory
    ('float64', 40, 8), ('float64', 64, 4)] + [
    pytest.param(dtype, shape, 8, id=f'{dtype}-{shape[0]}x{shape[1]}-8')
    for dtype, shape in ROUTE_SHAPES])
def test_kernel_matches_plain_on_card(dtype, size, b):
    """One launch solves the batch, on the route the plan picks; float64
    lane for lane, float32 with stop rule 1 at 20 iterations lane by
    lane."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    if isinstance(size, tuple):
        stamps, psf, bkgs, fluxes = shaped_star_stamps(b, *size, seed=7)
    else:
        stamps, psf, bkgs, fluxes = _stamps(b, size, seed=7)
    kw = dict(SCOPE, dtype=dtype, max_iter=100)
    if dtype == 'float32':
        kw.update(stop_criterion=1, max_iter=20)
    cfg = tsgp.SGPConfig(**kw)
    route = stamp_solver_plan(*psf.shape, cfg.torch_dtype).route
    before = launches['solve_rows']
    on_route = launches[f'solve_rows/{route}']
    x, it = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg)
    assert x.is_cuda and launches['solve_rows'] == before + 1
    assert launches[f'solve_rows/{route}'] == on_route + 1
    rows = stamp_rows(stamps, psf, bkgs, fluxes, SAT, cfg.torch_dtype,
                      torch.device('cuda'))
    xp, ip = solve_rows_plain(*rows, cfg)
    torch.cuda.synchronize()
    rel = _lane_rel(x.reshape(b, -1).cpu().numpy(), xp.cpu().numpy())
    np.testing.assert_array_equal(it.cpu().numpy(), ip.cpu().numpy())
    readings = (f'median {np.median(rel):.3e} p95 '
                f'{np.percentile(rel, 95):.3e} max {rel.max():.3e}')
    if dtype == 'float64':
        assert rel.max() <= 1e-7, readings
    else:
        # chip_smoke.py's median and p95 limits for this comparison (its
        # phase 6), and its earlier max, which this batch keeps on every
        # route
        assert (np.median(rel) <= 2e-4 and np.percentile(rel, 95) <= 2e-3
                and rel.max() <= 5e-3), readings


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    stamps, psf, bkgs, fluxes = _stamps(4, 16)
    cfg = tsgp.SGPConfig(**dict(SCOPE, max_iter=3))
    gn, bkg, flux, sat, taps = stamp_rows(stamps, psf, bkgs, fluxes, SAT,
                                          torch.float32, torch.device('cuda'))
    with pytest.raises(ValueError, match='contiguous'):
        solve_rows(gn, bkg.T.contiguous().T, flux, sat, taps, cfg)
    with pytest.raises(TypeError, match='bkg'):
        solve_rows(gn, bkg.double(), flux, sat, taps, cfg)
    with pytest.raises(TypeError, match='float32 or float64'):
        solve_rows(gn.half(), bkg.half(), flux.half(), sat.half(),
                   taps.half(), cfg)
    with pytest.raises(ValueError, match='shape'):
        solve_rows(gn, bkg, flux[:3], sat, taps, cfg)
    # 4 x 1024: float32's 16x16 tiles pad it to 64 tiles, 2048 threads, in
    # either orientation, so it takes Patch<float> on the FP32 pipes and
    # agrees with the plain version; float64's Patch needs more shared
    # memory than a block has in either orientation, so it raises before
    # the launch
    cfg1 = tsgp.SGPConfig(**dict(SCOPE, stop_criterion=1, max_iter=20))
    rows = stamp_rows(*shaped_star_stamps(4, 4, 1024, seed=5), SAT,
                      torch.float32, torch.device('cuda'))
    before = launches['solve_rows']
    x, it = solve_rows(*rows, cfg1)
    xp, ip = solve_rows_plain(*rows, cfg1)
    assert launches['solve_rows'] == before + 1
    assert launches['solve_rows/Patch<float>'] >= 1
    assert torch.equal(it, ip)
    # within test_kernel_matches_plain_on_card's max
    rel = _lane_rel(x.cpu().numpy(), xp.cpu().numpy())
    assert rel.max() <= 5e-3, rel
    with pytest.raises(ValueError, match='4x1024'):
        solve_rows(*(t.double() for t in rows),
                   tsgp.SGPConfig(**dict(SCOPE, dtype='float64')))
    assert launches['solve_rows'] == before + 1


def f32_spread_report(seeds=(3, 4, 5, 6), repeats=2):
    """Print how far the float32 stop-rule-1 solutions (31x31, B=64,
    max_iter=20) lie from one another: the port's plain version, JAX's
    kernel (interpret mode), JAX's general restore_stamps(flatten=True),
    each against the others and against the port's plain version in
    float64. Each seed runs ``repeats`` times; a run that differs from the
    first is reported. Per line: median, 95th percentile and max of the
    per-lane max|dx|/max|x|, and the lane of the max."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.experimental.pallas_batch import solve_stamps_pallas as jsp
    from tpu_sgp.parallel.batch import restore_stamps as jax_restore
    kw = dict(SCOPE, max_iter=20, stop_criterion=1)
    jcfg = JaxConfig(**kw, projection_method='pallas')
    cfg = config_from_jax(dataclasses.asdict(JaxConfig(**kw)))
    cfg64 = tsgp.SGPConfig(**dict(kw, dtype='float64'))
    for seed in seeds:
        stamps, psf, bkgs, fluxes = _stamps(64, 31, seed)
        runs = []
        for _ in range(repeats):
            xj = np.asarray(jsp(stamps, psf, bkgs, fluxes, SAT, jcfg)[0])
            xg = np.asarray(jax_restore(stamps, psf, bkgs, jcfg,
                                        fluxes=fluxes, sat_level=SAT,
                                        flatten=True).x)
            xp = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg,
                                     device='cpu')[0].numpy()
            runs.append((xp, xj, xg))
        x64 = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg64,
                                  device='cpu')[0].numpy()
        same = all(all(np.array_equal(a, b) for a, b in zip(r, runs[0]))
                   for r in runs[1:])
        print(f'seed {seed}: {repeats} runs bit-identical: {same}')
        xp, xj, xg = runs[0]
        for name, got, want in (('plain32 vs jax_kernel32', xp, xj),
                                ('plain32 vs jax_general32', xp, xg),
                                ('jax_kernel32 vs jax_general32', xj, xg),
                                ('plain32 vs plain64', xp, x64),
                                ('jax_kernel32 vs plain64', xj, x64),
                                ('jax_general32 vs plain64', xg, x64)):
            rel = _lane_rel(got, want)
            print(f'  {name}: median {np.median(rel):.3e} p95 '
                  f'{np.percentile(rel, 95):.3e} max {rel.max():.3e} '
                  f'(lane {int(rel.argmax())})')
        # the plain version's worst lane against float64, and that lane
        # solved alone (a batch of one takes another matmul's rounding)
        lane = int(_lane_rel(xp, x64).argmax())
        alone = solve_stamps_pallas(
            stamps[lane:lane + 1], psf, bkgs[lane:lane + 1],
            fluxes[lane:lane + 1], SAT, cfg, device='cpu')[0].numpy()
        one = lambda x: _lane_rel(x[lane:lane + 1], x64[lane:lane + 1])[0]
        print(f'  lane {lane} vs plain64: plain32 {one(xp):.3e}, '
              f'jax_kernel32 {one(xj):.3e}, jax_general32 {one(xg):.3e}, '
              f'plain32 solved alone '
              f'{_lane_rel(alone, x64[lane:lane + 1])[0]:.3e}')


if __name__ == '__main__':
    # JAX on the CPU with float64 enabled, as tests/conftest.py sets it:
    #     PYTHONPATH=. python tests/test_torch_stamp_solver.py
    import os
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_enable_x64', True)
    f32_spread_report()
