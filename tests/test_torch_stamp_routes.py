"""The whole-solver kernel's routes (kernel K2, ``kernels/stamp_solver.py``):
the launch plan that picks the operator's design and the stamps'
orientation from the shape before a launch, the transposed solve it takes
for some shapes, and non-square stamps against JAX's kernel.

The kernel itself runs on a card only (``tests/test_torch_stamp_solver.py``
and ``chip_smoke.py`` phase 42 hold every route against its plain version
there); these tests run the plan, and the plain version through the same
transposition the wrapper applies. The ``cuda`` ones hold the plan to the
C entries' own blocks and solve an empty batch on a transposed route.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_sgp_torch as tsgp
from tpu_sgp_torch.convert import config_from_jax
from tpu_sgp_torch.experimental.pallas_batch import (solve_stamps_pallas,
                                                     stamp_rows)
from tpu_sgp_torch.kernels import launches
from tpu_sgp_torch.kernels.stamp_solver import (MAX_PIXELS, MAX_THREADS,
                                                SMEM_PER_BLOCK, apply_operator,
                                                card_block, route_plan,
                                                solve_rows, solve_rows_plain,
                                                solve_transposed,
                                                stamp_solver_plan)
from tpu_sgp_torch.simulate import shaped_star_stamps

SAT = 65000.0
F32, F64 = torch.float32, torch.float64
# the solver's static reduction buffer, red[2][8][32] of the element type
STATIC = {F32: 2 * 8 * 32 * 4, F64: 2 * 8 * 32 * 8}
NON_SQUARE = [(8, 40), (40, 8), (4, 130)]


@pytest.mark.parametrize('h,w,dtype,design,transposed', [
    (31, 31, F32, 'TcPatch', False),
    (420, 9, F32, 'TcPatch', True),
    (240, 17, F32, 'TcPatch', True),
    (4, 1024, F32, 'Patch', False),
    (5, 800, F32, 'Patch', False),
    (2048, 2, F32, 'Patch', True),
    (31, 31, F64, 'Patch', False),
    (240, 17, F64, 'Patch', True)])
def test_plan_picks_the_route(h, w, dtype, design, transposed):
    plan = stamp_solver_plan(h, w, dtype)
    assert (plan.design, plan.transposed) == (design, transposed)
    assert plan.threads <= MAX_THREADS
    assert plan.smem + STATIC[dtype] <= SMEM_PER_BLOCK


def test_main_path_keeps_its_instantiation():
    """31x31 float32 keeps the tensor cores' block as built: 4 warps and a
    tap row of 32, which by_shape fixes at compile time
    (solve_stamps_kernel<f,128,32,1>), 2 x 31 x 64 + 4 x 31 x 36 floats of
    shared memory."""
    plan = stamp_solver_plan(31, 31, F32)
    assert (plan.design, plan.transposed, plan.threads, plan.pitch,
            plan.smem) == ('TcPatch', False, 128, 32,
                           (2 * 31 * 64 + 4 * 31 * 36) * 4)
    assert plan.route == 'TcPatch'


def test_float64_shape_that_fits_no_block_raises_naming_it():
    with pytest.raises(ValueError, match=r'4x1024.*shared memory'):
        stamp_solver_plan(4, 1024, F64)
    with pytest.raises(ValueError, match='4096'):
        stamp_solver_plan(65, 65, F32)


def test_plan_takes_the_cards_shared_memory():
    """A card with less shared memory a block than the H100 moves a
    shape to another route, or refuses it naming that card's limit."""
    assert stamp_solver_plan(240, 17, F32).design == 'TcPatch'
    small = stamp_solver_plan(240, 17, F32, smem_limit=131072)
    assert (small.design, small.transposed) == ('Patch', False)
    assert small.smem + STATIC[F32] <= 131072
    with pytest.raises(ValueError, match=r'31x31.*limit 49152'):
        stamp_solver_plan(31, 31, F64, smem_limit=49152)


def test_every_shape_up_to_the_dense_limit_has_its_route():
    """All 34720 (H, W) with H*W <= 4096. float32: every one has a route,
    the first of the order whose block fits. float64: a shape raises
    exactly where Patch fits neither orientation. The counts by route are
    those of the layouts' formulas (TcLayout and Layout in
    csrc/stamp_solver.cu) under 1024 threads and 232448 B a block."""
    order32 = [('TcPatch', False), ('TcPatch', True), ('Patch', False),
               ('Patch', True)]
    count32, count64, shapes = {}, {}, 0
    for h in range(1, MAX_PIXELS + 1):
        for w in range(1, MAX_PIXELS // h + 1):
            shapes += 1
            plan = stamp_solver_plan(h, w, F32)
            first = order32.index((plan.design, plan.transposed))
            assert all(route_plan(d, t, h, w, F32)[0] is None
                       for d, t in order32[:first]), (h, w)
            assert plan.threads <= MAX_THREADS and \
                plan.smem + STATIC[F32] <= SMEM_PER_BLOCK, (h, w)
            count32[plan.route] = count32.get(plan.route, 0) + 1
            fits = [route_plan('Patch', t, h, w, F64)[0]
                    for t in (False, True)]
            if any(fits):
                plan = stamp_solver_plan(h, w, F64)
                assert plan == next(p for p in fits if p), (h, w)
                key = plan.route
            else:
                with pytest.raises(ValueError):
                    stamp_solver_plan(h, w, F64)
                assert min(h, w) <= 5, (h, w)
                key = 'raises'
            count64[key] = count64.get(key, 0) + 1
    assert shapes == 34720
    assert count32 == {'TcPatch': 19641, 'TcPatch transposed': 1009,
                       'Patch<float>': 11524,
                       'Patch<float> transposed': 2546}
    assert count64 == {'Patch<double>': 26718,
                       'Patch<double> transposed': 3594, 'raises': 4408}


@pytest.mark.parametrize('h,w', NON_SQUARE)
def test_transposed_solve_equals_the_direct_one(h, w):
    """The wrapper's transposition around the plain version: the stamps'
    transposes with the transposed taps give the stamps' solve, float64,
    stop rule 3, lane for lane: equal iterations, x within 1e-9 of max|x|
    (only the sums' order differs; up to 4.8e-11 after 20-40 iterations
    here)."""
    stamps, psf, bkgs, fluxes = shaped_star_stamps(8, h, w, seed=5)
    rows = stamp_rows(stamps, psf, bkgs, fluxes, SAT, F64,
                      torch.device('cpu'))
    cfg = tsgp.SGPConfig(stop_criterion=3, tol_convergence=1e-4,
                         max_iter=100, init_recon=2, proj_type=1,
                         has_flux=True, has_sat_level=True, dtype='float64')
    x, it = solve_rows_plain(*rows, cfg)
    xt, itt = solve_transposed(solve_rows_plain, *rows, cfg)
    assert xt.shape == x.shape and xt.is_contiguous()
    np.testing.assert_array_equal(itt.numpy(), it.numpy())
    assert (it > 1).all()
    rel = (xt - x).abs().amax(1) / x.abs().amax(1)
    assert float(rel.max()) <= 1e-9


@pytest.mark.parametrize('h,w', NON_SQUARE)
def test_non_square_stamps_match_jax_kernel(h, w):
    """Non-square stamps through JAX's kernel (interpret mode) and the
    port's plain version, directly and through the transposition, float32,
    stop rule 1 at 15 iterations: equal iterations, x within 5e-4 of
    max|x| of JAX's (test_small_case_matches_jax_kernel's bar) and of the
    plain version in float64."""
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.experimental.pallas_batch import solve_stamps_pallas as jsp
    stamps, psf, bkgs, fluxes = shaped_star_stamps(4, h, w, seed=5)
    jcfg = JaxConfig(stop_criterion=1, max_iter=15, init_recon=2,
                     proj_type=1, has_flux=True, has_sat_level=True,
                     dtype='float32')
    xj, ij = (np.asarray(v) for v in jsp(stamps, psf, bkgs, fluxes, SAT,
                                          jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    x, it = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT, cfg,
                                device='cpu')
    assert x.shape == (4, h, w) and x.dtype == F32
    rows = stamp_rows(stamps, psf, bkgs, fluxes, SAT, F32,
                      torch.device('cpu'))
    xt, itt = solve_transposed(solve_rows_plain, *rows, cfg)
    x64 = solve_stamps_pallas(stamps, psf, bkgs, fluxes, SAT,
                              dataclasses.replace(cfg, dtype='float64'),
                              device='cpu')[0].numpy()
    far = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert far(xj, x64) <= 5e-4
    for got, iters in ((x.numpy(), it), (xt.reshape(4, h, w).numpy(), itt)):
        np.testing.assert_array_equal(iters.numpy(), ij)
        assert far(got, xj) <= 5e-4
        assert far(got, x64) <= 5e-4


def test_transposed_solve_of_no_stamps():
    """An empty batch goes through the transposition as through the direct
    solve: no rows out, in the stamps' shape."""
    h, w = 240, 17
    rows = stamp_rows(*shaped_star_stamps(1, h, w, seed=5), SAT, F32,
                      torch.device('cpu'))
    empty = [t[:0] for t in rows[:4]] + [rows[4]]
    cfg = tsgp.SGPConfig(stop_criterion=1, max_iter=5, init_recon=2,
                         proj_type=1, has_flux=True, has_sat_level=True)
    x, it = solve_transposed(solve_rows_plain, *empty, cfg)
    assert tuple(x.shape) == (0, h * w) and tuple(it.shape) == (0,)


@pytest.mark.cuda
def test_no_stamps_on_a_transposed_route_on_card():
    """B=0 at 240x17 (TcPatch transposed in float32, Patch<double>
    transposed in float64): solve_rows and apply_operator return empty
    results and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    for dtype in (F32, F64):
        empty = torch.empty(0, 240 * 17, dtype=dtype, device='cuda')
        lanes = torch.empty(0, dtype=dtype, device='cuda')
        taps = torch.full((240, 17), 1 / 4080, dtype=dtype, device='cuda')
        cfg = tsgp.SGPConfig(stop_criterion=1, max_iter=5, init_recon=2,
                             proj_type=1, has_flux=True, has_sat_level=True,
                             dtype=str(dtype).removeprefix('torch.'))
        assert stamp_solver_plan(240, 17, dtype).transposed
        before = launches['solve_rows']
        x, it = solve_rows(empty, empty, lanes, lanes, taps, cfg)
        assert tuple(x.shape) == (0, 4080) and tuple(it.shape) == (0,)
        assert launches['solve_rows'] == before
        assert tuple(apply_operator(empty, taps, 1).shape) == (0, 4080)


@pytest.mark.cuda
def test_plan_agrees_with_the_card_on_every_shape():
    """Every (H, W) with H*W <= 4096 and each design: the plan's block
    under the card's shared memory has the threads and bytes of the C
    entries' own layouts (card_block), or both refuse it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for h in range(1, MAX_PIXELS + 1):
        for w in range(1, MAX_PIXELS // h + 1):
            for design, dtype in (('TcPatch', F32), ('Patch', F32),
                                  ('Patch', F64)):
                plan = route_plan(design, False, h, w, dtype, limit)[0]
                card = card_block(design, h, w, dtype)
                want = plan and (plan.threads, plan.smem)
                got = card and (card['threads'], card['smem'])
                assert want == got, (design, dtype, h, w)
