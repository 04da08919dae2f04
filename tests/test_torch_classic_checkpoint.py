"""The port's classic solvers (Richardson-Lucy, Wiener), its checkpoints
and its per-stamp PSFs against the JAX package's, float64 on the CPU. A
checkpoint written by either package resumes in the other to the
uninterrupted solve."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgp import SGPConfig as JaxConfig
from tpu_sgp.parallel import batch as jbatch
from tpu_sgp.solvers import checkpoint as jckpt
from tpu_sgp.solvers import classic as jclassic
from tpu_sgp.solvers import sgp as jsgp
import tpu_sgp_torch as tsgp
from tpu_sgp_torch.simulate import (gaussian_psf, synthetic_star_field,
                                    synthetic_star_stamps)
from tpu_sgp_torch.solvers import checkpoint as tckpt

BKG = 150.0


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _frame():
    return synthetic_star_field(40, 36, n_stars=6, psf_size=9, fwhm=3.0,
                                seed=9)


@pytest.mark.parametrize('operator,shape', [('linear', None), ('otf', 24),
                                            ('matmul', 16)])
def test_richardson_lucy_matches_jax(operator, shape):
    """One image and a batch of 3, within 1e-10 of max|x|."""
    if shape is None:
        img, psf, _ = _frame()
    else:
        stamps, psf, _, _ = synthetic_star_stamps(1, size=shape, seed=4)
        img = stamps[0]
    bkg = BKG if shape is None else 120.0
    want = jclassic.richardson_lucy(jnp.asarray(img), jnp.asarray(psf), bkg,
                                    n_iters=12, operator=operator)
    got = tsgp.richardson_lucy(img, psf, bkg, n_iters=12, operator=operator,
                               device='cpu')
    assert got.shape == img.shape and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-10
    batch = np.stack([img, img * 1.5, img[::-1].copy()])
    bkgs = np.array([bkg, bkg * 1.5, bkg])
    got_b = tsgp.richardson_lucy(torch.as_tensor(batch), psf, bkgs,
                                 n_iters=12, operator=operator)
    for i in range(3):
        want_i = jclassic.richardson_lucy(jnp.asarray(batch[i]),
                                          jnp.asarray(psf), bkgs[i],
                                          n_iters=12, operator=operator)
        assert _rel(got_b[i].numpy(), want_i) <= 1e-10


def test_richardson_lucy_oversubtracted_background_starts_at_data_scale():
    img, psf, _ = _frame()
    bkg = float(img.mean()) * 2.0
    want = jclassic.richardson_lucy(jnp.asarray(img), jnp.asarray(psf), bkg,
                                    n_iters=3)
    got = tsgp.richardson_lucy(img, psf, bkg, n_iters=3, device='cpu')
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-300)


@pytest.mark.parametrize('shape', [(24, 24), (25, 31)])
def test_wiener_matches_jax(shape):
    """A scalar and a per-frequency noise-to-signal ratio; odd widths."""
    rng = np.random.default_rng(12)
    psf = rng.uniform(0.1, 1.0, shape)
    psf /= psf.sum()
    img = rng.uniform(0.0, 100.0, shape)
    nsr_map = rng.uniform(1e-3, 1e-2, (shape[0], shape[1] // 2 + 1))
    for nsr in (1e-3, nsr_map):
        want = jclassic.wiener(jnp.asarray(img), jnp.asarray(psf),
                               jnp.asarray(nsr))
        got = tsgp.wiener(img, psf, nsr, device='cpu')
        assert got.shape == shape
        assert _rel(got.numpy(), want) <= 1e-10
    batch = np.stack([img, img[::-1].copy()])
    got_b = tsgp.wiener(batch, psf, device='cpu')
    np.testing.assert_allclose(got_b[0].numpy(),
                               tsgp.wiener(img, psf, device='cpu').numpy(),
                               rtol=1e-12, atol=1e-12)
    assert tsgp.wiener(img.astype(np.float32), psf,
                       device='cpu').dtype == torch.float32


CFG = dict(max_iter=24, stop_criterion=3, tol_convergence=1e-7, init_recon=2,
           proj_type=1, has_flux=False, has_sat_level=False, dtype='float64',
           track_discr=True, warm_projection=True)


def _jax_args(img, psf):
    z = jnp.zeros(img.shape)
    return (jnp.asarray(img), jnp.asarray(psf), jnp.full(img.shape, BKG), z,
            0.0, z, 1.0, 1e-3, 0.0)


def _port_args(img, psf):
    z = np.zeros((1,) + img.shape)
    return (img[None], psf, np.full((1,) + img.shape, BKG), z, 0.0, z, 1.0,
            1e-3, 0.0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A single-image npz written by the JAX package after 9 iterations
    resumes in the port to the uninterrupted solve."""
    img, psf, _ = _frame()
    full = jsgp.solve(*_jax_args(img, psf), JaxConfig(**CFG))
    _, st = jsgp.solve_with_state(*_jax_args(img, psf),
                                  JaxConfig(**dict(CFG, max_iter=9)))
    path = str(tmp_path / 'jax_state')
    jckpt.save_state(path, st)
    state = tckpt.load_state(path, device='cpu')
    assert state.x.shape == (1,) + img.shape and state.fv.shape == (1,)
    assert int(state.it[0]) == 10
    res, _ = tsgp.resume_from_state(*_port_args(img, psf), state,
                                    tsgp.SGPConfig(**CFG), device='cpu')
    assert int(res.iters[0]) == int(full.iters) > 9
    assert _rel(res.x[0].numpy(), full.x) <= 1e-9
    np.testing.assert_allclose(res.discr[0].numpy(), np.asarray(full.discr),
                               rtol=1e-9, atol=1e-12)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's npz (batched, B=1) resumes in the JAX package under vmap
    to the uninterrupted solve, and has the JAX layout field for field."""
    img, psf, _ = _frame()
    full = jsgp.solve(*_jax_args(img, psf), JaxConfig(**CFG))
    _, st = tsgp.solve_with_state(*_port_args(img, psf),
                                  tsgp.SGPConfig(**dict(CFG, max_iter=9)),
                                  device='cpu')
    path = str(tmp_path / 'port_state.npz')
    tckpt.save_state(path, st, image_shape=img.shape)
    with np.load(path) as z:
        assert tuple(z.files) == jsgp.SGPState._fields
        assert z['x'].shape == z['g'].shape == (1,) + img.shape
    jstate = jckpt.load_state(path)
    cfg = JaxConfig(**CFG)
    args = _jax_args(img, psf)
    batched = [a[None] if hasattr(a, 'shape') and a.ndim else a
               for a in args]
    in_axes = [0 if hasattr(a, 'shape') and a.ndim else None for a in args]
    res, _ = jax.vmap(
        lambda *a: jsgp.resume_from_state(*a[:-1], a[-1], cfg),
        in_axes=(*in_axes, 0))(*batched, jstate)
    assert int(res.iters[0]) == int(full.iters)
    assert _rel(res.x[0], full.x) <= 1e-9


def test_checkpoint_without_warm_fields_and_orbax(tmp_path):
    """A checkpoint from before the warm-projection carry loads with a
    cold carry; orbax raises (it is JAX-only); unknown backends raise."""
    img, psf, _ = _frame()
    _, st = tsgp.solve_with_state(*_port_args(img, psf),
                                  tsgp.SGPConfig(**dict(CFG, max_iter=3)),
                                  device='cpu')
    old = {k: v.numpy() for k, v in zip(st._fields, st)
           if k not in ('lam_dual', 'dlam_dual')}
    path = str(tmp_path / 'old.npz')
    np.savez(path, **old)
    state = tckpt.load_state_npz(path, device='cpu')
    assert torch.isnan(state.lam_dual).all()
    assert torch.isinf(state.dlam_dual).all()
    assert state.x.dtype == torch.float64
    np.savez(path, **{k: v for k, v in old.items() if k != 'x_prev'})
    with pytest.raises(KeyError, match='x_prev'):
        tckpt.load_state_npz(path, device='cpu')
    with pytest.raises(NotImplementedError, match='JAX-only'):
        tckpt.save_state(path, st, backend='orbax')
    with pytest.raises(NotImplementedError, match='JAX-only'):
        tckpt.load_state(path, backend='orbax')
    with pytest.raises(ValueError, match='unknown checkpoint backend'):
        tckpt.load_state(path, backend='pickle')


@pytest.mark.parametrize('every', [12, 24, 100])
def test_solve_checkpointed_equals_uninterrupted(tmp_path, every):
    """Chunked equals uninterrupted, against the port's own solve and
    JAX's ``solve_checkpointed``; the last checkpoint on disk is the final
    state."""
    img, psf, _ = _frame()
    cfg = tsgp.SGPConfig(**CFG)
    want = tsgp.solve(*_port_args(img, psf), cfg, device='cpu')
    path = str(tmp_path / 'ckpt')
    res, state = tckpt.solve_checkpointed(*_port_args(img, psf), cfg,
                                          path=path, every=every,
                                          device='cpu')
    assert torch.equal(res.iters, want.iters)
    assert _rel(res.x.numpy(), want.x.numpy()) <= 1e-12
    saved = tckpt.load_state(path, device='cpu')
    assert saved.x.shape == (1,) + img.shape
    assert torch.equal(saved.x.reshape(1, -1), state.x)
    assert torch.equal(saved.it, state.it)
    if every == 12:
        res_j, _ = jckpt.solve_checkpointed(
            *_jax_args(img, psf), JaxConfig(**CFG),
            path=str(tmp_path / 'jax_ckpt'), every=every)
        assert int(res.iters[0]) == int(res_j.iters)
        assert _rel(res.x[0].numpy(), res_j.x) <= 1e-9
    with pytest.raises(ValueError, match='every must be'):
        tckpt.solve_checkpointed(*_port_args(img, psf), cfg, path=path,
                                 every=0, device='cpu')


@pytest.mark.parametrize('operator', ['auto', 'otf'])
def test_per_stamp_psfs_match_jax_restore_stamps(operator):
    """B=6 stamps, each with its own PSF width, through ``restore_stamps``
    with compaction (a tail of 2 gathers its lanes' PSFs): equal per-lane
    iterations and x within 1e-9 of JAX's."""
    stamps, _, bkgs, _ = synthetic_star_stamps(6, size=16, seed=13)
    psfs = np.stack([gaussian_psf(16, 2.2 + 0.3 * i) for i in range(6)])
    fluxes = stamps.sum(axis=(1, 2)) - 256 * bkgs
    cfg = dict(max_iter=40, stop_criterion=3, tol_convergence=1e-4,
               init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
               dtype='float64', track_discr=False, operator=operator)
    kw = dict(fluxes=fluxes, sat_level=65000.0)
    want = jbatch.restore_stamps(stamps, psfs, bkgs, JaxConfig(**cfg), **kw)
    got = tsgp.restore_stamps(stamps, psfs, bkgs, tsgp.SGPConfig(**cfg),
                              device='cpu', **kw)
    it = np.asarray(want.iters)
    np.testing.assert_array_equal(got.iters.numpy(), it)
    assert len(set(it.tolist())) > 1
    assert _rel(got.x.numpy(), want.x) <= 1e-9
    cap = int(np.sort(it)[2])
    two = tsgp.restore_stamps(stamps, psfs, bkgs, tsgp.SGPConfig(**cfg),
                              device='cpu', phase1_iters=cap, tail_bucket=2,
                              **kw)
    np.testing.assert_array_equal(two.iters.numpy(), it)
    assert _rel(two.x.numpy(), want.x) <= 1e-9
    shared = tsgp.restore_stamps(stamps, psfs[0], bkgs,
                                 tsgp.SGPConfig(**cfg), device='cpu', **kw)
    assert _rel(shared.x[0].numpy(), got.x[0].numpy()) <= 1e-9
    assert _rel(shared.x[5].numpy(), got.x[5].numpy()) > 1e-3
