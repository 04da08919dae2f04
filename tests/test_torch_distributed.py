"""The port's multi-device restoration against the JAX package on the CPU.

One world of four gloo ranks (``tests/_torch_spmd.py``, no JAX, one torch
thread a rank) runs every multi-rank case of the port in turn and hands
its results and inputs back as npz; the JAX side runs here on four of the
conftest's eight virtual CPU devices, as ``tests/test_distributed.py``
runs it. Everything is float64. The bars: equal iterations and x within
1e-9 relative (whole-frame float64 trajectories of the two packages part by
about 3e-11 after 25 iterations, ROADMAP "Limits").
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_sgp import SGPConfig as JaxConfig
from tpu_sgp.ops import reduce as jred
from tpu_sgp.ops.psf_operator import make_halo_operator as j_halo
from tpu_sgp.parallel import distributed as jdist
from tpu_sgp.solvers import checkpoint as jckpt
import tpu_sgp_torch as tsgp
from tpu_sgp_torch.ops.psf_operator import make_operator
from tpu_sgp_torch.parallel import distributed as tdist

from _torch_source_pin import REPO

sys.path.insert(0, os.path.join(REPO, 'tests'))
import _torch_spmd as spmd  # noqa: E402  (the world and its cases)

RTOL = 1e-9
WORLD = spmd.WORLD


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp('spmd')
    return spmd.run_world('distributed', out), out


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_mesh2():
    return jdist.make_image_mesh(devices=jax.devices()[:WORLD])


@pytest.mark.parametrize('name', ['gsum', 'gmax', 'gmin', 'gmean',
                                  'gsum_ff'])
def test_reductions_match_jax_under_shard_map(world, name):
    """Each rank reduces its (3, 8, 8) tiles and one collective combines
    the (3,) vector: JAX's psum / pmax / pmin under shard_map on the same
    2x2 tiling."""
    z, _ = world
    x = z['reduce_x']
    mesh = _jax_mesh2()
    fn = getattr(jred, name)

    def local(t):
        return jax.vmap(lambda u: fn(u, ('ty', 'tx')))(t)
    want = jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=P(None, 'ty', 'tx'),
                                 out_specs=P(), check_vma=False))(
        jax.device_put(jnp.asarray(x),
                       NamedSharding(mesh, P(None, 'ty', 'tx'))))
    np.testing.assert_allclose(z[f'reduce_{name}'], np.asarray(want),
                               rtol=1e-13)


def test_mesh_axes_gather_and_any(world):
    """all_gather returns the tiles in row-major mesh order (assembled:
    the input), ``any`` ORs a flag over the axes, and an axis of its own
    is one mesh dimension."""
    z, _ = world
    np.testing.assert_array_equal(z['reduce_whole'], z['reduce_x'])
    assert bool(z['reduce_any']) and not bool(z['reduce_none'])
    assert int(z['reduce_tx_size']) == 2
    assert tuple(z['mesh_2x2']) == (2, 2) and tuple(z['mesh_b']) == (2, 1, 2)


@pytest.mark.parametrize('psf_name', ['square', 'nonsquare'])
def test_halo_operator_matches_jax_and_linear(world, psf_name):
    """A and AT of the halo operator on a 2x2 and a 1x4 mesh (zero halos on
    the axis of size 1) equal the port's single-device 'linear' operator
    and, on the 2x2 mesh, JAX's halo operator; the 3x5 PSF checks the
    adjoint's swapped geometry."""
    z, _ = world
    y, psf = z['halo_y'], z[f'halo_psf_{psf_name}']
    A, AT = make_operator(torch.as_tensor(psf), y.shape[1:], 'linear')
    lin = {'A': A(torch.as_tensor(y)).numpy(),
           'AT': AT(torch.as_tensor(y)).numpy()}
    for mesh_name in ('2x2', '1x4'):
        for op in ('A', 'AT'):
            got = z[f'halo_{mesh_name}_{psf_name}_{op}']
            assert _rel(got, lin[op]) <= 1e-12, (mesh_name, op)

    mesh = _jax_mesh2()

    def local(t, p):
        JA, JAT = j_halo(p, ('ty', 'tx'))
        return jax.vmap(JA)(t), jax.vmap(JAT)(t)
    spec = P(None, 'ty', 'tx')
    ja, jat = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec, P()),
                                    out_specs=(spec, spec),
                                    check_vma=False))(
        jax.device_put(jnp.asarray(y), NamedSharding(mesh, spec)),
        jnp.asarray(psf))
    assert _rel(z[f'halo_2x2_{psf_name}_A'], ja) <= 1e-12
    assert _rel(z[f'halo_2x2_{psf_name}_AT'], jat) <= 1e-12


def test_halo_operator_rejects_even_psf():
    """An even PSF has no centre pixel: refused before any exchange."""
    from tpu_sgp_torch.ops.psf_operator import make_halo_operator
    with pytest.raises(ValueError, match='odd'):
        make_halo_operator(torch.ones(4, 5) / 20.0, (8, 8), axes=None)


@pytest.mark.parametrize('kind', ['kl', 'beta'])
def test_solve_distributed_matches_jax(world, kind):
    """The sharded whole-image solve on a 2x2 mesh, KL with flux and a
    saturation cap and beta with adaptation, both stopping early by rule
    3: equal iterations, x within 1e-9 of JAX's solve_distributed on the
    same 2x2 mesh, and the same x as JAX's single-device 'linear' solve."""
    z, _ = world
    img, psf = z[f'{kind}_img'], z[f'{kind}_psf']
    cfg = JaxConfig(**(spmd.KL if kind == 'kl' else spmd.BETA))
    kw = (dict(flux=float(z['kl_flux']), sat_level=65000.0) if kind == 'kl'
          else dict(beta0=1.01))
    want = jdist.solve_distributed(img, psf, 150.0, cfg, _jax_mesh2(), **kw)
    it = int(z[f'{kind}_res_iters'])
    assert it == int(want.iters) and it < cfg.max_iter
    assert _rel(z[f'{kind}_res_x'], want.x) <= RTOL
    assert z[f'{kind}_res_x'].shape == img.shape
    np.testing.assert_allclose(z[f'{kind}_res_beta'], float(want.beta),
                               rtol=RTOL)


def test_solve_distributed_batch_matches_jax(world):
    """Three 63x63 images on a (batch 2, ty 1, tx 2) mesh: the batch pads
    to four lanes and the images to 63x64; the batch groups run in
    lockstep (sync_axes) while each image keeps its own schedule."""
    z, _ = world
    imgs, psf = z['batch_imgs'], z['batch_psf']
    mesh = jdist.make_batch_image_mesh(batch=2, devices=jax.devices()[:4])
    want = jdist.solve_distributed_batch(imgs, psf, 150.0,
                                         JaxConfig(**spmd.KL), mesh,
                                         fluxes=z['batch_fluxes'],
                                         sat_level=65000.0)
    iters = z['batch_res_iters']
    np.testing.assert_array_equal(iters, np.asarray(want.iters))
    assert len(set(iters.tolist())) > 1 and iters.max() < spmd.KL['max_iter']
    assert z['batch_res_x'].shape == imgs.shape
    assert _rel(z['batch_res_x'], want.x) <= RTOL


def test_resume_on_another_geometry(world):
    """A 2x2 solve checkpointed at iteration 6, saved in the JAX package's
    single-image layout, resumed on a 1x4 mesh: the uninterrupted 12
    iterations. The JAX package resumes the port's checkpoint too, and a
    mismatched image is refused."""
    z, out = world
    assert tuple(z['resume_state_x_shape']) == (64, 64)
    assert int(z['resume_state_fv_ndim']) == 0
    assert int(z['resume_part_iters']) == 6
    assert int(z['resume_resumed_iters']) == int(z['resume_full_iters']) == 12
    assert _rel(z['resume_resumed_x'], z['resume_full_x']) <= 1e-12
    np.testing.assert_allclose(z['resume_resumed_discr'],
                               z['resume_full_discr'], rtol=1e-12)
    assert bool(z['resume_refused'])

    img, psf = z['resume_img'], z['resume_psf']
    state = jckpt.load_state(str(out / 'single_ckpt'))
    mesh = _jax_mesh2()
    resumed, _ = jdist.resume_distributed(
        img, psf, 150.0, state, JaxConfig(max_iter=12, **spmd.RESUME), mesh)
    full = jdist.solve_distributed(img, psf, 150.0,
                                   JaxConfig(max_iter=12, **spmd.RESUME),
                                   mesh)
    assert int(resumed.iters) == 12
    assert _rel(resumed.x, full.x) <= 1e-12
    assert _rel(z['resume_full_x'], full.x) <= RTOL


def test_batch_resume_on_another_geometry(world):
    """The (batch, ty, tx) form: beta with per-image beta0, checkpointed at
    iteration 5 on (2, 1, 2) and resumed on (2, 2, 1); against the
    uninterrupted port solve and JAX's."""
    z, _ = world
    assert tuple(z['bresume_state_x_shape']) == (4, 48, 48)
    np.testing.assert_array_equal(z['bresume_resumed_iters'],
                                  z['bresume_full_iters'])
    assert _rel(z['bresume_resumed_x'], z['bresume_full_x']) <= 1e-12
    np.testing.assert_allclose(z['bresume_resumed_beta'],
                               z['bresume_full_beta'], rtol=1e-12)
    base = dict(spmd.RESUME, divergence='beta', adapt_beta=True,
                schedule_lr=True)
    mesh = jdist.make_batch_image_mesh(batch=2, devices=jax.devices()[:4])
    want = jdist.solve_distributed_batch(
        z['bresume_gns'], z['bresume_psf'], 150.0,
        JaxConfig(max_iter=10, **base), mesh,
        beta0=np.array([1.0, 1.01, 0.99]))
    assert _rel(z['bresume_full_x'], want.x) <= RTOL
    np.testing.assert_allclose(z['bresume_full_beta'], np.asarray(want.beta),
                               rtol=RTOL)


@pytest.mark.parametrize('method', ['pallas', 'bisect'])
def test_restore_stamps_on_a_batch_mesh(world, method):
    """Ten stamps over a ('batch',) mesh of four ranks (padded to 12, a
    3-lane shard each, compaction on every rank's own lanes) against the
    unsharded call, lane for lane; with 'pallas' each rank runs the
    projection kernel's plain version on its shard."""
    z, _ = world
    got, want = (f'stamps_{method}_sharded', f'stamps_{method}_alone')
    np.testing.assert_array_equal(z[f'{got}_iters'], z[f'{want}_iters'])
    assert len(set(z[f'{got}_iters'].tolist())) > 1
    x, ref = z[f'{got}_x'], z[f'{want}_x']
    assert x.shape == ref.shape == (10, 16, 16)
    lane = np.abs(x - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert lane.max() <= RTOL


def test_session_on_a_batch_mesh(world):
    """RestorationSession(mesh=...) serves the same result as the
    unsharded session, on the mesh's device type."""
    z, _ = world
    assert str(z['session_device']) == 'cpu'
    np.testing.assert_array_equal(z['session_meshed_iters'],
                                  z['session_alone_iters'])
    assert _rel(z['session_meshed_x'], z['session_alone_x']) <= RTOL


def test_meshed_session_returns_full_precision_under_u16_egress(world):
    """A meshed session takes the plain path, as the JAX session does
    (``tpu_sgp/parallel/session.py:298-299``): with ``egress_dtype=
    'uint16'`` it returns x bit-equal to the f32-egress session, not
    quantised."""
    z, _ = world
    for field in ('x', 'iters', 'fv', 'beta', 'scaling'):
        np.testing.assert_array_equal(z[f'session_u16_{field}'],
                                      z[f'session_meshed_{field}'])


def test_micro_batch_server_on_a_batch_mesh(world):
    """MicroBatchServer over a meshed session: four client threads on the
    mesh's first rank submit at once; that rank forms each batch and ships
    it, and every request's result equals the unsharded session's, lane
    for lane. A request cancelled while queued is never shipped or
    solved; every follower serves the same batches, and closing on the
    first rank ended every rank's worker."""
    z, _ = world
    n = int(z['server_n'])
    for i in range(n):
        np.testing.assert_array_equal(z[f'server{i}_meshed_iters'],
                                      z[f'server{i}_alone_iters'])
        assert _rel(z[f'server{i}_meshed_x'], z[f'server{i}_alone_x']) \
            <= RTOL
    assert bool(z['server_cancelled'])
    np.testing.assert_array_equal(z['server_requests'], [n] * WORLD)
    batches = z['server_batches']
    assert 2 <= batches[0] <= n and (batches == batches[0]).all(), batches
    assert not z['server_alive'].any()


def test_micro_batch_server_takes_requests_on_the_first_rank_only(world):
    """A follower's ``submit`` raises ValueError naming the first rank."""
    z, _ = world
    refused = z['server_refused']
    assert refused[0] == ''
    assert all("mesh's first rank (global rank 0)" in e
               for e in refused[1:]), refused


@pytest.mark.parametrize('n', [1, 2, 3, 4, 5, 6, 7, 8])
def test_mesh_factorisation_matches_jax(n):
    """The near-square image grid and the (batch, ty, tx) rule, prime
    counts included, as JAX's make_image_mesh / make_batch_image_mesh
    factor the same device count."""
    devs = jax.devices()[:n]
    assert tdist.image_grid(n) == tuple(
        jdist.make_image_mesh(devices=devs).devices.shape)
    assert tdist.batch_image_grid(n) == tuple(
        jdist.make_batch_image_mesh(devices=devs).devices.shape)
    with pytest.raises(ValueError, match='does not divide'):
        tdist.batch_image_grid(n, batch=n + 1)


def test_pad_to_mesh_matches_jax():
    rng = np.random.default_rng(2)
    gn = rng.uniform(100.0, 200.0, (3, 90, 94))
    bkg = rng.uniform(140.0, 160.0, (3, 90, 94))
    for got, want in zip(tdist.pad_to_mesh(gn, bkg, 2, 4, 7),
                         jdist.pad_to_mesh(gn, bkg, 2, 4, 7)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_meshes_without_a_card_raise():
    """The mesh constructors default to the card: without one they raise
    before touching a process group."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tdist.make_image_mesh((1, 1))
    with pytest.raises(ValueError, match='mesh'):
        tsgp.solve(np.ones((1, 8, 8)), np.ones((3, 3)) / 9, 0.0, None, 1.0,
                   None, 1.0, 1e-3, 0.0,
                   tsgp.SGPConfig(axis_names=('ty', 'tx'), operator='halo'),
                   device='cpu')


# ---- the example scripts (examples_torch/) -----------------------------------

# The demo's float32 frames part like any whole frame (ROADMAP "Limits"): the
# JAX package's own float32 solve of the 256x256 field stops at 47, 60, 53
# and 59 iterations on 1, 2, 4 and 8 devices, with rel_err 0.1352, 0.1277,
# 0.1315 and 0.1303 and x up to 1.6e-2 of max|x| apart (on the CPU). So the
# float32 demo is held to JAX's float32 solve on the same mesh by these
# bars, about JAX's spread against itself; float64 is held lane for lane.
DEMO_F32_REL_ERR = 1e-2
DEMO_F32_X = 2e-2


def test_distributed_demo_matches_jax(world):
    """``examples_torch/distributed_demo.py`` on the four ranks: the
    256x256 field on the 2x2 mesh and four 64x128 fields on (2, 1, 2), as
    the JAX demo lays them out on four devices. Its two solves run again
    in float64 on the same inputs equal JAX's: equal iterations, x within
    1e-9. The demo as written (float32): finite, within its 60
    iterations, rel_err and x within the bars above of JAX's float32
    solves of the same inputs on the same meshes."""
    from tpu_sgp.metrics import relative_error
    z, _ = world
    demo_cfg = spmd.example('distributed_demo').CFG
    assert tuple(z['demo_mesh']) == (2, 2)
    assert tuple(z['demo_mesh3']) == (2, 1, 2)
    assert z['demo_x'].shape == (256, 256)
    assert z['demo_batch_x'].shape == (4, 64, 128)
    mesh = _jax_mesh2()
    bmesh = jdist.make_batch_image_mesh(devices=jax.devices()[:WORLD])

    def jax_solves(dtype):
        cfg = JaxConfig(**dict(demo_cfg, dtype=dtype))
        return (jdist.solve_distributed(z['demo_image'], z['demo_psf'],
                                        150.0, cfg, mesh),
                jdist.solve_distributed_batch(z['demo_imgs'],
                                              z['demo_psf3'], 150.0, cfg,
                                              bmesh))

    one, batch = jax_solves('float64')
    assert int(z['demo64_iters']) == int(one.iters)
    np.testing.assert_array_equal(z['demo64_batch_iters'],
                                  np.asarray(batch.iters))
    assert _rel(z['demo64_x'], one.x) <= RTOL
    assert _rel(z['demo64_batch_x'], batch.x) <= RTOL

    one, batch = jax_solves('float32')
    _, _, truth = spmd.synthetic_star_field(256, 256, n_stars=40,
                                            psf_size=31, fwhm=2.5, seed=3)
    want = relative_error(np.maximum(np.asarray(one.x), 0), truth + 150.0)
    assert abs(float(z['demo_rel_err']) - want) <= DEMO_F32_REL_ERR
    assert _rel(z['demo_x'], one.x) <= DEMO_F32_X
    assert _rel(z['demo_batch_x'], batch.x) <= DEMO_F32_X
    assert np.isfinite(z['demo_x']).all()
    assert np.isfinite(z['demo_batch_x']).all()
    assert 0 < int(z['demo_iters']) <= demo_cfg['max_iter']
    assert (z['demo_batch_iters'] <= demo_cfg['max_iter']).all()


def test_time_halo_operator_on_one_rank_meshes(world):
    """``examples_torch/time_halo_operator.py`` on a 1x1 mesh of each of
    the four ranks (64x64, 2 repeats, a chain of 3): a positive ratio and
    a single apply within 1e-5 of the linear operator; at the timing's own
    410x410 tile the halo apply equals the linear one within 1e-5 in
    float32 (the bar ``chip_smoke.py`` holds on the card) and 1e-12 in
    float64."""
    z, _ = world
    ranks = z['halo_ranks']
    assert ranks.shape == (WORLD, 5)
    ratio, rel, wall, rel32, rel64 = ranks.T
    assert (ratio > 0).all() and (wall > 0).all()
    assert (rel <= 1e-5).all()
    assert (rel32 <= 1e-5).all() and (rel64 <= 1e-12).all()
