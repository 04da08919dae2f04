"""The port's batched flux projections against the JAX package's: the
Pallas kernel (interpret mode on the CPU) and every XLA method, vmapped;
and on a card only, the CUDA kernel against its plain version and each
method on the card against the CPU.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
    python -m pytest tests/test_torch_projection.py --noconftest \
        -o addopts= -m cuda
"""
import numpy as np
import pytest
import torch

from tpu_sgp_torch.kernels.flux_projection import (project_rows,
                                                   project_rows_plain)
from tpu_sgp_torch.projection import flux_projection as tproj


def _rows(rng, rows=4, n=961):
    b = rng.uniform(50.0, 500.0, rows)
    c = rng.normal(0.5, 1.0, (rows, n))
    dia = rng.uniform(0.5, 2.0, (rows, n))
    scaling = rng.uniform(0.5, 2.0, rows)
    # saturation that binds some pixels but leaves room for the flux
    sat = rng.uniform(1.5, 3.0, rows) * b / n * scaling
    return b, c, dia, scaling, sat


@pytest.mark.parametrize('has_sat', [False, True])
def test_plain_rows_match_jax_pallas(has_sat):
    """Pattern of tests/test_projection.py:125-141, row by row, with
    per-row b, dia, scaling and saturation."""
    import jax.numpy as jnp
    from tpu_sgp.experimental.pallas_projection import project_df_pallas
    b, c, dia, scaling, sat = _rows(np.random.default_rng(5))
    t = torch.as_tensor
    got = tproj.project_df_pallas(t(b), t(c), t(dia), t(scaling),
                                  sat_level=t(sat) if has_sat else None,
                                  has_sat=has_sat).numpy()
    for i in range(len(b)):
        want = project_df_pallas(b[i], jnp.asarray(c[i]),
                                 jnp.asarray(dia[i]), scaling[i],
                                 sat_level=sat[i] if has_sat else None,
                                 has_sat=has_sat)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(got.sum(-1), b, rtol=1e-9)
    if has_sat:
        cap = sat / scaling - np.finfo(np.float64).eps
        assert (got <= cap[:, None]).all()
        assert np.isclose(got.max(-1), cap).any()   # the cap binds


@pytest.mark.parametrize('has_sat', [False, True])
@pytest.mark.parametrize('dtype,tol', [('float64', 1e-10), ('float32', 2e-5)])
def test_plain_long_row_matches_jax_pallas(has_sat, dtype, tol):
    """One long row, as a whole-frame solve gives the kernel (N = 5000,
    padded by JAX to (40, 128) lane tiles): the plain version against
    ``project_df_pallas`` in interpret mode, x within ``tol`` of max|x|.
    float32 sums 5000 terms in another order than the interpreter, so the
    last sectioning steps may pick the neighbouring segment."""
    import jax.numpy as jnp
    from tpu_sgp.experimental.pallas_projection import project_df_pallas
    b, c, dia, scaling, sat = _rows(np.random.default_rng(9), rows=1, n=5000)
    # a frame's flux grows with its pixels: the stamps' flux a pixel
    b, sat = b * (5000 / 961), sat * (5000 / 961)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    got = tproj.project_df_pallas(t(b), t(c), t(dia), t(scaling),
                                  sat_level=t(sat) if has_sat else None,
                                  has_sat=has_sat)
    assert got.dtype == tdt and got.shape == (1, 5000)
    j = lambda a: jnp.asarray(a, jdt)
    want = np.asarray(project_df_pallas(
        j(b[0]), j(c[0]), j(dia[0]), j(scaling[0]),
        sat_level=j(sat[0]) if has_sat else None, has_sat=has_sat))
    assert want.dtype == np.dtype(dtype)
    err = np.abs(got[0].numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err
    np.testing.assert_allclose(got.double().sum(-1).numpy(), b, rtol=10 * tol)


@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_flux_conserved(dtype, rtol):
    rng = np.random.default_rng(6)
    b, c, dia, scaling, sat = _rows(rng, rows=6, n=256)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    x = tproj.project_df_pallas(t(b), t(c), t(dia), t(scaling),
                                sat_level=t(sat))
    assert x.dtype == dtype
    assert (x >= 0).all()
    np.testing.assert_allclose(x.double().sum(-1).numpy(), b, rtol=rtol)


def test_section_steps_policy():
    assert tproj.bracket_bits(torch.float32) == 28
    assert tproj.bracket_bits(torch.float64) == 54
    assert tproj.section_steps(torch.float32) == 10
    assert tproj.section_steps(torch.float64) == 18


def test_cpu_tensor_takes_plain_path():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    launches nothing."""
    b, c, dia, scaling, sat = _rows(np.random.default_rng(7), rows=3, n=100)
    t = torch.as_tensor
    cap = t(sat / scaling)
    before = project_rows.launches
    got = project_rows(t(b), t(c), t(dia), cap, 18, True)
    want = project_rows_plain(t(b), t(c), t(dia), cap, 18, True)
    assert project_rows.launches == before
    assert torch.equal(got, want)


JAX_METHODS = {'bisect': 'project_df_bisect', 'section': 'project_df_section',
               'sort': 'project_df_sort', 'secant': 'project_df'}


def _jax_rows(method, b, c, dia, scaling, sat):
    """The JAX method vmapped over the rows (sat None: no saturation)."""
    import jax
    import jax.numpy as jnp
    from tpu_sgp.projection import flux_projection as jproj
    fn = getattr(jproj, JAX_METHODS[method])
    has_sat = sat is not None
    one = lambda b_, c_, d_, s_, q_: fn(b_, c_, d_, s_, sat_level=q_,
                                        has_sat=has_sat)
    q = jnp.asarray(sat if has_sat else np.zeros_like(b))
    return np.asarray(jax.vmap(one)(jnp.asarray(b), jnp.asarray(c),
                                    jnp.asarray(dia), jnp.asarray(scaling),
                                    q))


def _port_rows(method, b, c, dia, scaling, sat, dtype=torch.float64):
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return tproj.project(method, t(b), t(c), t(dia), t(scaling),
                         sat_level=None if sat is None else t(sat),
                         has_sat=sat is not None)


def _check_rows(method, b, c, dia, scaling, sat):
    """The port against JAX, x within 1e-12 of max|x| a row; NaN where
    JAX gives NaN."""
    got = _port_rows(method, b, c, dia, scaling, sat).numpy()
    want = _jax_rows(method, b, c, dia, scaling, sat)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want).any(-1)
    err = np.abs(got - want)[ok].max(-1) / np.abs(want)[ok].max(-1)
    assert (err <= 1e-12).all(), (method, err)
    return got


@pytest.mark.parametrize('method', list(JAX_METHODS))
@pytest.mark.parametrize('sat_case', ['none', 'binding', 'full'])
def test_method_matches_vmapped_jax(method, sat_case):
    """Every XLA projection of the JAX package against the port's, row by
    row, float64: x within 1e-12 of max|x|. 'binding' saturation clips
    some pixels; 'full' leaves less capacity than the flux, so x is the
    cap on every pixel."""
    b, c, dia, scaling, sat = _rows(np.random.default_rng(20), rows=6,
                                    n=300)
    if sat_case == 'none':
        sat = None
    elif sat_case == 'full':
        sat = 0.5 * b / 300 * scaling
    got = _check_rows(method, b, c, dia, scaling, sat)
    if sat_case == 'full' and method == 'secant':
        # the reference's bracketing grows lam until dlam overflows, and
        # both packages return NaN
        assert np.isnan(got).all()
    elif sat_case == 'full':
        cap = sat / scaling - np.finfo(np.float64).eps
        np.testing.assert_allclose(got, np.broadcast_to(cap[:, None],
                                                        got.shape),
                                   rtol=1e-12)
    else:
        np.testing.assert_allclose(got.sum(-1), b, rtol=1e-9)


@pytest.mark.parametrize('method', list(JAX_METHODS))
def test_anchor_counterexamples_match_jax(method):
    """The two instances of tests/test_projection.py:316-349 that defeated
    bracket narrowing before the analytic anchors (a dia=513 pixel; a flat
    shelf beside a tiny-dia cliff), saturated at 10, as two rows."""
    n = 64
    c1 = np.zeros(n)
    c1[-1] = 1.0
    d1 = np.ones(n)
    d1[-2] = 513.0
    c2 = np.zeros(n)
    c2[1], c2[2] = 137.0, -1.0
    d2 = np.ones(n)
    d2[1] = 89.0
    d2[n // 2:] = 0.0078125
    b = np.array([320.0, 160.0])
    got = _check_rows(method, b, np.stack([c1, c2]), np.stack([d1, d2]),
                      np.ones(2), np.full(2, 10.0))
    assert (got >= 0).all() and (got <= 10.0).all()
    np.testing.assert_allclose(got.sum(-1), b, rtol=1e-8)
    x32 = _port_rows(method, b, np.stack([c1, c2]), np.stack([d1, d2]),
                     np.ones(2), np.full(2, 10.0), torch.float32)
    assert x32.dtype == torch.float32
    # sign-only sectioning ends 3e-5 and 4e-4 off the flux in float32 here,
    # JAX's 'section' as well (319.99062842689455, 160.06863605976105):
    # what the anchors of 'bisect' repair
    want = [319.99062842689455, 160.06863605976105] \
        if method == 'section' else b
    np.testing.assert_allclose(x32.double().sum(-1).numpy(), want,
                               rtol=2e-6)


@pytest.mark.parametrize('method', list(JAX_METHODS))
@pytest.mark.parametrize('has_sat', [False, True])
def test_method_float32_conserves_flux(method, has_sat):
    """float32 rows (n=961, the stamps' width): flux to 1e-4, x >= 0 and
    under the cap; 'secant' computes in float64 and returns float32."""
    b, c, dia, scaling, sat = _rows(np.random.default_rng(21), rows=8)
    x = _port_rows(method, b, c, dia, scaling, sat if has_sat else None,
                   torch.float32)
    assert x.dtype == torch.float32
    assert (x >= 0).all()
    np.testing.assert_allclose(x.double().sum(-1).numpy(), b, rtol=1e-4)
    if has_sat:
        # within float32's rounding of a cap that 'secant' takes in float64
        assert (x.double().numpy()
                <= (sat / scaling)[:, None] * (1 + 2 ** -23)).all()


@pytest.mark.parametrize('has_sat', [False, True])
def test_warm_bisect_matches_jax_and_cold(has_sat):
    """project_df_bisect_warm against JAX's, vmapped, with warm windows
    that hit, windows that miss on either side, and a NaN previous root
    (the first call); its root against the cold guided secant's."""
    import jax
    import jax.numpy as jnp
    from tpu_sgp.projection import flux_projection as jproj
    b, c, dia, scaling, sat = _rows(np.random.default_rng(22), rows=6,
                                    n=300)
    sat = sat if has_sat else None
    t = torch.as_tensor
    x_cold, lam_cold = tproj._guided_root(t(b), t(c), t(dia), t(scaling),
                                          None if sat is None else t(sat),
                                          has_sat, None)
    lam_cold = lam_cold.numpy()
    lam_prev = lam_cold + np.array([1e-6, -1e-6, 5.0, -5.0, 0.0, np.nan])
    dlam_prev = np.array([1e-5, 1e-5, 1e-3, 1e-3, np.inf, np.inf])
    x, lam = tproj.project_df_bisect_warm(
        t(b), t(c), t(dia), t(scaling), None if sat is None else t(sat),
        has_sat, lam_prev=t(lam_prev), dlam_prev=t(dlam_prev))

    def one(b_, c_, d_, s_, q_, lp, dl):
        return jproj.project_df_bisect_warm(
            b_, c_, d_, s_, sat_level=q_, has_sat=has_sat, lam_prev=lp,
            dlam_prev=dl)

    q = jnp.asarray(sat if has_sat else np.zeros(6))
    xj, lamj = jax.vmap(one)(*(jnp.asarray(a) for a in (
        b, c, dia, scaling)), q, jnp.asarray(lam_prev),
        jnp.asarray(dlam_prev))
    xj = np.asarray(xj)
    assert (np.abs(x.numpy() - xj).max(-1) / np.abs(xj).max(-1)).max() \
        <= 1e-12
    np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), rtol=1e-12,
                               atol=1e-12)
    assert (np.abs(x.numpy() - x_cold.numpy()).max(-1)
            / np.abs(x_cold.numpy()).max(-1)).max() <= 1e-12
    np.testing.assert_allclose(x.numpy().sum(-1), b, rtol=1e-9)


def test_dispatch_names_every_method():
    assert tproj.METHODS == ('bisect', 'section', 'sort', 'secant',
                             'pallas')
    assert tproj.newton_passes(torch.float32) == 5
    assert tproj.newton_passes(torch.float64) == 8
    with pytest.raises(ValueError, match='unknown projection_method'):
        tproj.check_method('newton')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize('has_sat', [False, True])
# one warp a row up to 1024 pixels in float32 and 512 in float64 (a
# ragged last block of 4 rows), one block a row above: in registers up to
# 2048, then streamed
@pytest.mark.parametrize('rows,n', [(64, 961), (7, 256), (3, 3000), (9, 20),
                                    (5, 32), (13, 961), (6, 1025), (4, 513)])
def test_kernel_matches_plain_on_card(dtype, tol, has_sat, rows, n):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    b, c, dia, scaling, sat = _rows(np.random.default_rng(rows), rows, n)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    cap = t(sat / scaling) if has_sat else torch.zeros(rows, dtype=dtype,
                                                       device='cuda')
    steps = tproj.section_steps(dtype)
    before = project_rows.launches
    got = project_rows(t(b), t(c), t(dia), cap, steps, has_sat)
    want = project_rows_plain(t(b), t(c), t(dia), cap, steps, has_sat)
    torch.cuda.synchronize()
    assert project_rows.launches == before + 1
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    b, c, dia, scaling, sat = _rows(np.random.default_rng(8), 4, 300)
    t = lambda a: torch.as_tensor(a, device='cuda')
    cap = t(sat / scaling)
    with pytest.raises(ValueError, match='contiguous'):
        project_rows(t(b), t(c).T.contiguous().T, t(dia), cap, 18, True)
    with pytest.raises(TypeError, match='dia'):
        project_rows(t(b), t(c), t(dia).float(), cap, 18, True)
    with pytest.raises(TypeError, match='float32 or float64'):
        project_rows(t(b).half(), t(c).half(), t(dia).half(), cap.half(),
                     18, True)
    with pytest.raises(ValueError, match='shape'):
        project_rows(t(b)[:3], t(c), t(dia), cap, 18, True)


@pytest.mark.cuda
@pytest.mark.parametrize('method', ['bisect', 'section', 'sort', 'secant',
                                    'warm'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_method_on_card_matches_cpu(method, dtype):
    """Each plain-PyTorch method on CUDA tensors against the same call on
    the CPU: float64 x within 1e-10 of max|x|, float32 flux to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    b, c, dia, scaling, sat = _rows(np.random.default_rng(23), rows=64)

    def run(dev):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        if method == 'warm':
            return tproj.project_df_bisect_warm(
                t(b), t(c), t(dia), t(scaling), t(sat), True,
                lam_prev=t(np.full(64, np.nan)),
                dlam_prev=t(np.full(64, np.inf)))[0]
        return tproj.project(method, t(b), t(c), t(dia), t(scaling),
                             sat_level=t(sat), has_sat=True)

    got, want = run('cuda').cpu(), run('cpu')
    assert got.dtype == dtype
    if dtype == torch.float64:
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-10
    np.testing.assert_allclose(got.double().sum(-1).numpy(), b, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize('has_sat', [False, True])
# a whole frame as one row, a ragged last block, several long rows, and a
# row that fills its last block exactly
@pytest.mark.parametrize('rows,n', [(1, 168100), (1, 2049), (4, 65536),
                                    (3, 5000), (2, 4096)])
@pytest.mark.parametrize('path', ['auto', 'grid', 'rows'])
def test_long_rows_on_card_match_plain(dtype, tol, has_sat, rows, n, path):
    """Rows above 2048 pixels: the launcher's own choice is the grid path
    (each row split over many blocks); forced, the grid path and the
    one-block-a-row path both agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tpu_sgp_torch.kernels.flux_projection import launch_plan
    b, c, dia, scaling, sat = _rows(np.random.default_rng(rows + n), rows, n)
    # a frame's flux grows with its pixels: the stamps' flux a pixel
    b, sat = b * (n / 961), sat * (n / 961)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    cap = t(sat / scaling) if has_sat else torch.zeros(rows, dtype=dtype,
                                                       device='cuda')
    steps = tproj.section_steps(dtype)
    chosen, scratch, blocks = launch_plan(rows, n, dtype, path, 0)
    assert chosen == ('rows' if path == 'rows' else 'grid')
    assert (scratch > 0 and blocks > rows) == (chosen == 'grid')
    before = project_rows.launches, project_rows.grid_launches
    got = project_rows(t(b), t(c), t(dia), cap, steps, has_sat, path=path)
    want = project_rows_plain(t(b), t(c), t(dia), cap, steps, has_sat)
    torch.cuda.synchronize()
    assert project_rows.launches == before[0] + 1
    assert project_rows.grid_launches == before[1] + (chosen == 'grid')
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol
    np.testing.assert_allclose(got.double().sum(-1).cpu().numpy(), b,
                               rtol=1e-4 if dtype == torch.float32 else 1e-9)


@pytest.mark.cuda
def test_many_long_rows_keep_one_block_a_row_and_a_grid_too_large_raises():
    """More long rows than the card holds blocks for: the launcher keeps
    one block a row; forcing the grid path raises instead of hanging."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tpu_sgp_torch.kernels.flux_projection import launch_plan
    rows, n = 3000, 4096
    assert launch_plan(rows, n, torch.float32, 'auto', 0)[0] == 'rows'
    b, c, dia, scaling, sat = _rows(np.random.default_rng(3), rows, n)
    b, sat = b * (n / 961), sat * (n / 961)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device='cuda')
    cap = t(sat / scaling)
    got = project_rows(t(b), t(c), t(dia), cap, 10, True)
    want = project_rows_plain(t(b), t(c), t(dia), cap, 10, True)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    with pytest.raises(RuntimeError, match='grid path'):
        project_rows(t(b), t(c), t(dia), cap, 10, True, path='grid')
    torch.cuda.synchronize()
