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

from tpu_sgp_torch.kernels import launches
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


@pytest.mark.parametrize('n_iters', [None, 12])
@pytest.mark.parametrize('has_sat', [False, True])
@pytest.mark.parametrize('shape', [(31, 31), (37, 53)])
@pytest.mark.parametrize('dtype,tol', [('float64', 1e-10), ('float32', 2e-5)])
def test_single_image_matches_jax_pallas(dtype, tol, shape, has_sat,
                                         n_iters):
    """``experimental.pallas_projection.project_df_pallas``: one image of
    any shape and a scalar flux, JAX's signature, against JAX's function
    in interpret mode, x within ``tol`` of max|x| (the default bracket
    budget and 12 bits, four sectioning steps)."""
    import jax.numpy as jnp
    from tpu_sgp.experimental import pallas_projection as jpp
    from tpu_sgp_torch.experimental import pallas_projection as tpp
    n = shape[0] * shape[1]
    b, c, dia, scaling, sat = _rows(np.random.default_rng(n), rows=1, n=n)
    c, dia = c.reshape(shape), dia.reshape(shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = lambda a: torch.as_tensor(a, dtype=tdt)
    j = lambda a: jnp.asarray(a, jdt)
    got = tpp.project_df_pallas(t(b[0]), t(c), t(dia), t(scaling[0]),
                                sat_level=t(sat[0]) if has_sat else None,
                                n_iters=n_iters)
    want = np.asarray(jpp.project_df_pallas(
        j(b[0]), j(c), j(dia), j(scaling[0]),
        sat_level=j(sat[0]) if has_sat else None, n_iters=n_iters))
    assert got.dtype == tdt and tuple(got.shape) == shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize('n_iters', [None, 7, 30])
@pytest.mark.parametrize('has_sat', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_single_image_is_the_batched_projection_of_one_row(dtype, has_sat,
                                                           n_iters):
    """``experimental.pallas_projection.project_df_pallas`` on a CPU
    image gives the bits of ``projection.project_df_pallas`` on the
    image's one row, with the steps of ``n_iters`` bits."""
    from tpu_sgp_torch.experimental import pallas_projection as tpp
    b, c, dia, scaling, sat = _rows(np.random.default_rng(41), rows=1,
                                    n=37 * 53)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    got = tpp.project_df_pallas(float(b[0]), t(c).reshape(37, 53),
                                t(dia).reshape(37, 53), float(scaling[0]),
                                sat_level=float(sat[0]) if has_sat else None,
                                n_iters=n_iters)
    bits = tproj.bracket_bits(dtype) if n_iters is None else n_iters
    want = tproj.project_df_pallas(
        t(b), t(c), t(dia), t(scaling), t(sat) if has_sat else None,
        has_sat, n_steps=-(-bits // 3))
    assert got.dtype == dtype and tuple(got.shape) == (37, 53)
    assert torch.equal(got.reshape(1, -1), want)


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
    before = launches['project_rows']
    got = project_rows(t(b), t(c), t(dia), cap, 18, True)
    want = project_rows_plain(t(b), t(c), t(dia), cap, 18, True)
    assert launches['project_rows'] == before
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
    before = launches['project_rows']
    got = project_rows(t(b), t(c), t(dia), cap, steps, has_sat)
    want = project_rows_plain(t(b), t(c), t(dia), cap, steps, has_sat)
    torch.cuda.synchronize()
    assert launches['project_rows'] == before + 1
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
    before = launches['project_rows'], launches['project_rows.grid']
    got = project_rows(t(b), t(c), t(dia), cap, steps, has_sat, path=path)
    want = project_rows_plain(t(b), t(c), t(dia), cap, steps, has_sat)
    torch.cuda.synchronize()
    assert launches['project_rows'] == before[0] + 1
    assert launches['project_rows.grid'] == before[1] + (chosen == 'grid')
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


# ---- 'bisect' on long rows: the guided grid kernel and its route ----------

@pytest.mark.parametrize('rows,n,device,sharded,plan,want', [
    (1, 168100, 'cpu', False, None, 'plain'),           # CPU tensors
    (1, 168100, 'cuda', True, (165, 1056), 'plain'),    # under mesh axes
    (12288, 961, 'cuda', False, (12288, 1056), 'plain'),  # stamps
    (256, 961, 'cuda', False, (256, 1056), 'plain'),    # a served request
    (1, 2048, 'cuda', False, (2, 1056), 'plain'),       # K1's block rows
    (25, 168100, 'cuda', False, (4125, 1056), 'plain'),  # too many blocks
    (7, 168100, 'cuda', False, (1155, 1155), 'kernel'),  # all fit
    (1, 168100, 'cuda', False, (165, 1056), 'kernel'),  # one whole frame
    (1, 2049, 'cuda', False, (3, 1056), 'kernel'),
])
def test_guided_route_takes_the_kernel_only_for_few_long_rows_on_a_card(
        rows, n, device, sharded, plan, want):
    """The route of a cold 'bisect' projection from the shape alone: the
    grid kernel for rows above 2048 pixels on a card whose blocks all fit
    at once; the plain ladder for CPU tensors, mesh axes, stamps and more
    long rows than the card holds. With a plan (blocks, capacity) given,
    the rule asks no card."""
    from tpu_sgp_torch.kernels.flux_projection import guided_route
    assert guided_route(rows, n, torch.float32, device, sharded=sharded,
                        plan=plan) == want
    assert guided_route(rows, n, torch.float16, device, sharded=sharded,
                        plan=plan) == 'plain'


# sha256 (first 16 hex digits) of project('bisect', ...)'s x on seeded rows,
# as the plain ladder computed it before the kernel route existed
BISECT_CPU_PINS = {
    ('float32', False, 5, 300): '9090957b2106ce4c',
    ('float32', False, 1, 4097): '944acc94ec7901f2',
    ('float32', True, 5, 300): '4963fcbed766bfa5',
    ('float32', True, 1, 4097): 'fc0da2f67c21a1b8',
    ('float64', False, 5, 300): '81c1398de5e0ab80',
    ('float64', False, 1, 4097): 'f3c18a7c31da6555',
    ('float64', True, 5, 300): 'd21af46ad2e880a6',
    ('float64', True, 1, 4097): '9ec9a30f8d7f2d5e',
}


def _long_rows(rows, n, seed=None):
    """_rows with a frame's flux: a stamp's flux a pixel."""
    b, c, dia, scaling, sat = _rows(np.random.default_rng(
        rows * 1000 + n if seed is None else seed), rows, n)
    grow = max(1.0, n / 961)
    return b * grow, c, dia, scaling, sat * grow


@pytest.mark.parametrize('dtype,has_sat,rows,n', list(BISECT_CPU_PINS))
def test_bisect_on_cpu_is_bit_equal_to_the_plain_ladder(dtype, has_sat,
                                                        rows, n):
    """On CPU tensors, long rows included, project('bisect', ...) is the
    plain ladder: bit for bit ``_guided_root``'s x and the pinned bytes of
    its output before the kernel route, with no launch."""
    import hashlib
    from tpu_sgp_torch.kernels.flux_projection import project_guided_rows
    b, c, dia, scaling, sat = _long_rows(rows, n)
    t = lambda a: torch.as_tensor(a, dtype=getattr(torch, dtype))
    q = t(sat) if has_sat else None
    before = launches['project_guided_rows']
    x = tproj.project('bisect', t(b), t(c), t(dia), t(scaling),
                      sat_level=q, has_sat=has_sat)
    want = tproj._guided_root(t(b), t(c), t(dia), t(scaling), q, has_sat,
                              None)[0]
    assert launches['project_guided_rows'] == before
    assert torch.equal(x, want)
    assert hashlib.sha256(x.numpy().tobytes()).hexdigest()[:16] \
        == BISECT_CPU_PINS[(dtype, has_sat, rows, n)]


def test_bisect_on_cpu_records_no_kernel_span():
    """A traced 'bisect' projection of a long CPU row and a traced CPU
    frame solve: projection spans, no projection.kernel span and no guided
    launch."""
    from tpu_sgp_torch import observability
    from tpu_sgp_torch.kernels.flux_projection import project_guided_rows
    from tpu_sgp_torch.simulate import synthetic_star_field
    import tpu_sgp_torch
    b, c, dia, scaling, _ = _long_rows(1, 4097)
    t = torch.as_tensor
    img, psf, _ = synthetic_star_field(40, 40, n_stars=4, psf_size=9,
                                       fwhm=2.0, seed=3)
    before = launches['project_guided_rows']
    with observability.tracing() as trace:
        with observability.span('projection'):
            tproj.project('bisect', t(b), t(c), t(dia), t(scaling))
        tpu_sgp_torch.sgp(img, psf, 150.0, init_recon=2, proj_type=1,
                          stop_criterion=1, MAXIT=5, device='cpu')
    assert trace.get('projection').count >= 7
    assert trace.get('projection.kernel').count == 0
    assert launches['project_guided_rows'] == before


def test_guided_kernel_refuses_cpu_tensors():
    """The guided kernel has no CPU mode: CPU tensors raise before any
    launch (``project_df_bisect`` sends them to the plain ladder)."""
    from tpu_sgp_torch.kernels.flux_projection import project_guided_rows
    b, c, dia, _, _ = _long_rows(1, 4097)
    t = torch.as_tensor
    before = launches['project_guided_rows']
    with pytest.raises(ValueError, match='CUDA tensors'):
        project_guided_rows(t(b), t(c), t(dia), None, 5, False)
    assert launches['project_guided_rows'] == before


def _both_routes(b, c, dia, scaling, sat, dtype, has_sat):
    """The guided kernel and the plain ladder on the same card: (x, lam)
    of each, and the launches the kernel route made."""
    from tpu_sgp_torch.kernels.flux_projection import project_guided_rows
    t = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    args = t(b), t(c), t(dia), t(scaling), t(sat) if has_sat else None
    before = launches['project_guided_rows']
    got = tproj._guided_root_kernel(*args, has_sat, None)
    launched = launches['project_guided_rows'] - before
    want = tproj._guided_root(*args, has_sat, None)
    torch.cuda.synchronize()
    return got, want, launched


def _check_routes(got, want, b, dtype):
    """x within 1e-12 (float64) or 1e-5 (float32) of max|x|; in float32
    the flux to 1e-4 and within 1e-6 of the plain ladder's gap."""
    x, xp = got[0].double().cpu(), want[0].double().cpu()
    assert bool(torch.isfinite(x).all())
    err = float((x - xp).abs().max() / xp.abs().max())
    b = torch.as_tensor(b, dtype=torch.float64)
    gap = float(((x.sum(-1) - b).abs() / b).max())
    gap_plain = float(((xp.sum(-1) - b).abs() / b).max())
    if dtype == torch.float64:
        assert err <= 1e-12, err
    else:
        assert err <= 1e-5, err
        assert gap <= 1e-4 and gap <= gap_plain + 1e-6, (gap, gap_plain)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('has_sat', [False, True])
@pytest.mark.parametrize('rows,n', [(1, 168100), (1, 4097), (2, 168100)])
def test_guided_kernel_matches_plain_on_card(dtype, has_sat, rows, n):
    """The guided grid kernel against the plain ladder on the same card, in
    one launch; 'auto' takes the kernel for these shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tpu_sgp_torch.kernels.flux_projection import (guided_plan,
                                                       guided_route)
    assert guided_route(rows, n, dtype, 'cuda') == 'kernel'
    blocks, scratch, capacity = guided_plan(rows, n, dtype, 0)
    # 1024 pixels a block
    assert blocks == rows * -(-n // 1024) <= capacity and scratch > 0
    b, c, dia, scaling, sat = _long_rows(rows, n)
    got, want, launches = _both_routes(b, c, dia, scaling, sat, dtype,
                                       has_sat)
    assert launches == 1
    _check_routes(got, want, b, dtype)


def _adversarial(case, n, seed):
    """Rows that stress the ladder: one bright pixel holding nearly all
    the flux; a cap that clips all but about 0.1 % of the pixels; and a
    flux just above sum(max(c, 0)/dia), where the root sits next to
    lam = 0."""
    rng = np.random.default_rng(seed)
    c = rng.normal(-1.0, 0.3, n)
    dia = rng.uniform(0.5, 2.0, n)
    scaling = 1.0
    if case == 'bright':
        c[n // 3] = 5e4
        b = 1e3
        sat = 2e4
    elif case == 'clipped':
        c = rng.normal(0.5, 1.0, n)
        b = 1e4
        sat = 1.001 * b / n
    else:
        c = rng.normal(0.5, 1.0, n)
        b = float((np.maximum(c, 0) / dia).sum()) * (1 + 1e-6)
        sat = 10.0
    return (np.array([b]), c[None], dia[None], np.array([scaling]),
            np.array([sat]))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('case,has_sat', [('bright', False),
                                          ('bright', True),
                                          ('root_at_zero', False),
                                          ('root_at_zero', True)])
def test_guided_kernel_adversarial_rows_on_card(dtype, case, has_sat):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    b, c, dia, scaling, sat = _adversarial(case, 168100, 5)
    got, want, launches = _both_routes(b, c, dia, scaling, sat, dtype,
                                       has_sat)
    assert launches == 1
    _check_routes(got, want, b, dtype)


def _kernel_order_sum(x, axes=()):
    """Row sums in the guided kernel's order (``row_reduce`` in
    csrc/flux_projection.cu): a thread adds its 4 pixels
    part * 1024 + tid + 256 j in turn, a warp halves its 32 lanes (the xor
    shuffles), a block adds its 8 warps in turn, and lane l adds the row's
    parts l, l + 32, ... in turn before a last halving over the lanes.
    Pad pixels and parts add 0."""
    def halve(t):
        while t.shape[-1] > 1:
            h = t.shape[-1] // 2
            t = t[..., :h] + t[..., h:]
        return t[..., 0]

    def in_turn(t):
        r = t[..., 0, :]
        for j in range(1, t.shape[-2]):
            r = r + t[..., j, :]
        return r

    lead, n = x.shape[:-1], x.shape[-1]
    parts = -(-n // 1024)
    x = torch.nn.functional.pad(x, (0, parts * 1024 - n))
    threads = in_turn(x.reshape(*lead, parts, 4, 256))
    warps = halve(threads.reshape(*lead, parts, 8, 32))
    blocks = in_turn(warps[..., None])[..., 0]
    m = -(-parts // 32)
    lanes = in_turn(torch.nn.functional.pad(blocks, (0, m * 32 - parts))
                    .reshape(*lead, m, 32))
    return halve(lanes)


def test_kernel_order_sum_adds_every_pixel_once():
    """The test's model of the guided kernel's sums adds each pixel once:
    exact on integers, and within rounding of a plain sum on a ragged
    row."""
    x = torch.arange(3 * 168100, dtype=torch.float64).reshape(3, 168100)
    assert torch.equal(_kernel_order_sum(x), x.sum(-1))
    y = torch.rand(2, 5, 4097, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    assert torch.allclose(_kernel_order_sum(y), y.sum(-1), rtol=1e-13)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_guided_kernel_nearly_all_clipped_row_on_card(dtype, monkeypatch):
    """A cap that clips all but about 0.1 % of the pixels. The root is set
    by the few free pixels against sums over all of them, so another
    order of the sums moves x further than the other rows' limits (the
    card's torch.sum against the CPU's: 1.1e-3 of max|x| in float32). So:
    - the kernel against the plain ladder with its sums in the kernel's
      order (``_kernel_order_sum``, on the CPU), to 1e-5 (float32) or
      1e-12 (float64) of max|x|: the kernel's arithmetic, the order aside;
    - the kernel against the plain ladder on the card, within twice the
      furthest that a permutation of the pixels moves either of them;
    - both against the exact projection ('sort' in float64): the kernel
      no further than twice the plain ladder's furthest over four orders;
      the flux to 1e-4 (float32) or 1e-12, and x within [0, cap]."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    b, c, dia, scaling, sat = _adversarial('clipped', 168100, 5)
    n = c.shape[1]
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    exact = tproj.project_df_sort(t64(b), t64(c), t64(dia), t64(scaling),
                                  t64(sat), True)[0]
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())
    got, _, launches = _both_routes(b, c, dia, scaling, sat, dtype, True)
    assert launches == 1
    x = got[0][0].double().cpu()

    def ordered(perm):
        t = lambda a: torch.as_tensor(a, dtype=dtype)
        with monkeypatch.context() as m:
            m.setattr(tproj, 'gsum', _kernel_order_sum)
            return tproj._guided_root(t(b), t(c[:, perm]), t(dia[:, perm]),
                                      t(scaling), t(sat), True, None)[0]

    plain, order = [], []
    for seed in range(4):
        perm = np.random.default_rng(seed).permutation(n) \
            if seed else np.arange(n)
        _, want, _ = _both_routes(b, c[:, perm], dia[:, perm], scaling, sat,
                                  dtype, True)
        for runs, y in ((plain, want[0][0]), (order, ordered(perm)[0])):
            back = torch.empty(n, dtype=torch.float64)
            back[torch.as_tensor(perm)] = y.double().cpu()
            runs.append(back)
    shift = max(rel(r[k], r[0]) for r in (plain, order) for k in (1, 2, 3))
    limit = 1e-5 if dtype == torch.float32 else 1e-12
    assert rel(x, order[0]) <= limit, (rel(x, order[0]), limit)
    assert rel(x, plain[0]) <= 2 * shift, (rel(x, plain[0]), shift)
    far = max(rel(y, exact) for y in plain)
    assert rel(x, exact) <= 2 * far, (rel(x, exact), far)
    assert (x >= 0).all() and (x <= sat[0] * (1 + 2 ** -23)).all()
    gap = abs(float(x.sum()) / b[0] - 1)
    assert gap <= (1e-4 if dtype == torch.float32 else 1e-12), gap


@pytest.mark.cuda
def test_guided_route_on_card_and_a_grid_too_large_raises():
    """On the card: stamps and many long rows keep the plain ladder;
    forcing the kernel on a grid larger than the card holds raises."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    from tpu_sgp_torch.kernels.flux_projection import guided_route
    assert guided_route(12288, 961, torch.float32, 'cuda') == 'plain'
    assert guided_route(1, 168100, torch.float64, 'cuda') == 'kernel'
    rows, n = 64, 168100
    assert guided_route(rows, n, torch.float32, 'cuda') == 'plain'
    b, c, dia, scaling, _ = _long_rows(rows, n)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device='cuda')
    with pytest.raises(RuntimeError, match='guided projection kernel'):
        tproj._guided_root_kernel(t(b), t(c), t(dia), t(scaling), None,
                                  False, None)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_frame_sgp_on_card_through_each_route(monkeypatch):
    """One whole 410x410 frame through the facade on the card, the guided
    kernel (one launch and one projection.kernel span a projection) against
    the plain ladder: iterations within 3 of each other, flux to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    import tpu_sgp_torch
    from tpu_sgp_torch import observability
    from tpu_sgp_torch.kernels.flux_projection import project_guided_rows
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(410, 410, n_stars=60, psf_size=31,
                                       fwhm=3.0, seed=7)
    flux = float((img - 150.0).sum())

    def solve():
        return tpu_sgp_torch.sgp(img, psf, 150.0, init_recon=2, proj_type=1,
                                 stop_criterion=3, tol_convergence=1e-5)

    before = launches['project_guided_rows']
    with observability.tracing() as trace:
        x, iters = solve()[:2]
    spans = trace.get('projection').count
    assert spans > iters
    assert trace.get('projection.kernel').count == spans
    assert launches['project_guided_rows'] - before == spans
    monkeypatch.setattr(tproj, 'guided_route', lambda *a, **k: 'plain')
    xp, iters_p = solve()[:2]
    assert launches['project_guided_rows'] - before == spans
    assert abs(int(iters) - int(iters_p)) <= 3, (iters, iters_p)
    for got in (x, xp):
        assert abs(float(got.sum(dtype=np.float64)) / flux - 1) <= 1e-4
