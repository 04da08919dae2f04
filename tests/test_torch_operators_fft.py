"""The port's FFT operators ('otf', 'linear'), its split-bfloat16 operator
and its per-stamp operators against the JAX package's on the same seeded
inputs: float64 within 1e-12 of max|y| (FFT roundoff in two libraries),
'matmul_split' in float32 within 1e-6.

JAX is imported inside the tests that use it, so that the card's test runs
where JAX is not installed:
    python -m pytest tests/test_torch_operators_fft.py --noconftest \
        -o addopts= -m cuda
"""
import numpy as np
import pytest
import torch

from tpu_sgp_torch.ops import psf_operator as top
from tpu_sgp_torch.simulate import gaussian_psf


def _jax():
    """(jax, jax.numpy, the JAX package's operator module)."""
    import jax
    import jax.numpy as jnp
    from tpu_sgp.ops import psf_operator as jop
    return jax, jnp, jop


def _psf(rng, shape):
    p = rng.uniform(0.1, 1.0, shape)
    return p / p.sum()


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# square and 9x13 PSFs, odd and even frames
LINEAR_CASES = [((64, 48), (15, 15)), ((31, 41), (9, 13)),
                ((40, 40), (9, 13)), ((33, 32), (7, 7)), ((20, 24), (6, 4))]


@pytest.mark.parametrize('image,kernel', LINEAR_CASES)
def test_linear_operator_matches_jax(image, kernel):
    """A and AT on a batch of 3, as images and as raveled rows."""
    jax, jnp, jop = _jax()
    rng = np.random.default_rng(30)
    psf = rng.uniform(0.1, 1.0, kernel)          # not normalized: A does
    xs = rng.uniform(0.0, 100.0, (3,) + image)
    ops_j = jop.make_operator(jnp.asarray(psf), image, 'linear')
    ops_t = top.make_operator(torch.as_tensor(psf), image, 'auto')
    for op_j, op_t in zip(ops_j, ops_t):
        want = np.stack([np.asarray(op_j(jnp.asarray(x))) for x in xs])
        got = op_t(torch.as_tensor(xs))
        assert got.shape == xs.shape and got.dtype == torch.float64
        assert _rel(got.numpy(), want) <= 1e-12
        rows = op_t(torch.as_tensor(xs.reshape(3, -1)))
        assert rows.shape == (3, image[0] * image[1])
        np.testing.assert_array_equal(rows.numpy(),
                                      got.reshape(3, -1).numpy())


@pytest.mark.parametrize('shape', [(80, 80), (31, 31), (33, 40), (66, 65)])
def test_otf_operator_matches_jax(shape):
    """Odd and even frames: the inverse transform always gets ``s``."""
    jax, jnp, jop = _jax()
    rng = np.random.default_rng(31)
    psf = _psf(rng, shape)
    xs = rng.uniform(0.0, 100.0, (3,) + shape)
    method = 'auto' if shape[0] * shape[1] > 4096 else 'otf'
    ops_j = jop.make_operator(jnp.asarray(psf), shape, 'otf')
    ops_t = top.make_operator(torch.as_tensor(psf), shape, method)
    for op_j, op_t in zip(ops_j, ops_t):
        want = np.stack([np.asarray(op_j(jnp.asarray(x))) for x in xs])
        got = op_t(torch.as_tensor(xs))
        assert got.shape == xs.shape
        assert _rel(got.numpy(), want) <= 1e-12
        rows = op_t(torch.as_tensor(xs.reshape(3, -1)))
        np.testing.assert_array_equal(rows.numpy(),
                                      got.reshape(3, -1).numpy())


def test_otf_equals_dense_and_is_adjoint():
    """'otf' computes the dense circulant's product, and <A x, y> =
    <x, AT y>."""
    rng = np.random.default_rng(32)
    psf = torch.as_tensor(_psf(rng, (16, 20)))
    x = torch.as_tensor(rng.uniform(0.0, 10.0, (4, 16, 20)))
    y = torch.as_tensor(rng.uniform(0.0, 10.0, (4, 16, 20)))
    A, AT = top.make_operator(psf, (16, 20), 'otf')
    A_d, AT_d = top.make_operator(psf, (16, 20), 'matmul')
    assert _rel(A(x).numpy(), A_d(x).numpy()) <= 1e-12
    assert _rel(AT(x).numpy(), AT_d(x).numpy()) <= 1e-12
    np.testing.assert_allclose((A(x) * y).sum((1, 2)).numpy(),
                               (x * AT(y)).sum((1, 2)).numpy(), rtol=1e-12)


def test_linear_is_direct_convolution_and_keeps_the_transpose_quirk():
    """A is the zero-padded convolution with psf / sum(psf), cropped at
    (kh // 2, kw // 2); AT convolves with the axis transpose, not the
    flip, so for a 9x13 PSF it is not the adjoint. The padded size does
    not change the result."""
    from scipy.signal import convolve2d
    rng = np.random.default_rng(33)
    psf = rng.uniform(0.1, 1.0, (9, 13))
    x = rng.uniform(0.0, 10.0, (24, 30))
    k = psf / psf.sum()
    A, AT = top.make_linear_operator(torch.as_tensor(psf), (24, 30))
    full = convolve2d(x, k)
    np.testing.assert_allclose(A(torch.as_tensor(x[None]))[0].numpy(),
                               full[4:4 + 24, 6:6 + 30], rtol=1e-11,
                               atol=1e-12)
    full_t = convolve2d(x, k.T)
    np.testing.assert_allclose(AT(torch.as_tensor(x[None]))[0].numpy(),
                               full_t[6:6 + 24, 4:4 + 30], rtol=1e-11,
                               atol=1e-12)
    A2, _ = top.make_linear_operator(torch.as_tensor(psf), (24, 30),
                                     pad_to=(40, 50))
    assert _rel(A2(torch.as_tensor(x[None])).numpy(),
                A(torch.as_tensor(x[None])).numpy()) <= 1e-13
    with pytest.raises(ValueError, match='smaller than the linear'):
        top.make_linear_operator(torch.as_tensor(psf), (24, 30),
                                 pad_to=(31, 42))


@pytest.mark.parametrize('n,want', [(440, 448), (448, 448), (1, 2), (94, 96),
                                    (78, 80), (511, 512), (513, 540)])
def test_good_fft_size_equals_jax(n, want):
    jax, jnp, jop = _jax()
    assert top._good_fft_size(n) == jop._good_fft_size(n) == want


def test_good_fft_size_rejects_nonpositive():
    with pytest.raises(ValueError, match='positive'):
        top._good_fft_size(0)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_matmul_split_matches_jax(dtype):
    """float32 within 1e-6 of max|y| of JAX's bfloat16 products with
    float32 accumulation; within 2^-15 of the exact product. A float64
    iterate comes back in float64."""
    jax, jnp, jop = _jax()
    rng = np.random.default_rng(34)
    psf = gaussian_psf(12, 2.8)
    xs = rng.uniform(0.0, 100.0, (5, 144)).astype(dtype)
    A_j, AT_j = jop.make_operator(jnp.asarray(psf, jnp.float32), (144,),
                                  'matmul_split')
    tpsf = torch.as_tensor(psf, dtype=torch.float32)
    A_t, AT_t = top.make_operator(tpsf, (144,), 'matmul_split')
    A_e, AT_e = top.make_operator(tpsf.double(), (144,), 'matmul_flat')
    for op_j, op_t, op_e in ((A_j, A_t, A_e), (AT_j, AT_t, AT_e)):
        want = np.stack([np.asarray(op_j(jnp.asarray(x))) for x in xs])
        got = op_t(torch.as_tensor(xs))
        assert got.dtype == getattr(torch, dtype)
        assert _rel(got.numpy(), want) <= 1e-6
        exact = op_e(torch.as_tensor(xs).double()).numpy()
        assert _rel(got.numpy(), exact) <= 2.0 ** -15


def test_split_bf16_terms():
    jax, jnp, jop = _jax()
    m = torch.as_tensor(np.random.default_rng(35).uniform(0, 1, (7, 9)),
                        dtype=torch.float32)
    hi, lo = top._split_bf16(m)
    hi_j, lo_j = jop._split_bf16(jnp.asarray(m.numpy()))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(hi_j.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(lo_j.astype(jnp.float32)))


@pytest.mark.parametrize('method,shape', [('matmul', (12, 12)),
                                          ('otf', (12, 14)),
                                          ('linear', (16, 18))])
def test_per_stamp_psfs_match_vmapped_jax(method, shape):
    """A (B, H, W) stack of PSFs gives each image its own operator, as
    ``jax.vmap`` over ``make_operator`` does."""
    jax, jnp, jop = _jax()
    rng = np.random.default_rng(36)
    kshape = (5, 7) if method == 'linear' else shape
    psfs = np.stack([_psf(rng, kshape) for _ in range(4)])
    xs = rng.uniform(0.0, 100.0, (4,) + shape)
    ops_t = top.make_operator(torch.as_tensor(psfs), shape, method)
    for which, op_t in enumerate(ops_t):
        want = jax.vmap(lambda p, x: jop.make_operator(p, shape, method)[
            which](x))(jnp.asarray(psfs), jnp.asarray(xs))
        assert _rel(op_t(torch.as_tensor(xs)).numpy(), want) <= 1e-12
        rows = op_t(torch.as_tensor(xs.reshape(4, -1)))
        assert _rel(rows.reshape(xs.shape).numpy(), want) <= 1e-12


def test_dispatch_checks():
    psf = torch.as_tensor(gaussian_psf(8, 2.0))
    with pytest.raises(ValueError, match='otf operator requires'):
        top.make_operator(psf, (8, 9), 'otf')
    with pytest.raises(ValueError, match='matmul operator requires'):
        top.make_operator(psf, (8, 9), 'matmul')
    with pytest.raises(ValueError, match='raveled'):
        top.make_operator(psf, (8, 8), 'matmul_split')
    with pytest.raises(ValueError, match='shared PSF'):
        top.make_operator(torch.stack([psf, psf]), (64,), 'matmul_flat')
    with pytest.raises(ValueError, match='unknown operator'):
        top.make_operator(psf, (8, 8), 'fft')


@pytest.mark.cuda
@pytest.mark.parametrize('method,image,kernel', [
    ('otf', (64, 64), (64, 64)), ('linear', (120, 90), (9, 13)),
    ('linear', (64, 64), (15, 15))])
def test_fft_operators_on_card_match_cpu(method, image, kernel):
    """float64 on the card against the CPU within 1e-12 of max|y|, float32
    within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(37)
    psf = _psf(rng, kernel)
    xs = rng.uniform(0.0, 100.0, (3,) + image)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        out = {}
        for dev in ('cuda', 'cpu'):
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            out[dev] = [op(t(xs)).cpu().double().numpy()
                        for op in top.make_operator(t(psf), image, method)]
        for got, want in zip(out['cuda'], out['cpu']):
            assert _rel(got, want) <= tol
