"""Parity of the port's operators, divergence and reductions with the JAX
package's, on the same seeded inputs (f64 unless stated)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgp.ops import divergence as jdv
from tpu_sgp.ops import psf_operator as jop
from tpu_sgp.ops import reduce as jred
from tpu_sgp_torch.ops import divergence as tdv
from tpu_sgp_torch.ops import psf_operator as top
from tpu_sgp_torch.ops import reduce as tred
from tpu_sgp_torch.simulate import gaussian_psf


@pytest.mark.parametrize('shape', [(31, 31), (16, 16), (5, 8)])
def test_circulant_matrix_equals_jax(shape):
    rng = np.random.default_rng(0)
    psf = rng.uniform(0.0, 1.0, shape)
    want = np.asarray(jop.build_circulant_matrix(jnp.asarray(psf)))
    got = top.build_circulant_matrix(torch.as_tensor(psf)).numpy()
    np.testing.assert_array_equal(got, want)


def test_batched_operator_matches_jax_rows():
    """A(X) = X @ C^T and AT(X) = X @ C row by row against JAX's
    make_matmul_flat_operator on each raveled stamp."""
    rng = np.random.default_rng(1)
    psf = gaussian_psf(16, 2.8)
    xs = rng.uniform(0.0, 100.0, (5, 256))
    A_j, AT_j = jop.make_matmul_flat_operator(jnp.asarray(psf))
    A_t, AT_t = top.make_operator(torch.as_tensor(psf), (256,),
                                  'matmul_flat')
    got_a = A_t(torch.as_tensor(xs)).numpy()
    got_at = AT_t(torch.as_tensor(xs)).numpy()
    for i in range(len(xs)):
        np.testing.assert_allclose(got_a[i], np.asarray(A_j(xs[i])),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got_at[i], np.asarray(AT_j(xs[i])),
                                   rtol=1e-12, atol=1e-12)


def test_image_operator_matches_flat():
    """'auto' on (B, H, W) stamps picks the dense matrix and equals the
    flat operator on the raveled rows."""
    rng = np.random.default_rng(2)
    psf = torch.as_tensor(gaussian_psf(16, 2.8))
    x = torch.as_tensor(rng.uniform(0.0, 10.0, (3, 16, 16)))
    A, AT = top.make_operator(psf, (16, 16))
    A_f, AT_f = top.make_matmul_flat_operator(psf)
    np.testing.assert_array_equal(A(x).reshape(3, -1).numpy(),
                                  A_f(x.reshape(3, -1)).numpy())
    np.testing.assert_array_equal(AT(x).reshape(3, -1).numpy(),
                                  AT_f(x.reshape(3, -1)).numpy())


@pytest.mark.parametrize('method,item', [('otf', 'A10'), ('linear', 'A10'),
                                         ('halo', 'A13'),
                                         ('matmul_split', 'A11')])
def test_unported_operators_raise(method, item):
    psf = torch.as_tensor(gaussian_psf(16, 2.8))
    shape = (256,) if method == 'matmul_split' else (16, 16)
    with pytest.raises(NotImplementedError, match=item):
        top.make_operator(psf, shape, method)


@pytest.mark.parametrize('stable', [False, True])
def test_kl_objective_and_grad_match_jax(stable):
    rng = np.random.default_rng(3)
    psf = gaussian_psf(16, 2.8)
    gn = rng.uniform(1.0, 50.0, (4, 256))
    x = rng.uniform(0.0, 20.0, (4, 256))
    bkg = rng.uniform(0.5, 2.0, (4, 1))
    flux = rng.uniform(100.0, 900.0, 4)
    A_j, AT_j = jop.make_matmul_flat_operator(jnp.asarray(psf))
    A_t, AT_t = top.make_matmul_flat_operator(torch.as_tensor(psf))
    x_tf = A_t(torch.as_tensor(x))
    den = x_tf + torch.as_tensor(bkg)
    fv = tdv.kl_objective(x_tf, den, torch.as_tensor(gn),
                          torch.as_tensor(flux), stable=stable).numpy()
    g = tdv.kl_grad_wrt_recon(AT_t, den, torch.as_tensor(gn)).numpy()
    for i in range(4):
        xt = A_j(x[i])
        dj = xt + bkg[i]
        np.testing.assert_allclose(
            fv[i], float(jdv.kl_objective(xt, dj, gn[i], flux[i],
                                          stable=stable)), rtol=1e-12)
        np.testing.assert_allclose(
            g[i], np.asarray(jdv.kl_grad_wrt_recon(AT_j, dj, gn[i])),
            rtol=1e-12, atol=1e-14)


def test_beta_divergence_raises():
    with pytest.raises(NotImplementedError, match='A9'):
        tdv.beta_div()


@pytest.mark.parametrize('n', [961, 256, 1, 1000])
def test_gsum_ff_equals_jax_f32(n):
    rng = np.random.default_rng(n)
    rows = rng.normal(0.0, 1e3, (3, n)).astype(np.float32)
    got = tred.gsum_ff(torch.as_tensor(rows)).numpy()
    for i in range(3):
        assert got[i] == np.float32(jred.gsum_ff(jnp.asarray(rows[i])))


def test_plain_reductions_match_jax():
    rng = np.random.default_rng(4)
    rows = rng.normal(0.0, 1.0, (3, 100))
    t = torch.as_tensor(rows)
    for ours, theirs in ((tred.gsum, jred.gsum), (tred.gmax, jred.gmax),
                         (tred.gmin, jred.gmin), (tred.gmean, jred.gmean)):
        np.testing.assert_allclose(
            ours(t).numpy(), [float(theirs(jnp.asarray(r))) for r in rows],
            rtol=1e-13)
    with pytest.raises(NotImplementedError, match='A13'):
        tred.gsum(t, ('batch',))
