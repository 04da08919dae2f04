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
    """Only the mesh operator 'halo' is still to be ported and raises
    naming its ROADMAP item; 'otf', 'linear' (A10) and 'matmul_split'
    (A11), which raised until they were ported, build and apply."""
    psf = torch.as_tensor(gaussian_psf(16, 2.8))
    shape = (256,) if method == 'matmul_split' else (16, 16)
    if item == 'A13':
        with pytest.raises(NotImplementedError, match=item):
            top.make_operator(psf, shape, method)
        return
    A, AT = top.make_operator(psf, shape, method)
    x = torch.ones((2,) + shape, dtype=psf.dtype)
    assert A(x).shape == AT(x).shape == x.shape


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


# generic betas, beta = 1 and 0 and their neighbourhoods (the expm1
# switches at |t| < eps/512 and the series at |s| < 0.25), a tiny normal
# beta whose products with d are subnormal (XLA flushes them to zero, torch
# on the CPU does not), and beta = 2
BETAS = [0.7, 1.005, 1.0, 1.0 + 1e-9, 1.0 - 1e-9, 0.0, 1e-9, -1e-9,
         2.225e-308, 1e-300, 2.0, 1.3]


def _beta_rows(seed, zeros=False):
    """(4, 256) den and gn, gn with zero pixels when ``zeros``, and a
    (4,) beta row per case."""
    rng = np.random.default_rng(seed)
    den = rng.uniform(0.5, 60.0, (4, 256))
    gn = den * rng.uniform(0.5, 1.5, (4, 256))
    gn[:, :8] = den[:, :8]                  # den == gn: d = 0
    if zeros:
        gn[:, 8:20] = 0.0
    return den, gn


@pytest.mark.parametrize('beta', BETAS)
@pytest.mark.parametrize('stable', [False, True])
def test_beta_div_matches_jax(beta, stable):
    """beta_div with and without a hoisted log(gn), gn == 0 pixels
    included, per row against JAX on each row, rtol 1e-12."""
    den, gn = _beta_rows(10, zeros=True)
    betas = np.array([beta, beta * 0.5, beta, 1.0]) if beta > 1e-200 \
        else np.full(4, beta)
    t = torch.as_tensor
    got = tdv.beta_div(t(den), t(gn), t(betas), stable=stable).numpy()
    pos = gn > 0
    lg = np.log(np.where(pos, gn, 1.0))
    got_log = tdv.beta_div(t(den[:, 20:]), t(gn[:, 20:]), t(betas),
                           log_gn=t(lg[:, 20:]), stable=stable).numpy()
    for i in range(4):
        want = float(jdv.beta_div(jnp.asarray(den[i]), jnp.asarray(gn[i]),
                                  betas[i], stable=stable))
        want_log = float(jdv.beta_div(jnp.asarray(den[i, 20:]),
                                      jnp.asarray(gn[i, 20:]), betas[i],
                                      log_gn=jnp.asarray(lg[i, 20:]),
                                      stable=stable))
        np.testing.assert_allclose(got[i], want, rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(got_log[i], want_log, rtol=1e-12,
                                   atol=1e-300)
        assert np.isfinite(got[i])


@pytest.mark.parametrize('beta', BETAS)
def test_beta_div_with_dbeta_matches_jax(beta):
    """The fused value and d/dbeta of the solver's line search, and the
    separate elementwise derivative beta_div_dbeta, against JAX."""
    den, gn = _beta_rows(11)
    betas = np.full(4, beta)
    t = torch.as_tensor
    fv, dsum = tdv.beta_div_with_dbeta(t(den), t(gn), t(betas),
                                       torch.log(t(gn)))
    delem = tdv.beta_div_dbeta(t(den), t(gn), t(betas)).numpy()
    for i in range(4):
        wf, wd = jdv.beta_div_with_dbeta(jnp.asarray(den[i]),
                                         jnp.asarray(gn[i]), betas[i],
                                         jnp.log(jnp.asarray(gn[i])))
        np.testing.assert_allclose(fv[i].item(), float(wf), rtol=1e-12,
                                   atol=1e-300)
        np.testing.assert_allclose(dsum[i].item(), float(wd), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(
            delem[i], np.asarray(jdv.beta_div_dbeta(jnp.asarray(den[i]),
                                                    jnp.asarray(gn[i]),
                                                    betas[i])),
            rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('beta', [0.7, 1.0, 1.0 + 1e-9, 0.0, 2.0])
def test_beta_grad_wrt_recon_matches_jax(beta):
    rng = np.random.default_rng(12)
    psf = gaussian_psf(16, 2.8)
    gn = rng.uniform(1.0, 50.0, (3, 256))
    den = rng.uniform(0.5, 60.0, (3, 256))
    betas = np.array([beta, beta + 0.1, beta])
    _, AT_j = jop.make_matmul_flat_operator(jnp.asarray(psf))
    _, AT_t = top.make_matmul_flat_operator(torch.as_tensor(psf))
    got = tdv.beta_grad_wrt_recon(AT_t, torch.as_tensor(den),
                                  torch.as_tensor(gn),
                                  torch.as_tensor(betas)).numpy()
    for i in range(3):
        np.testing.assert_allclose(
            got[i], np.asarray(jdv.beta_grad_wrt_recon(
                AT_j, jnp.asarray(den[i]), jnp.asarray(gn[i]), betas[i])),
            rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('beta', [0.0, 1.0, 1.3])
def test_beta_div_value_and_special_match_jax(beta):
    """The exact beta in {0, 1} branches and the dispatch that picks them
    for a Python float."""
    den, gn = _beta_rows(13)
    got = tdv.beta_div_value(torch.as_tensor(den), torch.as_tensor(gn),
                             beta).numpy()
    for i in range(4):
        want = float(jdv.beta_div_value(jnp.asarray(den[i]),
                                        jnp.asarray(gn[i]), beta))
        np.testing.assert_allclose(got[i], want, rtol=1e-12)
    if beta in (0.0, 1.0):
        np.testing.assert_array_equal(
            got, tdv.beta_div_special(torch.as_tensor(den),
                                      torch.as_tensor(gn), beta).numpy())
    with pytest.raises(ValueError, match='only beta 0 or 1'):
        tdv.beta_div_special(torch.as_tensor(den), torch.as_tensor(gn), 0.5)


def test_e2_series_dpow_kernel_and_lr_schedule_match_jax():
    """E2 on both sides of its |s| < 0.25 switch, the derivative kernel at
    t = 0, tiny and subnormal, and the learning-rate schedule."""
    s = np.concatenate([np.linspace(-3.0, 3.0, 41), [0.0, 1e-300, 0.2499,
                                                     0.25, -0.25]])
    np.testing.assert_allclose(
        tdv._e2_from_expm1(torch.as_tensor(s),
                           torch.expm1(torch.as_tensor(s))).numpy(),
        np.asarray(jdv._e2_from_expm1(jnp.asarray(s),
                                      jnp.expm1(jnp.asarray(s)))),
        rtol=1e-13)
    assert tdv._E2_COEFFS == jdv._E2_COEFFS
    rng = np.random.default_rng(14)
    v = rng.normal(0.0, 2.0, 50)
    delta = rng.normal(0.0, 1.0, 50)
    for t in (0.0, 1e-300, 2.225e-308, 1e-9, 0.3, -1.2):
        np.testing.assert_allclose(
            tdv._dpow_kernel(torch.tensor(t, dtype=torch.float64),
                             torch.as_tensor(v),
                             torch.as_tensor(delta)).numpy(),
            np.asarray(jdv._dpow_kernel(jnp.asarray(t), jnp.asarray(v),
                                        jnp.asarray(delta))),
            rtol=1e-12, atol=1e-300)
    epochs = np.arange(1.0, 40.0)
    np.testing.assert_allclose(
        tdv.lr_schedule(torch.full((39,), 1e-3, dtype=torch.float64), 0.1,
                        torch.as_tensor(epochs)).numpy(),
        np.asarray(jdv.lr_schedule(1e-3, 0.1, jnp.asarray(epochs))),
        rtol=1e-14)


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
