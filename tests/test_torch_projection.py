"""The port's batched flux projection against the JAX Pallas kernel
(interpret mode on the CPU), and the CUDA kernel against its plain
version (on a card only).

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


@pytest.mark.parametrize('method,item', [('bisect', 'A5'), ('section', 'A5'),
                                         ('sort', 'A11'),
                                         ('secant', 'A11')])
def test_unported_methods_raise(method, item):
    with pytest.raises(NotImplementedError, match=item):
        tproj.check_method(method)


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
