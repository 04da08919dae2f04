"""What crosses from the JAX package to the port: the config, a
checkpointed solver state, the synthetic data; and the port's import of
no JAX."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgp import SGPConfig as JaxConfig
from tpu_sgp import simulate as jsim
from tpu_sgp.solvers import sgp as jsgp
import tpu_sgp_torch as tsgp
from tpu_sgp_torch import simulate as tsim
from tpu_sgp_torch.convert import config_from_jax, state_from_numpy

REPO = Path(__file__).resolve().parents[1]


def test_config_fields_and_defaults_equal():
    jf = dataclasses.fields(JaxConfig)
    tf = dataclasses.fields(tsgp.SGPConfig)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert [f.default for f in jf] == [f.default for f in tf]
    assert tsgp.SGPConfig().torch_dtype == torch.float32


@pytest.mark.parametrize('bad', [dict(stop_criterion=7), dict(init_recon=9),
                                 dict(bt_factor=0.9), dict(operator='fft'),
                                 dict(projection_method='newton')])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as want:
        JaxConfig(**bad)
    with pytest.raises(ValueError) as got:
        tsgp.SGPConfig(**bad)
    assert str(got.value) == str(want.value)


def test_config_from_jax_round_trips():
    jcfg = JaxConfig(max_iter=77, stop_criterion=3, dtype='float64',
                     projection_method='pallas', axis_names=())
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.torch_dtype == torch.float64
    with pytest.raises(TypeError, match='not_a_field'):
        config_from_jax({'not_a_field': 1})


def test_jax_state_resumes_in_the_port():
    """A vmapped JAX solve stops at 10 iterations; its state, as the npz
    layout of checkpoint.py holds it, resumes in the port and reaches
    JAX's full-solve iteration counts and x."""
    stamps, psf, bkgs, _ = tsim.synthetic_star_stamps(6, size=16, seed=5)
    fluxes = stamps.sum(axis=(1, 2)) - 256 * bkgs
    kw = dict(max_iter=40, stop_criterion=3, tol_convergence=1e-4,
              init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
              dtype='float64', track_discr=True, operator='matmul_flat',
              projection_method='pallas')
    flat = stamps.reshape(6, -1)
    zeros = np.zeros_like(flat)
    ones = np.ones(6)

    def jax_batch(fn, cfg, *extra):
        return jax.vmap(lambda g, bk, f, *e: fn(
            g, jnp.asarray(psf), bk, jnp.zeros(256), f, jnp.zeros(256), 1.0,
            1e-3, 65000.0, *e, cfg))(jnp.asarray(flat),
                                     jnp.asarray(bkgs[:, None]),
                                     jnp.asarray(fluxes), *extra)

    full = jax_batch(jsgp.solve, JaxConfig(**kw))
    _, st = jax_batch(jsgp.solve_with_state,
                      JaxConfig(**dict(kw, max_iter=10)))
    arrays = {k: np.asarray(v) for k, v in st._asdict().items()}
    state = state_from_numpy(arrays, device='cpu', dtype=torch.float64)
    assert state.it.dtype == torch.int32 and state.keep.dtype == torch.bool
    assert int(state.it.max()) == 11        # stopped by the cap at 10

    res, _ = tsgp.resume_from_state(flat, psf, bkgs, zeros, fluxes, zeros,
                                    ones, 1e-3 * ones, 65000.0 * ones, state,
                                    tsgp.SGPConfig(**kw), device='cpu')
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(full.iters))
    want = np.asarray(full.x)
    rel = np.abs(res.x.numpy() - want).max(1) / np.abs(want).max(1)
    assert rel.max() <= 1e-9
    np.testing.assert_allclose(res.discr.numpy(), np.asarray(full.discr),
                               rtol=1e-9, atol=1e-12)


def test_state_from_numpy_fills_fields_older_checkpoints_lack():
    fields = {k: np.zeros(3) for k in tsgp.SGPState._fields
              if k not in ('lam_dual', 'dlam_dual')}
    state = state_from_numpy(fields, device='cpu')
    assert torch.isnan(state.lam_dual).all()
    assert torch.isinf(state.dlam_dual).all()
    with pytest.raises(KeyError, match='x_prev'):
        state_from_numpy({k: v for k, v in fields.items() if k != 'x_prev'},
                         device='cpu')


@pytest.mark.parametrize('n,size,seed', [(5, 31, 42), (3, 16, 7)])
def test_synthetic_star_stamps_bit_equal(n, size, seed):
    got = tsim.synthetic_star_stamps(n, size=size, seed=seed)
    want = jsim.synthetic_star_stamps(n, size=size, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_port_imports_no_jax():
    code = ("import sys, tpu_sgp_torch, tpu_sgp_torch.convert, "
            "tpu_sgp_torch.experimental.pallas_batch, "
            "tpu_sgp_torch.kernels.stamp_solver; "
            "sys.exit('jax' in sys.modules or any("
            "m == 'tpu_sgp' or m.startswith('tpu_sgp.') "
            "for m in sys.modules))")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
