"""The whole-frame beta-SGP deployment (``sgpbench/configs/
m13_frame2048_beta.json``) at a small size on the CPU: ``restore_stamps`` on
one frame with the configuration's settings (the linear FFT operator, beta
adaptation with the lr schedule, ``'bisect'``) against the benchmark's
plain float64 reference (``sgpbench/reference/sgp_beta_plain.py``, loaded
by path) and against the one-image facade ``sgp_beta_div`` that the CLI's
whole-image mode calls; on a card only, the beta kernel's pixel counter.

The card's case runs where JAX is not installed:
    python -m pytest tests/test_torch_beta_frame.py --noconftest \
        -o addopts= -m cuda
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpu_sgp_torch import SGPConfig, sgp_beta_div
from tpu_sgp_torch import observability as obs
from tpu_sgp_torch.kernels import launches
from tpu_sgp_torch.parallel.batch import restore_stamps
from tpu_sgp_torch.simulate import synthetic_star_field

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'sgpbench')
REFERENCE = os.path.join(BENCH, 'reference', 'sgp_beta_plain.py')
CONFIG = os.path.join(BENCH, 'configs', 'm13_frame2048_beta.json')

SIZE = 64
BKG = 150.0
# the configuration's solver settings that the reference takes
SETTINGS = dict(init_recon=2, proj_type=1, stop_criterion=3,
                divergence='beta', m_mem=1, scale_data=True, max_iter=500,
                tol_convergence=1e-4, alpha_init=1.3, beta0=1.005, lr0=1e-3,
                adapt_beta=True, schedule_lr=True, lr_exp_param=0.1)
# fields on which 'bisect' and 'sort' both land within 1e-9 of the
# reference's exact projection (read 9e-11 and 8e-12); on seed 1 both
# read 2e-9 to 6e-9, the field's own sensitivity and not the method's
SEEDS = (0, 7)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several worker processes share a few cores: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    spec = importlib.util.spec_from_file_location(
        'sgpbench_reference_sgp_beta_plain', REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field(seed: int):
    img, psf, _ = synthetic_star_field(SIZE, SIZE, n_stars=8, psf_size=31,
                                       fwhm=3.0, bkg=BKG, seed=seed)
    return img, psf


def _config(dtype: str) -> SGPConfig:
    keys = ('init_recon', 'proj_type', 'stop_criterion', 'divergence',
            'm_mem', 'scale_data', 'max_iter', 'tol_convergence',
            'alpha_init', 'adapt_beta', 'schedule_lr', 'lr_exp_param')
    return SGPConfig(**{k: SETTINGS[k] for k in keys}, has_flux=False,
                     has_sat_level=False, dtype=dtype, track_discr=False,
                     projection_method='bisect', operator='linear')


def _program(img, psf, dtype='float64', device='cpu'):
    return restore_stamps(img[None], psf, np.array([BKG]), _config(dtype),
                          fluxes=None, sat_level=0.0,
                          beta0=SETTINGS['beta0'], lr0=SETTINGS['lr0'],
                          device=device)


def test_the_configuration_is_what_the_tests_run():
    import json
    with open(CONFIG) as f:
        doc = json.load(f)
    for k, v in SETTINGS.items():
        assert doc[k] == v, k
    assert (doc['operator'], doc['projection_method'], doc['psf_size'],
            doc['has_flux'], doc['has_sat_level']) == (
                'linear', 'bisect', 31, False, False)
    assert doc['reference'] == 'sgp_beta_plain'


@pytest.mark.parametrize('seed', SEEDS)
def test_float64_frame_matches_the_plain_reference(seed):
    img, psf = _field(seed)
    ref = _reference()
    x_ref, it_ref, beta_ref = ref.solve_with_beta(
        torch.tensor(img[None]), torch.tensor(psf), torch.tensor([BKG]),
        SETTINGS)
    res = _program(img, psf)
    np.testing.assert_array_equal(res.iters.numpy(), it_ref.numpy())
    x, xr = res.x.numpy().ravel(), x_ref.numpy().ravel()
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-8
    assert abs(float(res.beta[0]) - float(beta_ref[0])) < 1e-10
    # a rejected trial moved beta on this field
    assert float(beta_ref[0]) != SETTINGS['beta0']


def test_restore_stamps_on_one_frame_is_the_facade():
    """The cell's entry on one frame is the CLI's whole-image call,
    ``sgp_beta_div`` with the CLI's beta arguments, in float64."""
    img, psf = _field(SEEDS[0])
    x, iters, *_ = sgp_beta_div(
        img, psf, BKG, init_recon=2, proj_type=1, stop_criterion=3,
        MAXIT=500, alpha=1.3, betaParam=1.005, lr=1e-3, lr_exp_param=0.1,
        schedule_lr=True, tol_convergence=1e-4,
        use_original_SGP_Afunction=False, dtype='float64', device='cpu')
    res = _program(img, psf)
    assert int(res.iters[0]) == iters
    got = res.x.numpy()[0]
    assert np.abs(got - x).max() <= 1e-12 * np.abs(x).max()


@pytest.mark.cuda
def test_beta_pixels_count_each_launchs_rows_on_card():
    """After one float32 beta solve of a frame on the card, traced: the
    counter ``beta_div.pixels`` is ``beta_div.launches`` x N, each under
    ``beta.objective``, and the launches those of the launch counter."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    img, psf = _field(SEEDS[0])
    before = launches['beta_div_rows']
    with obs.tracing() as t:
        res = _program(img, psf, 'float32', 'cuda')
    launched = launches['beta_div_rows'] - before
    assert res.x.is_cuda and int(res.iters[0]) > 0
    assert t.get('beta_div.launches').count == launched > 0
    assert t.get('beta_div.pixels').count == launched * SIZE * SIZE
    for path in t.by_path():
        if path[-1] in ('beta_div.launches', 'beta_div.pixels'):
            assert path[-2] == 'beta.objective'
