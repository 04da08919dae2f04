"""The subdivision, spatial-PSF and simulation workloads in the port
against the JAX package on the CPU, in float64: the same seeded frames,
fixtures and PSF models through both packages, equal iteration counts,
restorations within 1e-9, the same files written.
"""
import os

import numpy as np
import pytest
import torch

from tpu_sgp_torch import SGPConfig
from tpu_sgp_torch.psf import native as tnative
from tpu_sgp_torch.psf.diapl import DiaplPSFModel
from tpu_sgp_torch.simulate import synthetic_star_field
from tpu_sgp_torch.workloads import simulation as tsim
from tpu_sgp_torch.workloads import spatial_psf as tspat
from tpu_sgp_torch.workloads import subdivisions as tsub

FIXTURES = ('NGC7027_255.mat', 'satellite_25500.mat')
# The seeded fixtures are two point sources, which the iteration sharpens
# into spikes: past about 60 iterations two float64 runs that differ by
# rounding alone part (rel_err 1e-13 apart after 27 iterations and 1e-10
# after 60 on the 16x16 satellite fixture, 4e-2 after 120 and 1e-2 after
# 332), so the satellite's 332 iterations are cut to the NGC fixture's 27
# in the tests that compare the packages
CUT_MAXIT = 27


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs several worker processes on a few cores, where
    torch's intra-op threads wait on each other at every small operation
    (a test ten times slower): these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- subdivisions ------------------------------------------------------------

def _record_solves(monkeypatch, mod, solves, fluxes):
    """Keep each solve's (beta, x, iterations) and the catalog flux of
    each restoration, in call order."""
    for name in ('sgp', 'sgp_beta_div'):
        orig = getattr(mod, name)

        def solve(*a, _o=orig, **k):
            out = _o(*a, **k)
            solves.append((k.get('betaParam'), np.asarray(out[0]), out[1]))
            return out
        monkeypatch.setattr(mod, name, solve)
    info = mod.source_info

    def source_info(x, **k):
        scat, bkg = info(x, **k)
        if k.get('n_pixels') == 1:
            fluxes.append(float(np.sum(scat.to_table(['segment_flux'])[
                'segment_flux'].value)) if scat is not None else np.nan)
        return scat, bkg
    monkeypatch.setattr(mod, 'source_info', source_info)


def test_subdivisions_kl_match_jax(tmp_path):
    from tpu_sgp.workloads import subdivisions as jsub
    kw = dict(use_beta_div=False, crowded=False, dtype='float64', maxit=20,
              warm=False)
    want = jsub.run(out_dir=str(tmp_path / 'jax'), **kw)
    got = tsub.run(out_dir=str(tmp_path / 'port'), device='cpu', **kw)
    assert got['iters'] == want['iters'] >= 1
    assert got['best_beta'] is want['best_beta'] is None
    assert _rel(got['restored'], want['restored']) <= 1e-9
    assert got['n_orig_detections'] == want['n_orig_detections']
    assert got['n_restored_detections'] == want['n_restored_detections'] > 0
    np.testing.assert_array_equal(got['orig_fluxes'], want['orig_fluxes'])
    assert _rel(got['restored_fluxes'], want['restored_fluxes']) <= 1e-9
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax'))


def test_subdivisions_beta_match_jax(tmp_path, monkeypatch):
    """The candidate search: each of the five candidate solves equal
    (iterations, x within 1e-9, catalog flux within 1e-9). The flux
    conserving projection leaves several candidates' restored catalog
    fluxes equal to rounding (three of five here, 1e-12 apart), so which of
    them wins is decided by rounding, in each package from one run to the
    next: the port's pick is held to score within 1e-9 of the JAX
    package's best, and its final solve to equal the JAX package's
    candidate solve at that beta."""
    from tpu_sgp.workloads import subdivisions as jsub
    rec = {'port': ([], []), 'jax': ([], [])}
    _record_solves(monkeypatch, tsub, *rec['port'])
    _record_solves(monkeypatch, jsub, *rec['jax'])
    kw = dict(use_beta_div=True, crowded=False, dtype='float64', maxit=20,
              warm=False)
    want = jsub.run(out_dir=str(tmp_path / 'jax'), **kw)
    got = tsub.run(out_dir=str(tmp_path / 'port'), device='cpu', **kw)
    (g_solves, g_flux), (w_solves, w_flux) = rec['port'], rec['jax']
    assert len(g_solves) == len(w_solves) == 6
    for (gb, gx, gi), (wb, wx, wi) in zip(g_solves[:5], w_solves[:5]):
        assert gb == wb and gi == wi
        assert _rel(gx, wx) <= 1e-9
    assert _rel(g_flux[:5], w_flux[:5]) <= 1e-9
    flux = float(np.sum(want['orig_fluxes']))
    np.testing.assert_array_equal(got['orig_fluxes'], want['orig_fluxes'])
    ffd = 1.0 - np.array(w_flux[:5]) / flux
    cands = [b for b, _, _ in w_solves[:5]]
    pick = cands.index(got['best_beta'])
    assert ffd[pick] - ffd.min() <= 1e-9
    assert g_solves[5][0] == got['best_beta']
    assert got['iters'] == w_solves[pick][2]
    assert _rel(got['restored'], w_solves[pick][1]) <= 1e-9
    assert got['n_restored_detections'] > 0
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax'))


# ---- spatial PSF -------------------------------------------------------------

def seeded_diapl_model(seed: int = 0) -> DiaplPSFModel:
    """A two-Gaussian DIAPL model (local degree 2, spatial degree 1) whose
    second component's weight and whose asymmetry drift across the frame:
    the layout of the reference's ``.bin.txt`` with seeded coefficients."""
    rng = np.random.default_rng(seed)
    base = np.zeros(12)            # per Gaussian: 1, y, y^2, x, xy, x^2
    base[[0, 6]] = 1.0, 0.3
    base[[1, 3, 7, 9]] = rng.normal(0.0, 2e-3, 4)
    base[[2, 4, 5, 8, 10, 11]] = np.abs(rng.normal(0.0, 1e-4, 6))
    grad_y, grad_x = np.zeros(12), np.zeros(12)
    grad_y[[1, 6]] = 2e-6, -5e-5
    grad_x[[3, 6]] = -3e-6, 1e-4
    return DiaplPSFModel(
        hw=15, ndeg_spat=1, ndeg_local=2, ngauss=2, recenter=1.0,
        cos=float(np.cos(0.3)), sin=float(np.sin(0.3)), ax=-0.32, ay=-0.26,
        sigma_inc=0.7, sigma_mscale=1.0, fitrad=15.0, x_orig=64.0,
        y_orig=64.0, vec_coeffs=np.concatenate([base, grad_y, grad_x]))


def _jax_model(model):
    from dataclasses import asdict

    from tpu_sgp.psf.diapl import DiaplPSFModel as JaxModel
    return JaxModel(**asdict(model))


def test_tile_psf_renderers_agree_and_match_jax(monkeypatch):
    """The C++ bulk renderer and the NumPy one within 1e-12, each equal to
    the JAX package's; normalised, and varying across the field."""
    from tpu_sgp.workloads import spatial_psf as jspat
    if not tnative.available():
        pytest.skip('no C++ toolchain: only the NumPy renderer runs')
    model = seeded_diapl_model()
    centers = np.array([[10.0, 12.0], [64.0, 64.0], [120.0, 100.0],
                        [2000.0, 1500.0]])
    native = tspat.render_tile_psfs(model, centers, 31)
    np.testing.assert_array_equal(
        native, jspat.render_tile_psfs(_jax_model(model), centers, 31))
    monkeypatch.setattr(tnative, 'available', lambda: False)
    plain = tspat.render_tile_psfs(model, centers, 31)
    assert np.abs(native - plain).max() <= 1e-12
    np.testing.assert_allclose(plain.sum(axis=(1, 2)), 1.0, rtol=1e-12)
    assert np.abs(plain[0] - plain[-1]).max() > 1e-4


def test_restore_with_spatial_psf_matches_jax():
    from tpu_sgp import SGPConfig as JaxConfig
    from tpu_sgp.workloads import spatial_psf as jspat
    image, _, _ = synthetic_star_field(128, 128, n_stars=12, seed=7,
                                       flux_range=(3e4, 9e4))
    model = seeded_diapl_model()
    cfg = dict(max_iter=25, stop_criterion=3, tol_convergence=1e-4,
               init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
               dtype='float64', operator='linear')
    kw = dict(subdiv_shape=(64, 64), overlap=8)
    want_m, want = jspat.restore_with_spatial_psf(
        image, _jax_model(model), JaxConfig(**cfg), **kw)
    got_m, got = tspat.restore_with_spatial_psf(
        image, model, SGPConfig(**cfg), device='cpu', **kw)
    assert len(got['origins']) == len(want['origins']) == 9
    np.testing.assert_array_equal(got['iters'], np.asarray(want['iters']))
    assert np.abs(got['psfs'] - want['psfs']).max() <= 1e-12
    assert _rel(got['tiles'], want['tiles']) <= 1e-9
    np.testing.assert_array_equal(got['footprint'], want['footprint'])
    cover = want['footprint'] > 0
    assert _rel(got_m[cover], want_m[cover]) <= 1e-9
    assert np.isfinite(got_m[cover]).all()


# ---- simulation --------------------------------------------------------------

def write_fixtures(path, n: int = 16, seed: int = 7) -> None:
    """Seeded ``.mat`` fixtures in the SGP-dec layout (gn, psf, bg, obj)."""
    from scipy.io import savemat
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n] - n // 2
    psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * 1.5 ** 2))
    psf /= psf.sum()
    obj = np.zeros((n, n))
    obj[5, 6] = 900.0
    obj[11, 9] = 600.0
    bg = 10.0
    gn = np.real(np.fft.ifft2(np.fft.fft2(obj)
                              * np.fft.fft2(np.fft.ifftshift(psf)))) + bg
    gn = rng.poisson(np.maximum(gn, 0.0)).astype(np.float64)
    for name in FIXTURES:
        savemat(str(path / name), {'gn': gn, 'psf': psf,
                                   'bg': np.array([[bg]]), 'obj': obj})


@pytest.mark.parametrize('fixture', FIXTURES)
def test_simulation_float64_matches_jax(tmp_path, fixture):
    from tpu_sgp.workloads import simulation as jsim
    write_fixtures(tmp_path)
    kw = dict(data_dir=str(tmp_path), dtype='float64', maxit=CUT_MAXIT)
    want = jsim.run_kl(fixture, **kw)
    got = tsim.run_kl(fixture, device='cpu', **kw)
    assert abs(got[1] - want[1]) <= 1e-9 * want[1]
    assert _rel(got[0], want[0]) <= 1e-9
    want = jsim.run_beta(fixture, do_sampling=True, n_draws=3, **kw)
    got = tsim.run_beta(fixture, do_sampling=True, n_draws=3, device='cpu',
                        **kw)
    assert got[4] == want[4]
    assert abs(got[1] - want[1]) <= 1e-9 * want[1]


def test_simulation_main_matches_jax(tmp_path, capsys, monkeypatch):
    """``main`` / ``run_all`` at their default dtype: float64 in the JAX
    package under x64, float32 in the port (ROADMAP Queue C)."""
    from tpu_sgp.workloads import simulation as jsim
    for mod in (jsim, tsim):
        monkeypatch.setattr(mod, 'SAT_MAXIT', CUT_MAXIT)
    write_fixtures(tmp_path)
    want = jsim.main(['--data_dir', str(tmp_path)])
    got = tsim.main(['--data_dir', str(tmp_path), '--device', 'cpu'])
    assert set(got) == set(want) == {'ngc_kl', 'sat_kl', 'ngc_beta',
                                     'sat_beta'}
    # the JAX package's own float32 lies 3e-5 (KL) and 2e-3 (beta) from
    # its float64 here: the port's float32 is held to 1e-3 or to twice
    # that distance, whichever is larger
    runs = {'kl': jsim.run_kl, 'beta': jsim.run_beta}
    for k, v in got.items():
        fixture = FIXTURES[k.startswith('sat')]
        own = abs(runs[k.split('_')[1]](fixture, data_dir=str(tmp_path),
                                        dtype='float32')[1] - want[k])
        assert np.isfinite(v), k
        assert abs(v - want[k]) <= max(1e-3 * want[k], 2 * own), k
    assert 'ngc_kl: rel_err' in capsys.readouterr().out
    assert tsim.DEFAULT_DATA_DIR.endswith(
        os.path.join('restoration', 'simulated_test', 'data'))


# ---- no card -----------------------------------------------------------------

def test_workloads_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    write_fixtures(tmp_path)
    image, _, _ = synthetic_star_field(64, 64, n_stars=4, seed=3)
    for call in (lambda: tsub.run(crowded=False, save=False, maxit=2),
                 lambda: tsim.run_kl(data_dir=str(tmp_path), maxit=2),
                 lambda: tsim.run_beta(data_dir=str(tmp_path), maxit=2),
                 lambda: tsim.run_all(str(tmp_path)),
                 lambda: tspat.restore_with_spatial_psf(
                     image, seeded_diapl_model(), subdiv_shape=(32, 32))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
