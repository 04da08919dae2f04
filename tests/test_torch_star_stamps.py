"""The star-stamp workload (``workloads/star_stamps.py``) in the port
against the JAX package on the CPU: the same seeded synthetic stamps, the
same host catalog, KL and beta.

The workload computes in float32 (its ``_workload_cfg``). As it stands,
the two packages sum in different orders, so iteration counts and metrics
are held as distributions; with ``_workload_cfg`` patched to float64 in
both modules (a patch from the test, no file changes) the counts are held
lane for lane and the restorations to 1e-9.
"""
import os
import types

import numpy as np
import pytest
import torch

from tpu_sgp_torch.workloads import star_stamps as tss

# torch on one thread a test (the fixture says why)
from test_torch_workloads import _one_torch_thread  # noqa: F401

N = 12
# metric arrays held to 1e-9 relative in float64. Two are held by their
# median over lanes instead, and bit for bit, with the rest of the host
# code, on equal restorations below: WD_RADIAL_PROFILE_DISTANCE is the
# distance between two Gaussian fits (scipy's curve_fit, which stops at its
# own tolerance, 1.5e-8), so a 1e-13 change of the restoration moves a fit
# by up to that tolerance and, on a flat cost surface, onto another optimum
# (2.4e-2 on one of 12 lanes); ELLIPTICITY_RATIO divides by the second
# moments of a restored star that can be a spike one pixel wide, where they
# follow rounding (4.7e-4 on one of 64 lanes, card against CPU)
EXACT = ('FLUX_FRACTIONAL_DIFFERENCE', 'FWHM_RATIO', 'ORIG_FLUX',
         'RESTORED_FLUX')
BY_MEDIAN = ('WD_RADIAL_PROFILE_DISTANCE', 'ELLIPTICITY_RATIO')


def _f64(monkeypatch, *mods):
    for mod in mods:
        orig = mod._workload_cfg
        monkeypatch.setattr(
            mod, '_workload_cfg',
            lambda *a, _o=orig, **k: _o(*a, **k).replace(dtype='float64'))


def _record(monkeypatch, mod, into):
    """Keep the restorations that ``run`` hands to its metric pass."""
    orig = mod.source_info_batch

    def rec(frames, **kw):
        into.append(np.stack(frames))
        return orig(frames, **kw)
    monkeypatch.setattr(mod, 'source_info_batch', rec)


def _both(tmp_path, use_beta):
    from tpu_sgp.workloads import star_stamps as jss
    want = jss.run(use_beta_div=use_beta, n_synthetic=N, save=True,
                   out_dir=str(tmp_path / 'jax'))
    got = tss.run(use_beta_div=use_beta, n_synthetic=N, save=True,
                  out_dir=str(tmp_path / 'port'), device='cpu')
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax'))
    assert len(os.listdir(tmp_path / 'port')) == len(got)
    assert set(got) == set(want)
    return got, want


def test_gathered_stamps_equal_the_jax_package():
    """Host code: equal stamps, PSFs, backgrounds, fluxes and tables."""
    from tpu_sgp.workloads import star_stamps as jss
    got, want = tss.gather_synthetic(N, 42), jss.gather_synthetic(N, 42)
    for name in ('stamps', 'psfs', 'bkgs', 'fluxes'):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for g, w in zip(got.orig_tables, want.orig_tables):
        for col in ('segment_flux', 'fwhm', 'xcentroid'):
            np.testing.assert_array_equal(g[col].value, w[col].value)
    assert tss._beta_candidates is tss.default_beta_candidates


@pytest.mark.parametrize('use_beta', [False, True], ids=['kl', 'beta'])
def test_float32_distributions_match_jax(tmp_path, use_beta):
    got, want = _both(tmp_path, use_beta)
    gi, wi = np.array(got['NUM_ITERS']), np.array(want['NUM_ITERS'])
    assert gi.shape == wi.shape and gi.size >= 10
    # 12 lanes: the median of an even count of integers moves by a half or
    # a whole when one lane stops one iteration later on one side
    assert abs(np.median(gi) - np.median(wi)) <= 1.0
    assert np.abs(gi - wi).mean() <= 2.0
    # a lane that stops 4 iterations later on one side moves its FWHM by
    # 1e-2, enough to move a 12-lane median by 2.6e-3: the medians are held
    # over the lanes that stop at the same iteration in both packages
    same = gi == wi
    assert same.mean() >= 0.5
    for name in ('FWHM_RATIO', 'FLUX_FRACTIONAL_DIFFERENCE'):
        g, w = np.array(got[name])[same], np.array(want[name])[same]
        assert abs(np.median(g) - np.median(w)) <= 1e-3, name
    np.testing.assert_array_equal(got['ORIG_FLUX'], want['ORIG_FLUX'])


@pytest.mark.parametrize('use_beta', [False, True], ids=['kl', 'beta'])
def test_float64_lane_for_lane_matches_jax(tmp_path, monkeypatch, use_beta):
    from tpu_sgp.workloads import star_stamps as jss
    _f64(monkeypatch, tss, jss)
    restored = {'port': [], 'jax': []}
    _record(monkeypatch, tss, restored['port'])
    _record(monkeypatch, jss, restored['jax'])
    got, want = _both(tmp_path, use_beta)
    assert got['NUM_ITERS'] == want['NUM_ITERS']
    assert got['WD_FIT_OK'] == want['WD_FIT_OK']
    (xg,), (xw,) = restored['port'], restored['jax']
    assert np.abs(xg - xw).max() <= 1e-9 * np.abs(xw).max()
    for name in EXACT:
        g, w = np.array(got[name]), np.array(want[name])
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), name
    for name in BY_MEDIAN:
        g, w = np.array(got[name]), np.array(want[name])
        assert np.median(np.abs(g - w) / np.abs(w)) <= 1e-5, name


def test_metrics_on_equal_restorations_are_bit_equal(tmp_path, monkeypatch):
    """The host half of ``run`` (catalogs, radial profiles, fits,
    distances) given the same restorations in both packages: every metric
    array but the timing bit-equal."""
    from tpu_sgp.workloads import star_stamps as jss
    sset = tss.gather_synthetic(N, 42)
    rng = np.random.default_rng(3)
    # a stand-in restoration: the stamp sharpened and rescaled, per lane
    x = np.clip(sset.stamps - sset.bkgs[:, None, None], 0.0, None) ** 1.3
    x *= (sset.fluxes / x.sum(axis=(1, 2)))[:, None, None]
    x += rng.uniform(0.0, 0.5, x.shape)
    iters = np.arange(N) + 10
    monkeypatch.setattr(jss, 'restore_stamps', lambda *a, **k:
                        types.SimpleNamespace(x=x.copy(), iters=iters))
    monkeypatch.setattr(tss, 'restore_stamps', lambda *a, **k:
                        types.SimpleNamespace(x=torch.from_numpy(x.copy()),
                                              iters=torch.from_numpy(iters)))
    got, want = _both(tmp_path, False)
    assert len(got['FWHM_RATIO']) >= 10
    for name in got:
        if name != 'EXEC_TIME':
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_main_prints_the_summary(tmp_path, capsys):
    m = tss.main(['--n_synthetic', '8', '--out_dir', str(tmp_path),
                  '--seed', '7', '--device', 'cpu'])
    assert 'NUM_ITERS: median=' in capsys.readouterr().out
    assert len(m['NUM_ITERS']) >= 6
    assert (tmp_path / 'NUM_ITERS.npy').exists()


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tss.run(n_synthetic=4, save=False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tss.main(['--n_synthetic', '4'])
