"""The benchmark's seeded inputs repeat by seed, and follow the program's
simulation models."""
import sys

import numpy as np
import pytest

from sgpbench_tiny import BENCH, REPO

sys.path.insert(0, REPO)
sys.path.insert(0, BENCH)

from traffic import data  # noqa: E402
from traffic.open_loop import mix  # noqa: E402


@pytest.mark.parametrize('seed', [0, 2 ** 31 + 7, 2 ** 62 + 5])
def test_stamps_repeat_by_seed(seed):
    a = data.star_stamps(64, 31, 2.8, 120.0, seed)
    b = data.star_stamps(64, 31, 2.8, 120.0, seed)
    c = data.star_stamps(64, 31, 2.8, 120.0, seed + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_stamps_follow_the_programs_model():
    from tpu_sgp_torch.simulate import synthetic_star_stamps
    ours = data.star_stamps(200, 31, 2.8, 120.0, 42)
    theirs = synthetic_star_stamps(200, 31, seed=42)
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert (ours[0] == theirs[0]).all(axis=(1, 2)).mean() > 0.99
    np.testing.assert_array_equal(ours[3], ours[0].sum((1, 2)) - 961 * 120)


def test_fields_repeat_by_seed_and_follow_the_programs_model():
    from tpu_sgp_torch.simulate import synthetic_star_field
    a = data.star_field(64, 48, 10, 3.0, 31, 150.0, seed=9)
    b = data.star_field(64, 48, 10, 3.0, 31, 150.0, seed=9)
    theirs = synthetic_star_field(64, 48, n_stars=10, fwhm=3.0, psf_size=31,
                                  bkg=150.0, seed=9)
    np.testing.assert_array_equal(a[0], b[0])
    # the same draws; a blur that differs in its last bits may move a rare
    # Poisson draw across a rounding edge
    assert (a[0] == theirs[0]).mean() > 0.999
    np.testing.assert_allclose(a[1], theirs[1], rtol=1e-15)


def test_same_convolution_matches_scipy():
    from scipy.signal import fftconvolve
    rng = np.random.default_rng(1)
    for shape, kshape in (((40, 52), (31, 31)), ((17, 9), (5, 7)),
                          ((8, 8), (4, 6))):
        img, ker = rng.random(shape), rng.random(kshape)
        np.testing.assert_allclose(data.convolve_same(img, ker),
                                   fftconvolve(img, ker, mode='same'),
                                   rtol=1e-10, atol=1e-12)


CELL = {'arrivals': {'rate_per_s': 30.0, 'mix_seed': 61},
        'sizes': {'min': 4, 'max': 256}}


def test_mix_is_one_set_in_another_order():
    r = lambda s: np.random.default_rng(s)
    t1, s1 = mix(CELL, 20.0, r(1))
    t2, s2 = mix(CELL, 20.0, r(2))
    t1b, s1b = mix(CELL, 20.0, r(1))
    np.testing.assert_array_equal(t1, t1b)
    np.testing.assert_array_equal(s1, s1b)
    assert len(s1) == 600 and not np.array_equal(s1, s2)
    np.testing.assert_array_equal(np.sort(s1), np.sort(s2))
    np.testing.assert_allclose(np.sort(np.diff(np.r_[t1, 20.0])),
                               np.sort(np.diff(np.r_[t2, 20.0])), rtol=1e-9)
    assert s1.min() >= 4 and s1.max() <= 256 and 45 < s1.mean() < 75
    assert t1[0] == 0.0 and t1[-1] < 20.0


def test_bursts_keep_the_mean_rate():
    cell = {'arrivals': dict(CELL['arrivals'], burst={
        'factor': 4, 'on_s': 1, 'period_s': 4}), 'sizes': CELL['sizes']}
    t, _ = mix(cell, 20.0, np.random.default_rng(3))
    assert len(t) == 600 and t.max() < 20.0
    on = (t % 4.0) < 1.0
    # a quarter of the time holds 4/4 of the mean rate's share
    assert 0.9 < on.mean() / (4 * 1 / 4) < 1.1
