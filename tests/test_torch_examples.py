"""The port's runnable examples (``examples_torch/``) against the JAX
package's (``examples/``) on the CPU: ``deconvolve_demo``,
``serving_demo`` and ``build_allsky_map``.

Each test runs the JAX example's ``main`` and the port's ``run`` on the
same seeded inputs. Only the data shrink, as in
``tests/test_tutorial_snippets.py``: the synthetic constructors the
examples call are patched to smaller sizes (the same patched constructor
on both sides), and every line of the examples runs as written. Each
side's solver calls are recorded through a wrapper that passes them on
unchanged, except that where the JAX example's precision follows JAX's
x64 flag (the facade, float64 here) the port is called in float64.

The bars (ROADMAP, "Limits on what a test may ask"): float64 equal
per-lane iterations, x within 1e-9 of max|x| and the printed figures within
1e-6; float32 (where the example pins it in its ``SGPConfig``) equal
median iterations and mean |diters| <= 1.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from tpu_sgp_torch import simulate as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_RTOL = 1e-9
PRINTED_TOL = 1e-6


def load(folder: str, name: str):
    """The example ``folder/name.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f'{folder}_{name}', os.path.join(REPO, folder, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread_no_subnormals():
    """Torch and BLAS on one thread (several test workers share a few
    cores), and float32 subnormals flushed to zero, as XLA's CPU backend
    computes: the Gaussian PSF's tails are float32 subnormals, on which
    MKL's GEMM runs about 70 times slower (a (64, 961) @ (961, 961)
    product: 70 ms against 1 ms; the port's results were bit-equal either
    way on 64 stamps)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def recorded(mod, name, calls, **extra):
    """Wrap ``mod.name`` so that each call's arguments, keyword arguments
    and result are kept in ``calls``; ``extra`` keywords are added to the
    call."""
    fn = getattr(mod, name)

    def wrapper(*a, **k):
        out = fn(*a, **k, **extra)
        calls.append((a, k, out))
        return out
    return wrapper


def lane_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def f32_iters_close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert np.median(got) == np.median(want), (got, want)
    assert np.abs(got - want).mean() <= 1.0, (got, want)


# ---- deconvolve_demo ---------------------------------------------------------

def test_deconvolve_demo_matches_jax(tmp_path, monkeypatch, capsys):
    """A 64x64 field of 8 stars (the demo's 256x256 field of 60, cut) and
    the demo's 128 stamps: the facade's KL and beta solves in float64 lane
    for lane, the printed source count, flux and rel_err, the stamp batch
    (float32 in the demo's config) as distributions, the FITS files."""
    jd = load('examples', 'deconvolve_demo')
    td = load('examples_torch', 'deconvolve_demo')
    fields = []

    def field(h, w, n_stars=200, **kw):
        out = tsim.synthetic_star_field(min(h, 64), min(w, 64),
                                        n_stars=min(n_stars, 8), **kw)
        fields.append(out)
        return out

    calls = {'jax': [], 'torch': []}
    for side, mod, extra in (('jax', jd, {}),
                             ('torch', td, {'dtype': 'float64'})):
        monkeypatch.setattr(mod, 'synthetic_star_field', field)
        for name in ('sgp', 'sgp_beta_div'):
            monkeypatch.setattr(mod, name,
                                recorded(mod, name, calls[side], **extra))
        monkeypatch.setattr(mod, 'restore_stamps',
                            recorded(mod, 'restore_stamps', calls[side]))
    monkeypatch.chdir(tmp_path)
    jd.main()
    printed = capsys.readouterr().out
    got = td.run(device='cpu', out_dir='port_out')

    ((_, jk, (jx, jit, *_)), (_, _, (jxb, jitb, *_)),
     (_, _, jres)) = calls['jax']
    ((_, _, (tx, tit, *_)), (_, _, (txb, titb, *_)),
     (_, _, tres)) = calls['torch']
    n_src, flux = re.search(r'(\d+) detected sources, flux (\d+)',
                            printed).groups()
    assert got['finite'] and got['flux_err'] <= 1e-4
    assert got['n_sources'] == int(n_src) and got['n_sources'] > 0
    assert got['flux'] == jk['flux'] and round(got['flux']) == int(flux)
    assert tx.dtype == np.float64
    assert tit == jit == got['kl_iters']
    assert titb == jitb == got['beta_iters']
    assert lane_rel(tx, jx) <= F64_RTOL
    assert lane_rel(txb, jxb) <= F64_RTOL
    truth = fields[0][2]
    rel = td.relative_error
    for key, x in (('kl_rel_err', jx), ('beta_rel_err', jxb)):
        want = rel(np.maximum(x, 0), truth + 150)
        assert abs(got[key] - want) <= PRINTED_TOL, (key, got[key], want)
    f32_iters_close(tres.iters.numpy(), np.asarray(jres.iters))
    assert got['stamps_median_iters'] == int(np.median(np.asarray(
        jres.iters)))
    for name in ('field_orig', 'field_kl', 'field_beta'):
        assert (tmp_path / 'port_out' / f'{name}.fits').stat().st_size == \
            (tmp_path / 'demo_out' / f'{name}.fits').stat().st_size


# ---- build_allsky_map --------------------------------------------------------

# The demo's batch (stop rule 3 at 1e-6, up to 300 iterations) is chaotic in
# both packages: the iterations amplify a rounding difference until lanes
# stop far apart. At 48x48 the JAX package's own (H, W), flat and 'otf'
# layouts stop the four tiles at [39, 76, 96, 62], [75, 97, 60, 153] and
# [36, 74, 78, 74] in float32, [144, 114, 198, 150] and [218, 179, 176, 150]
# in float64 ((H, W) and flat, x 9 % apart), and agree within 6e-10 after 60
# iterations (measured on the CPU). So, as ROADMAP "Limits" asks, the
# iteration counts of the demo as written are not compared; the port's
# solver is held on the demo's own inputs in float64 at 60 iterations, lane
# for lane; and the printed float32 figures are held to about three times
# JAX's spread across its own layouts (0.003 ADU and 0.0008):
ALLSKY_SIZE = 48          # the demo's 96, cut
ALLSKY_F64_ITERS = 60
ALLSKY_LEVEL_TOL = 1e-2   # ADU, the source-free level
ALLSKY_RATIO_TOL = 2e-3   # the aperture flux ratio


def test_build_allsky_map_matches_jax(monkeypatch, capsys):
    """Tiles of 48x48: the background estimates (host code) within 1e-6;
    the demo's restore call on its own inputs through both packages in
    float64 at 60 iterations, equal iterations and x within 1e-9; the
    printed float32 source-free level and aperture flux ratio within the
    tolerances above; every restored tile finite."""
    import tpu_sgp
    import tpu_sgp.parallel.batch as jbatch
    ja = load('examples', 'build_allsky_map')
    ta = load('examples_torch', 'build_allsky_map')
    calls = []
    monkeypatch.setattr(jbatch, 'restore_stamps',
                        recorded(jbatch, 'restore_stamps', calls))
    assert ja.main(ALLSKY_SIZE) == 0
    printed = capsys.readouterr().out
    got = ta.run(ALLSKY_SIZE, device='cpu')

    est = np.array(re.search(r'estimated backgrounds: \[([^\]]*)\]',
                             printed).group(1).split(), float)
    np.testing.assert_allclose(got['est_bkg'], est, atol=PRINTED_TOL)
    level, ratio = (float(v) for v in re.search(
        r'source-free level ([-+\d.]+) .*\n.*map/true = ([\d.]+)',
        printed).groups())
    assert abs(got['resid_median'] - level) <= ALLSKY_LEVEL_TOL
    assert abs(got['flux_ratio'] - ratio) <= ALLSKY_RATIO_TOL
    assert np.isfinite(got['restored']).all()

    (stamps, psf, bkgs, cfg), kw, _ = calls[0]
    cut = dict(dtype='float64', max_iter=ALLSKY_F64_ITERS)
    want = jbatch.restore_stamps(stamps, psf, bkgs, cfg.replace(**cut),
                                 **kw)
    have = ta.restore_stamps(stamps, psf, bkgs, ta.tpu_sgp_torch.SGPConfig(
        **{**cfg.__dict__, **cut}), device='cpu', **kw)
    assert isinstance(cfg, tpu_sgp.SGPConfig)
    np.testing.assert_array_equal(have.iters.numpy(), np.asarray(want.iters))
    assert lane_rel(have.x.numpy(), want.x) <= F64_RTOL


# ---- serving_demo ------------------------------------------------------------

def test_serving_demo_matches_jax(monkeypatch, capsys):
    """The demo's 1024 stamps cut to the 512 its requests reach: the five
    requests, the two streams and the eight micro-batched clients through
    both sessions (float32, the session's default configuration): the
    five requests' results finite, flux within 1e-4, their lanes pooled
    as float32 distributions of iterations, the printed medians equal;
    both streams and the eight clients served on both sides."""
    from tpu_sgp.parallel import session as jsession
    from tpu_sgp_torch.parallel import session as tsession
    js = load('examples', 'serving_demo')
    ts = load('examples_torch', 'serving_demo')

    def stamps(n, *a, **kw):
        return tsim.synthetic_star_stamps(min(n, 512), *a, **kw)

    calls = {'jax': [], 'torch': []}
    for side, mod, cls in (('jax', js, jsession.RestorationSession),
                           ('torch', ts, tsession.RestorationSession)):
        monkeypatch.setattr(mod, 'synthetic_star_stamps', stamps)
        monkeypatch.setattr(cls, 'restore',
                            recorded(cls, 'restore', calls[side]))
    js.main()
    printed = capsys.readouterr().out
    got = ts.run(device='cpu')

    assert got['finite'] and got['flux_err'] <= 1e-4
    jreq = [np.asarray(out.iters) for _, _, out in calls['jax']]
    treq = [np.asarray(out.iters) for _, _, out in calls['torch']]
    # the five requests, then the eight clients' (served by the server's
    # worker through the session's packed path, not ``restore``)
    assert len(jreq) == len(treq) == 5
    for (_, _, jout), (_, _, tout) in zip(calls['jax'], calls['torch']):
        assert np.isfinite(tout.x).all() and tout.x.shape == jout.x.shape
    f32_iters_close(np.concatenate(treq), np.concatenate(jreq))
    medians = [int(m) for m in re.findall(r'\((\d+) median iters\)',
                                          printed)]
    assert [m for _, _, m in got['batches']] == medians
    assert [n for n, _, _ in got['batches']] == [17, 50, 64, 200, 256]
    assert [(c, n) for c, n, _ in got['streams']] == [(1, 512), (4, 512)]
    # every client served; how many device calls the 10 ms window makes
    # depends on the threads' timing
    jcalls = int(re.search(r'\((\d+) device calls\)', printed).group(1))
    assert 1 <= got['server_calls'] <= 8 and 1 <= jcalls <= 8
