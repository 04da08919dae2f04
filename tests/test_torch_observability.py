"""The port's observability module (``tpu_sgp_torch/observability.py``)
against the JAX package's: ``timed`` and ``profiled`` on the CPU, the
convergence log lines, and ``nan_guard`` raising and passing exactly where
the JAX guard does (inputs of ``tests/test_observability.py``). Also the
package names the JAX package exports, and that the modules of this slice
import no JAX.
"""
import logging
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from tpu_sgp_torch import observability as obs

from _torch_source_pin import REPO
from test_torch_workloads import _one_torch_thread  # noqa: F401


class _Pair(NamedTuple):
    total: torch.Tensor
    parts: list


def test_timed_returns_the_result_and_a_wall():
    calls = []

    def fn(x):
        calls.append(1)
        return _Pair((x * x).sum(), [x[:2], {'n': x.numel()}])

    out, wall = obs.timed(fn, torch.arange(1000.0, dtype=torch.float64),
                          repeats=2)
    assert float(out.total) == float(np.sum(np.arange(1000.0) ** 2))
    assert out.parts[1] == {'n': 1000} and wall > 0 and len(calls) == 3


def test_profiled_writes_a_trace(tmp_path):
    logdir = tmp_path / 'trace' / 'run'
    with obs.profiled(str(logdir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list(logdir.glob('*.pt.trace.json'))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert 'aten::mm' in traces[0].read_text()


def _log_lines(module, path):
    logger = module.setup_sgp_logging(str(path))
    discr = np.array([1.0, 0.5, 0.25, 0.125])
    for criterion, tol in ((1, None), (3, 1e-4), (4, 1.1)):
        module.log_convergence_series(discr, iters=3,
                                      stop_criterion=criterion, tol=tol,
                                      logger=logger)
    module.log_convergence_series(discr, iters=2, stop_criterion=3, tol=0.5)
    logging.shutdown()
    return open(path).read().splitlines()


def test_log_lines_are_the_jax_packages(tmp_path):
    """Criteria 1, 3 and 4, with the logger given and the default one: the
    same messages, line for line; each line's prefix names the package's
    own logger."""
    from tpu_sgp import observability as jobs
    got = _log_lines(obs, tmp_path / 'port.log')
    want = _log_lines(jobs, tmp_path / 'jax.log')
    assert len(got) == 11 and got[0] == 'INFO:tpu_sgp_torch:it 1 of run ' \
        '(discr 0.5)'
    assert got == [line.replace('INFO:tpu_sgp:', 'INFO:tpu_sgp_torch:')
                   for line in want]
    assert 'D_k' in got[6] and got[3].endswith('tol 0.0001')


def _raises(fn) -> bool:
    try:
        fn()
    except FloatingPointError:
        return True
    return False


def _cases(log_nan, guard, active):
    """The guard's behaviour: (a NaN raises under it, a disabled guard
    passes through, nested guards leave the outer one on, the state is
    restored on leaving)."""
    def enabled():
        with guard():
            log_nan()

    def disabled():
        with guard(enable=False):
            log_nan()

    def nested():
        with guard():
            with guard():
                pass
            log_nan()

    return (_raises(enabled), not _raises(disabled),
            _raises(nested) and not active(),
            not _raises(log_nan) and not active())


def test_nan_guard_raises_and_passes_where_the_jax_guard_does():
    import jax
    import jax.numpy as jnp
    from tpu_sgp import observability as jobs
    jax_cases = _cases(
        lambda: jax.block_until_ready(jnp.log(jnp.asarray(-1.0)) * 1.0),
        jobs.nan_guard, lambda: jax.config.jax_debug_nans)
    port_cases = _cases(lambda: torch.log(torch.tensor(-1.0)) * 1.0,
                        obs.nan_guard,
                        lambda: bool(_get_current_dispatch_mode_stack()))
    assert port_cases == jax_cases == (True, True, True, True)


def test_nan_guard_skips_allocations():
    with obs.nan_guard():
        out = torch.empty(4096, dtype=torch.float64)
        out.fill_(2.0)
        torch.empty_like(out).zero_()
        assert float(out.sum()) == 8192.0


def test_nan_guard_on_a_solve_against_the_jax_guard():
    """The 64x64 frame of eight stars with no background: the KL ratio
    gn / (A x + bkg) divides by zero (``tpu_sgp/ops/divergence.py:254``)
    and the restoration is NaN after two iterations in both packages, and
    the guard raises FloatingPointError in both. With a background of 150
    the restoration is finite and the JAX guard passes, because it checks
    a jitted solve's outputs only, while the port's solve runs operation
    by operation and makes Inf by design (``torch.where(gn > 0, gn, inf)``,
    a NaN dual root before the first projection), so its guard raises: a
    recorded difference."""
    from tpu_sgp import observability as jobs
    import tpu_sgp
    import tpu_sgp_torch as tsgp
    from tpu_sgp_torch.simulate import synthetic_star_field
    img, psf, _ = synthetic_star_field(64, 64, n_stars=8, psf_size=15,
                                       fwhm=3.0, seed=1)
    kw = dict(MAXIT=20, dtype='float64', verbose=False)
    with pytest.raises(FloatingPointError):
        with jobs.nan_guard():
            tpu_sgp.sgp(img, psf, 0.0, **kw)
    with jobs.nan_guard():
        jx = tpu_sgp.sgp(img, psf, 150.0, **kw)[0]
    for bkg, finite in ((0.0, False), (150.0, True)):
        with pytest.raises(FloatingPointError):
            with obs.nan_guard():
                tsgp.sgp(img, psf, bkg, device='cpu', **kw)
        with obs.nan_guard(enable=False):
            x = tsgp.sgp(img, psf, bkg, device='cpu', **kw)[0]
        assert np.isfinite(x).all() if finite else np.isnan(x).all()
    assert not _get_current_dispatch_mode_stack()
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-9 * np.abs(jx).max())


def test_packages_export_the_jax_names():
    """Every name a JAX subpackage exports, the port's exports too; of
    ``parallel`` all but the seven mesh names that multi-device support
    adds."""
    import tpu_sgp
    import tpu_sgp_torch
    mesh = {'make_image_mesh', 'make_batch_image_mesh', 'solve_distributed',
            'solve_distributed_batch', 'init_distributed',
            'global_device_grid', 'make_multiprocess_mesh'}
    for sub in ('image', 'catalog', 'psf', 'workloads', 'parallel'):
        __import__(f'tpu_sgp.{sub}')
        __import__(f'tpu_sgp_torch.{sub}')
        want = set(getattr(tpu_sgp, sub).__all__)
        got = set(getattr(tpu_sgp_torch, sub).__all__)
        assert want - (mesh if sub == 'parallel' else set()) <= got, sub
    assert not mesh & got and mesh <= want


def test_modules_of_this_slice_import_no_jax():
    """Importing the slice's modules and building the Rice codec leaves
    ``jax`` and the JAX package out of ``sys.modules`` (a fresh
    interpreter)."""
    code = ("import sys, tpu_sgp_torch.observability, tpu_sgp_torch.preprocess, "
            "tpu_sgp_torch.psf.pipeline, tpu_sgp_torch.catalog.plotting, "
            "tpu_sgp_torch.image.tile_compression as tc; "
            "tc.rice_native_available(); "
            "sys.exit('jax' in sys.modules or any("
            "m == 'tpu_sgp' or m.startswith('tpu_sgp.') "
            "for m in sys.modules))")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
