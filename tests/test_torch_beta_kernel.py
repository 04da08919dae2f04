"""The beta objective with its d/dbeta row sums
(``ops.divergence.beta_div_with_dbeta``): on the CPU, the dispatch to the
plain version and to the kernel, and the kernel's plan of the compensated
tree against the plain tree; on a card only, the kernel
(``kernels.beta_divergence.beta_div_rows``) against the plain version
(``beta_div_with_dbeta_plain``) on the same CUDA tensors, and its launches
in a beta solve.

No JAX here, so that the card's tests run where it is not installed:
    python -m pytest tests/test_torch_beta_kernel.py --noconftest \
        -o addopts= -m cuda
"""
import numpy as np
import pytest
import torch

from tpu_sgp_torch import SGPConfig
from tpu_sgp_torch import observability as obs
from tpu_sgp_torch.kernels import beta_divergence as bk
from tpu_sgp_torch.kernels import launches
from tpu_sgp_torch.ops import divergence as dv
from tpu_sgp_torch.ops import reduce as tred

from test_torch_compensated_sum import _bits, _kernel_order_sum, _values
from test_torch_kernel_seam import _OnCard

DTYPES = (torch.float32, torch.float64)
# a row of one pixel to a frame's, a ragged and an exact power of two on
# each side of the 256-column cap, a 31x31 stamp
LENGTHS = (1, 2, 3, 31, 961, 1024, 1025, 4096, 4097, 168100, 2 ** 18 + 1)
# the rows' beta: the cell's start, the exact singular points, |beta| below
# eps/512 in both types (1e-20) and in float32 alone (1e-11), a beta just
# past 1, and values of the adapted range; further rows draw from it
BETAS = (1.005, 1.0, 0.0, 1e-20, 1e-11, 1.0 + 2 ** -20, 0.93, 1.17)


def _plan(n: int) -> tuple:
    """The kernel's plan of a row of ``n`` (``csrc/beta_divergence.cu``):
    p / 4 columns of the padded row p, within [1, 256], read 4 values a
    chunk."""
    bits = (n - 1).bit_length()
    cb = 0 if bits < 2 else min(bits - 2, 8)
    return 1 << cb, bits - cb, 2


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n', LENGTHS)
def test_kernel_plan_gives_the_tree(n, dtype):
    """The kernel's columns and chunks fold the objective's terms into
    ``gsum_ff``'s tree: the kernel's order with its plan gives the plain
    tree's bits (a stamp's row is the compensated sum's own plan, 256
    columns of 4)."""
    x = _values(np.random.default_rng(n + 7), 2, n, dtype)
    cols, levels, chunk = _plan(n)
    assert cols << levels == 1 << (n - 1).bit_length()
    assert torch.equal(_bits(_kernel_order_sum(x, cols, chunk)),
                       _bits(tred.tree_sum_ff(x)))


@pytest.mark.parametrize('stable', [False, True])
def test_cpu_tensors_take_the_plain_version(stable):
    """A CPU tensor keeps the plain version, bit for bit, and launches
    nothing; the kernel's wrapper refuses it."""
    den, gn, beta = _inputs(5, 961, torch.float64, 3)
    lg = torch.log(gn)
    before = launches['beta_div_rows']
    got = dv.beta_div_with_dbeta(den, gn, beta, lg, stable=stable)
    want = dv.beta_div_with_dbeta_plain(den, gn, beta, lg, stable=stable)
    assert launches['beta_div_rows'] == before
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match='CUDA'):
        bk.beta_div_rows(den, gn, beta, lg, stable)


class _Axes:
    """Stands in for mesh axes: records what it all-reduces and doubles
    it."""

    def __init__(self):
        self.reduced = []

    def __bool__(self):
        return True

    def all_reduce(self, x, op='sum'):
        self.reduced.append(op)
        return 2 * x


def test_cuda_tensors_launch_and_reduce_the_objective_alone(monkeypatch):
    """On a CUDA tensor the call is the kernel's, with its arguments as
    given; under mesh axes the objective is all-reduced and the d/dbeta
    sums stay local (the solver reduces them), as in the plain version."""
    calls = []
    fv, dsum = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])

    def kernel(*args):
        calls.append(args)
        return fv, dsum
    monkeypatch.setattr(bk, 'beta_div_rows', kernel)
    den, gn, lg = (_OnCard(torch.ones(2, 9)) for _ in range(3))
    axes = _Axes()
    got = dv.beta_div_with_dbeta(den, gn, 1.005, lg, axes, stable=True)
    assert calls == [(den, gn, 1.005, lg, True)]
    assert axes.reduced == ['sum']
    assert torch.equal(got[0], 2 * fv) and got[1] is dsum
    got = dv.beta_div_with_dbeta(den, gn, 0.9, lg)
    assert calls[-1] == (den, gn, 0.9, lg, False)
    assert got[0] is fv and got[1] is dsum


# ---- on a card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')


def _inputs(rows: int, n: int, dtype, seed: int, device='cpu') -> tuple:
    """den, gn and beta: gn photon counts spread over five decades, den
    = gn e^d with d in [-0.6, 0.6] so that |beta d| lies on both sides of
    the series switch at 0.25, and den == gn on every seventh pixel; beta
    ``BETAS``, then draws from [0.9, 1.2]."""
    rng = np.random.default_rng(seed)
    gn = rng.lognormal(np.log(300.0), 1.5, (rows, n))
    den = gn * np.exp(rng.uniform(-0.6, 0.6, (rows, n)))
    beta = rng.uniform(0.9, 1.2, rows)
    beta[:len(BETAS)] = BETAS[:rows]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    gn, den = t(gn), t(den)
    den[:, ::7] = gn[:, ::7]
    return den, gn, t(beta)


def _scales(den, gn, beta, lg) -> tuple:
    """Each row's sum of |term| of the objective and of d/dbeta, from the
    plain version one pixel a row."""
    rows, n = den.shape
    one = lambda a: a.reshape(-1, 1)
    terms = dv.beta_div_with_dbeta_plain(one(den), one(gn),
                                         beta.repeat_interleave(n), one(lg))
    return tuple(t.abs().reshape(rows, n).sum(-1) for t in terms)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('rows,n', [(1, 961), (7, 961), (2048, 961),
                                    (12288, 961), (1, 4096), (1, 168100)])
def test_kernel_against_the_plain_version_on_card(rows, n, dtype):
    """float32 with the compensated tree: the objective bit-equal to the
    plain version's, the d/dbeta sums within 1e-5 of sum |dphi| (another
    order of a plain sum); float32 without it both within 1e-5 of their
    sums of |term|; float64 both within 1e-12. One launch a call."""
    _card()
    den, gn, beta = _inputs(rows, n, dtype, rows + n, 'cuda')
    lg = torch.log(gn)
    f_scale, d_scale = _scales(den, gn, beta, lg)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for stable in (True, False):
        before = launches['beta_div_rows']
        fv, dsum = dv.beta_div_with_dbeta(den, gn, beta, lg, stable=stable)
        assert launches['beta_div_rows'] == before + 1
        pf, pd = dv.beta_div_with_dbeta_plain(den, gn, beta, lg,
                                              stable=stable)
        torch.cuda.synchronize()
        assert fv.shape == dsum.shape == (rows,)
        assert fv.dtype == dsum.dtype == dtype
        assert bool(torch.isfinite(fv).all() and torch.isfinite(dsum).all())
        if stable and dtype == torch.float32:
            assert torch.equal(_bits(fv), _bits(pf))
        else:
            assert bool(((fv - pf).abs() <= tol * f_scale).all())
        assert bool(((dsum - pd).abs() <= tol * d_scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_scalar_beta_and_strided_rows_on_card(dtype):
    """A Python beta is expanded over the rows; rows of a strided view
    (unit stride within a row) give the contiguous rows' results."""
    _card()
    den, gn, beta = _inputs(6, 2 * 961, dtype, 11, 'cuda')
    lg = torch.log(gn)
    view = lambda a: a[::2, 5:966]
    got = bk.beta_div_rows(view(den), view(gn), 1.005, view(lg), True)
    want = bk.beta_div_rows(view(den).contiguous(), view(gn).contiguous(),
                            torch.full((3,), 1.005, dtype=dtype,
                                       device='cuda'),
                            view(lg).contiguous(), True)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take():
    _card()
    den, gn, beta = _inputs(4, 300, torch.float32, 2, 'cuda')
    lg = torch.log(gn)
    with pytest.raises(ValueError, match='CUDA'):
        bk.beta_div_rows(den.cpu(), gn.cpu(), beta.cpu(), lg.cpu())
    for dtype in (torch.int32, torch.float16):
        with pytest.raises(TypeError, match='float32 or float64'):
            bk.beta_div_rows(den.to(dtype), gn, beta, lg)
    with pytest.raises(TypeError, match='gn is torch.float64'):
        bk.beta_div_rows(den, gn.double(), beta, lg)
    with pytest.raises(ValueError, match='unit stride'):
        bk.beta_div_rows(den.T.contiguous().T, gn, beta, lg)
    with pytest.raises(ValueError, match=r'log_gn must have shape'):
        bk.beta_div_rows(den, gn, beta, lg[:, :299])
    with pytest.raises(ValueError, match=r'beta must have shape'):
        bk.beta_div_rows(den, gn, beta[:3], lg)
    with pytest.raises(ValueError, match='size'):
        bk.beta_div_rows(den[:, :0], gn[:, :0], beta, lg[:, :0])
    before = launches['beta_div_rows']
    fv, dsum = bk.beta_div_rows(den[:0], gn[:0], beta[:0], lg[:0])
    assert fv.shape == dsum.shape == (0,)
    assert launches['beta_div_rows'] == before


@pytest.mark.cuda
def test_plans_on_card():
    """The C entry's plan is ``_plan``'s, and a stamp's row takes the
    compensated sum's own columns in both types."""
    _card()
    from tpu_sgp_torch.kernels import compensated_sum as cs
    for n in LENGTHS + (2 ** 31 - 1,):
        assert bk.beta_div_plan(n) == _plan(n)
    for dtype in DTYPES:
        assert bk.beta_div_plan(961)[:2] == cs.ff_sum_plan(961, dtype)[:2]
    for n in (0, 2 ** 31):
        with pytest.raises(ValueError, match='row length'):
            bk.beta_div_plan(n)


@pytest.mark.cuda
def test_beta_solve_launches_once_a_trial_on_card():
    """A float64 beta restore with beta adaptation on the card: one launch
    a ``beta.objective`` span but set-up's (which evaluates the objective
    alone), each counted under its span as ``beta_div.launches``."""
    _card()
    from tpu_sgp_torch.parallel.batch import restore_stamps
    from tpu_sgp_torch.simulate import synthetic_star_stamps
    stamps, psf, bkgs, _ = synthetic_star_stamps(8, size=12, seed=5)
    fluxes = stamps.sum(axis=(1, 2)) - 144 * bkgs
    cfg = SGPConfig(max_iter=40, stop_criterion=3, tol_convergence=1e-4,
                    proj_type=1, has_flux=True, init_recon=2,
                    has_sat_level=True, dtype='float64', divergence='beta',
                    adapt_beta=True, schedule_lr=True,
                    projection_method='section')
    before = launches['beta_div_rows']
    with obs.tracing() as t:
        res = restore_stamps(stamps, psf, bkgs, cfg, fluxes=fluxes,
                             sat_level=65000.0, flatten=True, device='cuda',
                             beta0=1.005, lr0=1e-3)
    launched = launches['beta_div_rows'] - before
    assert res.x.is_cuda and int(res.iters.max()) > 0
    assert launched == t.get('beta.objective').count - 1 > 0
    assert t.get('beta_div.launches').count == launched
    for path in t.by_path():
        if path[-1] == 'beta_div.launches':
            assert path[-2] == 'beta.objective'
