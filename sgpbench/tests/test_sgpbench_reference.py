"""The plain reference against the program in float64, and its
independence from the program."""
import ast
import os

import numpy as np
import pytest
import torch

from sgpbench_tiny import BENCH, REPO  # noqa: F401  (puts the repo on path)

import sys
sys.path.insert(0, REPO)
sys.path.insert(0, BENCH)

from reference import sgp_plain  # noqa: E402
from traffic import data  # noqa: E402

SETTINGS = dict(init_recon=2, proj_type=1, stop_criterion=3, divergence='kl',
                m_mem=1, scale_data=True)


def program(gn, psf, bkg, cfg, **kw):
    from tpu_sgp_torch.parallel.batch import restore_stamps
    return restore_stamps(gn, psf, bkg, cfg, device='cpu', **kw)


@pytest.mark.parametrize('seed', [3, 2 ** 40 + 1])
def test_stamps_match_the_program_in_float64(seed):
    from tpu_sgp_torch import SGPConfig
    gn, psf, bkg, flux = data.star_stamps(12, 31, 2.8, 120.0, seed)
    s = dict(SETTINGS, max_iter=100, tol_convergence=1e-4, alpha_init=1.3)
    cfg = SGPConfig(**s, has_flux=True, has_sat_level=True, dtype='float64',
                    track_discr=False)
    res = program(gn, psf, bkg, cfg, fluxes=flux, sat_level=65000.0,
                  flatten=True)
    x, it = sgp_plain.solve(torch.tensor(gn), torch.tensor(psf),
                            torch.tensor(bkg), s, flux=torch.tensor(flux),
                            sat=65000.0)
    np.testing.assert_array_equal(it.numpy(), res.iters.numpy())
    gap = (np.linalg.norm((res.x - x).reshape(12, -1), axis=1)
           / np.linalg.norm(x.reshape(12, -1), axis=1))
    assert gap.max() < 1e-9


def test_frames_match_the_program_in_float64():
    from tpu_sgp_torch import SGPConfig
    fields = [data.star_field(48, 40, 6, 3.0, 31, 150.0, seed=s)
              for s in (1, 2)]
    gn = np.stack([f[0] for f in fields])
    psf = fields[0][1]
    s = dict(SETTINGS, max_iter=60, tol_convergence=1e-5)
    cfg = SGPConfig(**s, has_flux=False, dtype='float64', operator='linear')
    res = program(gn, psf, np.full(2, 150.0), cfg)
    x, it = sgp_plain.solve(torch.tensor(gn), torch.tensor(psf),
                            torch.full((2,), 150.0), s)
    np.testing.assert_array_equal(it.numpy(), res.iters.numpy())
    assert np.abs(res.x.numpy() - x.numpy()).max() < 1e-9 * x.abs().max()


def test_controls_part_from_the_reference():
    gn, psf, bkg, flux = data.star_stamps(8, 31, 2.8, 120.0, 5)
    s = dict(SETTINGS, max_iter=100, tol_convergence=1e-4)
    t = torch.tensor
    x, _ = sgp_plain.solve(t(gn), t(psf), t(bkg), s, flux=t(flux))
    for control in ('tf32', 'bf16'):
        xc, _ = sgp_plain.solve(t(gn), t(psf), t(bkg), s, flux=t(flux),
                                control=control)
        gap = np.linalg.norm((xc - x).reshape(8, -1), axis=1) / np.linalg.norm(
            x.reshape(8, -1), axis=1)
        assert np.median(gap) > 1e-3, control


def test_tf32_rounding():
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    r = sgp_plain._round_tf32(a)
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


def imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split('.')[0])
    return out


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, 'reference')
    for name in os.listdir(ref):
        if name.endswith('.py'):
            found = imports(os.path.join(ref, name))
            assert not found & {'jax', 'jaxlib', 'flax', 'tpu_sgp',
                                'tpu_sgp_torch'}, (name, found)
