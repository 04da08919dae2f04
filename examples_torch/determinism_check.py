"""Fresh-process determinism check for float32 whole-frame stopping (the
port of ``examples/determinism_check.py``).

Stop rules 2/3 compare float32-accumulated scalars against 1e-5
tolerances, so a change in the order of a sum can move the iteration a
frame stops at. ``SGPConfig.stable_sums='auto'`` fixes that order with a
compensated pairwise tree (``ops/reduce.gsum_ff``) for float32 single
images. The JAX package needs it because XLA's compile-dependent tiling
reshuffled the order on the TPU; whether eager PyTorch on the card
reshuffles it at all is what this script measures.

Each arm runs the 410x410 float32 frame at stop rule 3 and 1e-5 in a
fresh process (``--solo``), under three perturbations that can move a
float32 reduction order on the card without touching any stop-rule math:

  default:       nothing changed.
  cublas-workspace: ``CUBLAS_WORKSPACE_CONFIG=:0:0``. cuBLAS picks its
                 GEMM algorithm by the workspace it may use; with none,
                 the split-K algorithms (which add partial sums in another
                 order) are ruled out. It moves every product of the path
                 that goes through cuBLAS.
  deterministic-algorithms: ``torch.use_deterministic_algorithms(True)``
                 (warnings only, with cuBLAS's fixed workspace). PyTorch
                 swaps the kernels that add with atomics, whose order
                 follows the race between threads, for ordered ones, and
                 so moves every such sum of the path.
  Whether the frame path has a product or an atomic sum that these move
  is what the negative control says.

  Not a perturbation here: solving the frame as lane 0 of a batch of two.
  That is another request, not the same one run again: it changes the
  launch shape of the solver's batched operations (and on the CPU the
  FFTs' rounding too), the float32 trajectory parts from the first
  iteration and grows about tenfold every ten, and the stop iteration
  moves in both arms, because the compensated sums fix the order of the
  stop rule's own sums, not the trajectory that feeds them. The JAX check
  varied only how one program was compiled, never its shapes.
  ``chip_smoke.py`` phase 39 measures what a batch of two changes.

  * stable_sums=True  arm: the iteration counts MUST agree.
  * stable_sums=False arm: the negative control. A perturbation that
    flips its count demonstrably moved the reduction order, which makes
    the stable arm's pass meaningful; if every run agrees the control is
    INCONCLUSIVE (reported as such; the exit code follows the stable arm).

The six solo processes run side by side: the card serves them all, and
on the CPU each runs torch on one thread (the count of threads is itself
part of the CPU's summation order, so it is the same in every run).

Usage:  python examples_torch/determinism_check.py [--device cpu]
            [--size N]                # the six runs; N=410 by default
        python examples_torch/determinism_check.py --solo [--unstable]
            [--perturb NAME] [--device cpu] [--size N]
The card unless given ``--device cpu``; raises without a card.
"""
import argparse
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

FRAME = 410
# (name, environment of the solo process, deterministic algorithms on)
PERTURBS = (('default', {}, False),
            ('cublas-workspace', {'CUBLAS_WORKSPACE_CONFIG': ':0:0'}, False),
            ('deterministic-algorithms',
             {'CUBLAS_WORKSPACE_CONFIG': ':4096:8'}, True))


def solo(stable: bool, deterministic: bool = False, device=None,
         size: int = FRAME) -> dict:
    """One stop-rule-3 solve of the seeded frame on ``device``: the
    iteration count (the payload) and the final objective value (which
    legitimately differs at roundoff between orders, so it is not
    compared)."""
    import torch

    from tpu_sgp_torch import SGPConfig
    from tpu_sgp_torch.device import resolve_device
    from tpu_sgp_torch.simulate import synthetic_star_field
    from tpu_sgp_torch.solvers.sgp import solve

    dev = resolve_device(device)
    if dev.type == 'cpu':
        torch.set_num_threads(1)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    img, psf, _ = synthetic_star_field(size, size, n_stars=60, psf_size=31,
                                       fwhm=3.0, seed=7)
    cfg = SGPConfig(max_iter=500, stop_criterion=3, tol_convergence=1e-5,
                    init_recon=2, proj_type=1, has_flux=False,
                    has_sat_level=False, dtype='float32', track_discr=False,
                    warm_projection=True, stable_sums=bool(stable))
    gn = torch.as_tensor(img[None], dtype=torch.float32, device=dev)
    psf_d = torch.as_tensor(psf, dtype=torch.float32, device=dev)
    bkg = torch.full_like(gn, 150.0)
    z = torch.zeros_like(gn)
    res = solve(gn, psf_d, bkg, z, 0.0, z, 1.0, 1e-3, 0.0, cfg)
    return {'iters': int(res.iters[0]), 'fv': float(res.fv[0])}


def _start_solo(stable: bool, name: str, env_extra: dict, device,
                size: int) -> subprocess.Popen:
    args = [sys.executable, os.path.abspath(__file__), '--solo',
            '--perturb', name, '--size', str(size)]
    if not stable:
        args.append('--unstable')
    if device is not None:
        args += ['--device', str(device)]
    return subprocess.Popen(args, env=dict(os.environ, **env_extra),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=_REPO)


def orchestrate(device=None, size: int = FRAME) -> dict:
    """Both arms under every perturbation, each a fresh process, all side
    by side. Returns the runs' payload lines, the agreement of each arm,
    the verdict lines and the exit code (0 when the stable arm agrees, 2
    when it does not, 1 when a run failed)."""
    from tpu_sgp_torch.device import resolve_device
    dev = resolve_device(device)
    procs = {(stable, name): _start_solo(stable, name, env, device, size)
             for stable in (True, False) for name, env, _ in PERTURBS}
    lines, failed = {}, []
    for key, p in procs.items():
        out, err = p.communicate()
        marker = [ln for ln in out.splitlines()
                  if ln.startswith('DETERMINISM')]
        if p.returncode != 0 or not marker:
            failed.append(f'solo run FAILED (stable={key[0]}, perturb='
                          f'{key[1]}):\n{out}\n{err[-2000:]}')
        else:
            lines[key] = marker[0].split('#')[0].strip()
    if failed:
        return {'device': dev, 'lines': lines, 'agree': {},
                'verdict': failed, 'code': 1}
    agree = {stable: len({lines[stable, name] for name, _, _ in PERTURBS})
             == 1 for stable in (True, False)}
    verdict = []
    if agree[False]:
        verdict.append('NEGATIVE CONTROL INCONCLUSIVE: stable_sums=False '
                       'agreed across every perturbation — none of them '
                       'moved this reduction order; the stable-arm pass '
                       'below is necessary but weaker evidence')
    else:
        verdict.append('negative control OK: stable_sums=False DIFFERS '
                       'across perturbations (the perturbation is real)')
    if agree[True]:
        verdict.append('OK: stable_sums=True iteration counts agree across '
                       'independent processes, the cuBLAS-workspace '
                       'perturbation, and the deterministic-algorithms '
                       'perturbation')
        code = 0
    else:
        verdict.append('MISMATCH: stable_sums=True differs between '
                       'independent runs')
        code = 2
    return {'device': dev, 'lines': lines, 'agree': agree,
            'verdict': verdict, 'code': code}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--solo', action='store_true')
    ap.add_argument('--unstable', action='store_true')
    ap.add_argument('--perturb', default='default',
                    choices=[name for name, _, _ in PERTURBS])
    ap.add_argument('--size', type=int, default=FRAME,
                    help='frame height and width (the JAX script: 410)')
    ap.add_argument('--device', default=None,
                    help="where to compute: the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.solo:
        stable = not args.unstable
        deterministic = dict((n, d) for n, _, d in PERTURBS)[args.perturb]
        r = solo(stable, deterministic, args.device, args.size)
        print(f'DETERMINISM stable={stable} iters={r["iters"]}  '
              f'# fv={r["fv"]:.9e}')
        return 0
    r = orchestrate(args.device, args.size)
    dev = r['device']
    if dev.type == 'cuda':
        import torch
        print(f'device: {dev} ({torch.cuda.get_device_name(dev)})')
    else:
        print(f'device: {dev}')
    for (stable, name), line in r['lines'].items():
        print(f'stable={stable} perturb={name}: {line}')
    for line in r['verdict']:
        print(line)
    return r['code']


if __name__ == '__main__':
    sys.exit(main())
