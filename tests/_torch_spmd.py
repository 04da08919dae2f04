"""Rank worker of the port's multi-rank CPU tests, and its launcher.

    python tests/_torch_spmd.py <suite> <rank> <world> <init_method> <out>

Each of ``world`` processes joins one gloo process group, runs every case
of ``suite`` ('distributed' or 'multiprocess') in turn, SPMD, on the CPU
with one torch thread, and rank 0 writes the results to ``<out>/<suite>.npz``
(inputs included, so the test compares against the JAX package on the very
same arrays). The worker imports no JAX: a rank starts in a few seconds.
``run_world`` starts the four ranks from a test.
"""
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpu_sgp_torch import SGPConfig  # noqa: E402
from tpu_sgp_torch.simulate import (synthetic_star_field,  # noqa: E402
                                    synthetic_star_stamps)

CPU = 'cpu'
WORLD = 4
# bench-like stamp configuration, float64, a loose stop so lanes part
STAMPS = dict(max_iter=40, stop_criterion=3, tol_convergence=1e-4,
              init_recon=2, proj_type=1, has_flux=True, has_sat_level=True,
              dtype='float64', track_discr=False)
# the distributed solves of tests/test_distributed.py, float64, stopping
# by rule 3 before their 25 iterations (17-20 on these images)
KL = dict(max_iter=25, stop_criterion=3, tol_convergence=5e-3, init_recon=2,
          proj_type=1, has_flux=True, has_sat_level=True, dtype='float64')
BETA = dict(max_iter=25, stop_criterion=3, tol_convergence=5e-3,
            init_recon=2, proj_type=1, has_flux=False, has_sat_level=False,
            divergence='beta', adapt_beta=True, schedule_lr=True,
            dtype='float64')
RESUME = dict(stop_criterion=1, init_recon=2, proj_type=1, has_flux=False,
              has_sat_level=False, dtype='float64')


def run_world(suite: str, outdir, env=None, timeout: float = 240.0):
    """Run ``suite`` in a world of four gloo ranks; every rank must exit 0
    within ``timeout`` seconds (a hang fails, it is never waited out).
    Returns the npz of rank 0."""
    init = f'file://{outdir}/rendezvous'
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(r),
         str(WORLD), init, str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, **(env or {})))
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-2000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad and len(logs) == WORLD, bad
    return np.load(os.path.join(outdir, f'{suite}.npz'))


def field(h, w, n_stars, seed, psf_size=15, fwhm=2.2):
    img, psf, _ = synthetic_star_field(h, w, n_stars=n_stars, seed=seed,
                                       psf_size=psf_size, fwhm=fwhm)
    return img, psf


def host(res):
    """A result's fields as numpy arrays, by name."""
    return {k: v.cpu().numpy() for k, v in res._asdict().items()}


def put(out, prefix, **arrays):
    for k, v in arrays.items():
        if isinstance(v, dict):
            put(out, f'{prefix}_{k}', **v)
        else:
            out[f'{prefix}_{k}'] = np.asarray(v)


def case_reduce(out, meshes):
    from tpu_sgp_torch.ops import reduce as red
    from tpu_sgp_torch.ops.mesh import MeshAxes
    from tpu_sgp_torch.parallel.distributed import _Layout
    x = np.random.default_rng(4).normal(1.0, 2.0, (3, 16, 16))
    lay = _Layout(meshes['2x2'], ('ty', 'tx'), (16, 16))
    t = torch.as_tensor(lay.tile(x)).reshape(3, -1)
    ax = lay.axes
    got = {f: getattr(red, f)(t, ax).numpy()
           for f in ('gsum', 'gmax', 'gmin', 'gmean', 'gsum_ff')}
    whole = lay.assemble(ax.all_gather(torch.as_tensor(lay.tile(x))))
    flag = torch.tensor(dist.get_rank() == 3)
    single = MeshAxes(meshes['2x2'], ('tx',))
    put(out, 'reduce', x=x, whole=whole.numpy(), any=ax.any(flag),
        none=ax.any(torch.tensor(False)), tx_size=single.size, **got)


def case_halo(out, meshes):
    from tpu_sgp_torch.ops.psf_operator import make_operator
    from tpu_sgp_torch.parallel.distributed import _Layout
    from tpu_sgp_torch.simulate import gaussian_psf
    rng = np.random.default_rng(0)
    y = rng.uniform(0.0, 100.0, (2, 48, 48))
    psfs = {'square': gaussian_psf(15, 2.2),
            'nonsquare': np.abs(rng.standard_normal((3, 5))) + 0.1}
    psfs['nonsquare'] /= psfs['nonsquare'].sum()
    put(out, 'halo', y=y, **{f'psf_{k}': v for k, v in psfs.items()})
    for mname in ('2x2', '1x4'):
        lay = _Layout(meshes[mname], ('ty', 'tx'), (48, 48))
        for pname, psf in psfs.items():
            A, AT = make_operator(torch.as_tensor(psf), (lay.th, lay.tw),
                                  'halo', lay.axes)
            tile = torch.as_tensor(lay.tile(y))
            for name, op in (('A', A), ('AT', AT)):
                whole = lay.assemble(lay.axes.all_gather(op(tile)))
                out[f'halo_{mname}_{pname}_{name}'] = whole.numpy()


def case_solves(out, meshes):
    from tpu_sgp_torch.parallel.distributed import solve_distributed
    img, psf = field(64, 64, 12, 5)
    flux = float(img.sum() - 150.0 * img.size)
    res = solve_distributed(img, psf, 150.0, SGPConfig(**KL),
                            meshes['2x2'], flux=flux, sat_level=65000.0)
    put(out, 'kl', img=img, psf=psf, flux=flux, res=host(res))
    img, psf = field(64, 64, 6, 7)
    res = solve_distributed(img, psf, 150.0, SGPConfig(**BETA),
                            meshes['2x2'], beta0=1.01)
    put(out, 'beta', img=img, psf=psf, res=host(res))


def case_batch(out, meshes):
    from tpu_sgp_torch.parallel.distributed import solve_distributed_batch
    imgs = []
    for seed in (5, 9, 11):
        img, psf = field(63, 63, 8, seed)
        imgs.append(img)
    imgs = np.stack(imgs)
    fluxes = imgs.sum(axis=(1, 2)) - 150.0 * 63 * 63
    res = solve_distributed_batch(imgs, psf, 150.0, SGPConfig(**KL),
                                  meshes['b2x1x2'], fluxes=fluxes,
                                  sat_level=65000.0)
    put(out, 'batch', imgs=imgs, psf=psf, fluxes=fluxes, res=host(res))


def case_resume(out, meshes, outdir):
    from tpu_sgp_torch.parallel.distributed import (
        resume_distributed, resume_distributed_batch, solve_distributed,
        solve_distributed_batch)
    from tpu_sgp_torch.solvers.checkpoint import load_state, save_state
    img, psf = field(64, 64, 8, 11)
    full = solve_distributed(img, psf, 150.0, SGPConfig(max_iter=12,
                                                        **RESUME),
                             meshes['2x2'])
    part, state = solve_distributed(img, psf, 150.0,
                                    SGPConfig(max_iter=6, **RESUME),
                                    meshes['2x2'], return_state=True)
    path = os.path.join(outdir, 'single_ckpt')
    if dist.get_rank() == 0:
        save_state(path, state)
    dist.barrier()
    restored = load_state(path, device=CPU)
    resumed, _ = resume_distributed(img, psf, 150.0, restored,
                                    SGPConfig(max_iter=12, **RESUME),
                                    meshes['1x4'])
    try:
        resume_distributed(img[:32, :32], psf, 150.0, restored,
                           SGPConfig(max_iter=12, **RESUME), meshes['1x4'])
        refused = False
    except ValueError as e:
        refused = 'pad' in str(e)
    put(out, 'resume', img=img, psf=psf, full=host(full), part=host(part),
        resumed=host(resumed), refused=refused,
        state_x_shape=np.array(state.x.shape), state_fv_ndim=state.fv.dim())

    gns = np.stack([field(48, 48, 6, seed)[0] for seed in (3, 4, 5)])
    base = dict(RESUME, divergence='beta', adapt_beta=True,
                schedule_lr=True)
    beta0 = np.array([1.0, 1.01, 0.99])
    full = solve_distributed_batch(gns, psf, 150.0,
                                   SGPConfig(max_iter=10, **base),
                                   meshes['b2x1x2'], beta0=beta0)
    _, state = solve_distributed_batch(gns, psf, 150.0,
                                       SGPConfig(max_iter=5, **base),
                                       meshes['b2x1x2'], beta0=beta0,
                                       return_state=True)
    path = os.path.join(outdir, 'batch_ckpt')
    if dist.get_rank() == 0:
        save_state(path, state)
    dist.barrier()
    resumed, _ = resume_distributed_batch(
        gns, psf, 150.0, load_state(path, device=CPU),
        SGPConfig(max_iter=10, **base), meshes['b2x2x1'], beta0=beta0)
    put(out, 'bresume', gns=gns, psf=psf, full=host(full),
        resumed=host(resumed), state_x_shape=np.array(state.x.shape))


def case_stamps(out, meshes):
    from tpu_sgp_torch import restore_stamps
    from tpu_sgp_torch.parallel.session import RestorationSession
    stamps, psf, bkgs, _ = synthetic_star_stamps(10, size=16, seed=3)
    fluxes = stamps.sum(axis=(1, 2)) - 256 * bkgs
    kw = dict(fluxes=fluxes, sat_level=65000.0, flatten=True,
              phase1_iters=8, tail_bucket=4)
    for method in ('pallas', 'bisect'):
        cfg = SGPConfig(**STAMPS, projection_method=method)
        sharded = restore_stamps(stamps, psf, bkgs, cfg,
                                 mesh=meshes['batch'], **kw)
        alone = restore_stamps(stamps, psf, bkgs, cfg, device=CPU, **kw)
        put(out, f'stamps_{method}', sharded=host(sharded),
            alone=host(alone))
    cfg = SGPConfig(**dict(STAMPS, max_iter=10, tol_convergence=1e-1))
    meshed = RestorationSession(psf, cfg, stamp_shape=(16, 16),
                                mesh=meshes['batch'])
    meshed16 = RestorationSession(psf, cfg, stamp_shape=(16, 16),
                                  mesh=meshes['batch'], egress_dtype='uint16')
    alone = RestorationSession(psf, cfg, stamp_shape=(16, 16), device=CPU)
    for s in (meshed, meshed16, alone):
        s.warmup(buckets=(8,))
    put(out, 'session', meshed=meshed.restore(stamps[:7], bkgs[:7],
                                               fluxes[:7])._asdict(),
        u16=meshed16.restore(stamps[:7], bkgs[:7], fluxes[:7])._asdict(),
        alone=alone.restore(stamps[:7], bkgs[:7], fluxes[:7])._asdict(),
        device=str(meshed.device))
    case_server(out, meshed, alone, stamps, bkgs, fluxes)


def case_server(out, meshed, alone, stamps, bkgs, fluxes):
    """The server over the meshed session: four client threads on rank 0
    submit at once, after one request cancelled while queued; the other
    ranks follow, and their own submit raises. Idle steps come every 50
    ms, so the followers also take the keep-alive step."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from tpu_sgp_torch.parallel import session as serving
    serving._KEEPALIVE_S = 0.05
    cuts = np.cumsum([0, 3, 2, 4, 1])
    reqs = [(stamps[a:b], bkgs[a:b], fluxes[a:b])
            for a, b in zip(cuts[:-1], cuts[1:])]
    first = dist.get_rank() == 0
    refused, cancelled, got = '', False, []
    with serving.MicroBatchServer(meshed, max_batch=8,
                                  max_delay_s=0.2) as server:
        if first:
            doomed = server.submit(*reqs[0])
            cancelled = doomed.cancel()
            gate = threading.Barrier(len(reqs))

            def client(r):
                gate.wait()
                return server.submit(*r).result(timeout=120)

            with ThreadPoolExecutor(len(reqs)) as pool:
                got = list(pool.map(client, reqs))
        else:
            try:
                server.submit(*reqs[0])
            except ValueError as e:
                refused = str(e)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (server.batches_served,
                                   server.requests_served,
                                   server._worker.is_alive(), refused))
    for i, (r, res) in enumerate(zip(reqs, got)):
        put(out, f'server{i}', meshed=res._asdict(),
            alone=alone.restore(*r)._asdict())
    batches, requests, alive, refused = zip(*every)
    put(out, 'server', n=len(reqs), cancelled=cancelled,
        batches=np.array(batches), requests=np.array(requests),
        alive=np.array(alive), refused=np.array(refused))


def example(name):
    """``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f'examples_torch_{name}',
        os.path.join(REPO, 'examples_torch', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HALO_TILE = 410     # the halo timing's default tile, for the agreement


def case_examples(out):
    """The distributed demo as written (float32, on the world's 2x2 and
    (2, 1, 2) meshes), and its two solves again in float64 on the same
    inputs; the halo timing on a 1x1 mesh of each rank at a small size,
    and one apply of the halo operator against the linear one there in
    float32 and float64 at the timing's own tile. Every rank builds the
    four one-rank meshes and their flattened groups, since a process
    group is made by the whole world; each then works on its own."""
    from tpu_sgp_torch.ops.mesh import MeshAxes
    from tpu_sgp_torch.ops.psf_operator import (make_halo_operator,
                                                make_linear_operator)
    from tpu_sgp_torch.parallel.distributed import (make_batch_image_mesh,
                                                    make_image_mesh,
                                                    solve_distributed,
                                                    solve_distributed_batch)
    from tpu_sgp_torch.simulate import gaussian_psf
    demo = example('distributed_demo')
    r = demo.run(device=CPU)
    put(out, 'demo', **{k: v for k, v in r.items() if k != 'devices'})
    cfg64 = SGPConfig(**dict(demo.CFG, dtype='float64'))
    one = solve_distributed(r['image'], r['psf'], 150.0, cfg64,
                            make_image_mesh(device_type=CPU))
    batch = solve_distributed_batch(r['imgs'], r['psf3'], 150.0, cfg64,
                                    make_batch_image_mesh(device_type=CPU))
    put(out, 'demo64', x=one.x.numpy(), iters=one.iters.numpy(),
        batch_x=batch.x.numpy(), batch_iters=batch.iters.numpy())

    rank = dist.get_rank()
    meshes = [make_image_mesh((1, 1), ranks=[q], device_type=CPU)
              for q in range(WORLD)]
    for m in meshes:
        m[('ty', 'tx')]._flatten()
    timed = example('time_halo_operator').run(meshes[rank], tile=64,
                                              repeats=2, chain=3)
    axes = MeshAxes(meshes[rank], ('ty', 'tx'))
    rng = np.random.default_rng(7)
    rel = {}
    for dt in (torch.float32, torch.float64):
        img = torch.as_tensor(rng.uniform(10, 1000, (1, HALO_TILE,
                                                     HALO_TILE)), dtype=dt)
        psf = torch.as_tensor(gaussian_psf(31, fwhm=3.0), dtype=dt)
        A, AT = make_linear_operator(psf, (HALO_TILE, HALO_TILE))
        Ah, ATh = make_halo_operator(psf, (HALO_TILE, HALO_TILE), axes)
        a, b = AT(A(img)), ATh(Ah(img))
        rel[str(dt)[6:]] = float((a - b).abs().max() / a.abs().max())
    every = [None] * WORLD
    dist.all_gather_object(every, (timed['ratio'], timed['max_rel_diff'],
                                   timed['linear_wall_s'], rel['float32'],
                                   rel['float64']))
    out['halo_ranks'] = np.array(every)


def run_distributed(outdir):
    from torch.distributed.device_mesh import DeviceMesh

    from tpu_sgp_torch.parallel.distributed import (make_batch_image_mesh,
                                                    make_image_mesh)
    meshes = {'2x2': make_image_mesh(device_type=CPU),
              '1x4': make_image_mesh((1, 4), device_type=CPU),
              'b2x1x2': make_batch_image_mesh(2, device_type=CPU),
              'b2x2x1': DeviceMesh(CPU, torch.arange(4).reshape(2, 2, 1),
                                   mesh_dim_names=('batch', 'ty', 'tx')),
              'batch': DeviceMesh(CPU, torch.arange(4),
                                  mesh_dim_names=('batch',))}
    out = {'mesh_2x2': np.array(meshes['2x2'].shape),
           'mesh_b': np.array(meshes['b2x1x2'].shape)}
    case_reduce(out, meshes)
    case_halo(out, meshes)
    case_solves(out, meshes)
    case_batch(out, meshes)
    case_resume(out, meshes, outdir)
    case_stamps(out, meshes)
    case_examples(out)
    return out


def run_multiprocess(outdir):
    from tpu_sgp_torch.ops.mesh import MeshAxes
    from tpu_sgp_torch.parallel.distributed import solve_distributed_batch
    from tpu_sgp_torch.parallel.multiprocess import (global_device_grid,
                                                     init_distributed,
                                                     make_multiprocess_mesh)
    out = {}
    init_distributed('unused:0', 4, 0)      # joined already: a no-op
    out['grid'] = global_device_grid((1, 2))
    out['grid_default'] = global_device_grid()
    errors = []
    for shape, env in (((2, 2), '2'), (None, '3')):
        os.environ['LOCAL_WORLD_SIZE'] = env
        try:
            global_device_grid(shape)
            errors.append('')
        except ValueError as e:
            errors.append(str(e))
    os.environ['LOCAL_WORLD_SIZE'] = '2'
    out['errors'] = np.array(errors)
    mesh = make_multiprocess_mesh((1, 2), device_type=CPU)
    out['mesh'] = mesh.mesh.numpy()
    out['spatial_ranks'] = np.array(MeshAxes(mesh, ('ty', 'tx')).ranks)
    imgs = np.stack([field(64, 64, 8, seed)[0] for seed in (5, 9)])
    psf = field(64, 64, 8, 5)[1]
    fluxes = imgs.sum(axis=(1, 2)) - 150.0 * 64 * 64
    res = solve_distributed_batch(imgs, psf, 150.0,
                                  SGPConfig(**dict(KL, max_iter=40)), mesh,
                                  fluxes=fluxes, sat_level=65000.0)
    put(out, 'mp', imgs=imgs, psf=psf, fluxes=fluxes, res=host(res))
    return out


def main():
    suite, rank, world, init, outdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import datetime
    timeout = datetime.timedelta(seconds=90)
    if suite == 'multiprocess':
        from tpu_sgp_torch.parallel.multiprocess import init_distributed
        init_distributed(init, world, rank, backend='gloo')
    else:
        dist.init_process_group('gloo', init_method=init, world_size=world,
                                rank=rank, timeout=timeout)
    out = {'distributed': run_distributed,
           'multiprocess': run_multiprocess}[suite](outdir)
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(outdir, f'{suite}.npz'), **out)
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
