"""Spatially-varying PSF restoration.

Port of ``tpu_sgp/workloads/spatial_psf.py:1``. The DIAPL PSF model is a
polynomial in frame position, but the reference never exploits it
in-repo: its spatial-variation hook is unused (psf_calculate.py:141-166)
and each sub-frame is deconvolved with one rendered matrix. Here the
variation becomes a first-class workload: render the local PSF at every
tile center (native C++ bulk evaluator when available, on the host),
restore ALL tiles as one batch with per-tile PSFs on ``device`` (the card
unless the caller passes ``'cpu'``), and blend with the background-matched
coadd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..catalog import source_info_batch
from ..config import SGPConfig
from ..device import resolve_device
from ..image import coadd_tiles, create_subdivisions
from ..parallel.batch import restore_stamps
from ..psf.diapl import DiaplPSFModel


# tpu_sgp/workloads/spatial_psf.py:24
def render_tile_psfs(model: DiaplPSFModel, centers_xy: np.ndarray,
                     psf_size: int = 31) -> np.ndarray:
    """(n, psf_size, psf_size) normalized local PSF matrices at the given
    frame positions; uses the native C++ bulk evaluator when built."""
    xs = np.asarray(centers_xy)[:, 0].astype(np.float64)
    ys = np.asarray(centers_xy)[:, 1].astype(np.float64)
    try:
        from ..psf import native
        if native.available():
            return native.render_grid(model, xs, ys, psf_size,
                                      normalize=True)
    except Exception:
        pass
    mats = [model.normalized_matrix(psf_size, model.local_coeffs(x, y))
            for x, y in zip(xs, ys)]
    return np.stack(mats)


# tpu_sgp/workloads/spatial_psf.py:42
def restore_with_spatial_psf(image: np.ndarray, model: DiaplPSFModel,
                             cfg: Optional[SGPConfig] = None,
                             subdiv_shape: Tuple[int, int] = (100, 100),
                             overlap: int = 10, psf_size: int = 31,
                             sat_level: float = 65000.0, beta0: float = 1.005,
                             mesh=None, device=None):
    """Deconvolve a frame whose PSF varies across the field.

    Returns (mosaic, dict with tiles/psfs/iters/origins).
    """
    device = resolve_device(device)
    if cfg is None:
        cfg = SGPConfig(max_iter=300, stop_criterion=3, tol_convergence=1e-4,
                        init_recon=2, proj_type=1, has_flux=True,
                        has_sat_level=True, dtype='float32',
                        operator='linear')
    subdivs = create_subdivisions(image, subdiv_shape, overlap=overlap)
    centers = np.array([[s.origin_original[0] + s.data.shape[1] / 2.0,
                         s.origin_original[1] + s.data.shape[0] / 2.0]
                        for s in subdivs])
    psfs = render_tile_psfs(model, centers, psf_size)

    # one threaded catalog pass over all tiles (result-identical to the
    # serial loop; the natives release the GIL)
    tile_cats = source_info_batch([s.data for s in subdivs],
                                  localbkg_width=5)
    tiles, bkg_maps, fluxes = [], [], []
    for s, (scat, bkg) in zip(subdivs, tile_cats):
        tiles.append(np.asarray(s.data, np.float64))
        bkg_maps.append(bkg.background)
        if scat is not None and len(scat):
            t = scat.to_table(['segment_flux'])
            fluxes.append(float(np.sum(t['segment_flux'].value)))
        else:
            fluxes.append(float(np.sum(s.data - bkg.background)))

    res = restore_stamps(np.stack(tiles), psfs, np.stack(bkg_maps), cfg,
                         fluxes=np.array(fluxes), beta0=beta0,
                         sat_level=sat_level, mesh=mesh, device=device)
    restored = res.x.cpu().numpy().astype(np.float64)
    origins = [s.origin_original for s in subdivs]
    mosaic, footprint = coadd_tiles(list(restored), origins, image.shape,
                                    match_background=True)
    return mosaic, {
        'tiles': restored, 'psfs': psfs, 'origins': origins,
        'iters': res.iters.cpu().numpy(), 'footprint': footprint,
        'centers': centers,
    }


# tpu_sgp/workloads/spatial_psf.py:91
def main(argv=None):
    import argparse

    from ..image import read_fits, write_fits

    ap = argparse.ArgumentParser(
        description='Deconvolve a frame with a spatially-varying DIAPL '
                    'PSF model (per-tile local PSFs, one batch, '
                    'background-matched coadd)')
    ap.add_argument('--image', required=True, help='science frame FITS')
    ap.add_argument('--psf_model', required=True,
                    help='DIAPL coefficient file (.bin.txt)')
    ap.add_argument('--out', default='spatial_psf_restored.fits')
    ap.add_argument('--subdivision_size', type=int, default=100)
    ap.add_argument('--subdiv_overlap', type=int, default=10)
    ap.add_argument('--psf_size', type=int, default=31)
    ap.add_argument('--initial_beta', type=float, default=1.005)
    ap.add_argument('--saturate', type=float, default=65000.0)
    ap.add_argument('--device', default=None,
                    help="where to restore: the card by default, 'cpu' for "
                         'the CPU')
    opt = ap.parse_args(argv)

    image, header = read_fits(opt.image)
    model = DiaplPSFModel.from_txt(opt.psf_model)
    mosaic, info = restore_with_spatial_psf(
        np.asarray(image, np.float64), model,
        subdiv_shape=(opt.subdivision_size, opt.subdivision_size),
        overlap=opt.subdiv_overlap, psf_size=opt.psf_size,
        beta0=opt.initial_beta, sat_level=opt.saturate, device=opt.device)
    write_fits(opt.out, np.asarray(mosaic, np.float32), header=header)
    it = info['iters']
    print(f'{len(info["tiles"])} tiles, iters median '
          f'{int(np.median(it))} max {int(it.max())} -> {opt.out}')
    return info


if __name__ == '__main__':
    main()
