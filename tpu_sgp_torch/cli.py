"""The command line, mirroring the reference's ``sgp.py`` CLI.

Port of ``tpu_sgp/cli.py:1``: the same flags, defaults, artifacts and CSV
schema, plus ``--device`` (the card by default, ``cpu`` for the CPU), which
every solve gets; results come back through ``.cpu().numpy()``. Run it as
``python -m tpu_sgp_torch.cli`` or ``tpu-sgp-torch``.

Flag names and defaults follow the reference's sgp.py:908-932.
Differences by design:
  * the subdivision loop runs as ONE device batch (the reference
    deconvolves tiles serially and round-trips them through temp FITS files;
    here tiles stay in device memory and are mosaicked with the native
    background-matched coadd)
  * source extraction always uses the native catalog stack (the reference's
    --use_sextractor path shells out to SExtractor through a stale call
    signature; the flag is accepted and mapped to the native stack)
"""
from __future__ import annotations

import argparse
import os
from timeit import default_timer as timer

import numpy as np

from .api import sgp, sgp_beta_div
from .catalog import source_info, source_info_batch
from .config import DEFAULT_COLUMNS, SGPConfig
from .device import resolve_device
from .image import (WCS, coadd_tiles, create_subdivisions, read_fits,
                    write_fits)
from .parallel.batch import restore_stamps
from .psf import scale_psf
from .simulate import artificial_sky_background

CSV_COLUMNS = DEFAULT_COLUMNS + ['X_IMAGE', 'Y_IMAGE', 'X_WORLD', 'Y_WORLD']


# tpu_sgp/cli.py:33
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='sets data path for data used for SGP')
    p.add_argument('--data_path_sciimg', type=str, required=True)
    p.add_argument('--data_path_psf', type=str, required=True)
    p.add_argument('--scale_psf', action='store_true')
    p.add_argument('--psf_scale_fwhm', type=float, default=1.2)
    p.add_argument('--init_recon', type=int, default=2)
    p.add_argument('--stop_criterion', type=int, default=3)
    p.add_argument('--flip_image', action='store_true')
    p.add_argument('--add_bkg_to_deconvolved', action='store_true')
    p.add_argument('--box_height', type=int, default=64)
    p.add_argument('--box_width', type=int, default=64)
    p.add_argument('--use_subdiv', action='store_true')
    p.add_argument('--subdivision_size', type=int, default=100)
    p.add_argument('--subdiv_overlap', type=int, default=10)
    p.add_argument('--sextractor_config_file_name', type=str, default=None)
    p.add_argument('--use_sextractor', action='store_true')
    p.add_argument('--use_beta_div', action='store_true')
    p.add_argument('--initial_beta', type=float, default=1.005)
    p.add_argument('--initial_lr', type=float, default=1e-3)
    p.add_argument('--tol_convergence', type=float, default=1e-4)
    p.add_argument('--gain', type=float, default=None)
    p.add_argument('--saturate', type=float, default=None)
    p.add_argument('--dtype', type=str, default='float32')
    p.add_argument('--catalog_workers', type=int, default=None,
                   help='host threads for the per-tile catalog stage '
                        '(default: one per CPU core; <=1 = serial)')
    p.add_argument('--output_dir', type=str,
                   default='sgp_reconstruction_results')
    p.add_argument('--plot', action='store_true')
    p.add_argument('--device', type=str, default=None,
                   help="where to restore: the card by default, 'cpu' for "
                        'the CPU')
    return p


# tpu_sgp/cli.py:67
def print_options(opt) -> None:
    print('\n------------ Options ------------')
    for arg in vars(opt):
        print(f'{arg}:\t\t{getattr(opt, arg)}')
    print('------------ End ----------------\n')


# tpu_sgp/cli.py:74
def _catalog_to_frame(table, wcs):
    import pandas as pd
    df = table.to_pandas()
    df['X_IMAGE'] = df['xcentroid']
    df['Y_IMAGE'] = df['ycentroid']
    if wcs is not None:
        ra, dec = wcs.pixel_to_world(df['xcentroid'].to_numpy(),
                                     df['ycentroid'].to_numpy())
        df['X_WORLD'], df['Y_WORLD'] = ra, dec
    else:
        df['X_WORLD'] = df['Y_WORLD'] = np.nan
    return df


# tpu_sgp/cli.py:88
def main(argv=None) -> dict:
    import pandas as pd
    opt = build_parser().parse_args(argv)
    print_options(opt)
    device = resolve_device(opt.device)

    psf, psf_hdr = read_fits(opt.data_path_psf)
    if opt.scale_psf:
        psf = scale_psf(psf, gaussian_fwhm=opt.psf_scale_fwhm,
                        size=psf.shape)
    psf = psf / psf.sum()

    image, hdr = read_fits(opt.data_path_sciimg)
    gain = opt.gain if opt.gain is not None else hdr.get('GAIN', 1.0)
    sat = (opt.saturate if opt.saturate is not None
           else hdr.get('SATURATE', 65000.0))
    wcs = WCS(hdr)
    if opt.flip_image:
        image = np.fliplr(image)
        psf = np.fliplr(psf)

    os.makedirs(opt.output_dir, exist_ok=True)
    basename = os.path.basename(opt.data_path_sciimg)
    solver_kw = dict(init_recon=opt.init_recon, proj_type=1,
                     stop_criterion=opt.stop_criterion, scale_data=True,
                     ccd_sat_level=sat, tol_convergence=opt.tol_convergence,
                     dtype=opt.dtype, device=device)

    orig_frames, deconv_frames = [], []
    t_all = timer()
    if opt.use_subdiv:
        subdivs = create_subdivisions(
            image, (opt.subdivision_size, opt.subdivision_size),
            overlap=opt.subdiv_overlap, wcs=wcs)

        tiles, bkg_maps, fluxes, rms_floors = [], [], [], []
        cats = source_info_batch([s.data for s in subdivs],
                                 n_workers=opt.catalog_workers,
                                 localbkg_width=5)
        for i, sub in enumerate(subdivs):
            scat, bkg = cats[i]
            tiles.append(np.asarray(sub.data, np.float64))
            bkg_maps.append(bkg.background)
            rms_floors.append(1.5 * bkg.background_rms_median)
            if scat is not None and len(scat):
                t = scat.to_table(DEFAULT_COLUMNS)
                fluxes.append(float(np.sum(t['segment_flux'].value)))
                df = _catalog_to_frame(t, sub.wcs)
                ox, oy = sub.origin_original
                df['X_IMAGE'] += ox
                df['Y_IMAGE'] += oy
                orig_frames.append(df)
            else:
                # background-subtracted, like the non-subdiv fallback: a
                # raw sum would force ~1e7 counts of spurious flux into a
                # source-free tile through the flux-conserving projection
                fluxes.append(float(np.sum(sub.data - bkg.background)))

        cfg = SGPConfig(
            max_iter=500, stop_criterion=opt.stop_criterion,
            tol_convergence=opt.tol_convergence, init_recon=opt.init_recon,
            proj_type=1, has_flux=True, has_sat_level=True,
            divergence='beta' if opt.use_beta_div else 'kl',
            adapt_beta=opt.use_beta_div, schedule_lr=opt.use_beta_div,
            dtype=opt.dtype, operator='linear',
            track_discr=False)  # the CLI reads x/iters only
        x0 = None
        if opt.init_recon == 1:
            # reference sgp.py:169 seeds randn(42) inside every solve; all
            # tiles share a shape so one seeded draw serves each of them
            np.random.seed(42)
            one = np.random.randn(*tiles[0].shape)
            x0 = np.broadcast_to(one, (len(tiles),) + one.shape)
        res = restore_stamps(np.stack(tiles), psf, np.stack(bkg_maps), cfg,
                             fluxes=np.array(fluxes), x0=x0,
                             beta0=opt.initial_beta, lr0=opt.initial_lr,
                             sat_level=sat, bucket=True, device=device)
        restored_tiles = res.x.cpu().numpy().astype(np.float64)

        dbkg_tiles, drms_tiles = [], []
        dcats = source_info_batch(
            list(restored_tiles), n_workers=opt.catalog_workers,
            per_frame_kwargs=[dict(threshold_floor=f) for f in rms_floors],
            n_pixels=1, localbkg_width=5)
        for i, sub in enumerate(subdivs):
            scat, dbkg = dcats[i]
            dbkg_tiles.append(dbkg.background)
            drms_tiles.append(dbkg.background_rms)
            if scat is not None and len(scat):
                t = scat.to_table(DEFAULT_COLUMNS)
                df = _catalog_to_frame(t, sub.wcs)
                ox, oy = sub.origin_original
                df['X_IMAGE'] += ox
                df['Y_IMAGE'] += oy
                deconv_frames.append(df)

        origins = [s.origin_original for s in subdivs]
        deconvolved, footprint = coadd_tiles(
            list(restored_tiles), origins, image.shape,
            match_background=True)
        # mosaicked background / RMS maps (the reference coadds these from
        # its temp_deconvolved_bkg*/bkgrms* tiles, sgp.py:1089-1091)
        deconvolved_bkg, _ = coadd_tiles(dbkg_tiles, origins, image.shape,
                                         match_background=True)
        # match_background=True for the RMS tiles too: the reference routes
        # bkgrms through the same reproject_and_coadd(match_background=True)
        # helper as the image tiles (utils.py:392-397)
        deconvolved_bkg_rms, _ = coadd_tiles(drms_tiles, origins,
                                             image.shape,
                                             match_background=True)
        iters = int(res.iters.max())
    else:
        scat, bkg = source_info(image,
                                box_size=(opt.box_height, opt.box_width),
                                localbkg_width=5)
        if scat is not None and len(scat):
            t = scat.to_table(DEFAULT_COLUMNS)
            orig_frames.append(_catalog_to_frame(t, wcs))
            flux = float(np.sum(t['segment_flux'].value))
        else:
            # no detections: fall back to the whole-frame flux (the solver
            # default sum(gn - bkg)) rather than crashing on a blank field
            flux = float(np.sum(image - bkg.background))
        solver = sgp_beta_div if opt.use_beta_div else sgp
        extra = ({'betaParam': opt.initial_beta, 'lr': opt.initial_lr,
                  'lr_exp_param': 0.1, 'schedule_lr': True}
                 if opt.use_beta_div else {})
        deconvolved, iters, _, _, _ = solver(
            image, psf, bkg.background, flux=flux,
            use_original_SGP_Afunction=psf.shape == image.shape,
            **solver_kw, **extra)
    wall = timer() - t_all

    # the artificial sky goes in BEFORE the deconvolved catalog: rescuing
    # the collapsed detection threshold on near-zero deconvolved
    # backgrounds is the flag's purpose (reference sgp.py:1126 adds it
    # ahead of the deconvolved source_info at :1141)
    if opt.add_bkg_to_deconvolved:
        pos = deconvolved[deconvolved > 0]
        if pos.size:
            deconvolved = deconvolved + artificial_sky_background(
                deconvolved, float(pos.min()) * 5, gain=gain)
        else:
            print('add_bkg_to_deconvolved skipped: reconstruction has no '
                  'positive pixels')

    if not opt.use_subdiv:
        dscat, dbkg = source_info(
            deconvolved, box_size=(opt.box_height, opt.box_width),
            n_pixels=1, localbkg_width=5,
            threshold_floor=1.5 * bkg.background_rms_median)
        deconvolved_bkg = dbkg.background
        deconvolved_bkg_rms = dbkg.background_rms
        if dscat is not None and len(dscat):
            deconv_frames.append(
                _catalog_to_frame(dscat.to_table(DEFAULT_COLUMNS), wcs))

    # ---- persist artifacts (reference naming) -----------------------------
    write_fits(os.path.join(opt.output_dir, f'orig_{basename}'), image,
               header=hdr)
    prefix = 'subdiv_' if opt.use_subdiv else ''
    out_hdr = hdr.copy()
    for k, v in wcs.to_header().items():
        out_hdr[k] = v
    write_fits(os.path.join(opt.output_dir,
                            f'{prefix}deconvolved_{basename}'),
               np.nan_to_num(deconvolved), header=out_hdr)

    # background / RMS FITS artifacts (reference sgp.py:1149-1151, 1185-1186)
    write_fits(os.path.join(opt.output_dir, f'deconv_bkg_{basename}'),
               np.nan_to_num(deconvolved_bkg))
    write_fits(os.path.join(opt.output_dir, f'deconv_bkgrms_{basename}'),
               np.nan_to_num(deconvolved_bkg_rms))

    orig_cat = (pd.concat(orig_frames, ignore_index=True)
                if orig_frames else pd.DataFrame())
    deconv_cat = (pd.concat(deconv_frames, ignore_index=True)
                  if deconv_frames else pd.DataFrame())
    def _to_csv(df, path):
        # enforce the declared schema (stable column set and order)
        (df.reindex(columns=CSV_COLUMNS) if len(df) else df).to_csv(path)

    _to_csv(orig_cat, os.path.join(opt.output_dir,
                                   f'orig_{basename}_scat.csv'))
    _to_csv(deconv_cat, os.path.join(opt.output_dir,
                                     f'deconv_{basename}_scat.csv'))

    print(f'No. of objects (original): {len(orig_cat)}')
    print(f'No. of objects (deconvolved): {len(deconv_cat)}')
    print(f'Execution time: {wall} seconds.')

    times_file = os.path.join(opt.output_dir, 'execution_times.txt')
    with open(times_file, 'a') as f:
        f.write(f'{opt.data_path_sciimg},{wall},{image.shape[1]},'
                f'{image.shape[0]},{len(orig_cat)}\n')

    if opt.plot:
        _comparison_plot(image, deconvolved)
    return {'deconvolved': deconvolved, 'iters': iters, 'wall': wall,
            'orig_catalog': orig_cat, 'deconv_catalog': deconv_cat}


# tpu_sgp/cli.py:291
def _comparison_plot(image, deconvolved):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 2, figsize=(16, 8))
    for a, img, title in ((ax[0], image, 'Original image'),
                          (ax[1], deconvolved, 'Result of deconvolution')):
        vmin, vmax = np.nanpercentile(img, [5, 99])
        im = a.imshow(img, origin='lower', vmin=vmin, vmax=vmax)
        fig.colorbar(im, ax=a, shrink=0.8)
        a.set_title(title, fontsize=12)
    fig.savefig('sgp_comparison.png', bbox_inches='tight')
    print('wrote sgp_comparison.png')


if __name__ == '__main__':
    main()
