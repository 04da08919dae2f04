"""Calibration-frame culling (the reference's IRAF Automation.cl, natively).

The reference's pre_processing/Automation.cl runs inside IRAF and
  * selects bias frames by EXPTIME == 0
  * rejects bias frames whose STDDEV exceeds 1.5x the median STDDEV
  * rejects flat frames whose MEAN exceeds 50000 (near saturation)
  * fixes missing/incorrect FILTER keywords
  * moves rejected frames into BadFrames/
This module reimplements those statistics rules on our FITS stack with no
IRAF dependency, as both a library API and a small CLI
(``python -m tpu_sgp_torch.preprocess <dir>``).
"""
# Host code (NumPy), kept equal to tpu_sgp/preprocess.py:1
from __future__ import annotations

import argparse
import glob
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .image import getheader, read_fits

BIAS_STDDEV_FACTOR = 1.5      # Automation.cl bias rejection rule
FLAT_MEAN_LIMIT = 50000.0     # Automation.cl flat rejection rule


# tpu_sgp/preprocess.py:31
@dataclass
class CullReport:
    biases: List[str] = field(default_factory=list)
    flats: List[str] = field(default_factory=list)
    bad_biases: List[str] = field(default_factory=list)
    bad_flats: List[str] = field(default_factory=list)
    filter_fixed: Dict[str, str] = field(default_factory=dict)


# tpu_sgp/preprocess.py:39
def _stats(path: str):
    data, hdr = read_fits(path)
    return float(np.mean(data)), float(np.std(data)), hdr


# tpu_sgp/preprocess.py:44
def select_biases(paths: List[str]) -> List[str]:
    """Bias frames are those with EXPTIME == 0 (Automation.cl rule)."""
    out = []
    for p in paths:
        try:
            if float(getheader(p).get('EXPTIME', -1)) == 0.0:
                out.append(p)
        except (OSError, ValueError, TypeError):
            # TypeError: a present-but-blank EXPTIME card parses to None;
            # skip the frame like any other unreadable header
            continue
    return out


# tpu_sgp/preprocess.py:58
def cull_frames(directory: str, pattern: str = '*.fits',
                bad_dir: str = 'BadFrames', move: bool = True,
                default_filter: Optional[str] = None,
                fix_headers: bool = True) -> CullReport:
    """Apply the Automation.cl culling rules to a directory of frames.

    With ``default_filter`` set, frames missing a FILTER keyword get it
    WRITTEN INTO the file (``fix_headers=False`` records them in the
    report only)."""
    paths = sorted(glob.glob(os.path.join(directory, pattern)))
    report = CullReport()
    report.biases = select_biases(paths)

    # bias rejection: STDDEV > 1.5 * median STDDEV (unreadable frames are
    # skipped like every other read path in this module)
    stds = {}
    for p in report.biases:
        try:
            _, std, _ = _stats(p)
        except (OSError, ValueError):
            continue
        stds[p] = std
    if stds:
        med = float(np.median(list(stds.values())))
        report.bad_biases = [p for p, s in stds.items()
                             if s > BIAS_STDDEV_FACTOR * med]

    # flat rejection: MEAN > 50000 (uses IMAGETYP/OBJECT hints when present)
    for p in paths:
        if p in report.biases:
            continue
        try:
            mean, _, hdr = _stats(p)
        except (OSError, ValueError):
            continue
        imagetyp = str(hdr.get('IMAGETYP', hdr.get('OBJECT', ''))).lower()
        is_flat = 'flat' in imagetyp or 'flat' in os.path.basename(p).lower()
        if is_flat:
            report.flats.append(p)
            if mean > FLAT_MEAN_LIMIT:
                report.bad_flats.append(p)
        if default_filter and 'FILTER' not in hdr:
            report.filter_fixed[p] = default_filter
            if fix_headers:
                # write the corrected keyword back the way Automation.cl
                # hedits frames in place: a raw-byte header splice, NOT a
                # read/write round-trip (which would drop COMMENT/HISTORY
                # cards and re-encode BSCALE/BZERO integer data as f64 —
                # silently mutating archival calibration frames)
                from .image import set_header_card
                set_header_card(p, 'FILTER', default_filter)

    if move:
        target = os.path.join(directory, bad_dir)
        os.makedirs(target, exist_ok=True)
        for p in report.bad_biases + report.bad_flats:
            shutil.move(p, os.path.join(target, os.path.basename(p)))
    return report


# tpu_sgp/preprocess.py:118
def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Cull bad bias/flat calibration frames '
                    '(Automation.cl rules, no IRAF needed)')
    ap.add_argument('directory')
    ap.add_argument('--pattern', default='*.fits')
    ap.add_argument('--no-move', action='store_true')
    ap.add_argument('--default-filter', default=None)
    opt = ap.parse_args(argv)
    rep = cull_frames(opt.directory, opt.pattern, move=not opt.no_move,
                      default_filter=opt.default_filter)
    print(f'biases: {len(rep.biases)} (rejected {len(rep.bad_biases)})')
    print(f'flats: {len(rep.flats)} (rejected {len(rep.bad_flats)})')
    if rep.filter_fixed:
        print(f'FILTER fixed on {len(rep.filter_fixed)} frames')
    for p in rep.bad_biases + rep.bad_flats:
        print(f'  moved: {p}')
    return rep


if __name__ == '__main__':
    main()
