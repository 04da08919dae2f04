"""Catalog visualization (reference ``plot_positions``, utils.py:293-310)."""
# Host code (NumPy, matplotlib), kept equal to tpu_sgp/catalog/plotting.py:1
from __future__ import annotations

import numpy as np


# tpu_sgp/catalog/plotting.py:7
def plot_positions(data_sub: np.ndarray, objects, scale: float = 6.0):
    """Background-subtracted image with one ellipse per detected source.

    ``objects`` is anything exposing xcentroid/ycentroid,
    semimajor/semiminor sigma and orientation columns (a catalog Table) or
    the sep-style dict keys x/y/a/b/theta the reference used. Returns the
    matplotlib figure.
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(10, 8))
    m, s = np.mean(data_sub), np.std(data_sub)
    ax.imshow(data_sub, interpolation='nearest', cmap='gray',
              vmin=m - s, vmax=m + s, origin='lower')

    def col(name, alt):
        try:
            return np.asarray(objects[name].value), name
        except Exception:
            return np.asarray(objects[alt]), alt

    xs, _ = col('xcentroid', 'x')
    ys, _ = col('ycentroid', 'y')
    aa, _ = col('semimajor_sigma', 'a')
    bb, _ = col('semiminor_sigma', 'b')
    th, th_key = col('orientation', 'theta')
    if th_key == 'theta':
        # sep-style theta is in RADIANS; matplotlib Ellipse wants degrees
        # (the reference converts with * 180/pi, utils.py:304). The Table
        # path's 'orientation' column is already in degrees.
        th = np.degrees(th)

    for i in range(len(xs)):
        e = Ellipse(xy=(xs[i], ys[i]), width=scale * aa[i],
                    height=scale * bb[i], angle=float(th[i]))
        e.set_facecolor('none')
        e.set_edgecolor('red')
        ax.add_artist(e)
    return fig
