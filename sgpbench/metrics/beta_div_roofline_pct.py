"""The beta objective kernel's share of its bytes bound, in the profiled
stretch: 100 x (the bytes it must read over the card's memory rate) / (its
device time).

The bytes are the program's ``beta_div.pixels`` counter (rows x N of each
launch of ``beta_div_rows``) times 3 x the item size: den, gn and log gn
read once each, as ``PERF.md``'s kernel table bounds the kernel; the two
(B,) sums it writes are left out. The item size is that of the kernel's
instance, ``beta_div_kernel<float, ...>`` or ``<double, ...>``. The device
time is the stretch's ``breakdown.device_ops`` entries whose name holds
``beta_div_kernel``. The breakdown keeps only the ten operations with the
most device time: on the whole-frame beta cell the kernel leads it, one
long row on one SM. None where the kernel did not run in the stretch, where
the program has no such counter, or where both dtypes' instances ran (or
one whose type the name does not show)."""

import re

# an H100 SXM's HBM3 rate, bytes a second
HBM_BYTES_S = 3.35e12
KERNEL = 'beta_div_kernel'
# the instance's type, as the profiler names it: beta_div_kernel<float, 1>
TYPE = re.compile(KERNEL + r'<(float|double)')
SIZES = {'float': 4, 'double': 8}


def item_size(name: str):
    """The item size of the kernel instance ``name``, or None."""
    m = TYPE.search(name)
    return SIZES[m[1]] if m else None


def kernel_time(rec):
    """(device seconds, item size) of the beta kernel's instances in the
    stretch's breakdown, or None where none ran or both dtypes did."""
    prof = rec.get('profile')
    if not prof:
        return None
    ops = [(name, s) for name, s in prof['breakdown']['device_ops']
           if KERNEL in name and s > 0]
    sizes = {item_size(name) for name, _ in ops}
    if len(sizes) != 1 or None in sizes:
        return None
    return sum(s for _, s in ops), sizes.pop()


def pixels():
    """The program's ``beta_div.pixels`` counter in the newest recording
    (the stretch's), or 0."""
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    return trace.get('beta_div.pixels').count if trace is not None else 0


def read(rec):
    found = kernel_time(rec)
    n = pixels()
    if found is None or not n:
        return None
    seconds, size = found
    return 100.0 * (3 * size * n / HBM_BYTES_S) / seconds
