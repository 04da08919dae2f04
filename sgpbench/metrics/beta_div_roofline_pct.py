"""The beta objective kernel's share of its bytes bound, in the profiled
stretch: 100 x (the bytes it must read over the card's memory rate) / (its
device time).

The bytes are the program's ``beta_div.pixels`` counter (rows x N of each
launch of ``beta_div_rows``) times 3 x the item size: den, gn and log gn
read once each, as ``PERF.md``'s kernel table bounds the kernel; the two
(B,) sums it writes are left out. The device time is the sum over every
operation of the whole stretch (the profile's ``device_s``, not the
breakdown's top ten) whose name holds ``beta_div_kernel``, whatever its
rank, so that the reading follows the same work however fast its kernels
run or however many there are. The item size is the first template
argument of those names: ``beta_div_kernel<float, 1>`` and
``beta_div_kernel_fold<float>`` both read 4 bytes.

The contract a later kernel keeps: every kernel of the beta objective's
passes carries ``beta_div_kernel`` and its element type (``<float`` or
``<double``) in its name. None where no such kernel ran in the stretch,
where the program has no such counter, or where both types' kernels ran
(or one whose type the name does not show)."""

import re

# an H100 SXM's HBM3 rate, bytes a second
HBM_BYTES_S = 3.35e12
KERNEL = 'beta_div_kernel'
# the kernel's type, its first template argument as the profiler names it:
# beta_div_kernel<float, 1>, beta_div_kernel_fold<float>
TYPE = re.compile(KERNEL + r'\w*<(float|double)')
SIZES = {'float': 4, 'double': 8}


def item_size(name: str):
    """The item size of the kernel instance ``name``, or None."""
    m = TYPE.search(name)
    return SIZES[m[1]] if m else None


def kernel_time(rec):
    """(device seconds, item size) of the beta kernels in the whole
    stretch, or None where none ran or both types did."""
    prof = rec.get('profile')
    if not prof:
        return None
    ops = [(name, s) for name, s in prof['device_s'].items()
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
