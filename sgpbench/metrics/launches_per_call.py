"""Kernels the device ran in the profiled stretch (copies and sets left
out) over the entry's calls in it."""


def read(rec):
    prof = rec.get('profile')
    if not prof or not prof['calls'] or not prof['kernels']:
        return None
    return prof['kernels'] / prof['calls']
