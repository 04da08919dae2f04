"""Kernels the device ran in the profiled stretch (copies and sets left
out) over the solver-loop iterations of its calls, a call's iterations
being the most that any of its lanes took."""


def read(rec):
    prof = rec.get('profile')
    if not prof or not prof['iters'] or not prof['kernels']:
        return None
    return prof['kernels'] / prof['iters']
