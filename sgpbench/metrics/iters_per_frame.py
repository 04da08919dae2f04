"""Mean of the solver's iteration count over every frame restored in the
window."""


def read(rec):
    if not rec.get('frames_done'):
        return None
    return rec['iters_sum'] / rec['frames_done']
