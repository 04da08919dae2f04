"""Mean of the solver's iteration count (SGPResult.iters) over every
stamp restored in the window."""


def read(rec):
    if not rec.get('stamps_done'):
        return None
    return rec['iters_sum'] / rec['stamps_done']
