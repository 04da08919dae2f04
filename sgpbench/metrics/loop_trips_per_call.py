"""Trips of the solver's batched loop (the program's ``solver.trip`` spans,
one iteration of every lane still running) in the profiled stretch over the
entry's calls in it: phase 1, the compaction tails and the finishing pass,
each as long as its slowest lane."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['calls']:
        return None
    trips = trace.get('solver.trip').count
    return trips / prof['calls'] if trips else None
