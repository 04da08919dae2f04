"""The host's reads of a device flag (the program's ``sync`` spans: the
loop's continue test, the line search's, the projection's) in the profiled
stretch over the solver loop's trips in it (``solver.trip`` spans)."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    if trace is None or not rec.get('profile'):
        return None
    trips = trace.get('solver.trip').count
    return trace.get('sync').count / trips if trips else None
