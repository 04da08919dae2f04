"""Rows the beta objective evaluated per stamp restored: the program's
``beta.rows`` counter (the batch's rows in each ``beta.objective`` pass,
those of lanes already done too) in the profiled stretch over the stamps
of the entry's calls in it. None where the program has no such counter."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['calls'] or not rec.get('calls'):
        return None
    rows = trace.get('beta.rows').count
    stamps = prof['calls'] * rec['attempted'] / rec['calls']
    return rows / stamps if rows else None
