"""Share of the profiled stretch's wall inside the flux-conserving
projection: the total of the program's ``projection`` spans (K1's launch,
or a plain method's launches and flag reads) over the stretch."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = trace.get('projection')
    return 100.0 * spans.total_s / prof['window_s'] if spans.count else None
