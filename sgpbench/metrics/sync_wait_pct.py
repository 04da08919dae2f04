"""Share of the profiled stretch's wall that the host spent waiting for a
device flag: the total of the program's ``sync`` spans over the stretch
(both on the host's ``perf_counter``)."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = trace.get('sync')
    return 100.0 * spans.total_s / prof['window_s'] if spans.count else None
