"""Share of the profiled stretch's wall in the beta gradient's passes: the
total time of the program's ``beta.gradient`` spans (den^(beta-1) less the
adjoint of gn den^(beta-2), in set-up and in each update) over the
stretch. None where the program has no such span."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = trace.get('beta.gradient')
    return 100.0 * spans.total_s / prof['window_s'] if spans.count else None
