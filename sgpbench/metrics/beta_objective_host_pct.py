"""Share of the profiled stretch's wall in the beta objective's passes:
the total time of the program's ``beta.objective`` spans (each evaluation
of the beta-divergence, with its d/dbeta in the line search's trials) over
the stretch. None where the program has no such span."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = trace.get('beta.objective')
    return 100.0 * spans.total_s / prof['window_s'] if spans.count else None
