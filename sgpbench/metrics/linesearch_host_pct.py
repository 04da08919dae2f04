"""Share of the profiled stretch's wall in the line search's own host work:
the self time of the program's ``solver.linesearch`` spans (the
backtracking trials' divergence evaluations; their ``sync`` children left
out) over the stretch."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = trace.get('solver.linesearch')
    return 100.0 * spans.self_s / prof['window_s'] if spans.count else None
