"""Share of the profiled stretch's wall in the entry points' own host work:
the self time of the program's ``entry`` spans and of every ``entry.*``
span (inputs to tensors and the upload, compaction's gathers and scatters,
the download; the solves inside them left out) over the stretch."""


def read(rec):
    from tpu_sgp_torch import observability
    last = getattr(observability, 'last_trace', None)
    trace = last() if last is not None else None
    prof = rec.get('profile')
    if trace is None or not prof or not prof['window_s']:
        return None
    spans = [s for name, s in trace.by_name().items()
             if name == 'entry' or name.startswith('entry.')]
    if not spans:
        return None
    return 100.0 * sum(s.self_s for s in spans) / prof['window_s']
