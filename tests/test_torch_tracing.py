"""The port's host spans (``tpu_sgp_torch/observability.py``: ``span``,
``host_flag``, ``tracing``, ``last_trace``) and where the program opens
them: the entry points, the solver loop, the projection and each host read
of a device flag. On the CPU: counts against the solver's own iteration
and objective counts, the recording's arithmetic, the events a
``torch.profiler`` sees, separate recordings for separate profiler
sessions, threads, and results bit for bit the same with tracing on and
off."""
import threading
import tracemalloc

import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpu_sgp_torch import SGPConfig
from tpu_sgp_torch import observability as obs
from tpu_sgp_torch.ops import divergence as dv
from tpu_sgp_torch.parallel.batch import restore_stamps
from tpu_sgp_torch.simulate import synthetic_star_stamps

from test_torch_workloads import _one_torch_thread  # noqa: F401

def _stamps(b=8, size=12, seed=5):
    stamps, psf, bkgs, _ = synthetic_star_stamps(b, size=size, seed=seed)
    return stamps, psf, bkgs, stamps.sum(axis=(1, 2)) - size * size * bkgs


def _cfg(**kw):
    return SGPConfig(**dict(dict(
        max_iter=40, stop_criterion=3, tol_convergence=1e-4, proj_type=1,
        has_flux=True, init_recon=2, has_sat_level=True,
        projection_method='pallas', dtype='float32'), **kw))


def _restore(cfg=None, b=8, **kw):
    stamps, psf, bkgs, fluxes = _stamps(b)
    return restore_stamps(stamps, psf, bkgs, cfg or _cfg(), fluxes=fluxes,
                          sat_level=65000.0, flatten=True, device='cpu',
                          **kw)


class _HostReads(TorchFunctionMode):
    """Counts the host's reads of a tensor's value (``bool``, ``item``)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__bool__, torch.Tensor.item):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_returns_the_shared_no_op_and_records_nothing(monkeypatch):
    """With no profiler and no tracing() block, span() is the one shared
    NO_SPAN, builds no span object, allocates nothing, and a solve leaves
    the newest recording as it was."""
    assert obs.span('entry') is obs.NO_SPAN
    assert obs.span('sync') is obs.NO_SPAN
    before = obs.last_trace()

    def refused(*a, **kw):
        raise AssertionError('a span was built with tracing off')
    monkeypatch.setattr(obs, '_Span', refused)
    res = _restore(b=4)
    assert int(res.iters.max()) > 0
    assert obs.last_trace() is before
    with obs.NO_SPAN as s:
        assert s is obs.NO_SPAN
    tracemalloc.start()
    try:
        snap = tracemalloc.take_snapshot()
        for _ in range(2000):
            with obs.span('solver.trip'):
                pass
        grown = sum(d.size_diff for d in
                    tracemalloc.take_snapshot().compare_to(snap, 'filename')
                    if d.traceback[0].filename == obs.__file__)
    finally:
        tracemalloc.stop()
    assert grown <= 0


def test_single_phase_counts_match_the_solver(monkeypatch):
    """One restore_stamps call without compaction: one entry, one solve, a
    trip an iteration of the slowest lane, and a sync for each of the
    loop's tests (trips + 1) and each of the line search's (a test before
    each trial and the one that ends the trials, every trip: the config's
    max_backtracks cannot bind before lam < 1e-12 accepts). The trials are
    counted as objective evaluations, less the first state's."""
    calls = []
    kl = dv.kl_objective

    def counted(*a, **kw):
        calls.append(1)
        return kl(*a, **kw)
    monkeypatch.setattr(dv, 'kl_objective', counted)
    reads = _HostReads()
    with obs.tracing() as t, reads:
        res = _restore()
    names = t.by_name()
    trips = int(res.iters.max())
    trials = len(calls) - 1
    assert names['solver.trip'].count == trips
    assert names['entry'].count == 1
    assert names['entry.prepare'].count == 1
    assert names['solver.solve'].count == 1
    assert names['solver.setup'].count == 1
    for phase in ('solver.direction', 'solver.linesearch', 'solver.update'):
        assert names[phase].count == trips, phase
    assert names['projection'].count == trips + 1   # and the initial one
    assert names['sync'].count == trips + 1 + trials + trips
    assert reads.n == names['sync'].count
    assert 'entry.compact' not in names and 'entry.download' not in names
    assert obs.last_trace() is t


def test_two_phase_counts_each_solve_and_compaction_round():
    """Phase 1, two tail rounds and the finishing pass: four solves, two
    entry.compact spans, each holding its round's resumed solve."""
    with obs.tracing() as t:
        _restore(b=16, phase1_iters=8, tail_bucket=4)
    names = t.by_name()
    paths = t.by_path()
    assert names['solver.solve'].count == 4
    assert names['entry.compact'].count == 2
    assert paths[('entry', 'entry.compact', 'solver.solve')].count == 2
    assert paths[('entry', 'solver.solve')].count == 2
    assert ('entry', 'solver.solve', 'solver.setup', 'projection') in paths
    # a resume starts from its state: no initial projection
    assert ('entry', 'entry.compact', 'solver.solve', 'solver.setup',
            'projection') not in paths


def test_self_times_add_up_to_each_root():
    """Self times are not negative, none exceeds its total, and the self
    times of a root span's subtree add up to the root's total."""
    with obs.tracing() as t:
        _restore(b=16, phase1_iters=8, tail_bucket=4)
        stamps, psf, bkgs, _ = _stamps(1, size=24)
        from tpu_sgp_torch import sgp
        sgp(stamps[0], psf, float(bkgs[0]), proj_type=1, stop_criterion=3,
            MAXIT=15, device='cpu')
    paths = t.by_path()
    roots = [p for p in paths if len(p) == 1]
    assert sorted(roots) == [('entry',)]
    assert paths[('entry',)].count == 2
    assert paths[('entry', 'entry.download')].count == 1
    for st in paths.values():
        assert st.self_s >= 0 and st.self_s <= st.total_s
    for root in roots:
        below = sum(st.self_s for p, st in paths.items()
                    if p[:len(root)] == root)
        assert below == pytest.approx(paths[root].total_s, rel=1e-9)


def test_profiler_events_match_the_recording_and_nest():
    """Under torch.profiler (no tracing() block) every span is a host
    event ``tpu_sgp_torch.<name>``, as many as the recording counts, and
    they lie inside an enclosing user record_function on the same
    timeline, each loop trip inside a solve."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('user.block'):
            _restore(b=16, phase1_iters=8, tail_bucket=4)
    t = obs.last_trace()
    events = [e for e in prof.events() if e.name.startswith(obs.SPAN_PREFIX)]
    got = {}
    for e in events:
        name = e.name[len(obs.SPAN_PREFIX):]
        got[name] = got.get(name, 0) + 1
    assert got == {n: s.count for n, s in t.by_name().items()}
    (user,) = [e for e in prof.events() if e.name == 'user.block']
    for e in events:
        assert user.time_range.start <= e.time_range.start
        assert e.time_range.end <= user.time_range.end
    solves = [e.time_range for e in events
              if e.name == obs.SPAN_PREFIX + 'solver.solve']
    for e in events:
        if e.name == obs.SPAN_PREFIX + 'solver.trip':
            assert any(s.start <= e.time_range.start and
                       e.time_range.end <= s.end for s in solves)


def test_each_profiler_session_gets_its_own_recording():
    """Two profiler sessions with untraced calls between them: two
    recordings, each holding its own session's spans alone."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for b in (4, 8):
        _restore(b=2)                       # untraced
        with profile(activities=[ProfilerActivity.CPU]):
            res = _restore(b=b)
        seen.append((obs.last_trace(), int(res.iters.max())))
        _restore(b=2)                       # untraced again
        assert obs.last_trace() is seen[-1][0]
    (first, trips1), (second, trips2) = seen
    assert first is not second
    assert first.get('entry').count == second.get('entry').count == 1
    assert first.get('solver.trip').count == trips1
    assert second.get('solver.trip').count == trips2


@pytest.mark.parametrize('method,warm', [('pallas', False),
                                         ('bisect', False),
                                         ('bisect', True)])
def test_results_are_bit_identical_with_tracing_on(method, warm):
    """Spans change no arithmetic: x and iters the same bits with tracing
    off, in a tracing() block and under a profiler; and the host reads the
    same device flags as often."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _cfg(projection_method=method, warm_projection=warm)
    off_reads, on_reads = _HostReads(), _HostReads()
    with off_reads:
        off = _restore(cfg)
    with obs.tracing() as t, on_reads:
        on = _restore(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        prof = _restore(cfg)
    for res in (on, prof):
        assert torch.equal(res.x, off.x)
        assert torch.equal(res.iters, off.iters)
    assert on_reads.n == off_reads.n == t.get('sync').count
    if warm:
        # the warm bisection reads its own flag inside the projection
        assert ('projection', 'sync') in {p[-2:] for p in t.by_path()}


def test_threads_nest_their_spans_under_their_own_parents():
    """Two threads solving at once in one tracing() block: each thread's
    spans hang under that thread's own root, and the counts add up."""
    errors = []

    def work(tag, b):
        try:
            with obs.span(tag):
                _restore(b=b)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    with obs.tracing() as t:
        threads = [threading.Thread(target=work, args=(f'thread.{i}', b))
                   for i, b in enumerate((4, 8))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    paths = t.by_path()
    for p in paths:
        assert p[0] in ('thread.0', 'thread.1')
        assert p.count('entry') == 1 or len(p) == 1
        assert not ({'thread.0', 'thread.1'} <= set(p))
    for i in (0, 1):
        assert paths[(f'thread.{i}', 'entry', 'solver.solve')].count == 1
    assert t.get('solver.solve').count == 2


def test_host_flag_and_traced_keep_what_they_wrap():
    """host_flag is bool() of its tensor; traced keeps the function's
    name, docstring and signature."""
    import inspect
    assert obs.host_flag(torch.tensor(True)) is True
    assert obs.host_flag(torch.zeros(3).any()) is False
    assert restore_stamps.__name__ == 'restore_stamps'
    assert 'Restore a batch of stamps' in restore_stamps.__doc__
    assert 'phase1_iters' in inspect.signature(restore_stamps).parameters
    with obs.tracing() as t:
        assert obs.host_flag(torch.tensor([1.0]).bool()) is True
    sync = t.get('sync')
    assert sync.count == 1 and sync.self_s == sync.total_s > 0


def _beta_cfg(**kw):
    return _cfg(**dict(dict(divergence='beta', adapt_beta=True,
                            schedule_lr=True, projection_method='section'),
                       **kw))


def _restore_beta(cfg=None, b=8, **kw):
    return _restore(cfg or _beta_cfg(), b=b, beta0=1.005, lr0=1e-3, **kw)


def test_beta_solve_spans_its_objective_and_gradient_and_counts_rows():
    """One beta solve without compaction: a ``beta.objective`` span for
    set-up's evaluation and each line-search trial (a trial follows each
    of the line search's flag reads but the one that ends the trip), a
    ``beta.gradient`` span for set-up's and each update's, and
    ``beta.rows`` the batch's rows in every objective pass, inside it."""
    b = 8
    with obs.tracing() as t:
        res = _restore_beta(b=b)
    names = t.by_name()
    paths = t.by_path()
    trips = int(res.iters.max())
    ls_syncs = sum(st.count for p, st in paths.items()
                   if p[-2:] == ('solver.linesearch', 'sync'))
    trials = ls_syncs - trips
    assert trials >= trips
    assert names['beta.objective'].count == trials + 1
    assert names['beta.gradient'].count == trips + 1
    assert names['beta.rows'] == (b * (trials + 1), 0.0, 0.0)
    for p, st in paths.items():
        if p[-1] == 'beta.rows':
            assert p[-2] == 'beta.objective'
        if p[-1] == 'beta.objective':
            assert p[-2] in ('solver.setup', 'solver.linesearch')
        if p[-1] == 'beta.gradient':
            assert p[-2] in ('solver.setup', 'solver.update')


def test_beta_rows_follow_compaction_and_the_disabled_line_search(
        monkeypatch):
    """With compaction every pass counts the rows of its own solve (the
    phase-1 batch, a tail, the finishing pass), as many passes as the
    objective was evaluated; with ``max_backtracks=0`` one objective pass a
    trip and set-up's."""
    passes = []
    for name in ('beta_div', 'beta_div_with_dbeta'):
        fn = getattr(dv, name)

        def counted(den, *a, _fn=fn, **kw):
            passes.append(den.shape[0])
            return _fn(den, *a, **kw)
        monkeypatch.setattr(dv, name, counted)
    with obs.tracing() as t:
        _restore_beta(b=16, phase1_iters=8, tail_bucket=4)
    assert set(passes) == {16, 4}
    assert t.get('beta.objective').count == len(passes)
    assert t.get('beta.rows').count == sum(passes)

    passes.clear()
    with obs.tracing() as t:
        res = _restore_beta(_beta_cfg(max_backtracks=0), b=4)
    trips = int(res.iters.max())
    assert len(passes) == trips + 1
    assert t.get('beta.objective').count == trips + 1
    assert t.get('beta.rows').count == 4 * (trips + 1)


def test_kl_solve_records_no_beta_span_and_keeps_its_line_search_self():
    """The KL path gains none of the beta spans and counters: its line
    search's trials stay in ``solver.linesearch``'s own time, whose only
    child span is the flag read."""
    with obs.tracing() as t:
        _restore(b=8)
    assert not [n for n in t.by_name() if n.startswith('beta.')]
    children = {p[-1] for p in t.by_path()
                if len(p) > 1 and p[-2] == 'solver.linesearch'}
    assert children == {'sync'}
    ls = t.get('solver.linesearch')
    assert ls.count > 0 and ls.self_s > 0


def test_count_records_nothing_while_tracing_is_off(monkeypatch):
    """Off, ``count`` adds to no recording and builds nothing; on, it adds
    its number under the innermost open span, with no time."""
    with obs.tracing() as t:
        pass

    def refused(*a, **kw):
        raise AssertionError('a count was recorded with tracing off')
    monkeypatch.setattr(obs.Trace, '_count', refused)
    obs.count('beta.rows', 5)
    res = _restore_beta(b=4)
    assert int(res.iters.max()) > 0
    assert obs.last_trace() is t and not t.by_path()
    monkeypatch.undo()
    with obs.tracing() as t:
        obs.count('rows', 3)
        with obs.span('outer'):
            obs.count('rows', 2)
            obs.count('rows', 4)
    paths = t.by_path()
    assert paths[('rows',)] == (3, 0.0, 0.0)
    assert paths[('outer', 'rows')] == (6, 0.0, 0.0)
    assert t.get('rows').count == 9
    assert paths[('outer',)].count == 1


def test_beta_results_are_bit_identical_with_tracing_on():
    """The beta spans and counter change no arithmetic and read no device
    value: x, iters and beta the same bits off, in a tracing() block and
    under a profiler, and the host reads as many flags."""
    from torch.profiler import ProfilerActivity, profile
    off_reads, on_reads = _HostReads(), _HostReads()
    with off_reads:
        off = _restore_beta(b=8, phase1_iters=6, tail_bucket=4)
    with obs.tracing() as t, on_reads:
        on = _restore_beta(b=8, phase1_iters=6, tail_bucket=4)
    with profile(activities=[ProfilerActivity.CPU]):
        prof = _restore_beta(b=8, phase1_iters=6, tail_bucket=4)
    for res in (on, prof):
        assert torch.equal(res.x, off.x)
        assert torch.equal(res.iters, off.iters)
        assert torch.equal(res.beta, off.beta)
    assert on_reads.n == off_reads.n == t.get('sync').count
