"""The seam every CUDA kernel of the port goes through
(``tpu_sgp_torch/kernels/_build.py``): binding a C entry, checking a
launch's operands, launching on the device's current stream and counting
the launch. No card is needed: a Python stand-in takes the place of a
bound kernel entry, and CPU tensors that say they lie on a card take the
place of CUDA operands.
"""
import ctypes
import ctypes.util
import types

import pytest
import torch

from tpu_sgp_torch import kernels
from tpu_sgp_torch.kernels import _build

STREAM = 0x7f00beef


class _Entry:
    """Stands in for a bound C entry: records its arguments and returns
    ``err``."""

    def __init__(self, err=0):
        self.err, self.args = err, None

    def __call__(self, *args):
        self.args = args
        return self.err


class _OnCard:
    """A CPU tensor that says it lies on a card: what ``check_operands``
    reads of a CUDA tensor."""
    is_cuda = True

    def __init__(self, t, device='cuda:0'):
        self.t, self.device = t, torch.device(device)

    def __getattr__(self, name):
        return getattr(self.t, name)


@pytest.fixture
def stream(monkeypatch):
    """The current stream of any device is the handle ``STREAM``."""
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: types.SimpleNamespace(
                            cuda_stream=STREAM))


def test_the_counter_is_the_package_export():
    assert kernels.launches is _build.launches


def test_nonzero_return_raises_and_counts_nothing(stream):
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError,
                       match=r'^seam kernel \(3 rows\): CUDA error 719$'):
        _build.launch(_Entry(719), torch.device('cuda', 0), 1, 2,
                      what='seam kernel (3 rows)', count=('seam.fail',))
    assert dict(kernels.launches) == before
    assert kernels.launches['seam.fail'] == 0


def test_zero_return_counts_once_under_each_key(stream):
    before = kernels.launches['seam.one'], kernels.launches['seam.two']
    _build.launch(_Entry(), torch.device('cuda', 0), what='seam',
                  count=('seam.one',))
    assert kernels.launches['seam.one'] == before[0] + 1
    _build.launch(_Entry(), torch.device('cuda', 0), what='seam',
                  count=('seam.one', 'seam.two'))
    assert (kernels.launches['seam.one'],
            kernels.launches['seam.two']) == (before[0] + 2, before[1] + 1)
    _build.launch(_Entry(), torch.device('cuda', 0), what='seam')
    assert kernels.launches['seam.one'] == before[0] + 2


def test_device_index_and_stream_are_passed_last(stream):
    fn = _Entry()
    _build.launch(fn, torch.device('cuda', 3), 11, None, 2.5, what='seam')
    assert fn.args == (11, None, 2.5, 3, STREAM)


def test_query_binds_c_ints_and_returns_the_out_parameters(monkeypatch):
    bound = []

    def plan(n, dtype, a, b):
        a._obj.value, b._obj.value = 2 * n, n << 40
        return 0
    monkeypatch.setattr(_build, 'entry',
                        lambda *key: bound.append(key) or plan)
    outs = (ctypes.c_int, ctypes.c_longlong)
    assert _build.query('lib', 'plan', 5, 1, outs=outs,
                        what='plan') == (10, 5 << 40)
    assert bound == [('lib', 'plan', (ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_longlong)))]
    monkeypatch.setattr(_build, 'entry', lambda *key: lambda n, a: 2)
    with pytest.raises(RuntimeError, match=r'^n=5 plan failed: CUDA error '
                                           r'2$'):
        _build.query('lib', 'plan', 5, outs=(ctypes.c_int,),
                     what='n=5 plan failed')


def test_entry_binds_a_symbol_once_and_use_library_rebinds(monkeypatch):
    """A C function of a loaded library through ``entry``: argument types
    and an int result, bound once; ``use_library`` drops the binding."""
    libc = ctypes.util.find_library('c')
    if libc is None:
        pytest.skip('no C library to bind')
    monkeypatch.setattr(_build, '_LOADED', {})
    _build.use_library('seam', libc)
    fn = _build.entry('seam', 'abs', (ctypes.c_int,))
    assert fn(-7) == 7 and fn.restype is ctypes.c_int
    assert fn.argtypes == [ctypes.c_int]
    assert _build.entry('seam', 'abs', (ctypes.c_int,)) is fn
    _build.use_library('seam', libc)
    assert _build.entry.cache_info().currsize == 0
    assert _build.entry('seam', 'abs', (ctypes.c_int,))(-3) == 3
    _build.use_library('seam', libc)      # leave no binding to the stand-in


def _operands(**over):
    """A K1-like launch: c and dia (4, 300), b and cap (4,), as CUDA
    tensors, with ``over`` replacing any of them."""
    ops = dict(c=torch.ones(4, 300), dia=torch.ones(4, 300),
               b=torch.ones(4), cap=torch.ones(4))
    ops = {k: _OnCard(t) for k, t in ops.items()} | over
    dims = dict(c='BN', dia='BN', b='B', cap='B')
    return {k: (t, dims[k]) for k, t in ops.items()}


def test_check_operands_returns_the_axis_sizes():
    assert _build.check_operands('c', **_operands()) == dict(B=4, N=300)


@pytest.mark.parametrize('error,words,over,kw', [
    (TypeError, 'float32 or float64',
     dict(c=_OnCard(torch.ones(4, 300, dtype=torch.float16))), {}),
    (TypeError, '^dia is torch.float64', dict(dia=_OnCard(
        torch.ones(4, 300, dtype=torch.float64))), {}),
    (TypeError, '^cap is .* on cuda:1', dict(cap=_OnCard(torch.ones(4),
                                                         'cuda:1')), {}),
    (TypeError, '^b is .* on cpu', dict(b=torch.ones(4)), {}),
    (ValueError, r'^b must have shape \(B=4\)',
     dict(b=_OnCard(torch.ones(3))), {}),
    (ValueError, r'^dia must have shape \(B=4, N=300\)',
     dict(dia=_OnCard(torch.ones(4, 301))), {}),
    (ValueError, r'^c must have shape \(B, N\)',
     dict(c=_OnCard(torch.ones(300))), {}),
    (ValueError, '^dia must be contiguous',
     dict(dia=_OnCard(torch.ones(300, 4).T)), {}),
    (ValueError, 'size', {}, dict(sizes=(('n_steps', 2 ** 31, 0),))),
    (ValueError, 'size', {}, dict(sizes=(('n', 'N', 301),))),
    (ValueError, 'size', dict(c=_OnCard(torch.ones(4, 0)),
                              dia=_OnCard(torch.ones(4, 0))),
     dict(sizes=(('row length', 'N', 1),))),
])
def test_check_operands_raises_for_each_fault(error, words, over, kw):
    with pytest.raises(error, match=words):
        _build.check_operands('c', **_operands(**over), **kw)


def test_unit_stride_asks_only_the_last_axis():
    x = torch.ones(300, 8)
    _build.check_operands('x', x=(_OnCard(x[::2]), None), unit_stride=True)
    with pytest.raises(ValueError, match='unit stride'):
        _build.check_operands('x', x=(_OnCard(x.T), None), unit_stride=True)
    with pytest.raises(ValueError, match='contiguous'):
        _build.check_operands('x', x=(_OnCard(x[::2]), None))


def test_cpu_operands_are_held_to_their_shapes_alone():
    """CPU tensors take a plain twin: dtype, layout and sizes are the
    launch's, not checked; shapes are."""
    half = torch.ones(4, 300, dtype=torch.float16)
    dims = _build.check_operands('c', c=(half, 'BN'), dia=(half.T.T, 'BN'),
                                 b=(torch.ones(4, dtype=torch.int32), 'B'),
                                 sizes=(('n', 'N', 301),))
    assert dims == dict(B=4, N=300)
    with pytest.raises(ValueError, match='shape'):
        _build.check_operands('c', c=(half, 'BN'), b=(torch.ones(3), 'B'))
