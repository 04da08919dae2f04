"""Batched flux-conserving projection: CUDA kernel wrapper, plain twin and
the schedule both run.

Replaces the Pallas kernel ``_kernel`` / ``project_df_pallas``
(``tpu_sgp/experimental/pallas_projection.py:40-122``). For each row of a
(B, N) batch it returns

    x = min(max((c + lam) * (1/dia), 0), cap)        (cap only with has_sat)

where lam is the root of sum(x) = b, found by 7-point sectioning (3 bits a
step) for ``n_steps`` steps from the bracket lo = min(-c),
hi = max(max(b*dia - c), lo + 1) (``pallas_projection.py:104-108``).

``project_rows`` launches ``csrc/flux_projection.cu`` for CUDA tensors and
calls ``project_rows_plain`` for CPU tensors; a CUDA call that cannot
launch raises, it never falls back. The batched solver gives it (B, 961)
stamps, one warp a row; a whole-frame solve gives it one row of H * W
pixels, which the kernel splits over the card's SMs.

``project_guided_rows`` runs the same file's other grid kernel: the cold
guided secant of the ``'bisect'`` method (``projection.flux_projection.
_guided_root``) on a few long rows in one launch; ``guided_route`` says
which rows it takes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_K = 7  # interior section points per step (pallas_projection.py:35)


def bracket_bits(dtype: torch.dtype) -> int:
    """Bracket-narrowing budget in bits (``flux_projection.py:244-252``):
    enough to push the bracket below the dtype's resolution."""
    return 54 if dtype == torch.float64 else 28


def section_steps(dtype: torch.dtype, bits: int | None = None) -> int:
    """Sectioning steps of 3 bits each that narrow the bracket by ``bits``
    (``pallas_projection.py:80-82``; default ``bracket_bits``: 10 steps in
    float32, 18 in float64)."""
    bits = bracket_bits(dtype) if bits is None else bits
    return int(math.ceil(bits / math.log2(_K + 1)))


def newton_passes(dtype: torch.dtype) -> int:
    """Main passes of the guided secant (``flux_projection.py:361-380``):
    5 in float32, 8 in float64."""
    return 8 if dtype == torch.float64 else 5


def project_rows_plain(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                       cap: torch.Tensor, n_steps: int,
                       has_sat: bool) -> torch.Tensor:
    """The projection in plain PyTorch over (B, N) rows, with per-row
    b and cap of shape (B,) (``pallas_projection.py:40-65, 100-108``)."""
    inv = 1.0 / dia
    cap = cap[:, None]

    def xval(lam):
        x = torch.clamp_min((c + lam[:, None]) * inv, 0.0)
        if has_sat:
            x = torch.minimum(x, cap)
        return x

    lo = (-c).amin(-1)
    hi = torch.maximum((b[:, None] * dia - c).amax(-1), lo + 1.0)
    for _ in range(n_steps):
        seg = (hi - lo) / (_K + 1)
        nbelow = torch.zeros_like(lo)
        for k in range(1, _K + 1):
            r = xval(lo + seg * k).sum(-1)
            nbelow = nbelow + (r - b < 0).to(lo.dtype)
        lo = lo + nbelow * seg
        hi = lo + seg
    return xval(0.5 * (lo + hi))


_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5
# which kernel serves a launch: the launcher's own rule, or one path forced
# for a measurement ('rows': one warp or one block a row; 'grid': a long
# row split over many blocks)
_PATHS = {'auto': 0, 'rows': 1, 'grid': 2}
_PLAN_OUTS = (ctypes.c_int, ctypes.c_longlong, ctypes.c_int)


@_build.cached
def launch_plan(rows: int, n: int, dtype: torch.dtype, path: str = 'auto',
                device: int = 0) -> tuple:
    """What the launcher does with a (rows, n) batch on ``device``:
    ``(path, scratch elements, blocks)``, where path is ``'rows'`` (one
    warp or one block a row) or ``'grid'`` (each row split over many
    blocks, all resident at once). ``'auto'`` takes the grid path for rows
    above 2048 pixels whose blocks all fit on the card together."""
    chosen, scratch, blocks = _build.query(
        'flux_projection', 'tpu_sgp_project_rows_plan', rows, n,
        int(dtype == torch.float64), _PATHS[path], device, outs=_PLAN_OUTS,
        what='flux projection launch plan failed')
    return ('rows', 'grid')[chosen - 1], scratch, blocks


def project_rows(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                 cap: torch.Tensor, n_steps: int,
                 has_sat: bool, path: str = 'auto') -> torch.Tensor:
    """Project every row of ``c`` (B, N) under the metric ``dia`` (B, N)
    onto {x : sum(x) = b, 0 <= x <= cap}. ``b`` and ``cap`` are (B,).

    CPU tensors take ``project_rows_plain``. CUDA tensors launch the
    kernel: one warp or one block a row, or, for a few rows longer than
    2048 pixels (one whole frame), each row split over many blocks
    (``launch_plan``). ``path`` forces one of the two for a measurement;
    a grid path that does not fit on the card raises.
    ``launches['project_rows']`` counts the launches and
    ``launches['project_rows.grid']`` those that took the grid path."""
    if not c.is_cuda:
        return project_rows_plain(b, c, dia, cap, n_steps, has_sat)
    dims = _build.check_operands(
        'c', c=(c, 'BN'), dia=(dia, 'BN'), b=(b, 'B'), cap=(cap, 'B'),
        sizes=(('n', 'N', 1), ('n_steps', n_steps, 0)))
    rows, n = dims['B'], dims['N']
    out = torch.empty_like(c)
    if rows == 0:
        return out
    device = c.device
    chosen, scratch_len, _ = launch_plan(rows, n, c.dtype, path,
                                         device.index)
    # the rows path takes no scratch (0 elements): a null pointer
    scratch = (torch.empty(scratch_len, dtype=c.dtype, device=device)
               if scratch_len else None)
    _build.launch(
        _build.kernel('flux_projection', 'tpu_sgp_project_rows', c.dtype,
                      _ARGS), device,
        b.data_ptr(), c.data_ptr(), dia.data_ptr(), cap.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch_len else None, rows,
        n, n_steps, int(has_sat), _PATHS[chosen],
        what=f'flux projection kernel launch failed ({chosen} path, {rows} '
             f'rows of {n})',
        count=('project_rows', 'project_rows.grid') if chosen == 'grid'
        else ('project_rows',))
    return out


# the guided secant on long rows: rows longer than this take the grid (the
# rule of launch_plan)
GUIDED_MIN_N = 2048
_GUIDED_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4


@_build.cached
def guided_plan(rows: int, n: int, dtype: torch.dtype,
                device: int = 0) -> tuple:
    """What a guided launch of (rows, n) needs on ``device``: ``(blocks,
    scratch elements, capacity)``, capacity being the blocks of the kernel
    that the card holds at once; it fits if blocks <= capacity."""
    return _build.query('flux_projection', 'tpu_sgp_project_guided_plan',
                        rows, n, int(dtype == torch.float64), device,
                        outs=_PLAN_OUTS,
                        what='guided projection launch plan failed')


def guided_route(rows: int, n: int, dtype: torch.dtype, device,
                 sharded: bool = False, plan: tuple | None = None) -> str:
    """Where a cold ``'bisect'`` projection of (rows, n) runs, from the
    shape alone: ``'kernel'`` (``project_guided_rows``) for rows above
    ``GUIDED_MIN_N`` pixels on a card whose blocks all fit on it at once,
    else ``'plain'`` (the PyTorch ladder): CPU tensors, rows sharded over
    mesh axes (their sums are collectives), short rows such as stamps, and
    more long rows than the card holds. ``plan``, ``(blocks, capacity)``,
    is the card's ``guided_plan`` unless given."""
    device = torch.device(device)
    if (sharded or device.type != 'cuda' or dtype not in _build.FLOATS
            or n <= GUIDED_MIN_N):
        return 'plain'
    if plan is None:
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        plan = guided_plan(rows, n, dtype, index)[::2]
    blocks, capacity = plan
    return 'kernel' if blocks <= capacity else 'plain'


def project_guided_rows(b: torch.Tensor, c: torch.Tensor, dia: torch.Tensor,
                        cap: torch.Tensor | None, n_passes: int,
                        has_sat: bool) -> tuple:
    """The cold guided secant of ``'bisect'`` on every row of ``c`` (B, N)
    under the metric ``dia`` (B, N), on the card in one launch: a probe,
    ``n_passes`` main passes, a finish pass and the closing secant, the
    schedule of ``projection.flux_projection._guided_root``. ``b`` and
    ``cap`` are (B,); ``cap`` (sat / scaling - eps) is read only with
    ``has_sat``. Returns ``(x, lam)``.

    CUDA tensors only; a launch that fails (a grid larger than the card
    holds at once) raises. ``launches['project_guided_rows']`` counts the
    launches."""
    if not c.is_cuda:
        raise ValueError('the guided kernel runs on CUDA tensors; CPU '
                         'tensors take the plain ladder')
    dims = _build.check_operands(
        'c', c=(c, 'BN'), dia=(dia, 'BN'), b=(b, 'B'),
        **({'cap': (cap, 'B')} if has_sat else {}),
        sizes=(('n', 'N', 1), ('n_passes', n_passes, 0)))
    rows, n = dims['B'], dims['N']
    out = torch.empty_like(c)
    lam = torch.empty(rows, dtype=c.dtype, device=c.device)
    if rows == 0:
        return out, lam
    device = c.device
    _, scratch_len, _ = guided_plan(rows, n, c.dtype, device.index)
    scratch = torch.empty(scratch_len, dtype=c.dtype, device=device)
    _build.launch(
        _build.kernel('flux_projection', 'tpu_sgp_project_guided_rows',
                      c.dtype, _GUIDED_ARGS), device,
        b.data_ptr(), c.data_ptr(), dia.data_ptr(),
        cap.data_ptr() if has_sat else None, out.data_ptr(), lam.data_ptr(),
        scratch.data_ptr(), rows, n, n_passes, int(has_sat),
        what=f'guided projection kernel launch failed ({rows} rows of {n})',
        count=('project_guided_rows',))
    return out, lam
