"""The compensated row sum (``ops.reduce.gsum_ff``): on the CPU, the
CUDA kernel's plan against the plain tree, bit for bit, through a plain
PyTorch copy of the kernel's column decomposition; on a card only, the
kernel (``kernels.compensated_sum.ff_sum_rows``) against the plain tree
and the facade's frame solve with each.

No JAX here, so that the card's tests run where it is not installed:
    python -m pytest tests/test_torch_compensated_sum.py --noconftest \
        -o addopts= -m cuda
"""
import numpy as np
import pytest
import torch

from tpu_sgp_torch.kernels import compensated_sum as cs
from tpu_sgp_torch.ops import reduce as tred

# rows of one value to columns of 512 (a block holds at most 1024
# columns, a quarter of the padded row), a ragged and an exact power of two
# on each side of each switch, a 31x31 stamp and a 410x410 frame
LENGTHS = (1, 2, 3, 5, 31, 32, 33, 255, 256, 257, 961, 1024, 1025, 4097,
           8192, 8193, 16385, 65537, 168100, 2 ** 18, 2 ** 18 + 1)
DTYPES = (torch.float32, torch.float64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _values(rng, rows: int, n: int, dtype) -> torch.Tensor:
    """Rows whose sum depends on the order of the operations, so that bit
    equality pins the order: a third of the values spread over 8 decades
    (24 in float64), their exact negatives and small ones, shuffled. The
    partial sums round, and the rounding errors that the lo accumulators
    add round again at the size of the result's last bits (any other
    column decomposition gives other bits on nearly every row)."""
    decades = 8 if dtype == torch.float32 else 24
    out = np.empty((rows, n))
    for r in range(rows):
        k = n // 3
        big = rng.normal(0.0, 1.0, k) * 10.0 ** rng.uniform(0, decades, k)
        small = rng.normal(0.0, 1e-2, n - 2 * k)
        out[r] = rng.permutation(np.concatenate([big, -big, small]))
    return torch.as_tensor(out, dtype=dtype)


def _node(ah, al, bh, bl):
    """A node of the tree, as ``tree_sum_ff`` writes it."""
    s = ah + bh
    bb = s - ah
    return s, (al + bl) + ((ah - (s - bb)) + (bh - bb))


def _levels(h, l):
    """The tree over the last axis of (h, l), a power of two wide: slot i
    with slot i + half, level by level."""
    while h.shape[-1] > 1:
        k = h.shape[-1] // 2
        h, l = _node(h[..., :k], l[..., :k], h[..., k:], l[..., k:])
    return h[..., 0], l[..., 0]


def _columns(h, l, cols: int):
    """The first log2(p / cols) levels of the tree over (B, p) rows: column
    j's values {j + m cols} laid side by side and their own tree taken.
    Returns (B, cols) of (hi, lo)."""
    rows, p = h.shape
    col = lambda a: a.reshape(rows, p // cols, cols).transpose(1, 2)
    return _levels(col(h), col(l))


def _rev(g: int, bits: int) -> int:
    return int(format(g, f'0{bits}b')[::-1], 2) if bits else 0


def _kernel_order_sum(x: torch.Tensor, cols: int, chunk: int):
    """The kernel's order of operations with ``cols`` columns a row, read
    ``2**chunk`` values at a time: chunk g of each column is its values
    {rev(g) + s 2^(levels - chunk)}, reduced on their own, and the chunks'
    results fold in order on a stack (chunk g merging once for each one
    that g ends in); then the block's levels over the columns and hi +
    lo."""
    rows, n = x.shape
    p = 1 << (n - 1).bit_length()
    levels = (p // cols).bit_length() - 1
    cl = min(levels, chunk)
    sb = levels - cl
    col = torch.nn.functional.pad(x, (0, p - n)).reshape(rows, p // cols,
                                                         cols)
    stack = [None] * (sb + 1)
    for g in range(1 << sb):
        m = _rev(g, sb) + (torch.arange(1 << cl) << sb)
        h = col[:, m, :].transpose(1, 2)            # (rows, cols, 2^cl)
        v = _levels(h, torch.zeros_like(h))
        lv = 0
        while (g >> lv) & 1:
            v = _node(*stack[lv], *v)
            lv += 1
        stack[lv] = v
    h, l = _levels(*v)
    return h + l


def _orders(n: int, most_chunks: int = 64):
    """(cols, chunk) of every power-of-two column count and chunks of 1, 2,
    8 and 16 values whose columns take at most ``most_chunks`` chunks."""
    p = 1 << (n - 1).bit_length()
    cols = p
    while cols >= 1:
        levels = (p // cols).bit_length() - 1
        for chunk in (0, 1, 3, 4):
            if levels - min(levels, chunk) <= most_chunks.bit_length() - 1:
                yield cols, chunk
        cols //= 2


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n', LENGTHS)
def test_every_column_count_gives_the_tree(n, dtype):
    """For every power-of-two column count, k levels over each strided
    column and then the tree over the columns give the tree's bits."""
    x = _values(np.random.default_rng(n), 3, n, dtype)
    want = _bits(tred.tree_sum_ff(x))
    p = 1 << (n - 1).bit_length()
    h = torch.nn.functional.pad(x, (0, p - n))
    cols = p
    while cols >= 1:
        got = _levels(*_columns(h, torch.zeros_like(h), cols))
        assert torch.equal(_bits(got[0] + got[1]), want), cols
        cols //= 2


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n', LENGTHS)
def test_kernel_order_gives_the_tree(n, dtype):
    """The kernel's order (bit-reversed chunks folded on a stack, then the
    block's levels) gives ``gsum_ff``'s bits for every column count and
    chunk size within 64 chunks a column, the kernel's own plan among them
    up to 2^18 + 1 (1024 columns of 2^9 values in chunks of 8 or 16; the
    card's tests hold the C entry's plan to this model)."""
    x = _values(np.random.default_rng(n + 1), 3, n, dtype)
    want = _bits(tred.gsum_ff(x))
    for cols, chunk in _orders(n):
        assert torch.equal(_bits(_kernel_order_sum(x, cols, chunk)),
                           want), (cols, chunk)


def test_long_columns_fold_on_the_stack():
    """A column of 4096 values read 4 at a time, 1024 chunks on a stack 10
    deep, gives the tree's bits (a row of 3000 in one column)."""
    x = _values(np.random.default_rng(3), 2, 3000, torch.float32)
    assert torch.equal(_bits(_kernel_order_sum(x, 1, 2)),
                       _bits(tred.tree_sum_ff(x)))


def test_plan_refuses_lengths_out_of_range():
    for n in (0, -1, 2 ** 31):
        with pytest.raises(ValueError, match='row length'):
            cs.ff_sum_plan(n)


def test_cpu_rows_take_the_plain_tree():
    """A CPU tensor keeps the plain tree: no kernel, the same bits as
    ``tree_sum_ff``, over leading axes too; an empty row sums to zeros."""
    x = _values(np.random.default_rng(5), 6, 1025, torch.float32)
    before = cs.ff_sum_rows.launches
    assert torch.equal(_bits(tred.gsum_ff(x.reshape(2, 3, 1025))),
                       _bits(tred.tree_sum_ff(x)).reshape(2, 3))
    assert cs.ff_sum_rows.launches == before
    z = tred.gsum_ff(torch.zeros(4, 0, dtype=torch.float64))
    assert z.shape == (4,) and z.dtype == torch.float64 and not z.any()
    with pytest.raises(ValueError, match='CUDA'):
        cs.ff_sum_rows(x)


# ---- on a card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('rows', [1, 3, 257])
@pytest.mark.parametrize('n', [1, 2, 3, 31, 961, 1024, 1025, 168100, 2 ** 18,
                               2 ** 18 + 1])
def test_kernel_equals_the_tree_on_card(n, rows, dtype):
    _card()
    x = _values(np.random.default_rng(n + rows), rows, n, dtype).cuda()
    before = cs.ff_sum_rows.launches
    got = cs.ff_sum_rows(x)
    assert cs.ff_sum_rows.launches == before + 1
    want = tred.tree_sum_ff(x)
    torch.cuda.synchronize()
    assert got.shape == (rows,) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    if rows <= 3:
        assert torch.equal(_bits(got.cpu()), _bits(tred.tree_sum_ff(x.cpu())))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_plans_of_the_main_shapes_on_card(dtype):
    """The C entry's plan: one block a row of p / 4 columns, at least 1
    and at most 1024; the CPU model of the kernel's order with that plan
    gives the tree's bits on every length of the CPU tests."""
    _card()
    chunk = 4 if dtype == torch.float32 else 3
    assert cs.ff_sum_plan(1, dtype) == (1, 0, chunk)
    assert cs.ff_sum_plan(3, dtype) == (1, 2, chunk)
    assert cs.ff_sum_plan(961, dtype) == (256, 2, chunk)    # a stamp
    assert cs.ff_sum_plan(410 * 410, dtype) == (1024, 8, chunk)  # a frame
    assert cs.ff_sum_plan(2 ** 31 - 1, dtype) == (1024, 21, chunk)
    for n in LENGTHS:
        cols, levels, chunk = cs.ff_sum_plan(n, dtype)
        assert cols << levels == 1 << (n - 1).bit_length()
        x = _values(np.random.default_rng(n + 2), 2, n, dtype)
        assert torch.equal(_bits(_kernel_order_sum(x, cols, chunk)),
                           _bits(tred.tree_sum_ff(x)))
        assert torch.equal(_bits(cs.ff_sum_rows(x.cuda()).cpu()),
                           _bits(tred.tree_sum_ff(x)))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_kernel_on_card_leading_axes_cancellation_and_nonfinite(dtype):
    """A 3-d input, rows of a strided view, the adversarial cancellation
    of tests/test_divergence.py:166 (large pairs cancel, tiny values
    survive), and NaN and inf propagating as the tree's do."""
    _card()
    rng = np.random.default_rng(166)
    x = _values(rng, 6, 1025, dtype).cuda().reshape(2, 3, 1025)
    assert torch.equal(_bits(tred.gsum_ff(x)), _bits(tred.tree_sum_ff(x)))
    wide = _values(rng, 8, 40000, dtype).cuda()
    view = wide[::2, 3:30003]             # row stride 80000, unit pixels
    assert torch.equal(_bits(cs.ff_sum_rows(view)),
                       _bits(tred.tree_sum_ff(view)))

    big = rng.normal(0, 1e6, 2048)
    tiny = rng.normal(0, 1e-2, 4096)
    row = np.concatenate([big, -big, tiny]).astype(np.float32)
    rows = torch.as_tensor(np.stack([row, row[::-1].copy()]), dtype=dtype)
    got = tred.gsum_ff(rows.cuda())
    assert torch.equal(_bits(got.cpu()), _bits(tred.tree_sum_ff(rows)))
    truth = float(np.sum(row.astype(np.float64)))
    assert abs(float(got[0]) - truth) <= 4 * abs(truth) * float(
        torch.finfo(dtype).eps)

    odd = _values(rng, 5, 3000, dtype)
    odd[0, 17] = float('nan')
    odd[1, 2999] = float('inf')
    odd[2, 0], odd[2, 1] = float('inf'), float('-inf')
    odd[3, 100] = torch.finfo(dtype).max
    odd[3, 101] = torch.finfo(dtype).max
    got = tred.gsum_ff(odd.cuda()).cpu()
    want = tred.tree_sum_ff(odd)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take():
    _card()
    x = torch.ones(4, 300, device='cuda')
    with pytest.raises(ValueError, match='unit stride'):
        cs.ff_sum_rows(x.T)
    for dtype in (torch.int32, torch.float16):
        with pytest.raises(TypeError, match='float32 or float64'):
            cs.ff_sum_rows(x.to(dtype))
    with pytest.raises(ValueError, match='CUDA'):
        cs.ff_sum_rows(x.cpu())
    with pytest.raises(ValueError, match='size'):
        cs.ff_sum_rows(x[:, :0])
    # gsum_ff makes a transposed row contiguous and still launches
    before = cs.ff_sum_rows.launches
    assert torch.equal(tred.gsum_ff(x.T), tred.tree_sum_ff(x.T.cpu()).cuda())
    assert cs.ff_sum_rows.launches == before + 1


def _frame():
    """Field 0 of the frame cell's fixed family (410x410, 60 stars, a 31x31
    PSF of FWHM 3.0, background 150), in float32 as the cell passes it."""
    from tpu_sgp_torch.simulate import synthetic_star_field
    seed = int(np.random.default_rng([410, 0]).integers(2 ** 63))
    img, psf, _ = synthetic_star_field(410, 410, n_stars=60, fwhm=3.0,
                                       psf_size=31, bkg=150.0, seed=seed)
    return img.astype(np.float32), psf


def _facade(img, psf):
    import tpu_sgp_torch
    return tpu_sgp_torch.sgp(img, psf, 150.0, MAXIT=500, stop_criterion=3,
                             tol_convergence=1e-5, init_recon=2, proj_type=1,
                             alpha=1.3, dtype='float32', device='cuda')


@pytest.mark.cuda
def test_facade_frame_is_bit_equal_with_the_kernel_and_the_tree(monkeypatch):
    """The float32 facade on a frame: the same iterations and x, bit for
    bit, whether its compensated sums launch the kernel or run the plain
    tree on the card."""
    _card()
    img, psf = _frame()
    before = cs.ff_sum_rows.launches
    x, iters, *_ = _facade(img, psf)
    launched = cs.ff_sum_rows.launches - before
    monkeypatch.setattr(cs, 'ff_sum_rows', tred.tree_sum_ff)
    xp, iters_p, *_ = _facade(img, psf)
    assert launched >= 2 * (iters + 1)
    assert iters == iters_p
    assert x.dtype == xp.dtype and x.tobytes() == xp.tobytes()


@pytest.mark.cuda
def test_traced_launches_count_two_an_objective(monkeypatch):
    """Under tracing, ``ff_sum.launches`` adds 2 for each KL objective
    evaluation (set-up's and each line-search trial's), under the span
    that evaluated it."""
    _card()
    from tpu_sgp_torch import observability
    from tpu_sgp_torch.ops import divergence as dv
    img, psf = _frame()
    _facade(img, psf)                     # builds, warms up
    evaluations = []
    kl = dv.kl_objective

    def counted(*args, **kw):
        evaluations.append(observability._local.stack[-1].name)
        return kl(*args, **kw)
    monkeypatch.setattr(dv, 'kl_objective', counted)
    with observability.tracing() as trace:
        _facade(img, psf)
    launches = {path[-2]: st.count for path, st in trace.by_path().items()
                if path[-1] == 'ff_sum.launches'}
    trials = evaluations.count('solver.linesearch')
    assert evaluations.count('solver.setup') == 1
    assert trials + 1 == len(evaluations)
    assert launches == {'solver.setup': 2, 'solver.linesearch': 2 * trials}
    assert trace.get('ff_sum.launches').count == 2 * (1 + trials)
