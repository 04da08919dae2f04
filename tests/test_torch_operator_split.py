"""The arithmetic of the whole-solver kernel's float32 operator
(``tpu_sgp_torch/csrc/stamp_solver.cu``, ``TcPatch``) in plain PyTorch on
the CPU, where no kernel runs.

The kernel computes AT (and A) as one matrix product a tap row a, of the
stamp with its rows shifted cyclically by a (one more for A) and the W x W
circulant of the tap row, over output rows and columns padded to
multiples of 16, and runs each product on the tensor cores as three TF32
products (hi*hi + hi*lo + lo*hi). Here, with the kernel's own padding and
indexing:

- in float64 the tap-row decomposition equals the dense circulant product
  that ``apply_operator_plain`` computes, for A, AT and (AT A);
- emulated in float32, the three-pass split keeps (AT A) x within the
  limit ``chip_smoke.py`` holds the kernel to on the card, and a single
  TF32 pass does not: why three passes are needed.
"""
import numpy as np
import pytest
import torch

from tpu_sgp_torch.kernels.stamp_solver import apply_operator_plain
from tpu_sgp_torch.ops.psf_operator import build_circulant_matrix
from tpu_sgp_torch.simulate import synthetic_star_stamps

# chip_smoke.py's OPERATOR_TOL: max|dy| / max|x| of (AT A) x against the
# dense product
OPERATOR_TOL = {'float32': 1e-5, 'float64': 1e-12}
SHAPES = [(31, 31), (7, 7), (5, 9), (16, 16), (17, 33), (40, 40)]


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, on the 13 low mantissa bits of an int32 view: the
    kernel's ``tf32_rna``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def three_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it in float32: each operand split into
    hi = tf32(v) and lo = tf32(v - hi), then lo*hi + hi*lo + hi*hi, three
    float32 products of TF32 values."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def one_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def tap_row_operator(x: torch.Tensor, taps: torch.Tensor, transpose: bool,
                     product=exact) -> torch.Tensor:
    """A(x) (transpose False) or AT(x) of (B, H*W) rows with the (H, W)
    taps = fftshift(psf), as sum over tap rows a of (S_a X) T_a:

    - X staged with its rows doubled (row u holds X[u mod H]) and zero
      columns up to P = 16 * ceil(W / 16);
    - output rows padded to M = 16 * ceil(H / 16), each padded row reading
      a real row (row i mod H), and output columns padded to P;
    - T_a[c][j] = k[a][(c - j) mod W] for AT, kf[a][(c - j - 1) mod W]
      with kf the flipped taps for A, which reads one row further down;
      T_a depends on c - j only (the kernel's widened tap row).

    ``product`` multiplies one tap row's (B, M, P) rows by its (P, P)
    circulant."""
    b = x.shape[0]
    h, w = taps.shape
    m, p = -(-h // 16) * 16, -(-w // 16) * 16
    xs = x.new_zeros(b, 2 * h, p)
    xs[:, :h, :w] = x.reshape(b, h, w)
    xs[:, h:, :w] = x.reshape(b, h, w)
    e = torch.arange(p)[:, None] - torch.arange(p)[None, :]     # c - j
    if transpose:
        tw, shift = taps[:, e % w], 0
    else:
        tw, shift = taps.flip(0, 1)[:, (e - 1) % w], 1
    rows = torch.arange(m) % h
    y = x.new_zeros(b, m, p)
    for a in range(h):
        y = y + product(xs[:, rows + shift + a, :], tw[a])
    return y[:, :h, :w].reshape(b, h * w)


def _main_path_rows(b: int = 8):
    """The main path's seeded 31x31 stamps (``chip_smoke.py``'s inputs,
    fewer of them) as (B, N) rows, and their taps."""
    stamps, psf, _, _ = synthetic_star_stamps(b, size=31, seed=42)
    x = torch.as_tensor(stamps.reshape(b, -1), dtype=torch.float64)
    taps = torch.fft.fftshift(torch.as_tensor(psf, dtype=torch.float64))
    return x, taps


def _random_rows(h: int, w: int):
    rng = np.random.default_rng(h * 100 + w)
    psf = rng.random((h, w))
    psf /= psf.sum()
    return (torch.as_tensor(rng.random((3, h * w))),
            torch.fft.fftshift(torch.as_tensor(psf)))


@pytest.mark.parametrize('which', ['A', 'AT', 'AT A'])
@pytest.mark.parametrize('h,w', SHAPES)
def test_tap_row_decomposition_equals_dense_operator(h, w, which):
    """float64: the kernel's decomposition against the dense circulant
    (``apply_operator_plain``'s matrix) within 1e-12 of max|x|, on random
    rows; at 31x31 also on the main path's stamps."""
    cases = [_random_rows(h, w)] + ([_main_path_rows()] if (h, w) == (31, 31)
                                    else [])
    for x, taps in cases:
        cmat = build_circulant_matrix(torch.fft.ifftshift(taps))
        if which == 'A':
            got, want = tap_row_operator(x, taps, False), x @ cmat.T
        elif which == 'AT':
            got, want = tap_row_operator(x, taps, True), x @ cmat
        else:
            got = tap_row_operator(tap_row_operator(x, taps, False), taps,
                                   True)
            want = apply_operator_plain(x, taps, 1)
        assert float((got - want).abs().max() / x.abs().max()) \
            <= OPERATOR_TOL['float64']


def _split_error(product) -> float:
    """max|dy| / max|x| of (AT A) x in float32 through ``product``, on the
    main path's stamps, against the float64 dense product."""
    x, taps = _main_path_rows()
    want = apply_operator_plain(x, taps, 1)
    x32, taps32 = x.float(), taps.float()
    y = tap_row_operator(x32, taps32, False, product)
    got = tap_row_operator(y, taps32, True, product)
    return float((got.double() - want).abs().max() / x.abs().max())


def test_three_tf32_passes_keep_float32_accuracy():
    assert _split_error(three_pass) <= OPERATOR_TOL['float32']


def test_one_tf32_pass_misses_the_float32_limit():
    """A single TF32 product keeps 11 bits of each operand: each product
    errs by up to 2^-11, and (AT A) x lands several times past the limit
    (3.7e-5 here) that the three passes meet 200 times over (5.4e-8)."""
    assert _split_error(one_pass) > OPERATOR_TOL['float32']


def test_tf32_rounds_to_nearest_with_ties_away():
    ulp = 2.0 ** -10                     # TF32's spacing in [1, 2)
    v = torch.tensor([1.0, 1 + ulp / 4, 1 + 3 * ulp / 4, 1 + ulp / 2,
                      -(1 + ulp / 2), 3.0, -7.25], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0,
                         -7.25], dtype=torch.float32)
    assert torch.equal(tf32(v), want)
    v = torch.rand(1000, generator=torch.Generator().manual_seed(0)) + 0.5
    hi = tf32(v)
    assert float(((v - hi).abs() / v).max()) <= 2.0 ** -11
    assert torch.equal(tf32(hi), hi)
