// Native DIAPL PSF model evaluator.
//
// The reference delegates PSF evaluation to the external DIAPL C binaries
// (psf_core.c inside the `phot` program) and re-implements the per-pixel
// formula in a pure-Python triple loop (psf_calculate.py:52-90, ~1ms per
// 31x31 matrix). This translation unit provides the native equivalent the
// framework ships itself: bulk rendering of spatially-varying PSF matrices
// across a frame (thousands of matrices per second), exposed to Python via
// ctypes (tpu_sgp/psf/native.py).
//
// Model per local pixel (x, y):
//   x1 = c*x - s*y ; y1 = s*x + c*y ; rr0 = ax*x1^2 + ay*y1^2
//   psf(x,y) = sum_g exp(rr0 * sigma_inc^(2g)) * sum_{m+n<=ldeg} k[g,m,n] x^m y^n
// Spatial variation: the coefficient vector is itself a polynomial of degree
// ndeg_spat in the frame position (xpsf - x_orig, ypsf - y_orig).

#include <cmath>
#include <cstdint>

extern "C" {

struct DiaplPSFParams {
  int32_t hw;
  int32_t ndeg_spat;
  int32_t ndeg_local;
  int32_t ngauss;
  int32_t ldeg;          // evaluation degree (reference pins this to 2)
  double cos_t;
  double sin_t;
  double ax;
  double ay;
  double sigma_inc;
  double x_orig;
  double y_orig;
};

static inline int n_local_coeffs(const DiaplPSFParams* p) {
  return p->ngauss * (p->ldeg + 1) * (p->ldeg + 2) / 2;
}

// Collapse the spatial polynomial at frame position (xpsf, ypsf) into one
// local coefficient set of length n_local_coeffs(p).
void diapl_local_coeffs(const DiaplPSFParams* p, const double* vec,
                        double xpsf, double ypsf, double* local) {
  const int ncomp = n_local_coeffs(p);
  for (int i = 0; i < ncomp; ++i) local[i] = 0.0;
  const double dx = xpsf - p->x_orig;
  const double dy = ypsf - p->y_orig;
  int itot = 0;
  double a1 = 1.0;
  for (int m = 0; m <= p->ndeg_spat; ++m) {
    double a2 = 1.0;
    for (int n = 0; n <= p->ndeg_spat - m; ++n) {
      for (int ic = 0; ic < ncomp; ++ic) local[ic] += vec[itot + ic] * a2 * a1;
      itot += ncomp;
      a2 *= dy;
    }
    a1 *= dx;
  }
}

// Evaluate one pixel from a local coefficient set.
static double eval_pix(const DiaplPSFParams* p, const double* local,
                       double x, double y) {
  const double x1 = p->cos_t * x - p->sin_t * y;
  const double y1 = p->sin_t * x + p->cos_t * y;
  double rr = p->ax * x1 * x1 + p->ay * y1 * y1;
  const double inc2 = p->sigma_inc * p->sigma_inc;
  double out = 0.0;
  int ic = 0;
  for (int g = 0; g < p->ngauss; ++g) {
    const double f = std::exp(rr);
    double a1 = 1.0;
    for (int m = 0; m <= p->ldeg; ++m) {
      double a2 = 1.0;
      for (int n = 0; n <= p->ldeg - m; ++n) {
        out += local[ic++] * f * a1 * a2;
        a2 *= y;
      }
      a1 *= x;
    }
    rr *= inc2;
  }
  return out;
}

// Render one (size x size) matrix over integer offsets
// -size/2 .. -size/2 + size - 1 (odd size: the reference's symmetric
// [-h, h]; even size: [-h, h-1] — exactly `size` samples either way, so
// the output buffer is never overrun). out[(i+h)*size + (j+h)] =
// psf(x=j, y=i), the reference's index layout (psf_calculate.py:101-109).
void diapl_eval_grid(const DiaplPSFParams* p, const double* local,
                     int32_t size, int32_t normalize, double* out) {
  const int h = size / 2;
  const int lo = -h, hi = -h + size - 1;
  double total = 0.0;
  for (int i = lo; i <= hi; ++i) {
    for (int j = lo; j <= hi; ++j) {
      const double v = eval_pix(p, local, (double)j, (double)i);
      out[(i + h) * size + (j + h)] = v;
      total += v;
    }
  }
  if (normalize && total != 0.0) {
    const double inv = 1.0 / total;
    for (int k = 0; k < size * size; ++k) out[k] *= inv;
  }
}

// Bulk: render n spatially-varying PSF matrices at frame positions
// (xs[k], ys[k]); out has shape [n, size, size] row-major. Positions are
// independent (disjoint out slices), so the loop threads under OpenMP
// with thread-count-invariant results.
void diapl_render_many(const DiaplPSFParams* p, const double* vec,
                       const double* xs, const double* ys, int32_t n,
                       int32_t size, int32_t normalize, double* out) {
  const int ncomp = n_local_coeffs(p);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    double* local = new double[ncomp];
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int k = 0; k < n; ++k) {
      diapl_local_coeffs(p, vec, xs[k], ys[k], local);
      diapl_eval_grid(p, local, size, normalize,
                      out + (int64_t)k * size * size);
    }
    delete[] local;
  }
}

}  // extern "C"
