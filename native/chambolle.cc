// Native (C++) implementation of the Chambolle TV-prox dual ascent and the
// circular-difference TV norm.
//
// Role in the framework (the reference is pure MATLAB; its "native" compute
// was MATLAB builtins — SURVEY.md §2): this library is the CPU-native
// counterpart of ops/tv.py — an independent implementation used as a test
// oracle against the JAX paths and as a fast fallback for host-side
// tooling (bench baselines, result post-processing) without pulling in a
// JAX runtime.  Semantics match utils/chambolle_prox_TV_stop.m:120-149
// iteration-for-iteration: Neumann stencils, tau=0.249-style damped dual
// step, pre-update fixed-point residual, early exit on err <= tol, optional
// warm-started duals.
//
// Build: `make -C native` -> libsemiblind_native.so (see native/Makefile).
// Binding: semiblind_tv/native (ctypes).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TV(x) with circular backward differences (utils/TVnorm.m + SALSA/diffh.m).
double tv_norm_f64(const double* x, int64_t m, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t im1 = (i == 0) ? m - 1 : i - 1;
    const double* row = x + i * n;
    const double* rowm = x + im1 * n;
    for (int64_t j = 0; j < n; ++j) {
      const int64_t jm1 = (j == 0) ? n - 1 : j - 1;
      const double dh = row[j] - row[jm1];
      const double dv = row[j] - rowm[j];
      acc += std::sqrt(dh * dh + dv * dv);
    }
  }
  return acc;
}

// Chambolle dual-projection TV prox.
//   g:        input image (m*n), row-major
//   lambda:   regularization weight
//   max_iter: dual-ascent sweep cap
//   tau:      dual step (reference: 0.249)
//   tol:      early-exit threshold on the fixed-point residual
//   px, py:   dual fields (in: warm start, out: final) — may be zeros
//   f:        output, f = g - lambda * div(px, py)
// Returns the number of sweeps actually executed.
int64_t chambolle_prox_f64(const double* g, double lambda, int64_t max_iter,
                           double tau, double tol, double* px, double* py,
                           double* f, int64_t m, int64_t n, double* err_out) {
  std::vector<double> divp(m * n), u(m * n), upx(m * n), upy(m * n);
  const double inv_lambda = 1.0 / lambda;

  auto divergence = [&](const double* p1, const double* p2, double* out) {
    for (int64_t i = 0; i < m; ++i) {
      for (int64_t j = 0; j < n; ++j) {
        // row part: u[0]=p1[0]; u[i]=p1[i]-p1[i-1] (1<=i<=m-2); u[m-1]=-p1[m-1]
        double a;
        if (i == 0)
          a = p1[j];
        else if (i == m - 1)
          a = -p1[(m - 1) * n + j];
        else
          a = p1[i * n + j] - p1[(i - 1) * n + j];
        double b;
        if (j == 0)
          b = p2[i * n];
        else if (j == n - 1)
          b = -p2[i * n + (n - 1)];
        else
          b = p2[i * n + j] - p2[i * n + (j - 1)];
        out[i * n + j] = a + b;
      }
    }
  };

  int64_t k = 0;
  double err = 0.0;
  for (; k < max_iter;) {
    ++k;
    divergence(px, py, divp.data());
    for (int64_t t = 0; t < m * n; ++t) u[t] = divp[t] - g[t] * inv_lambda;
    // forward differences, zero last row/col
    for (int64_t i = 0; i < m; ++i)
      for (int64_t j = 0; j < n; ++j) {
        upx[i * n + j] = (i + 1 < m) ? u[(i + 1) * n + j] - u[i * n + j] : 0.0;
        upy[i * n + j] = (j + 1 < n) ? u[i * n + j + 1] - u[i * n + j] : 0.0;
      }
    double err2 = 0.0;
    for (int64_t t = 0; t < m * n; ++t) {
      const double tmp = std::sqrt(upx[t] * upx[t] + upy[t] * upy[t]);
      const double rx = -upx[t] + tmp * px[t];
      const double ry = -upy[t] + tmp * py[t];
      err2 += rx * rx + ry * ry;
      const double denom = 1.0 + tau * tmp;
      px[t] = (px[t] + tau * upx[t]) / denom;
      py[t] = (py[t] + tau * upy[t]) / denom;
    }
    err = std::sqrt(err2);
    if (!(err > tol)) break;
  }
  divergence(px, py, divp.data());
  for (int64_t t = 0; t < m * n; ++t) f[t] = g[t] - lambda * divp[t];
  if (err_out) *err_out = err;
  return k;
}

// float32 wrappers (compute in f64 internally for the residual accuracy the
// early-exit needs, mirroring MATLAB's double everything).
int64_t chambolle_prox_f32(const float* g, double lambda, int64_t max_iter,
                           double tau, double tol, float* px, float* py,
                           float* f, int64_t m, int64_t n, double* err_out) {
  std::vector<double> gd(m * n), pxd(m * n), pyd(m * n), fd(m * n);
  for (int64_t t = 0; t < m * n; ++t) {
    gd[t] = g[t];
    pxd[t] = px[t];
    pyd[t] = py[t];
  }
  int64_t k = chambolle_prox_f64(gd.data(), lambda, max_iter, tau, tol,
                                 pxd.data(), pyd.data(), fd.data(), m, n,
                                 err_out);
  for (int64_t t = 0; t < m * n; ++t) {
    px[t] = static_cast<float>(pxd[t]);
    py[t] = static_cast<float>(pyd[t]);
    f[t] = static_cast<float>(fd[t]);
  }
  return k;
}

}  // extern "C"
