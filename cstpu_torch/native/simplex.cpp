// Dense two-phase revised simplex for standard-form LPs:
//     min c'x  s.t.  Ax = b, x >= 0
//
// Native-runtime component of the cstpu framework: the reference package
// reaches COIN-OR Clp (C++) through JuMP for equality-constrained basis
// pursuit (the reference's src/basispursuit.jl:7,13). cstpu's production
// path is the XLA-native ADMM solver (cstpu/models/basis_pursuit.py); this
// exact solver serves the same role Clp did — vertex-exact solutions with
// exact zeros — for host-side solves and as a conformance oracle for the
// first-order path. Zero dependencies; built with `make` or on first
// import via cstpu.native.
//
// Implementation notes:
//   * Phase 1 with artificial variables (rows sign-flipped so b >= 0),
//     Phase 2 with the original costs.
//   * Redundant-but-consistent rows leave their artificial basic at zero
//     level after Phase 1 with no possible drive-out pivot; those
//     artificials get Phase-2 cost ZERO (their level is structurally
//     forced to 0 by the independent rows, so this is exact) — a big-M
//     cost there poisons the dual vector y with ~1e30 and drowns every
//     reduced cost in cancellation noise, failing plainly feasible LPs.
//   * Dantzig pricing with a Bland's-rule fallback after a stall budget,
//     guaranteeing termination without cycling.
//   * The basis matrix is LU-factored ONCE per iteration (partial
//     pivoting); the factors serve the basic solution, the transposed
//     dual solve, and the entering-column solve.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// In-place LU with partial pivoting of an n x n row-major matrix.
// Combined L (unit diagonal, strictly lower) and U stored in `lu`;
// `perm` records row swaps: (PA) = LU with (PA)_i = A_{perm[i]}.
struct LU {
  int n = 0;
  std::vector<double> lu;
  std::vector<int> perm;

  bool factor(int n_, const double* M) {
    n = n_;
    lu.assign(static_cast<size_t>(n) * n, 0.0);
    std::memcpy(lu.data(), M, sizeof(double) * n * n);
    perm.resize(n);
    for (int i = 0; i < n; ++i) perm[i] = i;
    for (int col = 0; col < n; ++col) {
      int piv = col;
      double best = std::fabs(lu[static_cast<size_t>(col) * n + col]);
      for (int r = col + 1; r < n; ++r) {
        double v = std::fabs(lu[static_cast<size_t>(r) * n + col]);
        if (v > best) { best = v; piv = r; }
      }
      if (best < 1e-13) return false;
      if (piv != col) {
        for (int j = 0; j < n; ++j)
          std::swap(lu[static_cast<size_t>(col) * n + j],
                    lu[static_cast<size_t>(piv) * n + j]);
        std::swap(perm[col], perm[piv]);
      }
      const double d = lu[static_cast<size_t>(col) * n + col];
      for (int r = col + 1; r < n; ++r) {
        double f = lu[static_cast<size_t>(r) * n + col] / d;
        lu[static_cast<size_t>(r) * n + col] = f;
        if (f == 0.0) continue;
        for (int j = col + 1; j < n; ++j)
          lu[static_cast<size_t>(r) * n + j] -=
              f * lu[static_cast<size_t>(col) * n + j];
      }
    }
    return true;
  }

  // x = A^-1 rhs  (Ly = P rhs forward, Ux = y backward)
  void solve(const double* rhs, double* x) const {
    for (int i = 0; i < n; ++i) {
      double s = rhs[perm[i]];
      const double* Li = lu.data() + static_cast<size_t>(i) * n;
      for (int j = 0; j < i; ++j) s -= Li[j] * x[j];
      x[i] = s;
    }
    for (int i = n - 1; i >= 0; --i) {
      double s = x[i];
      const double* Ui = lu.data() + static_cast<size_t>(i) * n;
      for (int j = i + 1; j < n; ++j) s -= Ui[j] * x[j];
      x[i] = s / Ui[i];
    }
  }

  // y = A^-T rhs: A' y = rhs with PA = LU gives U'L'(Py) = rhs —
  // forward-substitute U', backward-substitute L' (unit diagonal),
  // then undo the permutation.
  void solve_t(const double* rhs, double* y,
               std::vector<double>& scratch) const {
    scratch.resize(n);
    double* z = scratch.data();
    for (int i = 0; i < n; ++i) {  // U' z = rhs (U' lower triangular)
      double s = rhs[i];
      for (int j = 0; j < i; ++j)
        s -= lu[static_cast<size_t>(j) * n + i] * z[j];
      z[i] = s / lu[static_cast<size_t>(i) * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {  // L' w = z (unit upper)
      double s = z[i];
      for (int j = i + 1; j < n; ++j)
        s -= lu[static_cast<size_t>(j) * n + i] * z[j];
      z[i] = s;
    }
    for (int i = 0; i < n; ++i) y[perm[i]] = z[i];
  }
};

struct Tableau {
  int n;                       // rows (constraints)
  int N;                       // columns (variables incl. artificials)
  std::vector<double> A;       // n x N row-major
  std::vector<double> b;       // n
  std::vector<double> c;       // N
  std::vector<int> basis;      // n basic column indices
  std::vector<double> xB;      // basic values
  std::vector<double> Bmat, y, u, scratch;
  LU lu;

  void column(int j, std::vector<double>& out) const {
    out.resize(n);
    for (int i = 0; i < n; ++i) out[i] = A[static_cast<size_t>(i) * N + j];
  }

  bool factor_basis() {  // gather B and LU-factor it
    Bmat.resize(static_cast<size_t>(n) * n);
    for (int i = 0; i < n; ++i)
      for (int r = 0; r < n; ++r)
        Bmat[static_cast<size_t>(r) * n + i] =
            A[static_cast<size_t>(r) * N + basis[i]];
    return lu.factor(n, Bmat.data());
  }

  bool refresh() {  // recompute basic solution xB = B^-1 b
    if (!factor_basis()) return false;
    xB.resize(n);
    lu.solve(b.data(), xB.data());
    return true;
  }

  // returns: 0 optimal, 2 unbounded, 3 iter limit, 4 singular
  int iterate(int max_iter, double tol) {
    std::vector<double> cB(n), aj(n);
    std::vector<char> is_basic(static_cast<size_t>(N), 0);
    int stall = 0;
    for (int it = 0; it < max_iter; ++it) {
      if (!refresh()) return 4;  // one LU per iteration, reused below
      for (int i = 0; i < n; ++i) cB[i] = c[basis[i]];
      y.resize(n);
      lu.solve_t(cB.data(), y.data(), scratch);

      // pricing: Dantzig normally; Bland after a stall budget
      const bool bland = stall > 2 * n + 20;
      int enter = -1;
      double best_red = -tol;
      std::fill(is_basic.begin(), is_basic.end(), 0);
      for (int i = 0; i < n; ++i) is_basic[basis[i]] = 1;
      for (int j = 0; j < N; ++j) {
        if (is_basic[j]) continue;
        double red = c[j];
        for (int i = 0; i < n; ++i)
          red -= y[i] * A[static_cast<size_t>(i) * N + j];
        if (red < best_red) {
          enter = j;
          if (bland) break;  // first improving index
          best_red = red;
        }
      }
      if (enter < 0) return 0;  // optimal

      column(enter, aj);
      u.resize(n);
      lu.solve(aj.data(), u.data());

      // ratio test (Bland tie-break: smallest basis column index)
      int leave = -1;
      double best_ratio = 0.0;
      for (int i = 0; i < n; ++i) {
        if (u[i] > tol) {
          // clamp round-off negatives: a slightly-negative basic value
          // must act as a degenerate zero, not a negative ratio that
          // walks the basis infeasible (breaks Bland's guarantee)
          double ratio = std::max(xB[i], 0.0) / u[i];
          if (leave < 0 || ratio < best_ratio - 1e-12 ||
              (std::fabs(ratio - best_ratio) <= 1e-12 &&
               basis[i] < basis[leave])) {
            leave = i;
            best_ratio = ratio;
          }
        }
      }
      if (leave < 0) return 2;  // unbounded
      if (best_ratio <= tol) ++stall; else stall = 0;
      basis[leave] = enter;
    }
    return 3;
  }
};

}  // namespace

extern "C" {

// min c'x s.t. Ax = b, x >= 0.  A row-major n x N.
// Returns 0 optimal, 1 infeasible, 2 unbounded, 3 iteration limit,
// 4 numerical failure.
int cstpu_simplex_solve(int n, int N, const double* A_in, const double* b_in,
                        const double* c_in, double* x_out, double* obj_out,
                        int max_iter, double tol) {
  if (n <= 0 || N <= 0) return 4;
  if (max_iter <= 0) max_iter = 50 * (n + N);
  if (tol <= 0) tol = 1e-9;

  Tableau T;
  T.n = n;
  T.N = N + n;  // + artificials
  T.A.assign(static_cast<size_t>(n) * T.N, 0.0);
  T.b.resize(n);
  for (int i = 0; i < n; ++i) {
    const double s = (b_in[i] < 0) ? -1.0 : 1.0;  // make b >= 0
    T.b[i] = s * b_in[i];
    for (int j = 0; j < N; ++j)
      T.A[static_cast<size_t>(i) * T.N + j] = s * A_in[static_cast<size_t>(i) * N + j];
    T.A[static_cast<size_t>(i) * T.N + N + i] = 1.0;  // artificial
  }

  // Phase 1: minimize sum of artificials
  T.c.assign(T.N, 0.0);
  for (int i = 0; i < n; ++i) T.c[N + i] = 1.0;
  T.basis.resize(n);
  for (int i = 0; i < n; ++i) T.basis[i] = N + i;
  int rc = T.iterate(max_iter, tol);
  if (rc != 0) return rc == 2 ? 4 : rc;  // phase-1 can't be unbounded
  if (!T.refresh()) return 4;
  double art = 0.0;
  for (int i = 0; i < n; ++i)
    if (T.basis[i] >= N) art += std::fabs(T.xB[i]);
  if (art > 1e-7) return 1;  // infeasible

  // Drive any zero-level artificials out of the basis when possible.
  for (int i = 0; i < n; ++i) {
    if (T.basis[i] < N) continue;
    std::vector<double> aj(n), u(n);
    int replacement = -1;
    for (int j = 0; j < N; ++j) {
      bool basic = false;
      for (int r = 0; r < n; ++r)
        if (T.basis[r] == j) { basic = true; break; }
      if (basic) continue;
      T.column(j, aj);
      T.lu.solve(aj.data(), u.data());
      if (std::fabs(u[i]) > 1e-7) { replacement = j; break; }
    }
    if (replacement >= 0) {
      T.basis[i] = replacement;
      if (!T.refresh()) return 4;
    }
  }

  // Phase 2: original costs. Nonbasic artificials are pinned out by a
  // big-M cost (their reduced cost stays hugely positive). An artificial
  // that COULD NOT be driven out marks a redundant-but-consistent row:
  // its level is structurally forced to 0 by the independent rows, so it
  // gets cost 0 — a big-M cost on a BASIC variable would put 1e30 into
  // cB and poison the dual vector with cancellation noise.
  T.c.assign(T.N, 0.0);
  for (int j = 0; j < N; ++j) T.c[j] = c_in[j];
  for (int i = 0; i < n; ++i) T.c[N + i] = 1e30;
  for (int i = 0; i < n; ++i)
    if (T.basis[i] >= N) T.c[T.basis[i]] = 0.0;
  rc = T.iterate(max_iter, tol);
  if (rc != 0 && rc != 3) return rc;
  if (!T.refresh()) return 4;

  std::fill(x_out, x_out + N, 0.0);
  double obj = 0.0;
  for (int i = 0; i < n; ++i) {
    if (T.basis[i] < N) {
      const double v = (std::fabs(T.xB[i]) < 1e-12) ? 0.0 : T.xB[i];
      x_out[T.basis[i]] = v;
      obj += c_in[T.basis[i]] * v;
    }
  }
  if (obj_out) *obj_out = obj;
  return rc;
}

}  // extern "C"
