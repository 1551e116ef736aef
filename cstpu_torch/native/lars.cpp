// Dense LARS / LASSO homotopy with exact event stepping.
//
// Native-runtime component of the cstpu framework: the reference package
// reaches the ECOS C interior-point solver through JuMP for basis-pursuit
// denoising (the reference's src/basispursuit.jl:83-99,135-137). cstpu's
// production path is the XLA-native ADMM solver
// (cstpu/models/basis_pursuit.py); this solver serves the same role ECOS
// did — machine-precision solutions with exact zeros — for host-side
// solves and as a conformance oracle for the first-order path.
//
// The weighted-LASSO solution path
//     x(lambda) = argmin_x 0.5||Ax - b||^2 + lambda * sum_j w_j |x_j|
// is piecewise linear in lambda; this solver walks it exactly from
// lambda_max downward, handling join events (an inactive atom's
// correlation reaches the equicorrelation level), leave events (an active
// coefficient crosses zero), and — in denoising mode — the residual-norm
// crossing ||Ax - b|| = delta, which by Lagrangian duality identifies the
// exact solution of
//     min sum_j w_j |x_j|  s.t.  ||Ax - b||_2 <= delta
// (the reference's bpd SOCP). Within a segment the crossing is the root
// of a quadratic in the step length, so the returned solution is exact to
// rounding, not to an iterative tolerance.
//
// Implementation notes:
//   * Active-set Gram factor kept as a growing dense Cholesky; appends
//     are O(nk + k^2), leaves (rare) refactor in O(nk^2 + k^3).
//   * Correlations are recomputed from the residual at every event
//     (O(nm), same order as the direction projection) so equicorrelation
//     drift cannot accumulate along the path.
//   * Zero dependencies; built on first import via cstpu.native.

#include <atomic>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// forward substitution: L y = rhs (k x k lower, row-major, stride kmax)
void fsolve(const double* L, int k, int kmax, const double* rhs, double* y) {
  for (int i = 0; i < k; ++i) {
    double s = rhs[i];
    const double* Li = L + static_cast<size_t>(i) * kmax;
    for (int j = 0; j < i; ++j) s -= Li[j] * y[j];
    y[i] = s / Li[i];
  }
}

// backward substitution: L' x = y
void bsolve(const double* L, int k, int kmax, const double* y, double* x) {
  for (int i = k - 1; i >= 0; --i) {
    double s = y[i];
    for (int j = i + 1; j < k; ++j)
      s -= L[static_cast<size_t>(j) * kmax + i] * x[j];
    x[i] = s / L[static_cast<size_t>(i) * kmax + i];
  }
}

struct Lars {
  int n, m, kmax;
  const double* A;  // n x m, row-major
  std::vector<int> act;         // active atom indices, join order
  std::vector<double> sgn;      // signs aligned with act
  std::vector<double> xa;       // coefficients aligned with act
  std::vector<double> L;        // kmax x kmax Cholesky of A_act'A_act
  std::vector<double> col;      // scratch n
  std::vector<double> g, y, d;  // scratch kmax

  double dot_col(int j, const double* v) const {  // a_j' v
    double s = 0;
    for (int i = 0; i < n; ++i) s += A[static_cast<size_t>(i) * m + j] * v[i];
    return s;
  }

  // append atom j; false if its out-of-span component is numerically zero
  bool append(int j, double sign_j) {
    int k = static_cast<int>(act.size());
    if (k >= kmax) return false;  // hard bound: a spuriously-passed d2
    //                               guard must not write past L
    double ata = 0;
    for (int i = 0; i < n; ++i) {
      double aij = A[static_cast<size_t>(i) * m + j];
      ata += aij * aij;
    }
    g.resize(kmax); y.resize(kmax);
    for (int p = 0; p < k; ++p) {
      double s = 0;
      for (int i = 0; i < n; ++i)
        s += A[static_cast<size_t>(i) * m + act[p]] *
             A[static_cast<size_t>(i) * m + j];
      g[p] = s;
    }
    fsolve(L.data(), k, kmax, g.data(), y.data());
    double d2 = ata;
    for (int p = 0; p < k; ++p) d2 -= y[p] * y[p];
    if (!(d2 > 1e-12 * ata)) return false;
    double* Lk = L.data() + static_cast<size_t>(k) * kmax;
    for (int p = 0; p < k; ++p) Lk[p] = y[p];
    Lk[k] = std::sqrt(d2);
    act.push_back(j);
    sgn.push_back(sign_j);
    xa.push_back(0.0);
    return true;
  }

  // remove active position p (coefficient hit zero); refactor Cholesky
  bool remove(int p) {
    act.erase(act.begin() + p);
    sgn.erase(sgn.begin() + p);
    xa.erase(xa.begin() + p);
    int k = static_cast<int>(act.size());
    std::vector<double> G(static_cast<size_t>(k) * k);
    for (int a = 0; a < k; ++a)
      for (int c = 0; c <= a; ++c) {
        double s = 0;
        for (int i = 0; i < n; ++i)
          s += A[static_cast<size_t>(i) * m + act[a]] *
               A[static_cast<size_t>(i) * m + act[c]];
        G[static_cast<size_t>(a) * k + c] = s;
      }
    for (int a = 0; a < k; ++a) {
      double* La = L.data() + static_cast<size_t>(a) * kmax;
      for (int c = 0; c <= a; ++c) {
        double s = G[static_cast<size_t>(a) * k + c];
        const double* Lc = L.data() + static_cast<size_t>(c) * kmax;
        for (int q = 0; q < c; ++q) s -= La[q] * Lc[q];
        if (c == a) {
          if (!(s > 0)) return false;
          La[a] = std::sqrt(s);
        } else {
          La[c] = s / Lc[c];
        }
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

// Walk the weighted-LASSO path of 0.5||Ax-b||^2 + lambda sum w|x|.
//   mode 0: stop at lambda == target            (exact LASSO solution)
//   mode 1: stop at ||Ax - b||_2 == target      (exact BPD solution)
// Outputs: x (m, exact zeros off-support), *lambda_out (stopping lambda),
// *iters_out. Returns 0 ok, 1 iteration limit, 2 numerical failure,
// 3 bad argument (weights must be positive; target must be >= 0),
// 4 target unreachable (mode 1: the path ends at lambda == 0 with
// ||Ax - b|| still above delta — the constraint is infeasible, e.g. an
// overdetermined system whose LS residual exceeds delta).
int cstpu_lars_solve(int n, int m, const double* A, const double* b,
                     const double* w, int mode, double target, double* x,
                     double* lambda_out, int* iters_out, int max_iter) {
  if (n <= 0 || m <= 0 || target < 0 || (mode != 0 && mode != 1)) return 3;
  for (int j = 0; j < m; ++j)
    if (!(w[j] > 0)) return 3;
  if (max_iter <= 0) max_iter = 100 * (n < m ? n : m) + 100;

  Lars S;
  S.n = n; S.m = m; S.A = A;
  S.kmax = (n < m ? n : m) + 1;
  S.L.assign(static_cast<size_t>(S.kmax) * S.kmax, 0.0);
  S.col.resize(n);

  std::vector<double> r(b, b + n);          // residual b - A x
  std::vector<double> c(m), v(n), phi(m);
  std::memset(x, 0, sizeof(double) * m);

  double bnorm2 = 0;
  for (int i = 0; i < n; ++i) bnorm2 += r[i] * r[i];

  // lambda_max and the first atom
  double lam = 0;
  int j0 = -1;
  for (int j = 0; j < m; ++j) {
    c[j] = S.dot_col(j, r.data());
    double v0 = std::fabs(c[j]) / w[j];
    if (v0 > lam) { lam = v0; j0 = j; }
  }
  *lambda_out = lam;
  *iters_out = 0;
  if (mode == 1 && bnorm2 <= target * target) return 0;  // x = 0 feasible
  if (mode == 0 && target >= lam) return 0;              // x = 0 optimal
  if (j0 < 0) return 2;
  if (!S.append(j0, c[j0] > 0 ? 1.0 : -1.0)) return 2;

  const double TINY = 1e-13;
  int last_dropped = -1;  // one-event rejoin exclusion after a leave
  for (int it = 0; it < max_iter; ++it) {
    *iters_out = it + 1;
    int k = static_cast<int>(S.act.size());

    // direction d = G^{-1}(w .* s); v = A_act d; phi = A' v
    S.g.resize(S.kmax); S.y.resize(S.kmax); S.d.resize(S.kmax);
    for (int p = 0; p < k; ++p) S.g[p] = w[S.act[p]] * S.sgn[p];
    fsolve(S.L.data(), k, S.kmax, S.g.data(), S.y.data());
    bsolve(S.L.data(), k, S.kmax, S.y.data(), S.d.data());
    std::fill(v.begin(), v.end(), 0.0);
    for (int p = 0; p < k; ++p) {
      double dp = S.d[p];
      int jp = S.act[p];
      for (int i = 0; i < n; ++i)
        v[i] += A[static_cast<size_t>(i) * m + jp] * dp;
    }
    for (int j = 0; j < m; ++j) phi[j] = S.dot_col(j, v.data());

    // earliest event in step length t = lam_old - lam_new
    double t_evt = lam;                      // lambda -> 0
    if (mode == 0 && lam - target < t_evt) t_evt = lam - target;
    int join_j = -1, leave_p = -1;
    double join_sign = 0;
    for (int j = 0; j < m; ++j) {
      bool active = false;
      for (int p = 0; p < k; ++p)
        if (S.act[p] == j) { active = true; break; }
      if (active) continue;
      for (int s2 = 0; s2 < 2; ++s2) {
        double sg = s2 ? -1.0 : 1.0;
        double den = phi[j] - sg * w[j];
        double num = c[j] - sg * lam * w[j];
        if (std::fabs(den) < TINY) continue;
        double t = num / den;
        if (t > TINY && t < t_evt - TINY) {
          t_evt = t; join_j = j; join_sign = sg; leave_p = -1;
        } else if (t > -TINY && t <= TINY && sg * den < -TINY &&
                   j != last_dropped && t < t_evt - TINY) {
          // TIED join: this atom reached the equicorrelation boundary at
          // the SAME event as the atom admitted last iteration (num ~ 0),
          // and staying inactive would grow its KKT violation
          // (sg*den < 0). One join per event, so ties are admitted by
          // consecutive zero-length steps; without this branch the tied
          // atom is rejected forever and the path silently violates KKT
          // (e.g. lasso(eye(2), [1,1]) returned [x, 0]). The
          // last_dropped exclusion prevents a drop -> instant-rejoin
          // cycle at the event where a coefficient crosses zero.
          t_evt = t > 0 ? t : 0.0;
          join_j = j; join_sign = sg; leave_p = -1;
        }
      }
    }
    for (int p = 0; p < k; ++p) {
      if (S.d[p] < -TINY) {  // x moves toward zero only if d_p < 0 for +x
        double t = -S.xa[p] / S.d[p];
        if (t > TINY && t < t_evt - TINY) {
          t_evt = t; leave_p = p; join_j = -1;
        }
      } else if (S.d[p] > TINY && S.xa[p] < 0) {
        double t = -S.xa[p] / S.d[p];
        if (t > TINY && t < t_evt - TINY) {
          t_evt = t; leave_p = p; join_j = -1;
        }
      }
    }

    // denoising: residual-norm crossing inside [0, t_evt]?
    if (mode == 1) {
      double a2 = 0, a1 = 0, a0 = -target * target;
      for (int i = 0; i < n; ++i) {
        a2 += v[i] * v[i];
        a1 += r[i] * v[i];
        a0 += r[i] * r[i];
      }
      // ||r - t v||^2 = a2 t^2 - 2 a1 t + (a0 + target^2) = target^2
      double tcross = -1;
      if (a2 > TINY) {
        double disc = a1 * a1 - a2 * a0;
        if (disc >= 0) {
          double root = (a1 - std::sqrt(disc)) / a2;  // first crossing
          if (root >= -TINY) tcross = root;
        }
      } else if (a0 <= 0) {
        tcross = 0;
      }
      if (tcross >= -TINY && tcross <= t_evt + TINY) {
        if (tcross < 0) tcross = 0;
        for (int p = 0; p < k; ++p)
          x[S.act[p]] = S.xa[p] + tcross * S.d[p];
        *lambda_out = lam - tcross;
        return 0;
      }
    }

    // advance to the event
    for (int p = 0; p < k; ++p) S.xa[p] += t_evt * S.d[p];
    for (int i = 0; i < n; ++i) r[i] -= t_evt * v[i];
    lam -= t_evt;
    for (int j = 0; j < m; ++j) c[j] = S.dot_col(j, r.data());

    if (join_j < 0 && leave_p < 0) {  // hit lambda target / lambda == 0
      for (int p = 0; p < k; ++p) x[S.act[p]] = S.xa[p];
      *lambda_out = lam;
      // mode 1 exits at the delta crossing; reaching lambda == 0 without
      // one means the constraint is unreachable on this path
      return (mode == 1) ? 4 : 0;
    }
    if (t_evt > TINY) last_dropped = -1;  // exclusion lasts one event
    if (leave_p >= 0) {
      last_dropped = S.act[leave_p];
      if (!S.remove(leave_p)) return 2;
    } else {
      if (!S.append(join_j, join_sign)) return 2;
    }
  }
  for (size_t p = 0; p < S.act.size(); ++p) x[S.act[p]] = S.xa[p];
  *lambda_out = lam;
  return 1;
}

// Threaded batch executor: B independent paths against ONE dictionary,
// work-stealing over a thread pool. The reference is single-threaded even
// on host (Base.Threads imported but never used,
// the reference's src/CompressedSensing.jl:12); here each instance writes
// its own status so one failure never aborts the batch (the framework's
// per-instance failure-mask convention). n_threads <= 0 picks
// hardware_concurrency.
int cstpu_lars_solve_batch(int n, int m, const double* A, const double* Bs,
                           int B, const double* w, int mode, double target,
                           double* X, double* lambdas, int* statuses,
                           int max_iter, int n_threads) {
  if (B <= 0) return 3;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > B) n_threads = B;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= B) return;
      int iters = 0;
      statuses[i] = cstpu_lars_solve(
          n, m, A, Bs + static_cast<size_t>(i) * n, w, mode, target,
          X + static_cast<size_t>(i) * m, lambdas + i, &iters, max_iter);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
