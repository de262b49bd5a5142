// minigeom — host-side multi-view geometry solvers (C API, no deps).
//
// Native replacement for the pycolmap surface the reference uses
// (SURVEY.md §2.3; `Initialization.py:90`, `Registration.py:96-107`):
// essential-matrix estimation with RANSAC + cheirality, PnP RANSAC with
// LM refinement. These are small-N, branch-heavy problems that belong on
// the host CPU, not in XLA.
//
// Solvers (pycolmap-grade):
//   * essential: Nister 5-POINT minimal solver (degree-10 polynomial via
//     Gauss-Jordan elimination of the ten cubic constraints, real roots
//     by Sturm bisection) inside LO-RANSAC (Sampson gating in normalized
//     coords; local optimization = all-inlier 8-point re-estimation),
//     4-way (R,t) disambiguation by cheirality.
//   * pnp: Grunert P3P minimal solver (quartic) inside LO-RANSAC
//     (local optimization = all-inlier DLT + LM), then
//     Levenberg-Marquardt on se(3) over the inliers.
//   * 8-point essential / P6P-DLT retained as the NON-minimal
//     (all-inlier) re-estimators used by the LO steps.
//
// Linear algebra is self-contained: Jacobi eigendecomposition of
// symmetric matrices (sizes <= 12) provides nullspaces and 3x3 SVDs;
// real polynomial roots (degree <= 10) via Sturm chains + bisection +
// Newton polish.
//
// Build: see build.sh (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <random>
#include <vector>

namespace {

// ----------------------------------------------------------------- small LA

// Jacobi eigendecomposition of symmetric n x n matrix A (row major).
// On return: eigenvalues in w (ascending), eigenvectors in columns of V.
void jacobi_eig(int n, double* A, double* w, double* V) {
  for (int i = 0; i < n * n; ++i) V[i] = 0.0;
  for (int i = 0; i < n; ++i) V[i * n + i] = 1.0;
  for (int sweep = 0; sweep < 100; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < n; ++p)
      for (int q = p + 1; q < n; ++q) off += A[p * n + q] * A[p * n + q];
    if (off < 1e-24) break;
    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        double apq = A[p * n + q];
        if (std::fabs(apq) < 1e-300) continue;
        double app = A[p * n + p], aqq = A[q * n + q];
        double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        double c = 1.0 / std::sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < n; ++k) {
          double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - s * akq;
          A[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - s * aqk;
          A[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  // sort ascending
  std::vector<int> idx(n);
  for (int i = 0; i < n; ++i) { idx[i] = i; w[i] = A[i * n + i]; }
  std::sort(idx.begin(), idx.end(), [&](int a, int b) { return w[a] < w[b]; });
  std::vector<double> w2(n), V2(n * n);
  for (int i = 0; i < n; ++i) {
    w2[i] = w[idx[i]];
    for (int k = 0; k < n; ++k) V2[k * n + i] = V[k * n + idx[i]];
  }
  std::memcpy(w, w2.data(), n * sizeof(double));
  std::memcpy(V, V2.data(), n * n * sizeof(double));
}

// nullspace direction of A (m x n, m >= n-1): eigenvector of A^T A with the
// smallest eigenvalue. A row-major.
void nullspace(int m, int n, const double* A, double* x) {
  std::vector<double> ata(n * n, 0.0);
  for (int i = 0; i < m; ++i)
    for (int a = 0; a < n; ++a)
      for (int b = 0; b < n; ++b) ata[a * n + b] += A[i * n + a] * A[i * n + b];
  std::vector<double> w(n), V(n * n);
  jacobi_eig(n, ata.data(), w.data(), V.data());
  for (int k = 0; k < n; ++k) x[k] = V[k * n + 0];
}

struct M3 { double m[9]; };
struct V3 { double v[3]; };

inline V3 mul(const M3& A, const V3& x) {
  V3 r;
  for (int i = 0; i < 3; ++i)
    r.v[i] = A.m[i * 3] * x.v[0] + A.m[i * 3 + 1] * x.v[1] + A.m[i * 3 + 2] * x.v[2];
  return r;
}
inline M3 mulT(const M3& A, const M3& B) {  // A * B
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A.m[i * 3 + k] * B.m[k * 3 + j];
      r.m[i * 3 + j] = s;
    }
  return r;
}
inline M3 transpose(const M3& A) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i * 3 + j] = A.m[j * 3 + i];
  return r;
}
inline double det3(const M3& A) {
  const double* a = A.m;
  return a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
         a[2] * (a[3] * a[7] - a[4] * a[6]);
}
inline V3 cross(const V3& a, const V3& b) {
  return {a.v[1] * b.v[2] - a.v[2] * b.v[1], a.v[2] * b.v[0] - a.v[0] * b.v[2],
          a.v[0] * b.v[1] - a.v[1] * b.v[0]};
}
inline double dot(const V3& a, const V3& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}
inline V3 normalize(const V3& a) {
  double n = std::sqrt(dot(a, a)) + 1e-300;
  return {a.v[0] / n, a.v[1] / n, a.v[2] / n};
}

// SVD of a 3x3 matrix: A = U diag(s) V^T via eigendecompositions.
void svd3(const M3& A, M3& U, double* s, M3& V) {
  // V from A^T A
  double ata[9];
  M3 At = transpose(A);
  M3 AtA = mulT(At, A);
  std::memcpy(ata, AtA.m, sizeof(ata));
  double w[3], Vm[9];
  jacobi_eig(3, ata, w, Vm);
  // descending order
  int order[3] = {2, 1, 0};
  for (int i = 0; i < 3; ++i) {
    s[i] = std::sqrt(std::max(0.0, w[order[i]]));
    for (int k = 0; k < 3; ++k) V.m[k * 3 + i] = Vm[k * 3 + order[i]];
  }
  // U columns = A v_i / s_i. The division is ill-conditioned once s_i is
  // small RELATIVE to s_0 (an essential matrix has s = (s,s,0) where the
  // numerical zero can be ~1e-9): rebuild such columns by cross products
  // so U stays orthonormal.
  double tol = 1e-6 * std::max(s[0], 1e-300);
  for (int i = 0; i < 3; ++i) {
    V3 vi = {V.m[0 * 3 + i], V.m[1 * 3 + i], V.m[2 * 3 + i]};
    V3 ui = mul(A, vi);
    if (s[i] > tol && i < 2) {
      for (int k = 0; k < 3; ++k) U.m[k * 3 + i] = ui.v[k] / s[i];
    } else if (i == 2) {
      V3 u0 = {U.m[0], U.m[3], U.m[6]};
      V3 u1 = {U.m[1], U.m[4], U.m[7]};
      // preserve the true sign when s_2 is genuinely nonzero
      V3 u2 = normalize(cross(u0, u1));
      if (s[i] > tol && dot(u2, ui) < 0)
        for (int k = 0; k < 3; ++k) u2.v[k] = -u2.v[k];
      for (int k = 0; k < 3; ++k) U.m[k * 3 + i] = u2.v[k];
    } else {
      // rank-<2 input: pick any unit vector orthogonal to column 0
      V3 u0 = {U.m[0], U.m[3], U.m[6]};
      V3 ref = std::fabs(u0.v[0]) < 0.9 ? V3{1, 0, 0} : V3{0, 1, 0};
      V3 u1 = normalize(cross(u0, ref));
      for (int k = 0; k < 3; ++k) U.m[k * 3 + i] = u1.v[k];
    }
  }
}

// -------------------------------------------------- univariate polynomials
// coefficients ascending: p[i] is the coefficient of z^i.

typedef std::vector<double> UP;

inline int udeg(const UP& p) {
  for (int i = (int)p.size() - 1; i >= 0; --i)
    if (std::fabs(p[i]) > 0.0) return i;
  return -1;
}

inline UP utrim(UP p, double tol = 0.0) {
  while (!p.empty() && std::fabs(p.back()) <= tol) p.pop_back();
  return p;
}

inline UP uadd(const UP& a, const UP& b, double sb = 1.0) {
  UP r(std::max(a.size(), b.size()), 0.0);
  for (size_t i = 0; i < a.size(); ++i) r[i] += a[i];
  for (size_t i = 0; i < b.size(); ++i) r[i] += sb * b[i];
  return r;
}

inline UP umul(const UP& a, const UP& b) {
  if (a.empty() || b.empty()) return UP();
  UP r(a.size() + b.size() - 1, 0.0);
  for (size_t i = 0; i < a.size(); ++i)
    for (size_t j = 0; j < b.size(); ++j) r[i + j] += a[i] * b[j];
  return r;
}

inline UP ushift(const UP& a) {  // multiply by z
  UP r(a.size() + 1, 0.0);
  for (size_t i = 0; i < a.size(); ++i) r[i + 1] = a[i];
  return r;
}

inline double ueval(const UP& p, double z) {
  double r = 0.0;
  for (int i = (int)p.size() - 1; i >= 0; --i) r = r * z + p[i];
  return r;
}

inline UP uderiv(const UP& p) {
  if (p.size() <= 1) return UP();
  UP r(p.size() - 1);
  for (size_t i = 1; i < p.size(); ++i) r[i - 1] = i * p[i];
  return r;
}

// polynomial remainder a mod b (b nonzero)
inline UP urem(UP a, const UP& b) {
  int db = udeg(b);
  if (db < 0) return UP();
  double lead = b[db];
  int da = udeg(a);
  while (da >= db) {
    double f = a[da] / lead;
    for (int i = 0; i <= db; ++i) a[da - db + i] -= f * b[i];
    a[da] = 0.0;  // force exact cancellation
    da = udeg(a);
  }
  a.resize(db > 0 ? db : 1, 0.0);
  return a;
}

// Real roots of p on a Cauchy-bound interval via Sturm chains + bisection
// + Newton polish. Returns count; roots written ascending.
int upoly_real_roots(const UP& p_in, double* roots, int max_roots = 16) {
  UP p = utrim(p_in, 0.0);
  int d = udeg(p);
  if (d <= 0) return 0;
  // scale so the leading coefficient is 1 (conditioning)
  {
    double lead = p[d];
    for (auto& c : p) c /= lead;
  }
  if (d == 1) { roots[0] = -p[0]; return 1; }
  // Sturm chain
  std::vector<UP> chain;
  chain.push_back(p);
  chain.push_back(uderiv(p));
  while (udeg(chain.back()) > 0) {
    UP r = urem(chain[chain.size() - 2], chain.back());
    // drop numerically-dead remainders
    double mx = 0;
    for (double c : r) mx = std::max(mx, std::fabs(c));
    if (mx < 1e-14) break;
    for (auto& c : r) c = -c;
    chain.push_back(utrim(r, 0.0));
    if ((int)chain.size() > d + 2) break;
  }
  auto signchanges = [&](double z) {
    int ch = 0, prev = 0;
    for (const auto& q : chain) {
      double v = ueval(q, z);
      int s = (v > 1e-300) ? 1 : ((v < -1e-300) ? -1 : 0);
      if (s != 0) {
        if (prev != 0 && s != prev) ++ch;
        prev = s;
      }
    }
    return ch;
  };
  double B = 0.0;
  for (int i = 0; i < d; ++i) B = std::max(B, std::fabs(p[i]));
  B += 1.0;
  int nroots = 0;
  // stack-based isolation
  struct Iv { double lo, hi; int clo, chi; };
  std::vector<Iv> stack;
  stack.push_back({-B, B, signchanges(-B), signchanges(B)});
  UP dp = uderiv(p);
  while (!stack.empty() && nroots < max_roots) {
    Iv iv = stack.back();
    stack.pop_back();
    int k = iv.clo - iv.chi;
    if (k <= 0) continue;
    if (k == 1 || iv.hi - iv.lo < 1e-12) {
      // bisect to refine a single root (or accept a tight cluster)
      double lo = iv.lo, hi = iv.hi;
      for (int it = 0; it < 80 && hi - lo > 1e-14; ++it) {
        double mid = 0.5 * (lo + hi);
        if (signchanges(mid) > iv.chi) lo = mid; else hi = mid;
      }
      double z = 0.5 * (lo + hi);
      // Newton polish
      for (int it = 0; it < 8; ++it) {
        double f = ueval(p, z), df = ueval(dp, z);
        if (std::fabs(df) < 1e-300) break;
        double step = f / df;
        z -= step;
        if (std::fabs(step) < 1e-15) break;
      }
      roots[nroots++] = z;
      continue;
    }
    double mid = 0.5 * (iv.lo + iv.hi);
    int cm = signchanges(mid);
    stack.push_back({iv.lo, mid, iv.clo, cm});
    stack.push_back({mid, iv.hi, cm, iv.chi});
  }
  std::sort(roots, roots + nroots);
  return nroots;
}

// ------------------------------------------- Nister 5-point essential solver
//
// E = x E1 + y E2 + z E3 + E4 over the 4-dim nullspace of the epipolar
// constraints; det(E)=0 plus the nine trace constraints
// 2 E E^T E - tr(E E^T) E = 0 give ten cubics in (x,y,z). Gauss-Jordan
// over the 20-monomial basis, then the three z-polynomial rows k,l,m
// give det C(z) = 0 of degree 10 (Nister, "An efficient solution to the
// five-point relative pose problem", PAMI 2004).

// trivariate monomial bases
// deg-2 order: x2 y2 z2 xy xz yz x y z 1
// deg-3 order (Nister column order):
//   0:x3 1:y3 2:x2y 3:xy2 4:x2z 5:x2 6:y2z 7:y2 8:xyz 9:xy
//   10:xz2 11:xz 12:x 13:yz2 14:yz 15:y 16:z3 17:z2 18:z 19:1
struct P1 { double c[4]; };    // cx, cy, cz, c1
struct P2 { double c[10]; };
struct P3c { double c[20]; };

inline P2 p1p1(const P1& a, const P1& b) {
  P2 r = {};
  r.c[0] = a.c[0] * b.c[0];                       // x2
  r.c[1] = a.c[1] * b.c[1];                       // y2
  r.c[2] = a.c[2] * b.c[2];                       // z2
  r.c[3] = a.c[0] * b.c[1] + a.c[1] * b.c[0];     // xy
  r.c[4] = a.c[0] * b.c[2] + a.c[2] * b.c[0];     // xz
  r.c[5] = a.c[1] * b.c[2] + a.c[2] * b.c[1];     // yz
  r.c[6] = a.c[0] * b.c[3] + a.c[3] * b.c[0];     // x
  r.c[7] = a.c[1] * b.c[3] + a.c[3] * b.c[1];     // y
  r.c[8] = a.c[2] * b.c[3] + a.c[3] * b.c[2];     // z
  r.c[9] = a.c[3] * b.c[3];                       // 1
  return r;
}

// index of monomial x^a y^b z^c (a+b+c<=3) in the deg-3 order above
inline int mono3_index(int a, int b, int c) {
  if (a == 3) return 0;
  if (b == 3) return 1;
  if (a == 2 && b == 1) return 2;
  if (a == 1 && b == 2) return 3;
  if (a == 2 && c == 1) return 4;
  if (a == 2) return 5;
  if (b == 2 && c == 1) return 6;
  if (b == 2) return 7;
  if (a == 1 && b == 1 && c == 1) return 8;
  if (a == 1 && b == 1) return 9;
  if (a == 1 && c == 2) return 10;
  if (a == 1 && c == 1) return 11;
  if (a == 1) return 12;
  if (b == 1 && c == 2) return 13;
  if (b == 1 && c == 1) return 14;
  if (b == 1) return 15;
  if (c == 3) return 16;
  if (c == 2) return 17;
  if (c == 1) return 18;
  return 19;
}

inline void p2p1_acc(const P2& a, const P1& b, double s, P3c& out) {
  // deg-2 monomial exponents in the P2 order
  static const int e2[10][3] = {{2,0,0},{0,2,0},{0,0,2},{1,1,0},{1,0,1},
                                {0,1,1},{1,0,0},{0,1,0},{0,0,1},{0,0,0}};
  static const int e1[4][3] = {{1,0,0},{0,1,0},{0,0,1},{0,0,0}};
  for (int i = 0; i < 10; ++i) {
    if (a.c[i] == 0.0) continue;
    for (int j = 0; j < 4; ++j) {
      if (b.c[j] == 0.0) continue;
      int idx = mono3_index(e2[i][0] + e1[j][0], e2[i][1] + e1[j][1],
                            e2[i][2] + e1[j][2]);
      out.c[idx] += s * a.c[i] * b.c[j];
    }
  }
}

// Solve for up to 10 essential matrices from exactly 5 normalized matches.
// E_out: [n_sols][9] row-major. Returns n_sols.
int essential_5pt(const double* x0, const double* x1, double E_out[][9]) {
  // 5x9 epipolar constraint matrix (same row layout as essential_from_8pt)
  double A[5 * 9];
  for (int i = 0; i < 5; ++i) {
    double u0 = x0[i * 2], v0 = x0[i * 2 + 1];
    double u1 = x1[i * 2], v1 = x1[i * 2 + 1];
    double* r = &A[i * 9];
    r[0] = u1 * u0; r[1] = u1 * v0; r[2] = u1;
    r[3] = v1 * u0; r[4] = v1 * v0; r[5] = v1;
    r[6] = u0;      r[7] = v0;      r[8] = 1.0;
  }
  // 4-dim nullspace: 4 smallest eigenvectors of A^T A
  double ata[81] = {0};
  for (int i = 0; i < 5; ++i)
    for (int a = 0; a < 9; ++a)
      for (int b = 0; b < 9; ++b) ata[a * 9 + b] += A[i * 9 + a] * A[i * 9 + b];
  double w[9], V[81];
  jacobi_eig(9, ata, w, V);
  double Eb[4][9];  // E1..E4 (x, y, z, 1 basis)
  for (int q = 0; q < 4; ++q)
    for (int k = 0; k < 9; ++k) Eb[q][k] = V[k * 9 + q];

  // entries of E as linear polynomials in (x, y, z)
  P1 e[9];
  for (int k = 0; k < 9; ++k)
    e[k] = {{Eb[0][k], Eb[1][k], Eb[2][k], Eb[3][k]}};

  P3c M[10];
  std::memset(M, 0, sizeof(M));
  // det(E) = e0(e4 e8 - e5 e7) - e1(e3 e8 - e5 e6) + e2(e3 e7 - e4 e6)
  p2p1_acc(p1p1(e[4], e[8]), e[0], 1.0, M[0]);
  p2p1_acc(p1p1(e[5], e[7]), e[0], -1.0, M[0]);
  p2p1_acc(p1p1(e[3], e[8]), e[1], -1.0, M[0]);
  p2p1_acc(p1p1(e[5], e[6]), e[1], 1.0, M[0]);
  p2p1_acc(p1p1(e[3], e[7]), e[2], 1.0, M[0]);
  p2p1_acc(p1p1(e[4], e[6]), e[2], -1.0, M[0]);
  // 2 E E^T E - tr(E E^T) E
  P2 G[9];  // G = E E^T (symmetric)
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      P2 s = {};
      for (int k = 0; k < 3; ++k) {
        P2 t2 = p1p1(e[i * 3 + k], e[j * 3 + k]);
        for (int q = 0; q < 10; ++q) s.c[q] += t2.c[q];
      }
      G[i * 3 + j] = s;
    }
  P2 tr = {};
  for (int q = 0; q < 10; ++q)
    tr.c[q] = G[0].c[q] + G[4].c[q] + G[8].c[q];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      P3c& row = M[1 + i * 3 + j];
      for (int k = 0; k < 3; ++k)
        p2p1_acc(G[i * 3 + k], e[k * 3 + j], 2.0, row);
      p2p1_acc(tr, e[i * 3 + j], -1.0, row);
    }

  // Gauss-Jordan of the 10x20 system over the first 10 columns
  double Mm[10][20];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 20; ++c) Mm[r][c] = M[r].c[c];
  for (int col = 0; col < 10; ++col) {
    int piv = -1;
    double best = 1e-12;
    for (int r = col; r < 10; ++r)
      if (std::fabs(Mm[r][col]) > best) { best = std::fabs(Mm[r][col]); piv = r; }
    if (piv < 0) return 0;  // degenerate configuration
    if (piv != col)
      for (int c = 0; c < 20; ++c) std::swap(Mm[col][c], Mm[piv][c]);
    double d = Mm[col][col];
    for (int c = 0; c < 20; ++c) Mm[col][c] /= d;
    for (int r = 0; r < 10; ++r) {
      if (r == col) continue;
      double f = Mm[r][col];
      if (f == 0.0) continue;
      for (int c = 0; c < 20; ++c) Mm[r][c] -= f * Mm[col][c];
    }
  }

  // rows 4..9 lead with x2z, x2, y2z, y2, xyz, xy. Build
  //   k = row(x2z) - z row(x2), l = row(y2z) - z row(y2),
  //   m = row(xyz) - z row(xy)
  // as C(z) [x y 1]^T = 0, entries univariate in z.
  auto row_xpoly = [&](int r) {  // cols 10..12 -> x z2, x z, x
    return UP{Mm[r][12], Mm[r][11], Mm[r][10]};
  };
  auto row_ypoly = [&](int r) {  // cols 13..15
    return UP{Mm[r][15], Mm[r][14], Mm[r][13]};
  };
  auto row_1poly = [&](int r) {  // cols 16..19 -> z3 z2 z 1
    return UP{Mm[r][19], Mm[r][18], Mm[r][17], Mm[r][16]};
  };
  UP C[3][3];
  int pairs[3][2] = {{4, 5}, {6, 7}, {8, 9}};
  for (int i = 0; i < 3; ++i) {
    int rz = pairs[i][0], r1 = pairs[i][1];
    C[i][0] = uadd(row_xpoly(rz), ushift(row_xpoly(r1)), -1.0);
    C[i][1] = uadd(row_ypoly(rz), ushift(row_ypoly(r1)), -1.0);
    C[i][2] = uadd(row_1poly(rz), ushift(row_1poly(r1)), -1.0);
  }
  // det C(z): degree <= 10
  UP det = uadd(
      uadd(umul(C[0][0], uadd(umul(C[1][1], C[2][2]), umul(C[1][2], C[2][1]), -1.0)),
           umul(C[0][1], uadd(umul(C[1][0], C[2][2]), umul(C[1][2], C[2][0]), -1.0)),
           -1.0),
      umul(C[0][2], uadd(umul(C[1][0], C[2][1]), umul(C[1][1], C[2][0]), -1.0)),
      1.0);

  double roots[16];
  int nr = upoly_real_roots(det, roots, 16);
  int nsol = 0;
  for (int ri = 0; ri < nr && nsol < 10; ++ri) {
    double z = roots[ri];
    // null vector of C(z): cross product of the two best-conditioned rows
    double rows[3][3];
    for (int i = 0; i < 3; ++i) {
      rows[i][0] = ueval(C[i][0], z);
      rows[i][1] = ueval(C[i][1], z);
      rows[i][2] = ueval(C[i][2], z);
    }
    double bestn = -1.0;
    V3 nvec = {0, 0, 0};
    for (int i = 0; i < 3; ++i) {
      int j = (i + 1) % 3;
      V3 a = {rows[i][0], rows[i][1], rows[i][2]};
      V3 b = {rows[j][0], rows[j][1], rows[j][2]};
      V3 c = cross(a, b);
      double n2 = dot(c, c);
      if (n2 > bestn) { bestn = n2; nvec = c; }
    }
    if (std::fabs(nvec.v[2]) < 1e-14 * std::sqrt(std::max(bestn, 1e-300)))
      continue;
    double x = nvec.v[0] / nvec.v[2], y = nvec.v[1] / nvec.v[2];
    double nrm = 0.0;
    for (int k = 0; k < 9; ++k) {
      E_out[nsol][k] = x * Eb[0][k] + y * Eb[1][k] + z * Eb[2][k] + Eb[3][k];
      nrm += E_out[nsol][k] * E_out[nsol][k];
    }
    nrm = std::sqrt(nrm) + 1e-300;
    for (int k = 0; k < 9; ++k) E_out[nsol][k] /= nrm;
    ++nsol;
  }
  return nsol;
}

// --------------------------------------------------- Grunert P3P solver
//
// Classic quartic formulation (Grunert 1841; coefficients per Haralick
// et al., "Review and analysis of solutions of the three point
// perspective pose estimation problem", IJCV 1994). Up to 4 poses.

// absolute orientation from exactly matched point sets (>=3, here 3):
// finds R, t with Xc = R Xw + t.
bool abs_orientation(int n, const V3* Xw, const V3* Xc, M3& R, V3& t) {
  V3 cw = {0, 0, 0}, cc = {0, 0, 0};
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      cw.v[k] += Xw[i].v[k] / n;
      cc.v[k] += Xc[i].v[k] / n;
    }
  M3 H = {};
  for (int i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        H.m[a * 3 + b] += (Xw[i].v[a] - cw.v[a]) * (Xc[i].v[b] - cc.v[b]);
  M3 U, V;
  double s[3];
  svd3(H, U, s, V);
  M3 R0 = mulT(V, transpose(U));
  if (det3(R0) < 0) {
    // flip the column of V for the smallest singular value
    for (int k = 0; k < 3; ++k) V.m[k * 3 + 2] *= -1;
    R0 = mulT(V, transpose(U));
  }
  R = R0;
  V3 Rcw = mul(R, cw);
  for (int k = 0; k < 3; ++k) t.v[k] = cc.v[k] - Rcw.v[k];
  return true;
}

// rays f[3] (unit, camera frame), world points X[3]. Up to 4 (R,t) with
// Xc = R Xw + t. Returns count.
int p3p_grunert(const V3* f, const V3* X, M3* R_out, V3* t_out) {
  double a2 = 0, b2 = 0, c2 = 0;  // a=|X2X3| (opp f1), b=|X1X3|, c=|X1X2|
  for (int k = 0; k < 3; ++k) {
    double d23 = X[1].v[k] - X[2].v[k];
    double d13 = X[0].v[k] - X[2].v[k];
    double d12 = X[0].v[k] - X[1].v[k];
    a2 += d23 * d23; b2 += d13 * d13; c2 += d12 * d12;
  }
  if (a2 < 1e-18 || b2 < 1e-18 || c2 < 1e-18) return 0;
  double ca = dot(f[1], f[2]);   // cos(alpha), opposite side a
  double cb = dot(f[0], f[2]);   // cos(beta)
  double cg = dot(f[0], f[1]);   // cos(gamma)

  double q = (a2 - c2) / b2;
  double p = (a2 + c2) / b2;
  // quartic in v = s3/s1 (Haralick eq. for Grunert's method)
  double A4 = (q - 1.0) * (q - 1.0) - 4.0 * (c2 / b2) * ca * ca;
  double A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - p) * ca * cg
                     + 2.0 * (c2 / b2) * ca * ca * cb);
  double A2 = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb
                     + 2.0 * ((b2 - c2) / b2) * ca * ca
                     - 4.0 * p * ca * cb * cg
                     + 2.0 * ((b2 - a2) / b2) * cg * cg);
  double A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * (a2 / b2) * cg * cg * cb
                     - (1.0 - p) * ca * cg);
  double A0 = (1.0 + q) * (1.0 + q) - 4.0 * (a2 / b2) * cg * cg;

  UP quart = {A0, A1, A2, A3, A4};
  double roots[8];
  int nr = upoly_real_roots(quart, roots, 8);
  int nsol = 0;
  for (int ri = 0; ri < nr && nsol < 4; ++ri) {
    double v = roots[ri];
    if (!(v > 0)) continue;
    double denom_u = 2.0 * (cg - v * ca);
    double u;
    if (std::fabs(denom_u) > 1e-12) {
      u = ((-1.0 + q) * v * v - 2.0 * q * cb * v + 1.0 + q) / denom_u;
    } else {
      // fall back to the quadratic in u from the (b,c) pair
      double k1 = 1.0 + v * v - 2.0 * v * cb;  // = b2/s1^2
      if (k1 < 1e-18) continue;
      double cc2 = c2 / b2 * k1;  // c2/s1^2
      double disc = cg * cg - (1.0 - cc2);
      if (disc < 0) continue;
      u = cg + std::sqrt(disc);
    }
    if (!(u > 0)) continue;
    double k1 = 1.0 + v * v - 2.0 * v * cb;
    if (k1 < 1e-18) continue;
    double s1 = std::sqrt(b2 / k1);
    double s2 = u * s1, s3 = v * s1;
    V3 Xc[3] = {{s1 * f[0].v[0], s1 * f[0].v[1], s1 * f[0].v[2]},
                {s2 * f[1].v[0], s2 * f[1].v[1], s2 * f[1].v[2]},
                {s3 * f[2].v[0], s3 * f[2].v[1], s3 * f[2].v[2]}};
    M3 R;
    V3 t;
    if (!abs_orientation(3, X, Xc, R, t)) continue;
    R_out[nsol] = R;
    t_out[nsol] = t;
    ++nsol;
  }
  return nsol;
}

// ------------------------------------------------------------- triangulation

// Midpoint triangulation of a normalized match under (I|0) and (R|t).
// Returns depth in both cameras via z0/z1.
void triangulate_depths(const M3& R, const V3& t, const V3& x0, const V3& x1,
                        double* z0, double* z1) {
  // Solve [x0, -R^T x1] [z0; z1] = R^T t ... use least squares on
  // z0 * x0 - z1 * (R^T x1) = R^T(-t)? Derive: X_c1 = R X_c0 + t;
  // z1 x1 = R z0 x0 + t  ->  z0 (R x0) - z1 x1 = -t, solve 3x2 LS.
  V3 Rx0 = mul(R, x0);
  double A[6] = {Rx0.v[0], -x1.v[0], Rx0.v[1], -x1.v[1], Rx0.v[2], -x1.v[2]};
  double b[3] = {-t.v[0], -t.v[1], -t.v[2]};
  // normal equations 2x2
  double a00 = 0, a01 = 0, a11 = 0, b0 = 0, b1 = 0;
  for (int i = 0; i < 3; ++i) {
    a00 += A[i * 2] * A[i * 2];
    a01 += A[i * 2] * A[i * 2 + 1];
    a11 += A[i * 2 + 1] * A[i * 2 + 1];
    b0 += A[i * 2] * b[i];
    b1 += A[i * 2 + 1] * b[i];
  }
  double det = a00 * a11 - a01 * a01;
  if (std::fabs(det) < 1e-18) { *z0 = *z1 = -1; return; }
  *z0 = (b0 * a11 - b1 * a01) / det;
  *z1 = (a00 * b1 - a01 * b0) / det;
}

// ------------------------------------------------------------ essential mat

void essential_from_8pt(int n, const double* x0, const double* x1, M3& E) {
  std::vector<double> A(n * 9);
  for (int i = 0; i < n; ++i) {
    double u0 = x0[i * 2], v0 = x0[i * 2 + 1];
    double u1 = x1[i * 2], v1 = x1[i * 2 + 1];
    double* r = &A[i * 9];
    r[0] = u1 * u0; r[1] = u1 * v0; r[2] = u1;
    r[3] = v1 * u0; r[4] = v1 * v0; r[5] = v1;
    r[6] = u0;      r[7] = v0;      r[8] = 1.0;
  }
  double e[9];
  nullspace(n, 9, A.data(), e);
  std::memcpy(E.m, e, sizeof(e));
  // project to essential manifold: singular values (s,s,0)
  M3 U, V;
  double s[3];
  svd3(E, U, s, V);
  double sm = (s[0] + s[1]) / 2;
  M3 S = {{sm, 0, 0, 0, sm, 0, 0, 0, 0}};
  E = mulT(mulT(U, S), transpose(V));
}

double sampson_sq(const M3& E, const double* p0, const double* p1) {
  V3 x0 = {p0[0], p0[1], 1.0}, x1 = {p1[0], p1[1], 1.0};
  V3 Ex0 = mul(E, x0);
  V3 Etx1 = mul(transpose(E), x1);
  double x1Ex0 = dot(x1, Ex0);
  double denom = Ex0.v[0] * Ex0.v[0] + Ex0.v[1] * Ex0.v[1] +
                 Etx1.v[0] * Etx1.v[0] + Etx1.v[1] * Etx1.v[1];
  return x1Ex0 * x1Ex0 / (denom + 1e-300);
}

// decompose E into the cheirality-best (R,t)
void decompose_E(const M3& E, int n, const double* x0, const double* x1,
                 const std::vector<int>& sample, M3& Rbest, V3& tbest) {
  M3 U, V;
  double s[3];
  svd3(E, U, s, V);
  if (det3(U) < 0) for (int k = 0; k < 3; ++k) U.m[k * 3 + 2] *= -1;
  if (det3(V) < 0) for (int k = 0; k < 3; ++k) V.m[k * 3 + 2] *= -1;
  M3 W = {{0, -1, 0, 1, 0, 0, 0, 0, 1}};
  M3 Ra = mulT(mulT(U, W), transpose(V));
  M3 Rb = mulT(mulT(U, transpose(W)), transpose(V));
  V3 u3 = {U.m[2], U.m[5], U.m[8]};
  M3 Rs[4] = {Ra, Ra, Rb, Rb};
  V3 ts[4] = {u3, {-u3.v[0], -u3.v[1], -u3.v[2]}, u3,
              {-u3.v[0], -u3.v[1], -u3.v[2]}};
  int best = 0, best_cnt = -1;
  for (int c = 0; c < 4; ++c) {
    int cnt = 0;
    for (int i : sample) {
      V3 a = {x0[i * 2], x0[i * 2 + 1], 1.0};
      V3 b = {x1[i * 2], x1[i * 2 + 1], 1.0};
      double z0, z1;
      triangulate_depths(Rs[c], ts[c], a, b, &z0, &z1);
      if (z0 > 0 && z1 > 0) ++cnt;
    }
    if (cnt > best_cnt) { best_cnt = cnt; best = c; }
  }
  Rbest = Rs[best];
  tbest = normalize(ts[best]);
}

// --------------------------------------------------------------- PnP pieces

// DLT P6P: projection matrix from >=6 2D(normalized)-3D matches, then
// extract (R, t) by orthogonalizing the left 3x3.
bool pnp_dlt(int n, const int* idx, int k, const double* x2d, const double* X3d,
             M3& R, V3& t) {
  std::vector<double> A(2 * k * 12, 0.0);
  for (int s = 0; s < k; ++s) {
    int i = idx[s];
    const double* X = &X3d[i * 3];
    double u = x2d[i * 2], v = x2d[i * 2 + 1];
    double* r0 = &A[(2 * s) * 12];
    double* r1 = &A[(2 * s + 1) * 12];
    for (int c = 0; c < 3; ++c) {
      r0[c] = X[c];
      r0[8 + c] = -u * X[c];
      r1[4 + c] = X[c];
      r1[8 + c] = -v * X[c];
    }
    r0[3] = 1.0; r0[11] = -u;
    r1[7] = 1.0; r1[11] = -v;
  }
  double p[12];
  nullspace(2 * k, 12, A.data(), p);
  M3 M = {{p[0], p[1], p[2], p[4], p[5], p[6], p[8], p[9], p[10]}};
  V3 p4 = {p[3], p[7], p[11]};
  double d = det3(M);
  if (d < 0) {
    for (int i = 0; i < 9; ++i) M.m[i] *= -1;
    for (int i = 0; i < 3; ++i) p4.v[i] *= -1;
  }
  M3 U, V;
  double s[3];
  svd3(M, U, s, V);
  double scale = (s[0] + s[1] + s[2]) / 3.0;
  if (scale < 1e-12) return false;
  R = mulT(U, transpose(V));
  if (det3(R) < 0) return false;
  for (int i = 0; i < 3; ++i) t.v[i] = p4.v[i] / scale;
  return true;
}

inline void rodrigues(const V3& w, M3& R) {
  double th = std::sqrt(dot(w, w));
  M3 I = {{1, 0, 0, 0, 1, 0, 0, 0, 1}};
  M3 K = {{0, -w.v[2], w.v[1], w.v[2], 0, -w.v[0], -w.v[1], w.v[0], 0}};
  if (th < 1e-12) { R = I; return; }
  double a = std::sin(th) / th;
  double b = (1 - std::cos(th)) / (th * th);
  M3 KK = mulT(K, K);
  for (int i = 0; i < 9; ++i) R.m[i] = I.m[i] + a * K.m[i] + b * KK.m[i];
}

// solve 6x6 A x = b by Gaussian elimination with partial pivoting;
// returns false on singularity.
bool solve6(const double* A_in, const double* b_in, double* x) {
  double Aa[36], bb[6];
  std::memcpy(Aa, A_in, sizeof(Aa));
  std::memcpy(bb, b_in, sizeof(bb));
  for (int col = 0; col < 6; ++col) {
    int piv = col;
    for (int r2 = col + 1; r2 < 6; ++r2)
      if (std::fabs(Aa[r2 * 6 + col]) > std::fabs(Aa[piv * 6 + col])) piv = r2;
    for (int c2 = 0; c2 < 6; ++c2) std::swap(Aa[col * 6 + c2], Aa[piv * 6 + c2]);
    std::swap(bb[col], bb[piv]);
    double d = Aa[col * 6 + col];
    if (std::fabs(d) < 1e-18) return false;
    for (int r2 = col + 1; r2 < 6; ++r2) {
      double f = Aa[r2 * 6 + col] / d;
      for (int c2 = col; c2 < 6; ++c2) Aa[r2 * 6 + c2] -= f * Aa[col * 6 + c2];
      bb[r2] -= f * bb[col];
    }
  }
  for (int r2 = 5; r2 >= 0; --r2) {
    double sum = bb[r2];
    for (int c2 = r2 + 1; c2 < 6; ++c2) sum -= Aa[r2 * 6 + c2] * x[c2];
    x[r2] = sum / Aa[r2 * 6 + r2];
  }
  return true;
}

// reprojection cost + (optionally) normal equations over inliers
double pnp_normal_eqs(int n, const uint8_t* inl, const double* x2d,
                      const double* X3d, const M3& R, const V3& t,
                      double* JTJ, double* JTr) {
  if (JTJ) std::memset(JTJ, 0, 36 * sizeof(double));
  if (JTr) std::memset(JTr, 0, 6 * sizeof(double));
  double cost = 0;
  for (int i = 0; i < n; ++i) {
    if (!inl[i]) continue;
    V3 X = {X3d[i * 3], X3d[i * 3 + 1], X3d[i * 3 + 2]};
    V3 Xc = mul(R, X);
    for (int k = 0; k < 3; ++k) Xc.v[k] += t.v[k];
    double z = Xc.v[2];
    if (z < 1e-9) { cost += 1.0; continue; }  // behind camera: fat penalty
    double u = Xc.v[0] / z, v = Xc.v[1] / z;
    double ru = u - x2d[i * 2], rv = v - x2d[i * 2 + 1];
    cost += ru * ru + rv * rv;
    if (!JTJ) continue;
    double du[3] = {1 / z, 0, -Xc.v[0] / (z * z)};
    double dv[3] = {0, 1 / z, -Xc.v[1] / (z * z)};
    // dXc/d(dw) = -[Xc]x (left perturbation), dXc/d(dt) = I
    double J[2][6];
    double Xx[9] = {0, -Xc.v[2], Xc.v[1], Xc.v[2], 0, -Xc.v[0],
                    -Xc.v[1], Xc.v[0], 0};
    for (int c = 0; c < 3; ++c) {
      double ju = 0, jv = 0;
      for (int k = 0; k < 3; ++k) {
        ju += du[k] * (-Xx[k * 3 + c]);
        jv += dv[k] * (-Xx[k * 3 + c]);
      }
      J[0][c] = ju; J[1][c] = jv;
      J[0][3 + c] = du[c]; J[1][3 + c] = dv[c];
    }
    for (int a = 0; a < 6; ++a) {
      JTr[a] += J[0][a] * ru + J[1][a] * rv;
      for (int b = 0; b < 6; ++b)
        JTJ[a * 6 + b] += J[0][a] * J[0][b] + J[1][a] * J[1][b];
    }
  }
  return cost;
}

// Levenberg-Marquardt on (R,t) minimizing normalized reprojection over
// inliers (the pycolmap pose_refinement equivalent; ref
// `Registration.py:107`).
void pnp_refine(int n, const uint8_t* inl, const double* x2d, const double* X3d,
                M3& R, V3& t, int iters = 30) {
  double lambda = 1e-4;
  double JTJ[36], JTr[6];
  double cost = pnp_normal_eqs(n, inl, x2d, X3d, R, t, JTJ, JTr);
  for (int it = 0; it < iters; ++it) {
    double x[6];
    double Ad[36];
    std::memcpy(Ad, JTJ, sizeof(Ad));
    for (int a = 0; a < 6; ++a) Ad[a * 6 + a] += lambda * (JTJ[a * 6 + a] + 1e-12);
    double nb[6];
    for (int a = 0; a < 6; ++a) nb[a] = -JTr[a];
    if (!solve6(Ad, nb, x)) { lambda *= 10; continue; }
    V3 dw = {x[0], x[1], x[2]};
    M3 dR;
    rodrigues(dw, dR);
    M3 Rn = mulT(dR, R);
    V3 tn = {t.v[0] + x[3], t.v[1] + x[4], t.v[2] + x[5]};
    double cost_n = pnp_normal_eqs(n, inl, x2d, X3d, Rn, tn, nullptr, nullptr);
    if (cost_n < cost) {
      R = Rn; t = tn;
      double step = 0;
      for (int k = 0; k < 6; ++k) step += x[k] * x[k];
      cost = pnp_normal_eqs(n, inl, x2d, X3d, R, t, JTJ, JTr);
      lambda = std::max(lambda / 3.0, 1e-12);
      if (step < 1e-20) break;
    } else {
      lambda *= 5.0;
      if (lambda > 1e8) break;
    }
  }
}

}  // namespace

// ================================================================= C API

extern "C" {

// kp0/kp1: [n,2] pixels; K row-major [3,3]. Outputs: R [3,3], t [3],
// inliers [n] (0/1). Returns 1 on success.
// Nister 5-point minimal solver inside LO-RANSAC. kp0/kp1: [n,2] pixels;
// K row-major [3,3]. Outputs: R [3,3], t [3], inliers [n] (0/1).
int mg_essential_ransac(const double* kp0, const double* kp1, int n,
                        const double* K, double threshold_px, double prob,
                        int max_iters, double* R_out, double* t_out,
                        uint8_t* inliers_out) {
  if (n < 5) return 0;
  double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  std::vector<double> x0(n * 2), x1(n * 2);
  for (int i = 0; i < n; ++i) {
    x0[i * 2] = (kp0[i * 2] - cx) / fx;
    x0[i * 2 + 1] = (kp0[i * 2 + 1] - cy) / fy;
    x1[i * 2] = (kp1[i * 2] - cx) / fx;
    x1[i * 2 + 1] = (kp1[i * 2 + 1] - cy) / fy;
  }
  double thr = threshold_px / fx;
  double thr2 = thr * thr;
  std::mt19937 rng(42);
  std::uniform_int_distribution<int> uni(0, n - 1);
  int best_cnt = -1;
  std::vector<uint8_t> best_inl(n, 0), inl(n, 0);
  M3 Ebest;
  // Score = #points that are Sampson inliers AND triangulate with
  // positive depth under the cheirality-best decomposition of E. Pure
  // Sampson counting cannot separate a planar scene's twisted-pair twin
  // (both satisfy the epipolar constraint on every coplanar point);
  // cheirality does — this mirrors pycolmap's pose-aware inlier count.
  auto score = [&](const M3& E, std::vector<uint8_t>& out) {
    int cnt = 0;
    std::vector<int> samp;
    for (int i = 0; i < n; ++i) {
      bool ok = sampson_sq(E, &x0[i * 2], &x1[i * 2]) < thr2;
      out[i] = ok;
      if (ok) samp.push_back(i);
    }
    if (samp.empty()) return 0;
    M3 R;
    V3 t;
    decompose_E(E, n, x0.data(), x1.data(), samp, R, t);
    for (int i : samp) {
      V3 a = {x0[i * 2], x0[i * 2 + 1], 1.0};
      V3 b = {x1[i * 2], x1[i * 2 + 1], 1.0};
      double z0, z1;
      triangulate_depths(R, t, a, b, &z0, &z1);
      bool ok = (z0 > 0 && z1 > 0);
      out[i] = ok;
      cnt += ok;
    }
    return cnt;
  };
  int iters = max_iters;
  for (int it = 0; it < iters; ++it) {
    int idx[5];
    for (int k = 0; k < 5;) {
      int cand = uni(rng);
      bool dup = false;
      for (int j = 0; j < k; ++j) dup |= (idx[j] == cand);
      if (!dup) idx[k++] = cand;
    }
    double s0[10], s1[10];
    for (int k = 0; k < 5; ++k) {
      s0[k * 2] = x0[idx[k] * 2]; s0[k * 2 + 1] = x0[idx[k] * 2 + 1];
      s1[k * 2] = x1[idx[k] * 2]; s1[k * 2 + 1] = x1[idx[k] * 2 + 1];
    }
    double Ecand[10][9];
    int ncand = essential_5pt(s0, s1, Ecand);
    bool improved = false;
    for (int c = 0; c < ncand; ++c) {
      M3 E;
      std::memcpy(E.m, Ecand[c], sizeof(E.m));
      int cnt = score(E, inl);
      if (cnt > best_cnt) {
        best_cnt = cnt;
        best_inl = inl;
        Ebest = E;
        improved = true;
      }
    }
    // LO step: non-minimal (8-point on all current inliers) re-estimate
    if (improved && best_cnt >= 8) {
      std::vector<double> i0, i1;
      for (int i = 0; i < n; ++i)
        if (best_inl[i]) {
          i0.push_back(x0[i * 2]); i0.push_back(x0[i * 2 + 1]);
          i1.push_back(x1[i * 2]); i1.push_back(x1[i * 2 + 1]);
        }
      M3 Elo;
      essential_from_8pt(best_cnt, i0.data(), i1.data(), Elo);
      int cnt = score(Elo, inl);
      if (cnt > best_cnt) {
        best_cnt = cnt;
        best_inl = inl;
        Ebest = Elo;
      }
    }
    if (improved) {
      // adaptive iteration count (clamp in double BEFORE the int cast —
      // need can be ~1e11 for low inlier ratios and int() would overflow)
      double w = double(best_cnt) / n;
      double denom = std::log(std::max(1e-12, 1.0 - std::pow(w, 5.0)));
      if (denom < -1e-12) {
        double need_d = std::log(1 - prob) / denom + 1.0;
        int need = (need_d > double(max_iters)) ? max_iters : int(need_d);
        iters = std::min(max_iters, std::max(need, it + 1));
      }
    }
  }
  if (best_cnt < 5) return 0;
  if (best_cnt < 8) {
    // too few inliers for the non-minimal polish: use the minimal model
    M3 R;
    V3 t;
    std::vector<int> all_inl;
    for (int i = 0; i < n; ++i) if (best_inl[i]) all_inl.push_back(i);
    decompose_E(Ebest, n, x0.data(), x1.data(), all_inl, R, t);
    std::memcpy(R_out, R.m, 9 * sizeof(double));
    std::memcpy(t_out, t.v, 3 * sizeof(double));
    std::memcpy(inliers_out, best_inl.data(), n);
    return 1;
  }
  // final non-minimal polish: 8-point on all inliers, kept only if it
  // scores at least as well (the linear solve is degenerate on planar
  // scenes — never let it displace a better minimal model)
  {
    std::vector<double> i0, i1;
    for (int i = 0; i < n; ++i)
      if (best_inl[i]) {
        i0.push_back(x0[i * 2]); i0.push_back(x0[i * 2 + 1]);
        i1.push_back(x1[i * 2]); i1.push_back(x1[i * 2 + 1]);
      }
    M3 E;
    essential_from_8pt(best_cnt, i0.data(), i1.data(), E);
    int cnt = score(E, inl);
    if (cnt >= best_cnt) {
      best_cnt = cnt;
      best_inl = inl;
      Ebest = E;
    }
  }
  std::vector<int> all_inl;
  for (int i = 0; i < n; ++i) if (best_inl[i]) all_inl.push_back(i);
  if ((int)all_inl.size() < 5) return 0;
  M3 R;
  V3 t;
  decompose_E(Ebest, n, x0.data(), x1.data(), all_inl, R, t);
  std::memcpy(R_out, R.m, 9 * sizeof(double));
  std::memcpy(t_out, t.v, 3 * sizeof(double));
  std::memcpy(inliers_out, best_inl.data(), n);
  return 1;
}

// Grunert P3P minimal solver inside LO-RANSAC (LO = all-inlier DLT + LM).
// p2d: [n,2] pixels; p3d: [n,3]; K [3,3]. Outputs R (w2c), t, inliers.
int mg_pnp_ransac(const double* p2d, const double* p3d, int n, const double* K,
                  double max_error_px, int max_iters, int refine,
                  double* R_out, double* t_out, uint8_t* inliers_out) {
  if (n < 4) return 0;
  double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  std::vector<double> x2(n * 2);
  for (int i = 0; i < n; ++i) {
    x2[i * 2] = (p2d[i * 2] - cx) / fx;
    x2[i * 2 + 1] = (p2d[i * 2 + 1] - cy) / fy;
  }
  double thr = max_error_px / fx;
  double thr2 = thr * thr;
  std::mt19937 rng(7);
  std::uniform_int_distribution<int> uni(0, n - 1);
  int best_cnt = -1;
  std::vector<uint8_t> best_inl(n, 0), inl(n, 0);
  M3 Rb; V3 tb;
  auto score = [&](const M3& R, const V3& t, std::vector<uint8_t>& out) {
    int cnt = 0;
    for (int i = 0; i < n; ++i) {
      V3 X = {p3d[i * 3], p3d[i * 3 + 1], p3d[i * 3 + 2]};
      V3 Xc = mul(R, X);
      for (int k = 0; k < 3; ++k) Xc.v[k] += t.v[k];
      bool ok = false;
      if (Xc.v[2] > 1e-9) {
        double du = Xc.v[0] / Xc.v[2] - x2[i * 2];
        double dv = Xc.v[1] / Xc.v[2] - x2[i * 2 + 1];
        ok = du * du + dv * dv < thr2;
      }
      out[i] = ok;
      cnt += ok;
    }
    return cnt;
  };
  int iters = max_iters;
  for (int it = 0; it < iters; ++it) {
    int idx[3];
    for (int k = 0; k < 3;) {
      int cand = uni(rng);
      bool dup = false;
      for (int j = 0; j < k; ++j) dup |= (idx[j] == cand);
      if (!dup) idx[k++] = cand;
    }
    V3 f[3], X[3];
    for (int k = 0; k < 3; ++k) {
      f[k] = normalize({x2[idx[k] * 2], x2[idx[k] * 2 + 1], 1.0});
      X[k] = {p3d[idx[k] * 3], p3d[idx[k] * 3 + 1], p3d[idx[k] * 3 + 2]};
    }
    M3 Rc[4]; V3 tc[4];
    int nc = p3p_grunert(f, X, Rc, tc);
    bool improved = false;
    for (int c = 0; c < nc; ++c) {
      int cnt = score(Rc[c], tc[c], inl);
      if (cnt > best_cnt) {
        best_cnt = cnt; best_inl = inl; Rb = Rc[c]; tb = tc[c];
        improved = true;
      }
    }
    // LO step: all-inlier DLT re-estimate + short LM, keep if better
    if (improved && best_cnt >= 6) {
      std::vector<int> iidx;
      for (int i = 0; i < n; ++i) if (best_inl[i]) iidx.push_back(i);
      M3 Rlo; V3 tlo;
      if (pnp_dlt(n, iidx.data(), (int)iidx.size(), x2.data(), p3d, Rlo, tlo)) {
        pnp_refine(n, best_inl.data(), x2.data(), p3d, Rlo, tlo, 10);
        int cnt = score(Rlo, tlo, inl);
        if (cnt > best_cnt) {
          best_cnt = cnt; best_inl = inl; Rb = Rlo; tb = tlo;
        }
      }
    }
    if (improved) {
      double w = double(best_cnt) / n;
      double denom = std::log(std::max(1e-12, 1.0 - std::pow(w, 3.0)));
      if (denom < -1e-12) {
        double need_d = std::log(1 - 0.9999) / denom + 1.0;
        int need = (need_d > double(max_iters)) ? max_iters : int(need_d);
        iters = std::min(max_iters, std::max(need, it + 1));
      }
    }
  }
  if (best_cnt < 4) return 0;
  if (refine) {
    pnp_refine(n, best_inl.data(), x2.data(), p3d, Rb, tb);
    int cnt = 0;
    for (int i = 0; i < n; ++i) {
      V3 X = {p3d[i * 3], p3d[i * 3 + 1], p3d[i * 3 + 2]};
      V3 Xc = mul(Rb, X);
      for (int k = 0; k < 3; ++k) Xc.v[k] += tb.v[k];
      bool ok = false;
      if (Xc.v[2] > 1e-9) {
        double du = Xc.v[0] / Xc.v[2] - x2[i * 2];
        double dv = Xc.v[1] / Xc.v[2] - x2[i * 2 + 1];
        ok = du * du + dv * dv < thr2;
      }
      best_inl[i] = ok;
      cnt += ok;
    }
    if (cnt >= 6) pnp_refine(n, best_inl.data(), x2.data(), p3d, Rb, tb);
  }
  std::memcpy(R_out, Rb.m, 9 * sizeof(double));
  std::memcpy(t_out, tb.v, 3 * sizeof(double));
  std::memcpy(inliers_out, best_inl.data(), n);
  return 1;
}

// ---- direct solver hooks (unit tests) ----

// x0/x1: [5,2] NORMALIZED coords. E_out: [10*9]. Returns solution count.
int mg_essential_5pt(const double* x0, const double* x1, double* E_out) {
  double E[10][9];
  int ns = essential_5pt(x0, x1, E);
  for (int s = 0; s < ns; ++s)
    std::memcpy(&E_out[s * 9], E[s], 9 * sizeof(double));
  return ns;
}

// p2n: [3,2] NORMALIZED coords; p3d: [3,3]. R_out [4*9], t_out [4*3].
int mg_p3p(const double* p2n, const double* p3d, double* R_out,
           double* t_out) {
  V3 f[3], X[3];
  for (int k = 0; k < 3; ++k) {
    f[k] = normalize({p2n[k * 2], p2n[k * 2 + 1], 1.0});
    X[k] = {p3d[k * 3], p3d[k * 3 + 1], p3d[k * 3 + 2]};
  }
  M3 R[4]; V3 t[4];
  int ns = p3p_grunert(f, X, R, t);
  for (int s = 0; s < ns; ++s) {
    std::memcpy(&R_out[s * 9], R[s].m, 9 * sizeof(double));
    std::memcpy(&t_out[s * 3], t[s].v, 3 * sizeof(double));
  }
  return ns;
}

}  // extern "C"
