// TM-align: pairwise protein structure alignment by TM-score optimisation.
//
// Clean-room implementation of the published algorithm (Y. Zhang,
// J. Skolnick, "TM-align: a protein structure alignment algorithm based on
// the TM-score", Nucleic Acids Research 33(7):2302-2309, 2005). The
// reference pipeline ships TM-align as an opaque C++ binary invoked per
// query-hit pair (merizo_search/programs/Foldclass/utils.py:75-109); this
// library replaces it with an in-process C API plus a threaded batch entry
// point so rescoring costs no fork+exec and no PDB round-trip through /tmp.
//
// Algorithm outline:
//   1. several initial alignments: gapless threading, secondary-structure
//      Needleman-Wunsch, and local fragment superposition;
//   2. for each, iterative refinement alternating (a) a TM-score-optimal
//      superposition search over the current alignment (fragment seeds +
//      distance-cutoff extension) and (b) NW dynamic programming on the
//      1/(1+d^2/d0^2) rotated-distance score matrix (gap open -0.6 / 0);
//   3. final TM-scores normalised by query and by target length.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtmalign.so tmalign.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct V3 { double x, y, z; };

static inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline double dist2(const V3& a, const V3& b) { V3 d = sub(a, b); return dot(d, d); }
static inline double dist(const V3& a, const V3& b) { return std::sqrt(dist2(a, b)); }

// Rot default-constructs to the identity transform: several call sites use
// the best rotation found by a search that can legitimately find none
// (alignments with < 3 pairs), and must then see a valid transform rather
// than uninitialized memory.
struct Rot {
  double u[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  double t[3] = {0, 0, 0};
};

static inline V3 apply(const Rot& r, const V3& p) {
  return {r.t[0] + r.u[0][0] * p.x + r.u[0][1] * p.y + r.u[0][2] * p.z,
          r.t[1] + r.u[1][0] * p.x + r.u[1][1] * p.y + r.u[1][2] * p.z,
          r.t[2] + r.u[2][0] * p.x + r.u[2][1] * p.y + r.u[2][2] * p.z};
}

// ---------------------------------------------------------------------------
// Optimal superposition (Kabsch via Jacobi eigendecomposition of B^T B).
// Returns the rigid transform mapping x -> y, least-squares over the
// selected pairs. Robust to reflections (proper rotation enforced).

static void jacobi3(double a[3][3], double d[3], double v[3][3]) {
  // symmetric 3x3 eigen-decomposition, cyclic Jacobi
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p)
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double sg = theta >= 0 ? 1.0 : -1.0;
        double tt = sg / (sg * theta + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(tt * tt + 1.0), s = tt * c;
        double app = a[p][p], aqq = a[q][q], apq = a[p][q];
        a[p][p] = c * c * app - 2 * s * c * apq + s * s * aqq;
        a[q][q] = s * s * app + 2 * s * c * apq + c * c * aqq;
        a[p][q] = a[q][p] = 0.0;
        for (int r = 0; r < 3; ++r) {
          if (r == p || r == q) continue;
          double arp = a[r][p], arq = a[r][q];
          a[r][p] = a[p][r] = c * arp - s * arq;
          a[r][q] = a[q][r] = s * arp + c * arq;
        }
        for (int r = 0; r < 3; ++r) {
          double vrp = v[r][p], vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
      }
  }
  for (int i = 0; i < 3; ++i) d[i] = a[i][i];
}

static bool kabsch(const std::vector<V3>& x, const std::vector<V3>& y,
                   const std::vector<int>& sel, Rot* out) {
  int n = (int)sel.size();
  if (n < 3) return false;
  // NOTE: callers pass parallel arrays: x[sel[i]] pairs with y[sel[i]].
  V3 cx{0, 0, 0}, cy{0, 0, 0};
  for (int i : sel) { cx.x += x[i].x; cx.y += x[i].y; cx.z += x[i].z; }
  cx.x /= n; cx.y /= n; cx.z /= n;
  for (int i : sel) { cy.x += y[i].x; cy.y += y[i].y; cy.z += y[i].z; }
  cy.x /= n; cy.y /= n; cy.z /= n;

  double r[3][3] = {{0}};
  for (int i : sel) {
    double px[3] = {x[i].x - cx.x, x[i].y - cx.y, x[i].z - cx.z};
    double py[3] = {y[i].x - cy.x, y[i].y - cy.y, y[i].z - cy.z};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) r[a][b] += py[a] * px[b];
  }
  // R = cov(y,x); rotation U = R (R^T R)^{-1/2} with det fix
  double rtr[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      rtr[a][b] = 0;
      for (int c = 0; c < 3; ++c) rtr[a][b] += r[c][a] * r[c][b];
    }
  double eval[3], evec[3][3];
  jacobi3(rtr, eval, evec);
  // sort eigenpairs descending — 3-element sort network; kabsch runs ~1M
  // times per batch and a std::sort call here profiled at half the total
  // alignment time (call + introsort overhead for 3 elements)
  int order[3] = {0, 1, 2};
  if (eval[order[0]] < eval[order[1]]) std::swap(order[0], order[1]);
  if (eval[order[1]] < eval[order[2]]) std::swap(order[1], order[2]);
  if (eval[order[0]] < eval[order[1]]) std::swap(order[0], order[1]);
  double a1[3] = {evec[0][order[0]], evec[1][order[0]], evec[2][order[0]]};
  double a2[3] = {evec[0][order[1]], evec[1][order[1]], evec[2][order[1]]};
  // a3 = a1 x a2 (right-handed basis)
  double a3[3] = {a1[1] * a2[2] - a1[2] * a2[1], a1[2] * a2[0] - a1[0] * a2[2],
                  a1[0] * a2[1] - a1[1] * a2[0]};
  double A[3][3] = {{a1[0], a1[1], a1[2]}, {a2[0], a2[1], a2[2]}, {a3[0], a3[1], a3[2]}};
  double B[3][3];
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 3; ++j) {
      B[i][j] = 0;
      for (int c = 0; c < 3; ++c) B[i][j] += r[j][c] * A[i][c];
    }
    double nb = std::sqrt(B[i][0] * B[i][0] + B[i][1] * B[i][1] + B[i][2] * B[i][2]);
    if (nb < 1e-12) return false;
    for (int j = 0; j < 3; ++j) B[i][j] /= nb;
  }
  // re-orthogonalise b2 against b1 (guards near-degenerate spectra)
  double d12 = B[0][0] * B[1][0] + B[0][1] * B[1][1] + B[0][2] * B[1][2];
  for (int j = 0; j < 3; ++j) B[1][j] -= d12 * B[0][j];
  double nb2 = std::sqrt(B[1][0] * B[1][0] + B[1][1] * B[1][1] + B[1][2] * B[1][2]);
  if (nb2 < 1e-12) return false;
  for (int j = 0; j < 3; ++j) B[1][j] /= nb2;
  // b3 = b1 x b2; det handled by construction
  B[2][0] = B[0][1] * B[1][2] - B[0][2] * B[1][1];
  B[2][1] = B[0][2] * B[1][0] - B[0][0] * B[1][2];
  B[2][2] = B[0][0] * B[1][1] - B[0][1] * B[1][0];
  double u[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      u[i][j] = 0;
      for (int c = 0; c < 3; ++c) u[i][j] += B[c][i] * A[c][j];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out->u[i][j] = u[i][j];
  out->t[0] = cy.x - (u[0][0] * cx.x + u[0][1] * cx.y + u[0][2] * cx.z);
  out->t[1] = cy.y - (u[1][0] * cx.x + u[1][1] * cx.y + u[1][2] * cx.z);
  out->t[2] = cy.z - (u[2][0] * cx.x + u[2][1] * cx.y + u[2][2] * cx.z);
  return true;
}

// ---------------------------------------------------------------------------

static double tm_d0(double l) {
  if (l <= 21) return 0.5;
  double d0 = 1.24 * std::cbrt(l - 15.0) - 1.8;
  return std::max(d0, 0.5);
}

// TM-score of alignment ali (x index -> y index, -1 unaligned) under
// transform r, normalised by lnorm with distance scale d0.
static double tm_under(const std::vector<V3>& x, const std::vector<V3>& y,
                       const std::vector<int>& ali, const Rot& r, double d0,
                       double lnorm) {
  double s = 0, d02 = d0 * d0;
  for (size_t i = 0; i < ali.size(); ++i) {
    if (ali[i] < 0) continue;
    double d2 = dist2(apply(r, x[i]), y[ali[i]]);
    s += 1.0 / (1.0 + d2 / d02);
  }
  return s / lnorm;
}

// TM-score rotation search: from fragment seeds of the aligned set, iterate
// superpose-on-subset -> rescore -> re-select pairs under a distance cutoff.
// (the TM-score "L_init schedule + extension" heuristic.)
static double tmscore_search(const std::vector<V3>& x, const std::vector<V3>& y,
                             const std::vector<int>& ali, double d0, double lnorm,
                             int n_iter, Rot* best_rot) {
  std::vector<int> pairs;  // x indices with ali >= 0
  for (size_t i = 0; i < ali.size(); ++i)
    if (ali[i] >= 0) pairs.push_back((int)i);
  int na = (int)pairs.size();
  if (na < 3) return 0.0;
  double d0s = std::min(std::max(d0, 4.5), 8.0);
  double best = -1.0;

  std::vector<V3> ysel(x.size());
  for (int i : pairs) ysel[i] = y[ali[i]];

  // seed fragments: L_init = na, na/2, na/4, na/8 (>= 4), varying start
  std::vector<std::pair<int, int>> seeds;  // (start, len) into pairs[]
  for (int len = na; len >= 4; len /= 2) {
    int step = std::max(len / 2, 1);
    for (int s = 0; s + len <= na; s += step) seeds.push_back({s, len});
    if (len == na) seeds.back() = {0, na};
    if ((int)seeds.size() > 32) break;
  }
  if (seeds.empty()) seeds.push_back({0, na});

  // SoA copies of the paired coordinates: the distance pass below is then
  // pure elementwise over contiguous arrays, which the compiler vectorizes
  // (identical per-element arithmetic, so results are unchanged; only the
  // scalar score SUM stays in original order to keep bit-exactness)
  size_t np_ = pairs.size();
  std::vector<double> pxx(np_), pxy(np_), pxz(np_), pyx(np_), pyy(np_), pyz(np_);
  for (size_t p = 0; p < np_; ++p) {
    const V3& a = x[pairs[p]];
    const V3& b = ysel[pairs[p]];
    pxx[p] = a.x; pxy[p] = a.y; pxz[p] = a.z;
    pyx[p] = b.x; pyy[p] = b.y; pyz[p] = b.z;
  }
  std::vector<int> prev_sel;
  std::vector<double> d2s(np_);  // per-pair d2 under the current r
  double d02 = d0 * d0;
  for (auto& sd : seeds) {
    std::vector<int> sel(pairs.begin() + sd.first,
                         pairs.begin() + sd.first + sd.second);
    Rot r;
    prev_sel.clear();
    for (int it = 0; it < n_iter; ++it) {
      if (!kabsch(x, ysel, sel, &r)) break;
      // elementwise vectorizable distance pass fills the cache the
      // reselection scans (tm_under semantics: sum over ali>=0, i.e.
      // exactly `pairs`, against ysel)
      for (size_t p = 0; p < np_; ++p) {
        // association order mirrors apply()/dist2() exactly so the values
        // (and thus selections/scores) are bit-identical to the AoS pass
        double ax = (r.t[0] + r.u[0][0] * pxx[p] + r.u[0][1] * pxy[p] +
                     r.u[0][2] * pxz[p]) - pyx[p];
        double ay = (r.t[1] + r.u[1][0] * pxx[p] + r.u[1][1] * pxy[p] +
                     r.u[1][2] * pxz[p]) - pyy[p];
        double az = (r.t[2] + r.u[2][0] * pxx[p] + r.u[2][1] * pxy[p] +
                     r.u[2][2] * pxz[p]) - pyz[p];
        d2s[p] = ax * ax + ay * ay + az * az;
      }
      double sc = 0;
      for (size_t p = 0; p < np_; ++p) sc += 1.0 / (1.0 + d2s[p] / d02);
      sc /= lnorm;
      if (sc > best) { best = sc; *best_rot = r; }
      prev_sel.swap(sel);
      // re-select pairs within d0_search (+1, +2.5 widening if too few)
      for (double cut : {d0s, d0s + 1.0, d0s + 2.5}) {
        sel.clear();
        double c2 = cut * cut;
        for (size_t p = 0; p < pairs.size(); ++p)
          if (d2s[p] < c2) sel.push_back(pairs[p]);
        if ((int)sel.size() >= 4) break;
      }
      if ((int)sel.size() < 4) { sel.assign(pairs.begin(), pairs.end()); }
      // fixpoint: the next kabsch input equals this one's, so every later
      // iteration would recompute the identical transform/score — exact break
      if (sel == prev_sel) break;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// Needleman-Wunsch with free end gaps (semi-global), gap-open only.

// S is row-major [nx, ny] flat (contiguous scoring keeps the DP inner loop
// on one stream; the nested-vector layout profiled ~20% of alignment time
// in pointer chasing and per-row allocations).
static void nw_align(const double* S, int nx, int ny,
                     double gap, std::vector<int>* ali) {
  // H needs only the previous row (rolling pair); P keeps the full
  // traceback, flat. Values identical to the full-matrix formulation.
  std::vector<double> hprev(ny + 1, 0.0), hcur(ny + 1, 0.0);
  std::vector<signed char> P((size_t)(nx + 1) * (ny + 1), 3);
  for (int i = 1; i <= nx; ++i) {
    hcur[0] = 0.0;
    signed char* prow = &P[(size_t)i * (ny + 1)];
    const double* srow = S + (size_t)(i - 1) * ny;
    for (int j = 1; j <= ny; ++j) {
      double diag = hprev[j - 1] + srow[j - 1];
      double up = hprev[j] + ((j == ny) ? 0.0 : gap);
      double left = hcur[j - 1] + ((i == nx) ? 0.0 : gap);
      double b = diag; signed char p = 0;
      if (up > b) { b = up; p = 1; }
      if (left > b) { b = left; p = 2; }
      hcur[j] = b; prow[j] = p;
    }
    hprev.swap(hcur);
  }
  ali->assign(nx, -1);
  int i = nx, j = ny;
  while (i > 0 && j > 0) {
    signed char p = P[(size_t)i * (ny + 1) + j];
    if (p == 0) { (*ali)[i - 1] = j - 1; --i; --j; }
    else if (p == 1) --i;
    else --j;
  }
}

// ---------------------------------------------------------------------------
// Secondary structure assignment from CA geometry (TM-align's make_sec):
// H helix, E strand, T turn, C coil.

static void assign_ss(const std::vector<V3>& ca, std::vector<char>* ss) {
  int n = (int)ca.size();
  ss->assign(n, 'C');
  for (int i = 2; i + 2 < n; ++i) {
    double d13 = dist(ca[i - 2], ca[i]);
    double d14 = dist(ca[i - 2], ca[i + 1]);
    double d15 = dist(ca[i - 2], ca[i + 2]);
    double d24 = dist(ca[i - 1], ca[i + 1]);
    double d25 = dist(ca[i - 1], ca[i + 2]);
    double d35 = dist(ca[i], ca[i + 2]);
    double dh = 2.1;
    if (std::fabs(d15 - 6.37) < dh && std::fabs(d14 - 5.18) < dh &&
        std::fabs(d25 - 5.18) < dh && std::fabs(d13 - 5.45) < dh &&
        std::fabs(d24 - 5.45) < dh && std::fabs(d35 - 5.45) < dh) {
      (*ss)[i] = 'H';
      continue;
    }
    double de = 1.42;
    if (std::fabs(d15 - 13.0) < de && std::fabs(d14 - 10.4) < de &&
        std::fabs(d25 - 10.4) < de && std::fabs(d13 - 6.1) < de &&
        std::fabs(d24 - 6.1) < de && std::fabs(d35 - 6.1) < de) {
      (*ss)[i] = 'E';
      continue;
    }
    if (d15 < 8.0) (*ss)[i] = 'T';
  }
}

// ---------------------------------------------------------------------------
// Initial alignments

// 1) gapless threading: best diagonal offset by TM-score
static void init_gapless(const std::vector<V3>& x, const std::vector<V3>& y,
                         double d0, double lnorm, std::vector<int>* ali) {
  int nx = (int)x.size(), ny = (int)y.size();
  int lmin = std::min(nx, ny);
  int step = std::max(lmin / 40, 1);
  double best = -1.0;
  std::vector<int> cand(nx, -1);
  for (int off = -(nx - 5); off <= ny - 5; off += step) {
    cand.assign(nx, -1);
    std::vector<int> sel;
    for (int i = 0; i < nx; ++i) {
      int j = i + off;
      if (j >= 0 && j < ny) { cand[i] = j; sel.push_back(i); }
    }
    if ((int)sel.size() < 5) continue;
    std::vector<V3> ysel(nx);
    for (int i : sel) ysel[i] = y[cand[i]];
    Rot r;
    if (!kabsch(x, ysel, sel, &r)) continue;
    double sc = tm_under(x, y, cand, r, d0, lnorm);
    if (sc > best) { best = sc; *ali = cand; }
  }
  if (ali->empty()) ali->assign(nx, -1);
}

// 2) secondary-structure NW
static void init_ss(const std::vector<V3>& x, const std::vector<V3>& y,
                    std::vector<int>* ali) {
  std::vector<char> sx, sy;
  assign_ss(x, &sx);
  assign_ss(y, &sy);
  int nx = (int)x.size(), ny = (int)y.size();
  std::vector<double> S((size_t)nx * ny);
  for (int i = 0; i < nx; ++i)
    for (int j = 0; j < ny; ++j) S[(size_t)i * ny + j] = (sx[i] == sy[j]) ? 1.0 : 0.0;
  nw_align(S.data(), nx, ny, -1.0, ali);
}

// 3) local fragment superposition: superpose best gapless fragment pair,
// then NW on the resulting distance matrix
static void init_fragment(const std::vector<V3>& x, const std::vector<V3>& y,
                          double d0, std::vector<int>* ali) {
  int nx = (int)x.size(), ny = (int)y.size();
  int fl = std::max(std::min(std::min(nx, ny) / 2, 20), 5);
  double best = -1.0;
  Rot bestr;
  int sx_step = std::max(nx / 16, 1), sy_step = std::max(ny / 16, 1);
  for (int ix = 0; ix + fl <= nx; ix += sx_step)
    for (int jy = 0; jy + fl <= ny; jy += sy_step) {
      std::vector<int> sel(fl);
      std::vector<V3> ysel(nx);
      std::vector<int> cand(nx, -1);
      for (int k = 0; k < fl; ++k) {
        sel[k] = ix + k;
        cand[ix + k] = jy + k;
        ysel[ix + k] = y[jy + k];
      }
      Rot r;
      if (!kabsch(x, ysel, sel, &r)) continue;
      // score the whole chains under this local frame
      double d02 = d0 * d0, sc = 0;
      for (int i = 0; i < nx; ++i) {
        double bd = 1e18;
        V3 xt = apply(r, x[i]);
        for (int j = 0; j < ny; j += 2) bd = std::min(bd, dist2(xt, y[j]));
        sc += 1.0 / (1.0 + bd / d02);
      }
      if (sc > best) { best = sc; bestr = r; }
    }
  if (best < 0) { ali->assign(nx, -1); return; }
  std::vector<double> S((size_t)nx * ny);
  double d02 = d0 * d0;
  for (int i = 0; i < nx; ++i) {
    V3 xt = apply(bestr, x[i]);
    double* srow = &S[(size_t)i * ny];
    for (int j = 0; j < ny; ++j) srow[j] = 1.0 / (1.0 + dist2(xt, y[j]) / d02);
  }
  nw_align(S.data(), nx, ny, -0.6, ali);
}

// ---------------------------------------------------------------------------
// DP iteration from an initial alignment; returns best TM (lnorm) found.

static double dp_iterate(const std::vector<V3>& x, const std::vector<V3>& y,
                         std::vector<int> ali, double d0, double lnorm,
                         int n_outer, int n_tm_iter, std::vector<int>* best_ali) {
  int nx = (int)x.size(), ny = (int)y.size();
  double best = -1.0;
  double d02 = d0 * d0;
  std::vector<double> S((size_t)nx * ny);
  // SoA copy of y: the O(nx*ny) score fill below is elementwise over j and
  // vectorizes over contiguous arrays (identical per-element arithmetic)
  std::vector<double> yx(ny), yy(ny), yz(ny);
  for (int j = 0; j < ny; ++j) { yx[j] = y[j].x; yy[j] = y[j].y; yz[j] = y[j].z; }
  const double gaps[2] = {-0.6, 0.0};
  for (int g = 0; g < 2; ++g) {
    std::vector<int> cur = ali;
    std::vector<int> prev;
    for (int it = 0; it < n_outer; ++it) {
      Rot r;
      double sc = tmscore_search(x, y, cur, d0, lnorm, n_tm_iter, &r);
      if (sc > best) { best = sc; *best_ali = cur; }
      for (int i = 0; i < nx; ++i) {
        V3 xt = apply(r, x[i]);
        double* srow = &S[(size_t)i * ny];
        for (int j = 0; j < ny; ++j) {
          double dx = xt.x - yx[j], dy = xt.y - yy[j], dz = xt.z - yz[j];
          srow[j] = 1.0 / (1.0 + (dx * dx + dy * dy + dz * dz) / d02);
        }
      }
      prev = cur;
      nw_align(S.data(), nx, ny, gaps[g], &cur);
      if (cur == prev) break;
    }
    Rot r;
    double sc = tmscore_search(x, y, cur, d0, lnorm, n_tm_iter, &r);
    if (sc > best) { best = sc; *best_ali = cur; }
  }
  return best;
}

struct Result {
  double qtm, ttm, rmsd;
  int len_ali;
};

static Result tmalign_one(const float* xq, int nx, const float* xt, int ny,
                          int fast, int* ali_out) {
  std::vector<V3> x(nx), y(ny);
  for (int i = 0; i < nx; ++i) x[i] = {xq[3 * i], xq[3 * i + 1], xq[3 * i + 2]};
  for (int j = 0; j < ny; ++j) y[j] = {xt[3 * j], xt[3 * j + 1], xt[3 * j + 2]};
  double lmin = std::min(nx, ny);
  double d0 = tm_d0(lmin);
  int n_outer = fast ? 4 : 20;
  int n_tm_iter = fast ? 4 : 8;

  std::vector<std::vector<int>> inits;
  inits.emplace_back();
  init_gapless(x, y, d0, lmin, &inits.back());
  inits.emplace_back();
  init_ss(x, y, &inits.back());
  if (!fast) {
    inits.emplace_back();
    init_fragment(x, y, d0, &inits.back());
  }

  double best = -1.0;
  std::vector<int> best_ali(nx, -1);
  for (auto& ali : inits) {
    if ((int)ali.size() != nx) continue;
    std::vector<int> ba;
    double sc = dp_iterate(x, y, ali, d0, lmin, n_outer, n_tm_iter, &ba);
    if (sc > best) { best = sc; best_ali = ba; }
  }

  Result res{};
  Rot r;
  res.qtm = tmscore_search(x, y, best_ali, tm_d0(nx), nx, n_tm_iter, &r);
  res.ttm = tmscore_search(x, y, best_ali, tm_d0(ny), ny, n_tm_iter, &r);
  std::vector<int> sel;
  std::vector<V3> ysel(nx);
  for (int i = 0; i < nx; ++i)
    if (best_ali[i] >= 0) { sel.push_back(i); ysel[i] = y[best_ali[i]]; }
  res.len_ali = (int)sel.size();
  if (kabsch(x, ysel, sel, &r)) {
    double s = 0;
    for (int i : sel) s += dist2(apply(r, x[i]), ysel[i]);
    res.rmsd = std::sqrt(s / std::max((int)sel.size(), 1));
  }
  if (ali_out)
    for (int i = 0; i < nx; ++i) ali_out[i] = best_ali[i];
  return res;
}

}  // namespace

extern "C" {

// Align one pair. xq [nx*3], xt [ny*3] float32 CA coords.
// out: [qtm, ttm, rmsd, len_ali]. ali_out: nx ints (y index or -1), nullable.
int tmalign_pair(const float* xq, int nx, const float* xt, int ny, int fast,
                 double* out, int* ali_out) {
  if (nx < 3 || ny < 3) return -1;
  Result r = tmalign_one(xq, nx, xt, ny, fast, ali_out);
  out[0] = r.qtm; out[1] = r.ttm; out[2] = r.rmsd; out[3] = r.len_ali;
  return 0;
}

// Batch: coords packed back-to-back; offsets in residues (len n_pairs+1 each
// for queries and targets would be redundant — each pair carries its own
// offsets). qoff/toff[i] is the residue offset of pair i's query/target in
// xq/xt; qlen/tlen its length. out is [n_pairs*4]; ali_out (nullable) is
// packed per pair at qoff[i]. Runs on nthreads std::threads (0 = hardware).
int tmalign_batch(const float* xq, const int* qoff, const int* qlen,
                  const float* xt, const int* toff, const int* tlen,
                  int n_pairs, int fast, int nthreads, double* out,
                  int* ali_out) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, n_pairs));
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_pairs) return;
      double* o = out + 4 * i;
      int* ao = ali_out ? ali_out + qoff[i] : nullptr;
      if (tmalign_pair(xq + 3 * qoff[i], qlen[i], xt + 3 * toff[i], tlen[i],
                       fast, o, ao) != 0) {
        o[0] = o[1] = o[2] = 0.0; o[3] = 0;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
