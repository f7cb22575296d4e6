// Exact path-dependent TreeSHAP and its interaction values for Hopper
// (sm_90a): K6.
//
// No Pallas kernel: this replaces the reference's jitted XLA programs
// xgboost_tpu/interpret/device.py:114 (_bucket_phi, the SHAP values of one
// bucket of root->leaf paths) and :210 (_bucket_interactions, their
// pairwise interaction terms), which XLA runs as long chains of small
// elementwise operations over (rows, paths) with (rows, paths, nodes)
// intermediates.  Two entries, one kernel template:
//
//   xtb_treeshap               (R, F+1) f64: for every row, the sum over
//                              the buckets (in (m, D) order, in f64) of
//                              the bucket's f32 sum over its paths (in
//                              path order) of
//                                phi_i = ((o_i - z_i) v) W_i
//                              at column slot_feat[i], the bias added to
//                              column F last
//   xtb_treeshap_interactions  (R, (F+1)^2) f64: the same with, per path
//                              and slot pair s < j (in (s, j) order),
//                                term = (((v/2)(o_s - z_s))(o_j - z_j)) W_sj
//                              at [f_s, f_j] and at [f_j, f_s]: the two
//                              cells take the same terms in the same
//                              order, so one sum (of the unordered pair)
//                              is kept and written to both
//
// W_i = sum_k wk[k] c_k, with c the coefficients of prod_{j != i} (z_j +
// o_j t) built in f32 in the reference's order (j ascending, c_k <- c_k z_j
// + c_{k-1} o_j); W_sj the same over the slots other than s and j with the
// Shapley weights of m-1 elements.  The one fraction o_s of a slot is 1
// where the row follows every node of its feature on the path (NaN takes
// the node's default direction, else x < threshold).  Every multiply, add
// and subtract is its own rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn) and the library is built with --fmad=false, so each term is
// the plain version's (interpret/device.py bucket_phi_plain,
// bucket_interactions_plain) bit for bit.
//
// Design.  A term depends on the row only through the path's m one
// fractions, that is through the m-bit mask of the slots the row leaves.
// So the launch first computes, for every path of up to eight slots and
// every one of its 2^m masks, all of the path's terms (phase 1, spread
// over the whole grid; a grid barrier ends it), and each row then only
// tests its path's nodes, reads its terms at its mask and adds them into
// its f32 bucket sums (phase 2).  The terms are the same operations on the
// same values whether computed once a mask or once a row, so they keep
// their bits.  Phase 1 builds each element's coefficients from a shared
// prefix: element i's polynomial takes the elements before it in the same
// order as every element after it, so that prefix is built once a mask and
// copied (and a pair (s, j) shares its elements before j likewise).  A
// bucket is tabulated only where the host gave it room in the table (its
// budget caps the scratch of a large ensemble) and the call has at least
// 2^m rows; the others' paths, and those of more than eight slots (rare),
// compute their terms a row in phase 2, in the same order, on a per-row
// global scratch.
//
// Phase 2: one block takes row tiles in turn (a persistent grid, at most
// as many blocks as the card holds at once, as the cooperative launch
// needs).  A thread owns RT rows (rows tid + k blockDim; one or two, as
// the host plans) and their whole output: it reads each node record
// (feature, slot and flags in one int, and the threshold) once for its RT
// rows.  Phase 2 waits on its loads, not on its arithmetic, so a bucket's
// node count is a constant up to eight (the path's record and X reads all
// issued at once; past eight, the first eight so), and paths go two or
// four at a time where their registers allow (their table reads in flight
// together).  The table is read with plain loads, not through the
// read-only path (ld.global.nc), which may not hold data written in the
// same launch: the grid barrier's fences order phase 1's stores before
// them.  In shared memory where the block fits: the tile's X rows
// (feature-major), the bucket's f32 sums of only the cells the bucket
// touches (a list made on the host), and the f64 totals of only the cells
// any bucket touches (their union).  A path's
// cells are distinct, so its sums are read, added and written back as one
// batch.  At a bucket's end each thread adds its rows' f32 sums into their
// f64 totals and zeroes them; at the tile's end the block writes its rows
// of the output row-major, coalesced, with zeros at the cells no bucket
// touches and the bias added to column F.  No atomics: every cell's sum is
// taken inside one thread in path order, the same bits on every run.
// Where the tiles do not fit, the f32 sums and the f64 totals live in
// global scratch (cell-major, a column a row) and X is read in place.
//
// Bound on an H100 SXM (3.35 TB/s; an unfused f32 multiply or add at one a
// lane a clock, about 33.5e12 a second): X read once and the output
// written once, against the adds of each row's terms and phase 1's
// operations: the values and the interactions are bound by their bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// K6_ONLY_M (a build for ptxas's report alone, never loaded): phases 1 and 2
// take only the paths of that m (0: those past kSmallM), so that -Xptxas
// -v gives each m template's registers and spills
#ifdef K6_ONLY_M
#define K6_M(m) ((m) == K6_ONLY_M)
#else
#define K6_M(m) true
#endif

namespace {

constexpr int kSmallM = 8;  // largest m whose terms phase 1 tabulates
constexpr int kMaxD = 8;    // a path's nodes whose reads go out at once
constexpr int kGlobalRows = 128;  // rows a block when the tiles are global
// paths taken four at a time where a path's cells times the rows a thread
// are at most kQuadCells, two at a time where at most kPairedCells (their
// registers)
constexpr int kQuadCells = 8;
constexpr int kPairedCells = 16;
// per bucket: path begin and end, m, D, node base, slot base, weight
// offset, cell begin and end, path-cell base, table base (-1: none)
constexpr int kMeta = 11;
enum { kP0, kP1, kM, kD, kNode, kSlot, kWk, kCell0, kCell1, kPcell, kTab };

struct Tables {
  const float* X;
  int R, F, n_buckets;
  const int* meta;
  const int2* node;    // {feature << 10 | slot << 2 | went left << 1 |
                       //  default left, threshold's bits}
  const float* z;      // per path and slot
  const float* v;      // per path
  const float* wk;     // per bucket
  const int* cell_u;   // per bucket's touched cell: its index in the union
  const int* pcell;    // per path and term, its cells' bucket-local index
  const int* out_u;    // per output cell: its index in the union, or -1
  int n_union, tile_max, max_m, r_pad;
  double bias;         // added to column F of the values
  float* tab;          // per tabulated path: terms x 2^m, term-major
  double* out;         // (R, cells) f64 row-major
  float* gtile;        // (tile_max, r_pad) f32 where the tiles are global
  double* gtotal;      // (n_union, r_pad) f64 where the tiles are global
  float* poly;         // (4 max_m, r_pad) f32 where max_m > kSmallM
  unsigned* barrier;   // one zeroed counter
};

// ---------------------------------------------------------------- terms
// N > 0: m == N, the coefficient arrays in registers; N == 0: any m, the
// arrays in a per-row global scratch (a column a row).
template <int N>
struct RegArr {
  float a[N > 0 ? N : 1];
  __device__ __forceinline__ float& operator[](int k) { return a[k]; }
  __device__ __forceinline__ float operator[](int k) const { return a[k]; }
};

struct GlobalArr {
  float* p;
  size_t st;
  __device__ __forceinline__ float& operator[](int k) { return p[k * st]; }
  __device__ __forceinline__ float operator[](int k) const {
    return p[k * st];
  }
};

// the coefficients c (of pos elements) times (z + o t)
template <int N, class A>
__device__ __forceinline__ void extend(A& c, int pos, float z, float o) {
  c[pos + 1] = __fmul_rn(c[pos], o);  // c_{pos+1} was 0: 0 z + c_pos o
#pragma unroll
  for (int k = pos; k >= 1; --k)
    c[k] = __fadd_rn(__fmul_rn(c[k], z), __fmul_rn(c[k - 1], o));
  c[0] = __fmul_rn(c[0], z);
}

template <int N, class A, class B>
__device__ __forceinline__ void copy(A& dst, B& src, int n) {
#pragma unroll
  for (int k = 0; k < (N > 0 ? N : n); ++k) dst[k] = src[k];
}

// sum_k w[k] c_k over k < n, from the first product up (0 + x is x: every
// product is +0 or positive)
template <int N, class A, class W>
__device__ __forceinline__ float weight_sum(A& c, const W& w, int n) {
  float s = __fmul_rn(w[0], c[0]);
#pragma unroll
  for (int k = 1; k < n; ++k)
    s = __fadd_rn(s, __fmul_rn(w[k], c[k]));
  return s;
}

// Every term of one path at one set of one fractions, in order (element i,
// or pair (s, j)), handed to emit(q, term).  pre, qc and c are scratch
// arrays of m floats; o, z and w (the Shapley weights) are read by index.
template <bool kInter, int N, class A, class O, class Z, class W, class E>
__device__ __forceinline__ void path_terms(int m_dyn, float v, const O& o,
                                           const Z& z, const W& w, A& pre,
                                           A& qc, A& c, E&& emit) {
  const int m = N > 0 ? N : m_dyn;
  pre[0] = 1.0f;
  if constexpr (!kInter) {
#pragma unroll
    for (int i = 0; i < m; ++i) {
      // element i: the prefix of elements 0..i-1, then i+1..m-1
      copy<N>(c, pre, m);
#pragma unroll
      for (int j = i + 1; j < m; ++j) extend<N>(c, j - 1, z[j], o[j]);
      const float W = weight_sum<N>(c, w, m);
      emit(i, __fmul_rn(__fmul_rn(__fsub_rn(o[i], z[i]), v), W));
      if (i + 1 < m) extend<N>(pre, i, z[i], o[i]);
    }
  } else {
    const float hv = __fmul_rn(0.5f, v);
    int q = 0;
#pragma unroll
    for (int s = 0; s + 1 < m; ++s) {
      const float omz_s = __fsub_rn(o[s], z[s]);
      copy<N>(qc, pre, m);  // elements 0..s-1
#pragma unroll
      for (int j = s + 1; j < m; ++j) {
        copy<N>(c, qc, m);  // elements 0..s-1, s+1..j-1
#pragma unroll
        for (int e = j + 1; e < m; ++e) extend<N>(c, e - 2, z[e], o[e]);
        const float W = weight_sum<N>(c, w, m - 1);
        const float omz_j = __fsub_rn(o[j], z[j]);
        emit(q, __fmul_rn(__fmul_rn(__fmul_rn(hv, omz_s), omz_j), W));
        ++q;
        if (j + 1 < m) extend<N>(qc, j - 1, z[j], o[j]);
      }
      if (s + 2 < m) extend<N>(pre, s, z[s], o[s]);
    }
  }
}

template <bool kInter>
__host__ __device__ constexpr int n_terms(int m) {
  return kInter ? m * (m - 1) / 2 : m;
}

// Does phase 1 tabulate this bucket's terms?  Where the host gave it room
// in the table and the call has at least 2^m rows (else a row's terms
// cost less than a mask's).
__device__ __forceinline__ bool tabulated(const Tables& T, const int* b) {
  return b[kTab] >= 0 && b[kM] <= kSmallM && (1 << b[kM]) <= T.R;
}

// The bucket's Shapley weights, in registers (m of them, m - 1 for pairs)
template <bool kInter, int M>
__device__ __forceinline__ RegArr<M> weights(const Tables& T, const int* b) {
  RegArr<M> w;
#pragma unroll
  for (int k = 0; k < M; ++k)
    w[k] = k < (kInter ? M - 1 : M) ? __ldg(T.wk + b[kWk] + k) : 0.0f;
  return w;
}

// Phase 1 for one bucket of m == M: every (path, mask) of the bucket, the
// items spread over the grid, mask fastest (coalesced stores).
template <bool kInter, int M>
__device__ void build_bucket(const Tables& T, const int* b, int gtid,
                             int nthr) {
  constexpr int NT = n_terms<kInter>(M);
  const int P = b[kP1] - b[kP0];
  const RegArr<M> w = weights<kInter, M>(T, b);
  for (int it = gtid; it < (P << M); it += nthr) {
    const int p = it >> M, mask = it & ((1 << M) - 1);
    RegArr<M> o, z, pre, qc, c;
#pragma unroll
    for (int s = 0; s < M; ++s) {
      o[s] = (mask >> s) & 1 ? 0.0f : 1.0f;
      z[s] = __ldg(T.z + b[kSlot] + p * M + s);
      pre[s] = qc[s] = c[s] = 0.0f;
    }
    float* out = T.tab + b[kTab] + (size_t)p * (NT << M) + mask;
    path_terms<kInter, M>(M, __ldg(T.v + b[kP0] + p), o, z, w, pre, qc, c,
                          [&](int q, float t) { out[q << M] = t; });
  }
}

// ---------------------------------------------------------------- rows
// does the row leave the path at this node?
__device__ __forceinline__ bool leaves_path(float x, float thr, int word) {
  const bool gol = isnan(x) ? (word & 1) != 0 : x < thr;
  return gol != ((word & 2) != 0);
}

// A thread's view of its rows: X of feature f, row k at x[f xf + k xk];
// the bucket's f32 sums at tile[i ts + k tk]; the f64 totals at
// tot[u us + k tk].
struct RowView {
  const float* x;
  size_t xf, xk;
  float* tile;
  double* tot;
  size_t ts, us, tk;
};

// a cell's offset in the tile: 32 bits in shared memory
template <bool kSmem>
struct Off {
  using type = size_t;
};
template <>
struct Off<true> {
  using type = unsigned;
};

// The thread's RT rows' masks at one path: bit s set where the row leaves
// the path at a node of slot s.  D > 0: the path's D node records, then
// all their X reads, issued before the first test; D == 0: d_dyn nodes,
// the first kMaxD issued so (predicated), the rest one after another (a
// path whose features repeat).
template <int D, int RT>
__device__ __forceinline__ void path_masks(const int2* node, int d_dyn,
                                           const RowView& V,
                                           unsigned (&bad)[RT]) {
  constexpr int kHead = D > 0 ? D : kMaxD;
  const int n = D > 0 ? D : d_dyn;
#pragma unroll
  for (int k = 0; k < RT; ++k) bad[k] = 0u;
  int2 rec[kHead];
  float x[kHead][RT];
#pragma unroll
  for (int d = 0; d < kHead; ++d)
    if (D > 0 || d < n) rec[d] = __ldg(node + d);
#pragma unroll
  for (int d = 0; d < kHead; ++d) {
    if (D > 0 || d < n) {
      const float* xf = V.x + (size_t)(rec[d].x >> 10) * V.xf;
#pragma unroll
      for (int k = 0; k < RT; ++k) x[d][k] = xf[k * V.xk];
    }
  }
#pragma unroll
  for (int d = 0; d < kHead; ++d) {
    if (D > 0 || d < n) {
      const float thr = __int_as_float(rec[d].y);
      const unsigned bit = 1u << ((rec[d].x >> 2) & 255);
#pragma unroll
      for (int k = 0; k < RT; ++k)
        if (leaves_path(x[d][k], thr, rec[d].x)) bad[k] |= bit;
    }
  }
  if constexpr (D == 0) {
    for (int d = kMaxD; d < n; ++d) {
      const int2 r = __ldg(node + d);
      const float thr = __int_as_float(r.y);
      const float* xf = V.x + (size_t)(r.x >> 10) * V.xf;
      const unsigned bit = 1u << ((r.x >> 2) & 255);
#pragma unroll
      for (int k = 0; k < RT; ++k)
        if (leaves_path(xf[k * V.xk], thr, r.x)) bad[k] |= bit;
    }
  }
}

// NP paths (p, p+1, ...) of a tabulated bucket of m == M and D nodes (0:
// any): each path's nodes tested once for the thread's RT rows, its terms
// read at each row's mask, all of that issued for the NP paths together;
// then each path's terms added into its rows' sums, path after path, each
// path's as one batch (its cells are distinct).
template <bool kInter, int M, int RT, bool kSmem, int D, int NP>
__device__ __forceinline__ void paths_step(const Tables& T, const int* b,
                                           const RowView& V, int p) {
  using O = typename Off<kSmem>::type;
  constexpr int NT = n_terms<kInter>(M);
  const int Dn = D > 0 ? D : b[kD];
  unsigned bad[NP][RT];
  O cell[NP][NT];
  float term[NP][RT][NT];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int* pc = T.pcell + b[kPcell] + (p + i) * NT;
#pragma unroll
    for (int c = 0; c < NT; ++c) cell[i][c] = (O)__ldg(pc + c) * (O)V.ts;
    path_masks<D, RT>(T.node + b[kNode] + (p + i) * Dn, Dn, V, bad[i]);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float* tp = T.tab + b[kTab] + (size_t)(p + i) * (NT << M);
#pragma unroll
    for (int k = 0; k < RT; ++k)
#pragma unroll
      for (int q = 0; q < NT; ++q)
        term[i][k][q] = tp[(q << M) + bad[i][k]];
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      float* tile = V.tile + k * V.tk;
      float acc[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) acc[c] = tile[cell[i][c]];
#pragma unroll
      for (int c = 0; c < NT; ++c) acc[c] = __fadd_rn(acc[c], term[i][k][c]);
#pragma unroll
      for (int c = 0; c < NT; ++c) tile[cell[i][c]] = acc[c];
    }
  }
}

// Phase 2 for one tabulated bucket of m == M and D nodes (0: any): its
// paths four or two at a time where their registers allow, one at a time
// otherwise.
template <bool kInter, int M, int RT, bool kSmem, int D>
__device__ __forceinline__ void rows_small_d(const Tables& T, const int* b,
                                             const RowView& V) {
  constexpr int NT = n_terms<kInter>(M);
  constexpr int NP = NT * RT <= kQuadCells     ? 4
                     : NT * RT <= kPairedCells ? 2
                                               : 1;
  const int P = b[kP1] - b[kP0];
  int p = 0;
  for (; p + NP <= P; p += NP)
    paths_step<kInter, M, RT, kSmem, D, NP>(T, b, V, p);
  if constexpr (NP > 1) {
    for (; p < P; ++p) paths_step<kInter, M, RT, kSmem, D, 1>(T, b, V, p);
  }
}

// Phase 2 for one tabulated bucket of m == M: its node count made a
// constant up to eight (m <= D always) where the tiles are in shared
// memory (a runtime count slows the loads that go out together: measured
// in PERF.md).
template <bool kInter, int M, int RT, bool kSmem>
__device__ __forceinline__ void rows_small(const Tables& T, const int* b,
                                           const RowView& V) {
  if constexpr (kSmem) switch (b[kD]) {
#define K6_NODES(d)                                          \
  case d:                                                    \
    if constexpr (d >= M) {                                  \
      rows_small_d<kInter, M, RT, kSmem, d>(T, b, V);        \
      return;                                                \
    }                                                        \
    break;
    K6_NODES(1)
    K6_NODES(2)
    K6_NODES(3)
    K6_NODES(4)
    K6_NODES(5)
    K6_NODES(6)
    K6_NODES(7)
    K6_NODES(8)
#undef K6_NODES
    default: break;
  }
  rows_small_d<kInter, M, RT, kSmem, 0>(T, b, V);
}

// Phase 2 for a bucket that phase 1 did not tabulate (m > kSmallM, no
// room in the table, or fewer rows than masks): each row's terms computed
// in the same order on its global scratch (o, pre, qc, c: m floats each),
// which keeps this rare path from raising every kernel's registers.
template <bool kInter, int RT>
__device__ void rows_general(const Tables& T, const int* b, const RowView& V,
                             int row0) {
  const int P = b[kP1] - b[kP0], m = b[kM], D = b[kD];
  const int2* node = T.node + b[kNode];
  const int* pcell = T.pcell + b[kPcell];
  const float* w = T.wk + b[kWk];
  const int nt = kInter ? m * (m - 1) / 2 : m;
  const size_t st = (size_t)T.r_pad;
  for (int k = 0; k < RT; ++k) {
    float* base = T.poly + row0 + k * V.tk;
    GlobalArr o{base, st}, pre{base + T.max_m * st, st},
        qc{base + 2 * T.max_m * st, st}, c{base + 3 * T.max_m * st, st};
    float* tile = V.tile + k * V.tk;
    for (int p = 0; p < P; ++p) {
      for (int s = 0; s < m; ++s) o[s] = 1.0f;
      for (int d = 0; d < D; ++d) {
        const int2 rec = __ldg(node + p * D + d);
        const float x = V.x[(size_t)(rec.x >> 10) * V.xf + k * V.xk];
        if (leaves_path(x, __int_as_float(rec.y), rec.x))
          o[(rec.x >> 2) & 255] = 0.0f;
      }
      const float* z = T.z + b[kSlot] + (size_t)p * m;
      const int* pc = pcell + (size_t)p * nt;
      path_terms<kInter, 0>(m, T.v[b[kP0] + p], o, z, w, pre, qc, c,
                            [&](int q, float t) {
                              float& a = tile[pc[q] * V.ts];
                              a = __fadd_rn(a, t);
                            });
    }
  }
}

template <bool kInter, int RT, bool kSmem>
__device__ __forceinline__ void rows_bucket(const Tables& T, const int* b,
                                            const RowView& V, int row0) {
  switch (tabulated(T, b) ? b[kM] : 0) {
#define K6_ROWS(m)                                                   \
  case m:                                                            \
    if constexpr (K6_M(m) && (m > 1 || !kInter))                     \
      rows_small<kInter, m, RT, kSmem>(T, b, V);                     \
    break;
    K6_ROWS(1)  // no pairs: the interaction tables hold m >= 2 only
    K6_ROWS(2)
    K6_ROWS(3)
    K6_ROWS(4)
    K6_ROWS(5)
    K6_ROWS(6)
    K6_ROWS(7)
    K6_ROWS(8)
#undef K6_ROWS
    default:
      if constexpr (K6_M(0)) rows_general<kInter, RT>(T, b, V, row0);
  }
}

template <bool kInter>
__device__ void build_tables(const Tables& T) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  for (int bi = 0; bi < T.n_buckets; ++bi) {
    const int* b = T.meta + bi * kMeta;
    if (!tabulated(T, b)) continue;  // its terms computed a row in phase 2
    switch (b[kM]) {
#define K6_BUILD(m)                                                  \
  case m:                                                            \
    if constexpr (K6_M(m) && (m > 1 || !kInter))                     \
      build_bucket<kInter, m>(T, b, gtid, nthr);                     \
    break;
      K6_BUILD(1)
      K6_BUILD(2)
      K6_BUILD(3)
      K6_BUILD(4)
      K6_BUILD(5)
      K6_BUILD(6)
      K6_BUILD(7)
      K6_BUILD(8)
#undef K6_BUILD
      default: break;
    }
  }
}

// Every block arrives once; the cooperative launch keeps the whole grid on
// the card at once, so the wait ends.
__device__ __forceinline__ void grid_barrier(unsigned* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1u);
    while (*(volatile unsigned*)counter < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// kSmem: the tile's X rows, f32 sums and f64 totals in shared memory
// (totals at a stride of rows + 1, so that the output's reads across cells
// fall in distinct banks); else X read in place and both in global scratch.
template <bool kInter, int RT, bool kSmem>
__global__ void treeshap_kernel(const Tables T) {
  extern __shared__ __align__(16) unsigned char smem[];
  build_tables<kInter>(T);
  grid_barrier(T.barrier);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int rows = nt * RT;
  const int F = T.F, C = kInter ? (F + 1) * (F + 1) : F + 1;
  const int n_tiles = (T.R + rows - 1) / rows;
  const size_t us = kSmem ? (size_t)rows + 1 : (size_t)T.r_pad;
  double* tot_s = reinterpret_cast<double*>(smem);
  float* xs = reinterpret_cast<float*>(tot_s + (size_t)T.n_union * us);
  float* tile_s = xs + (size_t)F * rows;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * rows;
    RowView V;
    if constexpr (kSmem) {
      __syncthreads();  // the previous tile's output is written
      for (int i = tid; i < rows * F; i += nt) {
        const int r = i / F, f = i - r * F;
        xs[(size_t)f * rows + r] =
            row0 + r < T.R ? T.X[(size_t)(row0 + r) * F + f] : 0.0f;
      }
      V = RowView{xs + tid, (size_t)rows, (size_t)nt, tile_s + tid,
                  tot_s + tid, (size_t)rows, us, (size_t)nt};
    } else {
      // RT == 1: rows past R read the last row and write their scratch
      // columns (r_pad of them), never the output
      const int row = row0 + tid;
      V = RowView{T.X + (size_t)min(row, T.R - 1) * F, 1, 0,
                  T.gtile + row, T.gtotal + row, (size_t)T.r_pad, us, 0};
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      for (int i = 0; i < T.tile_max; ++i) V.tile[i * V.ts + k * V.tk] = 0.0f;
      for (int u = 0; u < T.n_union; ++u) V.tot[u * V.us + k * V.tk] = 0.0;
    }
    if constexpr (kSmem) __syncthreads();
    for (int bi = 0; bi < T.n_buckets; ++bi) {
      const int* b = T.meta + bi * kMeta;
      rows_bucket<kInter, RT, kSmem>(T, b, V, row0 + tid);
      const int c0 = b[kCell0], n = b[kCell1] - c0;
      for (int i = 0; i < n; ++i) {  // the cells this bucket touched
        const size_t u = (size_t)__ldg(T.cell_u + c0 + i) * V.us;
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          float& s = V.tile[i * V.ts + k * V.tk];
          V.tot[u + k * V.tk] += (double)s;
          s = 0.0f;
        }
      }
    }
    // every thread's totals are written (the output reads other rows')
    __syncthreads();
    const double* tot = kSmem ? tot_s : T.gtotal + row0;
    const int nr = min(rows, T.R - row0);
    double* out = T.out + (size_t)row0 * C;
    for (int r = 0; r < nr; ++r) {
      for (int c = tid; c < C; c += nt) {
        const int u = __ldg(T.out_u + c);
        double val = u >= 0 ? tot[u * us + r] : 0.0;
        if (!kInter && c == F) val += T.bias;
        out[(size_t)r * C + c] = val;
      }
    }
  }
}

// The first error of a call, with the runtime's last-error state cleared,
// so that a refused launch does not surface again at the next one.
int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

constexpr int kMaxDevices = 64;

// A kernel's launch on the current device: shared memory above 48 KB
// opted into once a device and size (so that a launch captured into a CUDA
// graph makes no such call), the SMs counted once a device, and the blocks
// an SM holds at this size asked each launch (a host-side computation).
template <bool kInter, int RT, bool kSmem>
int launch_kernel(const Tables& T, int threads, size_t bytes,
                  cudaStream_t s) {
  static size_t allowed[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  auto kernel = treeshap_kernel<kInter, RT, kSmem>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return status(err);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return status(err);
    allowed[dev] = bytes;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return status(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return status(err);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(T.barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return status(err);
  Tables arg = T;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3(per_sm * sms[dev]), dim3(threads),
                                    args, bytes, s);
  return status(err);
}

template <bool kInter>
int launch(const Tables& T, int rows_per_block, int rows_per_thread,
           void* stream) {
  if (T.R < 1 || T.F < 1 || T.n_buckets < 0 || T.max_m < 1 ||
      T.n_union < 0 || T.tile_max < 0 || rows_per_block < 0 ||
      T.barrier == nullptr || T.r_pad < T.R)
    return (int)cudaErrorInvalidValue;
  if (T.max_m > kSmallM && T.poly == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block_rows = rows_per_block > 0 ? rows_per_block : kGlobalRows;
  if ((long long)T.r_pad < ((long long)T.R + block_rows - 1) / block_rows *
                               block_rows)
    return (int)cudaErrorInvalidValue;  // the scratch's columns
  if (rows_per_block == 0) {  // the tiles in global memory, a row a thread
    if (T.gtile == nullptr || T.gtotal == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_kernel<kInter, 1, false>(T, kGlobalRows, 0, s);
  }
  const int rt = rows_per_thread;
  if (rt < 1 || rows_per_block % rt != 0) return (int)cudaErrorInvalidValue;
  const int threads = rows_per_block / rt;
  const size_t rows = (size_t)rows_per_block;
  const size_t bytes = 8 * (size_t)T.n_union * (rows + 1) +
                       4 * rows * ((size_t)T.F + T.tile_max);
  switch (rt) {
    case 1: return launch_kernel<kInter, 1, true>(T, threads, bytes, s);
    case 2: return launch_kernel<kInter, 2, true>(T, threads, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Tables tables(const void* X, int R, int F, int n_buckets, const void* meta,
              const void* node, const void* z, const void* v, const void* wk,
              const void* cell_u, const void* pcell, const void* out_u,
              int n_union, int tile_max, int max_m, int r_pad, double bias,
              void* tab, void* out, void* gtile, void* gtotal, void* poly,
              void* barrier) {
  Tables T;
  T.X = static_cast<const float*>(X);
  T.R = R;
  T.F = F;
  T.n_buckets = n_buckets;
  T.meta = static_cast<const int*>(meta);
  T.node = static_cast<const int2*>(node);
  T.z = static_cast<const float*>(z);
  T.v = static_cast<const float*>(v);
  T.wk = static_cast<const float*>(wk);
  T.cell_u = static_cast<const int*>(cell_u);
  T.pcell = static_cast<const int*>(pcell);
  T.out_u = static_cast<const int*>(out_u);
  T.n_union = n_union;
  T.tile_max = tile_max;
  T.max_m = max_m;
  T.r_pad = r_pad;
  T.bias = bias;
  T.tab = static_cast<float*>(tab);
  T.out = static_cast<double*>(out);
  T.gtile = static_cast<float*>(gtile);
  T.gtotal = static_cast<double*>(gtotal);
  T.poly = static_cast<float*>(poly);
  T.barrier = static_cast<unsigned*>(barrier);
  return T;
}

}  // namespace

extern "C" {

// X (R, F) f32 row-major; the tables as ops/treeshap_cuda.py pack_tables
// lays them out, all on the current device; tab f32, room for every
// bucket that phase 1 tabulates at this R (meta's table base plus P terms
// x 2^m); out (R, F+1) f64, written whole; rows_per_block rows a block of
// rows_per_thread rows a thread (1 or 2), or 0 for the tiles in global
// memory: then gtile (tile_max, r_pad) f32 and gtotal (n_union, r_pad)
// f64, else null; poly (4 max_m, r_pad) f32 where a bucket is not
// tabulated at this R (m > 8, no room in the table, or R < 2^m), else
// null;
// r_pad a multiple of the rows a block (128 for the global tiles) at least
// R; barrier one int32.  Returns a cudaError_t.
int xtb_treeshap(const void* X, int R, int F, int n_buckets, const void* meta,
                 const void* node, const void* z, const void* v,
                 const void* wk, const void* cell_u, const void* pcell,
                 const void* out_u, int n_union, int tile_max, int max_m,
                 int r_pad, double bias, int rows_per_block,
                 int rows_per_thread, void* tab, void* out, void* gtile,
                 void* gtotal, void* poly, void* barrier, void* stream) {
  return launch<false>(
      tables(X, R, F, n_buckets, meta, node, z, v, wk, cell_u, pcell, out_u,
             n_union, tile_max, max_m, r_pad, bias, tab, out, gtile, gtotal,
             poly, barrier),
      rows_per_block, rows_per_thread, stream);
}

// The same for the interaction terms: out (R, (F+1)^2) f64; every bucket
// has m >= 2; the bias is not added.
int xtb_treeshap_interactions(
    const void* X, int R, int F, int n_buckets, const void* meta,
    const void* node, const void* z, const void* v, const void* wk,
    const void* cell_u, const void* pcell, const void* out_u, int n_union,
    int tile_max, int max_m, int r_pad, double bias, int rows_per_block,
    int rows_per_thread, void* tab, void* out, void* gtile, void* gtotal,
    void* poly, void* barrier, void* stream) {
  return launch<true>(
      tables(X, R, F, n_buckets, meta, node, z, v, wk, cell_u, pcell, out_u,
             n_union, tile_max, max_m, r_pad, bias, tab, out, gtile, gtotal,
             poly, barrier),
      rows_per_block, rows_per_thread, stream);
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
