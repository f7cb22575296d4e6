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
//   xtb_treeshap               (F+1, R) f64: for every row, the sum over
//                              the buckets (in (m, D) order, in f64) of
//                              the bucket's f32 sum over its paths (in
//                              path order) of
//                                phi_i = ((o_i - z_i) v) W_i
//                              at column slot_feat[i]
//   xtb_treeshap_interactions  ((F+1)^2, R) f64: the same with, per path
//                              and slot pair s < j,
//                                term = (((v/2)(o_s - z_s))(o_j - z_j)) W_sj
//                              at [f_s, f_j] and at [f_j, f_s]
//
// W_i = sum_k wk[k] c_k, from zero upward, with c the coefficients of
// prod_{j != i} (z_j + o_j t) built in f32 in the reference's order (j
// ascending, c_k <- c_k z_j + c_{k-1} o_j); W_sj the same over the slots
// other than s and j with the Shapley weights of m-1 elements.  The one
// fraction o_s of a slot is 1 where the row follows every node of its
// feature on the path (NaN takes the node's default direction, else
// x < threshold).  Every multiply, add and subtract is its own rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn) and the library is built
// with --fmad=false, so each term is the plain version's
// (interpret/device.py bucket_phi_plain, bucket_interactions_plain) bit
// for bit; sums differ from the plain version's only by index_add_'s
// order on the card.
//
// Bound on an H100 SXM (67 TFLOP/s f32, 3.35 TB/s): the work is f32
// arithmetic, about m (2(m-1) + 1.5(m-1)(m-2) + 2m + 4) operations a
// (row, path) for the values and (m(m-1)/2) (2(m-2) + 1.5(m-2)(m-3)
// + 2(m-1) + 7) for the interactions, against X read once (4 F bytes a
// row) and the output written once (8 (F+1) or 8 (F+1)^2 bytes a row): at
// depth 6 and F = 28 the values are bound by the operations, the
// interactions at small m by the bytes of their output.
//
// Design.  One thread owns one row and its whole output; the rows of a
// block walk the same paths in step, so the path tables are read as
// broadcasts.  The row's f32 bucket sums and f64 totals live in shared
// memory where a block of 128, 64 or 32 rows fits (the block's X rows are
// staged there too), cell-major with a stride of rows + 1 so that each
// warp's accesses fall in distinct banks; otherwise in global memory,
// cell-major (rows contiguous, so a warp's accesses coalesce).  At a
// bucket's end each thread adds its own f32 sums of the cells the bucket
// touches (a list made on the host) into its f64 totals and zeroes them:
// no atomics, no second pass, the same bits on every run.  Paths of up to
// eight unique features keep their coefficients in registers (fully
// unrolled per m); longer paths keep them in a per-row global scratch
// (2 max_m floats a row, cell-major), so any m a model has is taken.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmallM = 8;       // largest m with register coefficients
constexpr int kGlobalRows = 128; // block size when the tiles are global
constexpr int kMeta = 9;         // ints per bucket in the meta table
constexpr int kNoSkip = 1 << 30;

struct Tables {
  const float* X;
  int R, F, n_buckets;
  // per bucket: path begin, path end, m, D, node base, slot base, weight
  // offset, cell begin, cell end
  const int* meta;
  const int* node_feat;
  const float* node_thr;
  const uint8_t* node_flags;  // bit 0: default left, bit 1: went left
  const int* node_slot;
  const float* z;
  const int* slot_feat;
  const float* v;
  const float* wk;
  const int* cells;
  int max_m;
  double* out;   // (cells, R) f64
  float* scratch;  // (cells, R) f32 in global mode, else null
  float* poly;     // (2 max_m, R) f32 where max_m > kSmallM, else null
};

// a slot's one fractions and a path's coefficients in registers
template <int M>
struct RegPoly {
  float c[M], o[M], z[M];
  __device__ __forceinline__ float& C(int k) { return c[k]; }
  __device__ __forceinline__ float O(int s) const { return o[s]; }
  __device__ __forceinline__ float Z(int s) const { return z[s]; }
};

// the same in a per-row global scratch, cell-major
struct GlobalPoly {
  float* c;
  float* o;
  const float* z;
  size_t st;
  __device__ __forceinline__ float& C(int k) { return c[k * st]; }
  __device__ __forceinline__ float O(int s) const { return o[s * st]; }
  __device__ __forceinline__ float Z(int s) const { return z[s]; }
};

// sum_k wk[k] c_k over the n slots other than sa and sb (sa < sb)
template <int N, class Poly>
__device__ __forceinline__ float weight_sum(Poly& P, int n_dyn, int sa,
                                            int sb, const float* wk) {
  const int n = N >= 0 ? N : n_dyn;
  P.C(0) = 1.0f;
#pragma unroll
  for (int jj = 0; jj < n; ++jj) {
    int e = jj;
    e += e >= sa;
    e += e >= sb;
    const float ze = P.Z(e), oe = P.O(e);
    P.C(jj + 1) = __fmul_rn(P.C(jj), oe);  // c_{jj+1} was 0: 0 z + c o
#pragma unroll
    for (int k = jj; k >= 1; --k)
      P.C(k) = __fadd_rn(__fmul_rn(P.C(k), ze), __fmul_rn(P.C(k - 1), oe));
    P.C(0) = __fmul_rn(P.C(0), ze);
  }
  float W = 0.0f;
#pragma unroll
  for (int k = 0; k <= n; ++k) W = __fadd_rn(W, __fmul_rn(wk[k], P.C(k)));
  return W;
}

// One path's terms into the row's f32 tile (tile[cell * st]).  M > 0:
// m == M with registers; M == 0: any m, P in global scratch.
template <bool kInter, int M, class Poly>
__device__ __forceinline__ void path_terms(Poly& P, int m, float v,
                                           const int* sfeat, int F1,
                                           const float* wk, float* tile,
                                           size_t st) {
  const int mm = M > 0 ? M : m;
  if constexpr (!kInter) {
#pragma unroll
    for (int i = 0; i < mm; ++i) {
      const float W = weight_sum<M - 1>(P, mm - 1, i, kNoSkip, wk);
      const float phi =
          __fmul_rn(__fmul_rn(__fsub_rn(P.O(i), P.Z(i)), v), W);
      float& cell = tile[sfeat[i] * st];
      cell = __fadd_rn(cell, phi);
    }
  } else {
    const float hv = __fmul_rn(0.5f, v);
#pragma unroll
    for (int s = 0; s < mm; ++s) {
      const float omz_s = __fsub_rn(P.O(s), P.Z(s));
#pragma unroll
      for (int j = s + 1; j < mm; ++j) {
        const float W = weight_sum<M - 2>(P, mm - 2, s, j, wk);
        const float omz_j = __fsub_rn(P.O(j), P.Z(j));
        const float term =
            __fmul_rn(__fmul_rn(__fmul_rn(hv, omz_s), omz_j), W);
        float& a = tile[(sfeat[s] * F1 + sfeat[j]) * st];
        a = __fadd_rn(a, term);
        float& b = tile[(sfeat[j] * F1 + sfeat[s]) * st];
        b = __fadd_rn(b, term);
      }
    }
  }
}

// does the row leave the path at this node?
__device__ __forceinline__ bool leaves_path(float x, float thr,
                                            uint8_t flags) {
  const bool gol = isnan(x) ? (flags & 1) != 0 : x < thr;
  return gol != ((flags & 2) != 0);
}

template <bool kInter, int M>
__device__ __forceinline__ void bucket_small(const Tables& T, const int* b,
                                             const float* xrow, size_t xst,
                                             float* tile, size_t st) {
  const int p0 = b[0], p1 = b[1], D = b[3];
  const float* wk = T.wk + b[6];
  const int F1 = T.F + 1;
  for (int p = p0; p < p1; ++p) {
    const int nb = b[4] + (p - p0) * D, sb = b[5] + (p - p0) * M;
    unsigned bad = 0;
    for (int d = 0; d < D; ++d) {
      const float x = xrow[T.node_feat[nb + d] * xst];
      if (leaves_path(x, T.node_thr[nb + d], T.node_flags[nb + d]))
        bad |= 1u << T.node_slot[nb + d];
    }
    RegPoly<M> P;
#pragma unroll
    for (int s = 0; s < M; ++s) {
      P.o[s] = (bad >> s) & 1u ? 0.0f : 1.0f;
      P.z[s] = T.z[sb + s];
    }
    path_terms<kInter, M>(P, M, T.v[p], T.slot_feat + sb, F1, wk, tile, st);
  }
}

template <bool kInter>
__device__ void bucket_general(const Tables& T, const int* b, int row,
                               const float* xrow, size_t xst, float* tile,
                               size_t st) {
  const int p0 = b[0], p1 = b[1], m = b[2], D = b[3];
  const float* wk = T.wk + b[6];
  const int F1 = T.F + 1;
  GlobalPoly P;
  P.st = (size_t)T.R;
  P.c = T.poly + row;
  P.o = T.poly + (size_t)T.max_m * T.R + row;
  for (int p = p0; p < p1; ++p) {
    const int nb = b[4] + (p - p0) * D, sb = b[5] + (p - p0) * m;
    for (int s = 0; s < m; ++s) P.o[s * P.st] = 1.0f;
    for (int d = 0; d < D; ++d) {
      const float x = xrow[T.node_feat[nb + d] * xst];
      if (leaves_path(x, T.node_thr[nb + d], T.node_flags[nb + d]))
        P.o[T.node_slot[nb + d] * P.st] = 0.0f;
    }
    P.z = T.z + sb;
    path_terms<kInter, 0>(P, m, T.v[p], T.slot_feat + sb, F1, wk, tile, st);
  }
}

template <bool kInter>
__device__ void bucket(const Tables& T, const int* b, int row,
                       const float* xrow, size_t xst, float* tile,
                       size_t st) {
  switch (b[2]) {
    case 1:  // no pairs: the interaction tables hold m >= 2 only
      if constexpr (!kInter) bucket_small<kInter, 1>(T, b, xrow, xst, tile,
                                                     st);
      break;
    case 2: bucket_small<kInter, 2>(T, b, xrow, xst, tile, st); break;
    case 3: bucket_small<kInter, 3>(T, b, xrow, xst, tile, st); break;
    case 4: bucket_small<kInter, 4>(T, b, xrow, xst, tile, st); break;
    case 5: bucket_small<kInter, 5>(T, b, xrow, xst, tile, st); break;
    case 6: bucket_small<kInter, 6>(T, b, xrow, xst, tile, st); break;
    case 7: bucket_small<kInter, 7>(T, b, xrow, xst, tile, st); break;
    case 8: bucket_small<kInter, 8>(T, b, xrow, xst, tile, st); break;
    default: bucket_general<kInter>(T, b, row, xrow, xst, tile, st);
  }
}

// kSmem: the block's X rows, f32 sums and f64 totals in shared memory
// (blockDim.x rows, stride blockDim.x + 1); else X read in place and both
// tiles in global memory (stride R).
template <bool kInter, bool kSmem>
__global__ void treeshap_kernel(const Tables T, int n_cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rows = blockDim.x;
  const int row0 = blockIdx.x * rows;
  const int row = row0 + tid;
  const bool active = row < T.R;
  const float* xrow;
  size_t xst;
  float* tile;
  double* total;
  size_t st;
  if constexpr (kSmem) {
    st = (size_t)rows + 1;
    total = reinterpret_cast<double*>(smem) + tid;
    float* xs = reinterpret_cast<float*>(
        reinterpret_cast<double*>(smem) + (size_t)n_cells * st);
    tile = xs + (size_t)T.F * st + tid;
    // the block's rows of X, read coalesced, stored feature-major
    for (int i = tid; i < rows * T.F; i += rows) {
      const int r = i / T.F, f = i - r * T.F;
      xs[f * st + r] = row0 + r < T.R ? T.X[(size_t)(row0 + r) * T.F + f]
                                      : 0.0f;
    }
    xrow = xs + tid;
    xst = st;
    __syncthreads();
  } else {
    if (!active) return;
    st = (size_t)T.R;
    total = T.out + row;
    tile = T.scratch + row;
    xrow = T.X + (size_t)row * T.F;
    xst = 1;
  }
  if (!active) return;
  for (int c = 0; c < n_cells; ++c) {
    total[c * st] = 0.0;
    tile[c * st] = 0.0f;
  }
  for (int bi = 0; bi < T.n_buckets; ++bi) {
    const int* b = T.meta + bi * kMeta;
    bucket<kInter>(T, b, row, xrow, xst, tile, st);
    for (int i = b[7]; i < b[8]; ++i) {  // the cells this bucket touched
      const size_t c = (size_t)T.cells[i] * st;
      total[c] += (double)tile[c];
      tile[c] = 0.0f;
    }
  }
  if constexpr (kSmem) {
    for (int c = 0; c < n_cells; ++c)
      T.out[(size_t)c * T.R + row] = total[c * st];
  }
}

// The first error of a call, with the runtime's last-error state cleared,
// so that a refused launch does not surface again at the next one.
int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <bool kInter>
int launch(const Tables& T, int rows_per_block, void* stream) {
  const int n_cells = kInter ? (T.F + 1) * (T.F + 1) : T.F + 1;
  if (T.R < 1 || T.F < 1 || T.n_buckets < 0 || T.max_m < 1 ||
      rows_per_block < 0)
    return (int)cudaErrorInvalidValue;
  if (T.max_m > kSmallM && T.poly == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block > 0) {
    const size_t st = (size_t)rows_per_block + 1;
    const size_t bytes =
        st * ((size_t)n_cells * 8 + ((size_t)T.F + n_cells) * 4);
    cudaError_t err = cudaFuncSetAttribute(
        treeshap_kernel<kInter, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return status(err);
    const int grid = (T.R + rows_per_block - 1) / rows_per_block;
    treeshap_kernel<kInter, true><<<grid, rows_per_block, bytes, s>>>(
        T, n_cells);
  } else {
    if (T.scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int grid = (T.R + kGlobalRows - 1) / kGlobalRows;
    treeshap_kernel<kInter, false><<<grid, kGlobalRows, 0, s>>>(T, n_cells);
  }
  return status(cudaGetLastError());
}

Tables tables(const void* X, int R, int F, int n_buckets, const void* meta,
              const void* node_feat, const void* node_thr,
              const void* node_flags, const void* node_slot, const void* z,
              const void* slot_feat, const void* v, const void* wk,
              const void* cells, int max_m, void* out, void* scratch,
              void* poly) {
  Tables T;
  T.X = static_cast<const float*>(X);
  T.R = R;
  T.F = F;
  T.n_buckets = n_buckets;
  T.meta = static_cast<const int*>(meta);
  T.node_feat = static_cast<const int*>(node_feat);
  T.node_thr = static_cast<const float*>(node_thr);
  T.node_flags = static_cast<const uint8_t*>(node_flags);
  T.node_slot = static_cast<const int*>(node_slot);
  T.z = static_cast<const float*>(z);
  T.slot_feat = static_cast<const int*>(slot_feat);
  T.v = static_cast<const float*>(v);
  T.wk = static_cast<const float*>(wk);
  T.cells = static_cast<const int*>(cells);
  T.max_m = max_m;
  T.out = static_cast<double*>(out);
  T.scratch = static_cast<float*>(scratch);
  T.poly = static_cast<float*>(poly);
  return T;
}

}  // namespace

extern "C" {

// X (R, F) f32 row-major; the tables as ops/treeshap_cuda.py pack_tables
// lays them out, all on the current device; out (F+1, R) f64, written
// whole; scratch (F+1, R) f32 where rows_per_block is 0 (the tiles in
// global memory), else null; poly (2 max_m, R) f32 where max_m > 8, else
// null.  Returns a cudaError_t.
int xtb_treeshap(const void* X, int R, int F, int n_buckets, const void* meta,
                 const void* node_feat, const void* node_thr,
                 const void* node_flags, const void* node_slot,
                 const void* z, const void* slot_feat, const void* v,
                 const void* wk, const void* cells, int max_m,
                 int rows_per_block, void* out, void* scratch, void* poly,
                 void* stream) {
  return launch<false>(
      tables(X, R, F, n_buckets, meta, node_feat, node_thr, node_flags,
             node_slot, z, slot_feat, v, wk, cells, max_m, out, scratch,
             poly),
      rows_per_block, stream);
}

// The same for the interaction terms: out ((F+1)^2, R) f64, scratch
// ((F+1)^2, R) f32 where rows_per_block is 0; every bucket has m >= 2.
int xtb_treeshap_interactions(
    const void* X, int R, int F, int n_buckets, const void* meta,
    const void* node_feat, const void* node_thr, const void* node_flags,
    const void* node_slot, const void* z, const void* slot_feat,
    const void* v, const void* wk, const void* cells, int max_m,
    int rows_per_block, void* out, void* scratch, void* poly, void* stream) {
  return launch<true>(
      tables(X, R, F, n_buckets, meta, node_feat, node_thr, node_flags,
             node_slot, z, slot_feat, v, wk, cells, max_m, out, scratch,
             poly),
      rows_per_block, stream);
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
