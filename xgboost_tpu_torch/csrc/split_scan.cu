// Split scan for Hopper (sm_90a): K3.
//
// No TPU kernel: this replaces the reference's split evaluation, which on
// the CPU runs as the native scan native/xtb_kernels.h:647
// (xtb_split_scan_impl, unconstrained) and otherwise as the XLA formulation
// of xgboost_tpu/ops/split.py:253 (evaluate_splits, under monotone
// constraints or with categorical features).  For each node n it finds
// the best split over the features f and bins b of its histogram
// hist[n, f, b, (g, h)]:
//
//   left sums  GL, HL = prefix over bins 0..b     (missing values right)
//              GL + missG, HL + missH               (missing values left)
//   gain       score(left) + score(right) - score(node)
//
// and returns the gain, feature, bin, default direction and left sums of
// the first best candidate in (feature, bin) order.
//
// The bits are the reference's.  The prefix sums run in the reference's
// order: mode 0 (unconstrained) adds one bin at a time in f32, as the
// native scan does; mode 1 (monotone) adds in XLA's CPU order for
// jnp.cumsum, sequentially inside blocks of 16 bins, the block totals
// scanned the same way (recursively), and each block's exclusive prefix
// added last.  The gain arithmetic is the reference's op for op: mode 0
// xtb_calc_gain; mode 1 the XLA formulation, whose one fused multiply-add
// XLA's CPU compiler makes is written out as __fmaf_rn.  The library is
// built with --fmad=false (ops/hist_cuda.py), so nvcc contracts nothing
// else, and without fast math, so every division is IEEE div.rn.
//
// Mode 2 (categorical; xgboost_tpu/ops/split.py:269-417) is mode 1's XLA
// formulation for every feature, with the gain unconstrained (or mode 1's
// under monotone constraints), and for each categorical feature:
//   - its bins stably sorted by G / (H + 1e-6), +inf where H <= 0, before
//     the blocked prefix (the stable sort of jnp.argsort);
//   - below max_cat_to_onehot bins, one-hot: left sums at bin b are the
//     sorted row's total minus the UNSORTED bin b, and every valid bin is
//     a candidate; under deterministic_histogram the histogram is
//     comb * scale, and the reference's compiled program fuses that
//     product into the subtraction, so the kernel computes
//     fma(-comb[b], scale, total) from the comb it is given;
//   - cat_set[n, b], the categories routed right: the chosen bin of a
//     one-hot split, the bins ranked after the chosen position of a
//     partition (all zero where the best feature is numeric).
// The sort is a bitonic sort, by one warp in its shared memory, of the
// 64-bit words (key << 32 | bin): the bin breaks ties, so equal keys keep
// their bin order, the permutation of a stable sort.  Keys compare as
// JAX's sort compares floats: -0 as +0, NaN after +inf.
//
// Bound on an H100 SXM (3.35 TB/s): the histogram is read once, 8 bytes a
// (node, feature, bin), and about 30 f32 operations are done on each; at a
// depth-6 level (32 nodes x 28 features x 256 bins) that is 1.8 MB, about
// 0.55 us; at the Criteo-shaped depth-8 level of mode 2 (64 x 39 x 128)
// 2.6 MB, about 0.76 us.  What holds it above that bound is the order of
// the sums: mode 0's prefix is a chain of B dependent adds for every
// (node, feature).
//
// Design.  One warp per feature, and a thread block cluster of G blocks
// (at most 8, of about 8 warps each, fewer where the shared memory is
// short) per node, so that a node's features spread over G SMs and a
// warp takes ceil(F / (G W)) features.  A warp copies its feature's B
// (g, h) pairs into a shared-memory row with coalesced loads; the row
// leaves one spare pair after every 16, so that lanes working on
// neighbouring blocks of 16 meet no bank conflict.  Mode 2 sorts a
// categorical feature's bins first.  The prefix is spread over the lanes:
//   - mode 0, the one chain: each lane takes 8 consecutive bins into
//     registers; the running sum passes from lane to lane by shuffles and
//     each lane adds its own bins in order (B dependent register adds and
//     B / 8 shuffles);
//   - modes 1 and 2, XLA's blocks: lane j sums block j of 16 bins from
//     0.0; the block totals go to a level above, scanned the same way
//     (recursively, until a level holds at most 16 values, which one lane
//     sums in order); then every level adds each block's exclusive prefix
//     (0.0 for the first) to the block, from the top down.
// Then the 32 lanes score the bins in parallel (the scoring of a bin does
// not depend on any other), each keeping its first best, and a shuffle
// reduction picks the warp's first best (higher gain, then lower flat
// index f * B + b).  That order is total, so the reduction of the warps'
// bests gives the same answer however the features were grouped: every
// warp reads the cluster's warps' bests through distributed shared
// memory; warp 0 of the first block writes the node's answer (with the
// reference's answers where no candidate exists) and, in mode 2, the warp
// that scanned the chosen feature writes cat_set from the order it still
// holds.  One launch, no scratch in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 32;
constexpr int kBlockWarps = 8;  // warps a block aims at: features per SM
constexpr int kMaxCluster = 8;  // the portable cluster limit
constexpr int kScanBlock = 16;  // XLA's CPU scan block
constexpr int kChainBins = 8;   // mode 0: bins a lane holds at a time
constexpr int kMaxDevices = 64;
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float lambda_, alpha, mcw, mds;
};

struct Cand {
  float gain;
  int idx;  // flat f * B + b; INT32_MAX when none
  int dl;
  float GL, HL;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.gain > b.gain || (a.gain == b.gain && a.idx < b.idx);
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int off) {
  Cand o;
  o.gain = __shfl_down_sync(kFull, c.gain, off);
  o.idx = __shfl_down_sync(kFull, c.idx, off);
  o.dl = __shfl_down_sync(kFull, c.dl, off);
  o.GL = __shfl_down_sync(kFull, c.GL, off);
  o.HL = __shfl_down_sync(kFull, c.HL, off);
  return o;
}

// lane 0 ends with the warp's best of the lanes' candidates
__device__ __forceinline__ Cand warp_best_of(Cand c) {
  for (int off = 16; off > 0; off /= 2) {
    const Cand o = shfl_down(c, off);
    if (better(o, c)) c = o;
  }
  return c;
}

// ---- the shared-memory layout of a warp, in float2 units
// a row of n pairs with one spare pair after every 16
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
__host__ __device__ __forceinline__ int padded_len(int n) {
  return n + (n >> 4) + 1;
}

// the levels above the row in the blocked prefix: one total per block of
// the level below, while the level below holds more than one block
__host__ __device__ __forceinline__ int scan_levels_len(int B) {
  int len = 0;
  for (int n = B; n > kScanBlock;) {
    n = (n + kScanBlock - 1) / kScanBlock;
    len += padded_len(n);
  }
  return len;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// a warp's words: the row; modes 1 and 2 the levels; mode 2 the raw bins
// and the sort's 64-bit words
__host__ __device__ __forceinline__ int warp_words(int mode, int B) {
  int w = padded_len(B);
  if (mode >= 1) w += scan_levels_len(B);
  if (mode == 2) w += B + pow2_at_least(B);
  return w;
}

// ---- mode 0: xtb_calc_gain (native/xtb_kernels.h:637)
__device__ __forceinline__ float gain_native(float G, float H,
                                             const Params& p) {
  if (H <= 0.0f) return 0.0f;
  float a = fabsf(G) - p.alpha;
  if (a < 0.0f) a = 0.0f;
  const float t = G < 0.0f ? -a : a;
  if (p.mds == 0.0f) return t * t / (H + p.lambda_);
  float w = -t / (H + p.lambda_);
  if (w > p.mds) w = p.mds;
  if (w < -p.mds) w = -p.mds;
  return -(2.0f * t * w + (H + p.lambda_) * w * w);
}

// ---- mode 1: the XLA formulation (xgboost_tpu/ops/split.py:72-101)
__device__ __forceinline__ float thr_xla(float g, float alpha) {
  float a = fabsf(g) - alpha;
  a = a < 0.0f ? 0.0f : a;
  return copysignf(a, g);  // sign(g) * a, -0.0 kept as jnp.sign keeps it
}

__device__ __forceinline__ float weight_xla(float G, float H,
                                            const Params& p, float lo,
                                            float hi) {
  float w = -thr_xla(G, p.alpha) / (H + p.lambda_);
  if (p.mds > 0.0f) w = fminf(fmaxf(w, -p.mds), p.mds);
  w = fminf(fmaxf(w, lo), hi);
  return H <= 0.0f ? 0.0f : w;
}

__device__ __forceinline__ float gain_given_weight_xla(float G, float H,
                                                       float w,
                                                       const Params& p) {
  if (H <= 0.0f) return 0.0f;
  const float b = (H + p.lambda_) * w * w;
  return -__fmaf_rn(2.0f * thr_xla(G, p.alpha), w, b);
}

// ---- mode 2, unconstrained: the XLA formulation's calc_gain
// (xgboost_tpu/ops/split.py:84-92)
__device__ __forceinline__ float gain_xla(float G, float H, const Params& p) {
  if (H <= 0.0f) return 0.0f;
  if (p.mds == 0.0f) {
    const float t = thr_xla(G, p.alpha);
    return t * t / (H + p.lambda_);
  }
  return gain_given_weight_xla(G, H,
                               weight_xla(G, H, p, -INFINITY, INFINITY), p);
}

// One-hot left sums at bin b: the sorted row's total minus bin b, or with
// comb (hist = comb * scale, deterministic_histogram) one rounding,
// fma(-comb, scale, total), as XLA fuses the dequantising product.
__device__ __forceinline__ float2 onehot_left(float2 total, float2 h,
                                              const float2* crow, float2 sc,
                                              int b) {
  if (crow == nullptr) return make_float2(total.x - h.x, total.y - h.y);
  const float2 c = crow[b];
  return make_float2(__fmaf_rn(-c.x, sc.x, total.x),
                     __fmaf_rn(-c.y, sc.y, total.y));
}

// The categorical sort key of a bin, as an unsigned integer whose order is
// the order of jnp.argsort's float comparison: G / (H + 1e-6), +inf where
// H <= 0, -0 taken as +0 and NaN as the one NaN that sorts last.
__device__ __forceinline__ uint32_t cat_key(float2 gh) {
  float r = gh.y > 0.0f ? gh.x / (gh.y + kEps) : INFINITY;
  if (r == 0.0f) r = 0.0f;
  uint32_t u = isnan(r) ? 0x7fc00000u : __float_as_uint(r);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp copies a feature's B pairs from device memory to dst[at(b)],
// 8 loads a lane in flight before the first store.
template <typename At>
__device__ __forceinline__ void copy_row(const float2* __restrict__ src,
                                         float2* dst, int B, int lane,
                                         At at) {
  for (int c0 = 0; c0 < B; c0 += 32 * kChainBins) {
    float2 v[kChainBins];
#pragma unroll
    for (int k = 0; k < kChainBins; ++k) {
      const int b = c0 + 32 * k + lane;
      v[k] = b < B ? src[b] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kChainBins; ++k) {
      const int b = c0 + 32 * k + lane;
      if (b < B) dst[at(b)] = v[k];
    }
  }
}

// The warp sorts the bins of one feature, raw[0..B) in shared memory:
// s[0..P) (P = pow2_at_least(B)) ends with the words (key << 32 | bin) in
// ascending order, so that position r holds the bin of rank r, for r < B
// (the padding sorts last).
__device__ void sort_bins(const float2* raw, int B, unsigned long long* s,
                          int lane) {
  const int P = pow2_at_least(B);
  __syncwarp();  // raw is written
  for (int b = lane; b < P; b += 32)
    s[b] = b < B ? (unsigned long long)cat_key(raw[b]) << 32 | (unsigned)b
                 : ~0ull;
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long a = s[i], c = s[i + j];
        if ((a > c) == ((i & k) == 0)) {
          s[i] = c;
          s[i + j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Mode 0, in place: row's B pairs -> their prefix sums, one bin at a time
// from 0.0.  Lane j holds bins [c0 + 8j, c0 + 8j + 8) of each 256-bin
// chunk in registers; the running sum visits the lanes in order.
__device__ void prefix_chain(float2* row, int B, int lane) {
  float2 run = make_float2(0.0f, 0.0f);
  for (int c0 = 0; c0 < B; c0 += 32 * kChainBins) {
    const int base = c0 + kChainBins * lane;
    float2 v[kChainBins];
#pragma unroll
    for (int k = 0; k < kChainBins; ++k)
      v[k] = base + k < B ? row[pad(base + k)] : make_float2(0.0f, 0.0f);
    const int holders = min(32, (B - c0 + kChainBins - 1) / kChainBins);
    for (int j = 0; j < holders; ++j) {
      if (lane == j) {
#pragma unroll
        for (int k = 0; k < kChainBins; ++k) {
          run.x = run.x + v[k].x;
          run.y = run.y + v[k].y;
          v[k] = run;
        }
      }
      run.x = __shfl_sync(kFull, run.x, j);
      run.y = __shfl_sync(kFull, run.y, j);
    }
#pragma unroll
    for (int k = 0; k < kChainBins; ++k)
      if (base + k < B) row[pad(base + k)] = v[k];
  }
}

// The array of level l of the blocked prefix (level 0: the row) and its
// length.
__device__ __forceinline__ float2* level_at(float2* row, float2* levels,
                                            int B, int l, int& n) {
  float2* a = row;
  float2* next = levels;
  n = B;
  for (int i = 0; i < l; ++i) {
    n = (n + kScanBlock - 1) / kScanBlock;
    a = next;
    next += padded_len(n);
  }
  return a;
}

// Modes 1 and 2, in place: row's B pairs -> their prefix sums in XLA's
// blocked order (ops/split.py: prefix_blocked): in-block sums from 0.0,
// the block totals prefixed the same way one level up, each block's
// exclusive prefix (0.0 for the first) added last.
__device__ void prefix_blocked(float2* row, float2* levels, int B,
                               int lane) {
  int top = 0;
  for (int m = B; m > kScanBlock; m = (m + kScanBlock - 1) / kScanBlock)
    ++top;
  for (int l = 0; l < top; ++l) {  // down: in-block sums, totals up
    int n, nu;
    float2* a = level_at(row, levels, B, l, n);
    float2* up = level_at(row, levels, B, l + 1, nu);
    for (int j = lane; j < nu; j += 32) {
      float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kScanBlock; ++k) {
        const int i = kScanBlock * j + k;
        const float2 x = i < n ? a[pad(i)] : make_float2(0.0f, 0.0f);
        s.x = s.x + x.x;
        s.y = s.y + x.y;
        if (i < n) a[pad(i)] = s;
      }
      up[pad(j)] = s;  // with the zero padding, as XLA pads the axis
    }
    __syncwarp();
  }
  {  // the top level: one block, summed in order
    int n;
    float2* a = level_at(row, levels, B, top, n);
    if (lane == 0) {
      float2 s = make_float2(0.0f, 0.0f);
      for (int i = 0; i < n; ++i) {
        const float2 x = a[pad(i)];
        s.x = s.x + x.x;
        s.y = s.y + x.y;
        a[pad(i)] = s;
      }
    }
    __syncwarp();
  }
  for (int l = top - 1; l >= 0; --l) {  // up: the exclusive prefixes
    int n, nu;
    float2* a = level_at(row, levels, B, l, n);
    const float2* up = level_at(row, levels, B, l + 1, nu);
    for (int i = lane; i < n; i += 32) {
      const int j = i / kScanBlock;
      const float2 e = j ? up[pad(j - 1)] : make_float2(0.0f, 0.0f);
      float2 v = a[pad(i)];
      v.x = v.x + e.x;
      v.y = v.y + e.y;
      a[pad(i)] = v;
    }
    __syncwarp();
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
split_scan_kernel(const float2* __restrict__ hist,
                  const float2* __restrict__ totals,
                  const int* __restrict__ n_bins,
                  const uint8_t* __restrict__ fmask, int fmask_rows,
                  const float2* __restrict__ bounds,
                  const int* __restrict__ mono,
                  const uint8_t* __restrict__ cat, int max_cat_to_onehot,
                  const float2* __restrict__ comb,
                  const float* __restrict__ scale, int F, int B, Params p,
                  float* out_gain, int64_t* out_feat, int64_t* out_bin,
                  uint8_t* out_dleft, float* out_GL, float* out_HL,
                  uint8_t* out_cat_set) {
  extern __shared__ float2 smem[];
  __shared__ Cand warp_best[kMaxWarps];
  __shared__ float2 f0_first, f0_last;  // feature 0's row ends (block 0)
  // the cluster of gridDim.y blocks scans node blockIdx.x; warp w of block
  // g (its rank in the cluster) is the node's warp g * W + w of G * W
  const int n = blockIdx.x, G = gridDim.y, W = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool lead = blockIdx.y == 0;  // writes the node's answer
  const float2 tot = totals[n];
  if (MODE == 0 && tot.x == 0.0f && tot.y == 0.0f) {
    // a dead slot: the native scan's direct answer
    if (lead && threadIdx.x == 0) {
      out_gain[n] = -INFINITY;
      out_feat[n] = 0;
      out_bin[n] = 0;
      out_dleft[n] = 1;
      out_GL[n] = 0.0f;
      out_HL[n] = 0.0f;
    }
    return;
  }
  const float lo = bounds ? bounds[n].x : -INFINITY;
  const float hi = bounds ? bounds[n].y : INFINITY;
  float parent;
  if (MODE == 0) {
    parent = gain_native(tot.x, tot.y, p);
  } else if (mono == nullptr) {
    parent = gain_xla(tot.x, tot.y, p);
  } else {
    parent = gain_given_weight_xla(tot.x, tot.y,
                                   weight_xla(tot.x, tot.y, p, lo, hi), p);
  }
  const float2 sc = comb ? make_float2(scale[0], scale[1])
                         : make_float2(0.0f, 0.0f);
  float2* row = smem + (size_t)warp * warp_words(MODE, B);
  float2* levels = row + padded_len(B);         // modes 1, 2
  float2* raw = levels + scan_levels_len(B);    // mode 2
  unsigned long long* sorted =                  // mode 2
      reinterpret_cast<unsigned long long*>(raw + B);
  Cand best{-INFINITY, INT32_MAX, 1, 0.0f, 0.0f};
  int sorted_f = -1;  // mode 2: the feature whose order `sorted` holds
  const int gw = blockIdx.y * W + warp;  // the warp's rank in the node
  for (int f = gw; f < F; f += G * W) {
    const float2* src = hist + ((size_t)n * F + f) * B;
    const float2* crow = comb ? comb + ((size_t)n * F + f) * B : nullptr;
    const bool is_cat = MODE == 2 && cat[f] != 0;
    const int nb = n_bins[f];
    const bool onehot = is_cat && nb < max_cat_to_onehot;
    if (is_cat) {
      copy_row(src, raw, B, lane, [](int b) { return b; });
      sort_bins(raw, B, sorted, lane);
      sorted_f = f;
      for (int r = lane; r < B; r += 32)
        row[pad(r)] = raw[(uint32_t)sorted[r]];
    } else {
      copy_row(src, row, B, lane, [](int b) { return pad(b); });
    }
    __syncwarp();
    if (MODE == 0)
      prefix_chain(row, B, lane);
    else
      prefix_blocked(row, levels, B, lane);
    __syncwarp();
    const float2 last = row[pad(B - 1)];
    if (f == 0 && lane == 0) {
      f0_last = last;
      f0_first = onehot ? onehot_left(last, raw[0], crow, sc, 0) : row[0];
    }
    const float missG = tot.x - last.x, missH = tot.y - last.y;
    const bool has_miss = fabsf(missH) > kEps;
    const bool allowed = fmask == nullptr
        || fmask[(size_t)(fmask_rows > 1 ? n : 0) * F + f] != 0;
    const int c = mono ? mono[f] : 0;
    Cand lb{-INFINITY, INT32_MAX, 1, 0.0f, 0.0f};
    for (int b = lane; b < B && allowed; b += 32) {
      if (onehot ? !(b < nb)
                 : !((b < nb - 1) || (b == nb - 1 && has_miss)))
        continue;
      // one-hot: left = every category but b (the unsorted bin b)
      float2 l = row[pad(b)];
      if (onehot) l = onehot_left(last, raw[b], crow, sc, b);
      const float glr = l.x, hlr = l.y;
      const float gll = glr + missG, hll = hlr + missH;
      float g2;
      int dl;
      if (MODE == 0) {
        g2 = -INFINITY;
        dl = 1;
        {  // missing -> right
          const float GR = tot.x - glr, HR = tot.y - hlr;
          if (hlr >= p.mcw && HR >= p.mcw && hlr > 0.0f && HR > 0.0f) {
            g2 = gain_native(glr, hlr, p) + gain_native(GR, HR, p) - parent;
            dl = 0;
          }
        }
        {  // missing -> left
          const float GR = tot.x - gll, HR = tot.y - hll;
          if (hll >= p.mcw && HR >= p.mcw && hll > 0.0f && HR > 0.0f) {
            const float gl = gain_native(gll, hll, p)
                + gain_native(GR, HR, p) - parent;
            if (gl >= g2) {
              g2 = gl;
              dl = 1;
            }
          }
        }
      } else {
        float side[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // 0: missing right, 1: left
          const float GL = s ? gll : glr, HL = s ? hll : hlr;
          const float GR = tot.x - GL, HR = tot.y - HL;
          float g;
          if (mono) {
            const float wL = weight_xla(GL, HL, p, lo, hi);
            const float wR = weight_xla(GR, HR, p, lo, hi);
            g = gain_given_weight_xla(GL, HL, wL, p)
                + gain_given_weight_xla(GR, HR, wR, p) - parent;
            if ((c > 0 && wL > wR) || (c < 0 && wL < wR)) g = -INFINITY;
          } else {  // mode 2 unconstrained
            g = gain_xla(GL, HL, p) + gain_xla(GR, HR, p) - parent;
          }
          if (!(HL >= p.mcw && HR >= p.mcw && HL > 0.0f && HR > 0.0f))
            g = -INFINITY;
          side[s] = g;
        }
        dl = side[1] >= side[0];
        g2 = dl ? side[1] : side[0];
      }
      if (g2 > lb.gain) {
        lb.gain = g2;
        lb.idx = f * B + b;
        lb.dl = dl;
        lb.GL = dl ? gll : glr;
        lb.HL = dl ? hll : hlr;
      }
    }
    lb = warp_best_of(lb);
    if (lane == 0 && better(lb, best)) best = lb;
    __syncwarp();
  }
  if (lane == 0) warp_best[warp] = best;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every warp's best is in its block's shared memory
  // every warp: the node's best over the cluster's warps
  best = Cand{-INFINITY, INT32_MAX, 1, 0.0f, 0.0f};
  for (int i = lane; i < G * W; i += 32) {
    const Cand o = cluster.map_shared_rank(warp_best, i / W)[i % W];
    if (better(o, best)) best = o;
  }
  best = warp_best_of(best);
  cluster.sync();  // no block leaves while another reads its bests
  best.idx = __shfl_sync(kFull, best.idx, 0);
  const bool none = best.idx == INT32_MAX;
  const int bf = none ? 0 : best.idx / B;
  const int bb = none ? 0 : best.idx % B;
  if (MODE == 2 && gw == bf % (G * W)) {
    // the warp that scanned the chosen feature writes the categories
    // routed right: the chosen bin of a one-hot split, the bins ranked
    // after the chosen position of a partition (it sorts the feature
    // again only if it scanned another categorical feature after it)
    const int nbf = n_bins[bf];
    uint8_t* cs = out_cat_set + (size_t)n * B;
    if (cat[bf] != 0 && !(nbf < max_cat_to_onehot)) {
      if (sorted_f != bf) {
        copy_row(hist + ((size_t)n * F + bf) * B, raw, B, lane,
                 [](int b) { return b; });
        sort_bins(raw, B, sorted, lane);
      }
      for (int r = lane; r < B; r += 32) {
        const int b = (int)(uint32_t)sorted[r];
        cs[b] = b < nbf && r > bb;
      }
    } else {
      for (int b = lane; b < B; b += 32)
        cs[b] = cat[bf] != 0 && b < nbf && b == bb;
    }
  }
  if (!lead || warp != 0 || lane != 0) return;
  if (none) {
    // no candidate: the first (feature 0, bin 0), missing left, with
    // feature 0's sums, as the argmax over all -inf lands
    best.gain = -INFINITY;
    best.idx = 0;
    best.dl = 1;
    const float2 first = MODE == 0 ? hist[(size_t)n * F * B] : f0_first;
    best.GL = first.x + (tot.x - f0_last.x);
    best.HL = first.y + (tot.y - f0_last.y);
  }
  out_gain[n] = best.gain;
  out_feat[n] = bf;
  out_bin[n] = bb;
  out_dleft[n] = (uint8_t)best.dl;
  out_GL[n] = best.GL;
  out_HL[n] = best.HL;
}

// The first error of a call, with the runtime's last-error state cleared,
// so that a refused launch does not surface again at the next one (of this
// kernel or of another in the process).
int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// Per (mode, device): the dynamic shared memory a block may use, set as
// the kernel's limit at the first launch (0: not yet).
std::atomic<int> g_smem_limit[3][kMaxDevices];

int smem_limit(const void* kernel, int mode, int& limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return status(err);
  if (dev < kMaxDevices && (limit = g_smem_limit[mode][dev].load()) > 0)
    return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return status(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return status(err);
  limit = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return status(err);
  if (dev < kMaxDevices) g_smem_limit[mode][dev].store(limit);
  return 0;
}

template <int MODE>
int launch(const void* hist, const void* totals, const void* n_bins,
           const void* fmask, int fmask_rows, const void* bounds,
           const void* mono, const void* cat, int max_cat_to_onehot,
           const void* comb, const void* scale, int N, int F, int B,
           const Params& p, void* out_gain, void* out_feat, void* out_bin,
           void* out_dleft, void* out_GL, void* out_HL, void* out_cat_set,
           void* stream) {
  const void* kernel = (const void*)split_scan_kernel<MODE>;
  int limit = 0;
  const int rc = smem_limit(kernel, MODE, limit);
  if (rc != 0) return rc;
  // a warp per feature: a cluster of G blocks (at most 8) per node, each
  // of about 8 warps, fewer where the shared memory is short, and as few
  // warps as keep the same features per warp
  const size_t per_warp = (size_t)warp_words(MODE, B) * sizeof(float2);
  const int G = min(kMaxCluster, (F + kBlockWarps - 1) / kBlockWarps);
  int W = min(kMaxWarps, (F + G - 1) / G);
  if ((size_t)W * per_warp > (size_t)limit)
    W = max(1, (int)((size_t)limit / per_warp));
  const int per = (F + G * W - 1) / (G * W);
  W = (F + G * per - 1) / (G * per);
  // a block the card cannot hold is refused by the launch
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = G;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N, G, 1);
  cfg.blockDim = dim3(W * 32, 1, 1);
  cfg.dynamicSmemBytes = (size_t)W * per_warp;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return status(cudaLaunchKernelEx(
      &cfg, split_scan_kernel<MODE>, static_cast<const float2*>(hist),
      static_cast<const float2*>(totals), static_cast<const int*>(n_bins),
      static_cast<const uint8_t*>(fmask), fmask_rows,
      static_cast<const float2*>(bounds), static_cast<const int*>(mono),
      static_cast<const uint8_t*>(cat), max_cat_to_onehot,
      static_cast<const float2*>(comb), static_cast<const float*>(scale), F,
      B, p, static_cast<float*>(out_gain), static_cast<int64_t*>(out_feat),
      static_cast<int64_t*>(out_bin), static_cast<uint8_t*>(out_dleft),
      static_cast<float*>(out_GL), static_cast<float*>(out_HL),
      static_cast<uint8_t*>(out_cat_set)));
}

}  // namespace

extern "C" {

// hist (N, F, B, 2) f32, totals (N, 2) f32, n_bins (F,) int32; fmask
// (fmask_rows, F) uint8 (or bool) with fmask_rows 1 (one mask for every
// node) or N, or null; bounds (N, 2) f32 [lower, upper] or null; mono (F,)
// int32 or null; cat (F,) uint8 (or bool), the categorical features, for
// mode 2, with comb (N, F, B, 2) f32 and scale (2,) f32 (hist = comb *
// scale) or both null.  mode 0: the native scan (unconstrained); 1: the
// XLA formulation (monotone); 2: the XLA formulation with categorical
// features (monotone where mono is given).  Outputs (N,): gain f32,
// feature and bin int64, dleft uint8, GL and HL f32; mode 2 also cat_set
// (N, B) uint8.  Returns a cudaError_t.
int xtb_split_scan(const void* hist, const void* totals, const void* n_bins,
                   const void* fmask, int fmask_rows, const void* bounds,
                   const void* mono, const void* cat, int max_cat_to_onehot,
                   const void* comb, const void* scale, int N, int F, int B,
                   float lambda_, float alpha,
                   float min_child_weight, float max_delta_step, int mode,
                   void* out_gain, void* out_feat, void* out_bin,
                   void* out_dleft, void* out_GL, void* out_HL,
                   void* out_cat_set, void* stream) {
  if (N < 1 || F < 1 || B < 1 || mode < 0 || mode > 2
      || (mode == 1 && mono == nullptr)
      || (mode == 2 && (cat == nullptr || out_cat_set == nullptr))
      || (comb != nullptr && (mode != 2 || scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{lambda_, alpha, min_child_weight, max_delta_step};
#define XTB_LAUNCH(M)                                                     \
  launch<M>(hist, totals, n_bins, fmask, fmask_rows, bounds, mono, cat,    \
            max_cat_to_onehot, comb, scale, N, F, B, p, out_gain, out_feat, \
            out_bin, out_dleft, out_GL, out_HL, out_cat_set, stream)
  switch (mode) {
    case 0: return XTB_LAUNCH(0);
    case 1: return XTB_LAUNCH(1);
    default: return XTB_LAUNCH(2);
  }
#undef XTB_LAUNCH
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
