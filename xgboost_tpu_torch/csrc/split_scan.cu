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
// The sort is a rank count in shared memory: bin b's rank is the number of
// bins whose key is lower, or equal with a lower index, so equal keys keep
// their bin order (stable).  Keys compare as JAX's sort compares floats:
// -0 as +0, NaN after +inf.  A row has at most a few hundred bins, so its
// B x B comparisons stay in the warp's shared memory: no key tensor in
// device memory and no sort launch beside the scan.  After the block's
// best is known, its threads rank the chosen feature's bins again to
// write cat_set, so no rank leaves the block.
//
// Bound on an H100 SXM (3.35 TB/s): the histogram is read once, 8 bytes a
// (node, feature, bin), and about 30 f32 operations are done on each; at a
// depth-6 level (32 nodes x 28 features x 256 bins) that is 1.8 MB, about
// 0.55 us; at the Criteo-shaped depth-8 level of mode 2 (64 x 39 x 128)
// 2.6 MB, about 0.76 us.  What holds it above that bound is the
// sequential prefix: each (node, feature) is a chain of B dependent adds.
//
// Design.  One block per node, one warp per feature at a time.  The warp
// copies the feature's B (g, h) pairs into its shared-memory row with
// coalesced loads (mode 2: sorted through the ranks into a second row);
// lane 0 turns the row into its prefix sums in place, in
// the mode's order (the one sequential part); then the 32 lanes score the
// bins in parallel (the scoring of a bin does not depend on any other),
// each keeping its first best, and a shuffle reduction picks the warp's
// first best (higher gain, then lower flat index).  The warps of the block
// then reduce their bests the same way, and thread 0 writes the node's
// answer, with the reference's answers where no candidate exists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kScanBlock = 16;  // XLA's CPU scan block
constexpr int kMaxLevels = 8;   // blocked scans of up to 16^8 bins
constexpr float kEps = 1e-6f;

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
  o.gain = __shfl_down_sync(0xffffffffu, c.gain, off);
  o.idx = __shfl_down_sync(0xffffffffu, c.idx, off);
  o.dl = __shfl_down_sync(0xffffffffu, c.dl, off);
  o.GL = __shfl_down_sync(0xffffffffu, c.GL, off);
  o.HL = __shfl_down_sync(0xffffffffu, c.HL, off);
  return o;
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

// The rank of bin b among keys[0..n): the stable sort's position.
__device__ __forceinline__ int cat_rank(const uint32_t* keys, int n, int b) {
  const uint32_t kb = keys[b];
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const uint32_t kj = keys[j];
    r += (kj < kb) || (kj == kb && j < b);
  }
  return r;
}

// In place: row[0..n) (g, h) pairs -> their prefix sums in XLA's blocked
// order (in-block running sums; each completed block's total pushed to the
// level above, whose answer is the next block's exclusive prefix).
__device__ void prefix_blocked(float2* row, int n) {
  int top = 0;
  for (int m = n; m > kScanBlock; m = (m + kScanBlock - 1) / kScanBlock)
    ++top;
  float2 s[kMaxLevels], e[kMaxLevels];
  int cnt[kMaxLevels];
  for (int l = 0; l < kMaxLevels; ++l) {
    s[l] = make_float2(0.0f, 0.0f);
    e[l] = make_float2(0.0f, 0.0f);
    cnt[l] = 0;
  }
  for (int i = 0; i < n; ++i) {
    float2 v = row[i];
    for (int l = 0;; ++l) {
      s[l].x = s[l].x + v.x;
      s[l].y = s[l].y + v.y;
      float2 out = s[l];
      if (l < top) {
        out.x = s[l].x + e[l].x;
        out.y = s[l].y + e[l].y;
      }
      if (l == 0) {
        row[i] = out;
      } else {  // the block below completed: its next exclusive prefix
        e[l - 1] = out;
        s[l - 1] = make_float2(0.0f, 0.0f);
        cnt[l - 1] = 0;
      }
      if (l == top || ++cnt[l] < kScanBlock) break;
      v = s[l];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
split_scan_kernel(const float2* __restrict__ hist,
                  const float2* __restrict__ totals,
                  const int* __restrict__ n_bins,
                  const uint8_t* __restrict__ fmask, int fmask_rows,
                  const float2* __restrict__ bounds,
                  const int* __restrict__ mono,
                  const uint8_t* __restrict__ cat, int max_cat_to_onehot,
                  const float2* __restrict__ comb,
                  const float* __restrict__ scale, int F, int B, Params p,
                  int mode, float* out_gain,
                  int64_t* out_feat, int64_t* out_bin, uint8_t* out_dleft,
                  float* out_GL, float* out_HL, uint8_t* out_cat_set) {
  // kWarps rows of B (g, h) pairs; mode 2 adds kWarps rows of the raw
  // bins and kWarps rows of B keys
  extern __shared__ float2 rows[];
  __shared__ Cand warp_best[kWarps];
  __shared__ float2 f0_first, f0_last, f0_raw;  // feature 0's row ends
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float2 tot = totals[n];
  if (mode == 0 && tot.x == 0.0f && tot.y == 0.0f) {
    // a dead slot: the native scan's direct answer
    if (threadIdx.x == 0) {
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
  if (mode == 0) {
    parent = gain_native(tot.x, tot.y, p);
  } else if (mono == nullptr) {
    parent = gain_xla(tot.x, tot.y, p);
  } else {
    parent = gain_given_weight_xla(tot.x, tot.y,
                                   weight_xla(tot.x, tot.y, p, lo, hi), p);
  }
  const float2 sc = comb ? make_float2(scale[0], scale[1])
                         : make_float2(0.0f, 0.0f);
  float2* row = rows + (size_t)warp * B;
  float2* raw = rows + (size_t)(kWarps + warp) * B;  // mode 2
  uint32_t* keys =
      reinterpret_cast<uint32_t*>(rows + (size_t)2 * kWarps * B) +
      (size_t)warp * B;
  Cand best{-INFINITY, INT32_MAX, 1, 0.0f, 0.0f};
  for (int f = warp; f < F; f += kWarps) {
    const float2* src = hist + ((size_t)n * F + f) * B;
    const float2* crow = comb ? comb + ((size_t)n * F + f) * B : nullptr;
    const bool is_cat = mode == 2 && cat[f] != 0;
    const bool onehot = is_cat && n_bins[f] < max_cat_to_onehot;
    if (mode == 2) {
      for (int b = lane; b < B; b += 32) {
        raw[b] = src[b];
        keys[b] = cat_key(raw[b]);
      }
      __syncwarp();
      for (int b = lane; b < B; b += 32)
        row[is_cat ? cat_rank(keys, B, b) : b] = raw[b];
    } else {
      for (int b = lane; b < B; b += 32) row[b] = src[b];
    }
    __syncwarp();
    if (lane == 0) {
      if (f == 0) f0_raw = row[0];
      if (mode == 0) {
        float2 acc = make_float2(0.0f, 0.0f);
        for (int b = 0; b < B; ++b) {
          const float2 v = row[b];
          acc.x = acc.x + v.x;
          acc.y = acc.y + v.y;
          row[b] = acc;
        }
      } else {
        prefix_blocked(row, B);
      }
      if (f == 0) {
        f0_first = row[0];
        f0_last = row[B - 1];
        if (onehot)
          f0_first = onehot_left(row[B - 1], raw[0], crow, sc, 0);
      }
    }
    __syncwarp();
    const float2 last = row[B - 1];
    const float missG = tot.x - last.x, missH = tot.y - last.y;
    const bool has_miss = fabsf(missH) > kEps;
    const int nb = n_bins[f];
    const bool allowed = fmask == nullptr
        || fmask[(size_t)(fmask_rows > 1 ? n : 0) * F + f] != 0;
    const int c = mono ? mono[f] : 0;
    Cand lb{-INFINITY, INT32_MAX, 1, 0.0f, 0.0f};
    for (int b = lane; b < B && allowed; b += 32) {
      if (onehot ? !(b < nb)
                 : !((b < nb - 1) || (b == nb - 1 && has_miss)))
        continue;
      // one-hot: left = every category but b (the unsorted bin b)
      float glr = row[b].x, hlr = row[b].y;
      if (onehot) {
        const float2 l = onehot_left(last, raw[b], crow, sc, b);
        glr = l.x;
        hlr = l.y;
      }
      const float gll = glr + missG, hll = hlr + missH;
      float g2;
      int dl;
      if (mode == 0) {
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
    for (int off = 16; off > 0; off /= 2) {
      const Cand o = shfl_down(lb, off);
      if (better(o, lb)) lb = o;
    }
    if (lane == 0 && lb.gain > best.gain) best = lb;
    __syncwarp();
  }
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (mode == 2) {
    // every thread reduces the warps' bests, then the block writes the
    // chosen feature's cat_set (row 0 of the keys holds its keys)
    for (int w = 0; w < kWarps; ++w)
      if (better(warp_best[w], best)) best = warp_best[w];
    const int bf = best.idx == INT32_MAX ? 0 : best.idx / B;
    const int bb = best.idx == INT32_MAX ? 0 : best.idx % B;
    const int nbf = n_bins[bf];
    const bool part = cat[bf] != 0 && !(nbf < max_cat_to_onehot);
    uint32_t* k0 = reinterpret_cast<uint32_t*>(rows + (size_t)2 * kWarps * B);
    __syncthreads();  // every warp is done with its key row
    const float2* src = hist + ((size_t)n * F + bf) * B;
    for (int b = threadIdx.x; b < B; b += blockDim.x) k0[b] = cat_key(src[b]);
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      bool in_set = false;
      if (cat[bf] != 0 && b < nbf)
        in_set = part ? cat_rank(k0, B, b) > bb : b == bb;
      out_cat_set[(size_t)n * B + b] = in_set;
    }
  }
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w)
    if (better(warp_best[w], best)) best = warp_best[w];
  if (best.idx == INT32_MAX) {
    // no candidate: the first (feature 0, bin 0), missing left, with
    // feature 0's sums, as the argmax over all -inf lands
    best.gain = -INFINITY;
    best.idx = 0;
    best.dl = 1;
    if (mode == 0) {
      best.GL = f0_raw.x + (tot.x - f0_last.x);
      best.HL = f0_raw.y + (tot.y - f0_last.y);
    } else {
      best.GL = f0_first.x + (tot.x - f0_last.x);
      best.HL = f0_first.y + (tot.y - f0_last.y);
    }
  }
  out_gain[n] = best.gain;
  out_feat[n] = best.idx / B;
  out_bin[n] = best.idx % B;
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

}  // namespace

extern "C" {

// hist (N, F, B, 2) f32, totals (N, 2) f32, n_bins (F,) int32; fmask
// (fmask_rows, F) uint8 with fmask_rows 1 (one mask for every node) or N,
// or null; bounds (N, 2) f32 [lower, upper] or null; mono (F,) int32 or
// null; cat (F,) uint8, the categorical features, for mode 2, with comb
// (N, F, B, 2) f32 and scale (2,) f32 (hist = comb * scale) or both null.
// mode 0: the
// native scan (unconstrained); 1: the XLA formulation (monotone); 2: the
// XLA formulation with categorical features (monotone where mono is
// given).  Outputs (N,): gain f32, feature and bin int64, dleft uint8, GL
// and HL f32; mode 2 also cat_set (N, B) uint8.  Returns a cudaError_t.
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
  const size_t smem = (size_t)kWarps * B
      * (mode == 2 ? 2 * sizeof(float2) + sizeof(uint32_t) : sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      split_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return status(err);
  const Params p{lambda_, alpha, min_child_weight, max_delta_step};
  split_scan_kernel<<<N, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(hist), static_cast<const float2*>(totals),
      static_cast<const int*>(n_bins), static_cast<const uint8_t*>(fmask),
      fmask_rows, static_cast<const float2*>(bounds),
      static_cast<const int*>(mono), static_cast<const uint8_t*>(cat),
      max_cat_to_onehot, static_cast<const float2*>(comb),
      static_cast<const float*>(scale), F, B, p, mode,
      static_cast<float*>(out_gain),
      static_cast<int64_t*>(out_feat), static_cast<int64_t*>(out_bin),
      static_cast<uint8_t*>(out_dleft), static_cast<float*>(out_GL),
      static_cast<float*>(out_HL), static_cast<uint8_t*>(out_cat_set));
  return status(cudaGetLastError());
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
