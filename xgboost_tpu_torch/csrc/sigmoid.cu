// XLA's f32 logistic for Hopper (sm_90a): K4.
//
// No TPU kernel: this replaces the reference's jax.nn.sigmoid
// (xgboost_tpu/objective/regression.py:113) and the binary:logistic
// gradient around it (regression.py:115-119 and _pack, :23), which the
// reference runs op by op on XLA's CPU.  XLA compiles the sigmoid into
// 1 / (1 + exp(-x)) with its own f32 exponential, so PyTorch's sigmoid
// does not give the reference's bits, and it runs with denormals flushed
// to zero.  Two entries:
//
//   xtb_sigmoid        p = sigmoid(x), what utils/fp.py sigmoid_f32
//                      computes (the prediction's transform)
//   xtb_logistic_grad  the (R, 1, 2) gradient pairs of binary:logistic,
//                      what ops/sigmoid_cuda.py logistic_gradient_plain
//                      computes, in one pass:
//                        p = sigmoid(x); w = y == 1 ? spw : 1
//                        g = (p - y) w;  h = max(p (1 - p), 1e-16) w
//                        g, h times the row's weight where one is given
//
// The exponential: clamp to [-104, 88.8]; n = floor(x log2(e) + 1/2), at
// most 127; r = x - n ln2 in two parts; the Cephes degree-6 polynomial in
// r by Horner's rule; 1 + (y r^2 + r); times 2^n as two factors
// 2^lo 2^(n-lo), so that n down to -150 fits the exponent field; a result
// below the smallest normal f32 flushed to zero.  The gradient's label and
// weight, and each of its differences and products that can fall below
// the smallest normal f32, are flushed the same way (keeping the sign),
// as XLA's CPU programs run.  The max keeps a NaN, as
// jnp.maximum and torch.clamp do (fmaxf would not).  Every multiply-add
// that XLA fuses is written out as __fmaf_rn and every other operation as
// its own rounded intrinsic; the library is built with --fmad=false
// (ops/hist_cuda.py) and without fast math, so nvcc contracts nothing and
// the division is IEEE div.rn.  Both entries are bitwise their plain
// versions on any f32 input.
//
// Bound on an H100 SXM (3.35 TB/s): the sigmoid moves 8 bytes an element
// (a margin read, a probability written), the gradient 16 (margin and
// label read, the pair written) or 20 with weights; at the main path's
// 1,000,448 margins that is 2.4, 4.8 and 6.0 us by the bytes; about 30 f32
// operations an element are far below the operations' bound.
//
// Design.  Four elements a thread with 16-byte loads and stores (float4),
// and a scalar pass for the last n % 4 elements or where a pointer is not
// 16-byte aligned; a grid of a few blocks per SM (132 SMs on an H100)
// striding over the elements, so that every SM has loads in flight.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal f32

__device__ __forceinline__ float flush(float v) {
  return v < kFltMin ? 0.0f : v;
}

// XLA's flush to zero of a result of either sign (NaN passes)
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float exp_xla(float x) {
  x = fminf(fmaxf(x, -104.0f), 88.8f);
  float n = floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f));
  n = n > 127.0f ? 127.0f : n;  // XLA's cap: 2^n stays a normal f32
  float r = __fmaf_rn(n, -0.693359375f, x);
  r = __fmaf_rn(n, 2.12194440e-4f, r);
  float y = __fmaf_rn(r, 1.9875691500e-4f, 1.3981999507e-3f);
  y = __fmaf_rn(y, r, 8.3334519073e-3f);
  y = __fmaf_rn(y, r, 4.1665795894e-2f);
  y = __fmaf_rn(y, r, 1.6666665459e-1f);
  y = __fmaf_rn(y, r, 5.0000001201e-1f);
  y = __fadd_rn(1.0f, __fmaf_rn(y, __fmul_rn(r, r), r));
  const int ni = (int)n;
  const int lo = ni >> 1;  // floor(ni / 2), as the plain version's //
  const float out = __fmul_rn(__fmul_rn(y, __int_as_float((lo + 127) << 23)),
                              __int_as_float((ni - lo + 127) << 23));
  return flush(out);
}

__device__ __forceinline__ float sigmoid_xla(float v) {
  return isnan(v) ? v
                  : flush(__fdiv_rn(1.0f, __fadd_rn(1.0f, exp_xla(-v))));
}

// one element's gradient pair
__device__ __forceinline__ float2 logistic_grad(float x, float y, float wt,
                                                bool weighted, float spw) {
  y = ftz(y);
  const float p = sigmoid_xla(x);
  const float w = y == 1.0f ? spw : 1.0f;
  const float g = ftz(__fmul_rn(ftz(__fsub_rn(p, y)), w));
  const float q = __fmul_rn(p, __fsub_rn(1.0f, p));
  const float h = ftz(__fmul_rn(q < 1e-16f ? 1e-16f : q, w));  // NaN kept
  if (!weighted) return make_float2(g, h);
  wt = ftz(wt);
  return make_float2(ftz(__fmul_rn(g, wt)), ftz(__fmul_rn(h, wt)));
}

__device__ __forceinline__ long long first_index() {
  return (long long)blockIdx.x * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long stride() {
  return (long long)gridDim.x * kThreads;
}

// vec4: elements [0, n4 * 4) as float4; then every thread of the grid
// takes the tail [n4 * 4, n) one element at a time
__global__ void __launch_bounds__(kThreads)
    sigmoid_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long n, long long n4) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = first_index(); i < n4; i += stride()) {
    const float4 v = x4[i];
    o4[i] = make_float4(sigmoid_xla(v.x), sigmoid_xla(v.y),
                        sigmoid_xla(v.z), sigmoid_xla(v.w));
  }
  for (long long i = 4 * n4 + first_index(); i < n; i += stride())
    out[i] = sigmoid_xla(x[i]);
}

__global__ void __launch_bounds__(kThreads)
    logistic_grad_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ wt, float spw,
                         float* __restrict__ out, long long n, long long n4) {
  const bool weighted = wt != nullptr;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const float4* w4 = reinterpret_cast<const float4*>(wt);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = first_index(); i < n4; i += stride()) {
    const float4 a = x4[i], b = y4[i];
    const float4 c = weighted ? w4[i] : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    const float2 g0 = logistic_grad(a.x, b.x, c.x, weighted, spw);
    const float2 g1 = logistic_grad(a.y, b.y, c.y, weighted, spw);
    const float2 g2 = logistic_grad(a.z, b.z, c.z, weighted, spw);
    const float2 g3 = logistic_grad(a.w, b.w, c.w, weighted, spw);
    o4[2 * i] = make_float4(g0.x, g0.y, g1.x, g1.y);
    o4[2 * i + 1] = make_float4(g2.x, g2.y, g3.x, g3.y);
  }
  for (long long i = 4 * n4 + first_index(); i < n; i += stride()) {
    const float2 g = logistic_grad(x[i], y[i], weighted ? wt[i] : 1.0f,
                                   weighted, spw);
    out[2 * i] = g.x;
    out[2 * i + 1] = g.y;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the float4 part (0 where a pointer is not 16-byte aligned) and the grid
void geometry(long long n, bool vec, long long& n4, int& grid) {
  n4 = vec ? n / 4 : 0;
  const long long items = n4 + (n - 4 * n4);
  const long long blocks = (items + kThreads - 1) / kThreads;
  grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
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

// x and out (n,) f32, contiguous, on the current device.  Returns a
// cudaError_t.
int xtb_sigmoid(const void* x, void* out, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  long long n4;
  int grid;
  geometry(n, aligned16(x) && aligned16(out), n4, grid);
  sigmoid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n4);
  return status(cudaGetLastError());
}

// margin, label and weight (or null) (n,) f32, contiguous, on the current
// device; out (n, 2) f32, the (grad, hess) pairs.  Returns a cudaError_t.
int xtb_logistic_grad(const void* margin, const void* label,
                      const void* weight, float scale_pos_weight, void* out,
                      long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  long long n4;
  int grid;
  geometry(n, aligned16(margin) && aligned16(label) && aligned16(weight)
                  && aligned16(out), n4, grid);
  logistic_grad_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(margin), static_cast<const float*>(label),
      static_cast<const float*>(weight), scale_pos_weight,
      static_cast<float*>(out), n, n4);
  return status(cudaGetLastError());
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
