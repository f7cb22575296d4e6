// XLA's f32 logistic for Hopper (sm_90a): K4.
//
// No TPU kernel: this replaces the reference's jax.nn.sigmoid
// (xgboost_tpu/objective/regression.py:113), the binary:logistic gradient's
// and prediction's transform.  XLA on the CPU compiles it into
// 1 / (1 + exp(-x)) with its own f32 exponential, so PyTorch's sigmoid does
// not give the reference's bits.  This kernel computes, for every element,
// what the plain version utils/fp.py sigmoid_f32 computes, op for op:
//
//   exp: clamp to [-104, 88.8]; n = floor(x log2(e) + 1/2), at most 127;
//        r = x - n ln2 in two parts; the Cephes degree-6 polynomial in r by
//        Horner's rule; 1 + (y r^2 + r); times 2^n as two factors
//        2^lo 2^(n-lo), so that n down to -150 fits the exponent field; a
//        result below the smallest normal f32 flushed to zero
//   sigmoid: 1 / (1 + exp(-x)), flushed the same way
//
// Every multiply-add that XLA fuses is written out as __fmaf_rn and every
// other operation as its own rounded intrinsic; the library is built with
// --fmad=false (ops/hist_cuda.py) and without fast math, so nvcc contracts
// nothing and the division is IEEE div.rn.  The results are bitwise the
// plain version's on any f32 input (NaN stays NaN).
//
// Bound on an H100 SXM (3.35 TB/s): 4 bytes read and 4 written per
// element, about 30 f32 operations on each; at the main path's 1,000,448
// margins that is 8 MB, about 2.4 us, by the bytes.
//
// Design.  One thread per element in a grid-stride loop over 256-thread
// blocks: each element is independent, the loads and stores coalesce, and
// the arithmetic hides under the memory traffic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal f32

__device__ __forceinline__ float flush(float v) {
  return v < kFltMin ? 0.0f : v;
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

__global__ void __launch_bounds__(kThreads)
    sigmoid_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long n) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const float v = x[i];
    out[i] = isnan(v) ? v
                      : flush(__fdiv_rn(1.0f, __fadd_rn(1.0f, exp_xla(-v))));
  }
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
  // enough blocks to fill the card several times over; the loop strides
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 65536 ? blocks : 65536);
  sigmoid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return status(cudaGetLastError());
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
