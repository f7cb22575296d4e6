// LambdaMART top-k pair gradients for Hopper (sm_90a): K5.
//
// No TPU kernel: this replaces the reference's native CPU kernel
// xtb_lambdarank_topk_impl (native/xtb_kernels.h:997-1068), which
// xgboost_tpu/objective/ranking.py:139 (_lambda_gradients_topk_native)
// calls for rank:ndcg, rank:pairwise and rank:map with the default
// lambdarank_pair_method "topk".  Its bits come from sequential f32 sums
// in loop order and from glibc's expf, exp2f and log2f, so this kernel
// keeps both: what ops/lambdarank_cuda.py lambdarank_topk_plain computes
// in PyTorch operations, in one launch a round.
//
// Per query group g of n docs, with the docs in the order of a stable
// descending sort of their scores (order, from the wrapper) and the labels
// sorted descending (ideal):
//   gain[p]  = exp2f(y) - 1 at sorted position p; disc[p] = 1/log2f(2+p)
//              (a table from utils/libm.py)
//   idcg     = sum over p of exp2f(y_ideal[p]) - 1 times disc[p], in
//              order, at least 1e-10
//   spread   = the first and last sorted scores differ
//   each pair (i, j), i < min(k, n), i < j < n, with gain[i] != gain[j]:
//     high, low = the pair's higher- and lower-gain doc's scores
//     sig   = 1 / (1 + expf(-(high - low)))
//     delta = |(gain[i] - gain[j]) (disc[i] - disc[j])| / idcg (ndcg) or 1
//     delta = delta / (|high - low| + 0.01) where score_norm and spread
//     lam   = (sig - 1) delta; h = 2 max(sig (1 - sig) delta, 1e-16)
//     lam_acc[i] += lam sgn; lam_acc[j] -= lam sgn (sgn = +1 if i is high)
//     hess_acc[i] += h; hess_acc[j] += h; sum_lambda += -2 lam
//   norm = log2f(1 + sum_lambda) / max(sum_lambda, 1e-16) where group_norm
//          and sum_lambda > 0, else 1
//   grad, hess of the doc at position p = lam_acc[p] norm, hess_acc[p] norm
// The native loop adds into each position first its terms as the j of a
// pair (over i ascending), then as the i (over j ascending), and sums
// sum_lambda over (i, j) in loop order; the kernel adds in the same
// orders.  Groups of one doc and rows outside every group get (0, 0).
//
// glibc's functions are its FMA variants (e_expf-fma.c and the like, the
// ones an x86-64 CPU with FMA resolves): a table and a polynomial in
// double, rounded once to float; the fused multiply-adds of their machine
// code are __fma_rn here, every other operation a single rounded one.
// The library is built with --fmad=false (ops/hist_cuda.py EXTRA_FLAGS),
// so nvcc contracts nothing else, and without fast math, so f32 division
// is IEEE div.rn and subnormals are kept, as on the CPU.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the inputs (scores,
// labels, the two orders, 16 bytes a row), the group pointer and the
// output pairs (8 bytes a row) are read or written once: about 75 MB at
// the MSLR-shaped main path's 3.77M rows, 0.022 ms.  Each pair costs an
// expf (about 20 double operations, 5 of them fused) and about 15 f32
// operations: about 104M pairs a round, some 0.05 ms at the card's peak,
// so operations bound it (chip_smoke.py phase 2g counts this run's pairs).
//
// Design.  One block of 128 threads per group.  A first pass gathers each
// sorted position's score and gain into the scratch rows and the ideal
// products; one thread sums idcg in order.  Then for each of the top
// min(k, n) positions i in turn, the block computes the pair terms of i
// with every j > i in chunks of kChunk: each thread its own j's terms,
// which it subtracts from j's accumulators (j's as-j terms arrive in i
// order, one row at a time) and writes to shared memory; three lanes then
// add the chunk in j order, one into i's gradient, one into i's hessian,
// one into sum_lambda.  Any group size works: the accumulators live in the
// scratch rows (global memory, cached), the chunks bound the shared
// memory, and k > n takes all n.  A first design that is right, not yet a
// fast one: each of a group's min(k, n) rows waits on one term's latency
// (the scratch rows in global memory, an expf and three f32 divisions)
// and two barriers, while the serial lanes add (unrolling their loads
// changed nothing on the card), so the launch runs at some 34 times its
// bound at the MSLR shape (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;

__constant__ unsigned long long kExp2fTab[32] = {
    0x3FF0000000000000ull, 0x3FEFD9B0D3158574ull, 0x3FEFB5586CF9890Full,
    0x3FEF9301D0125B51ull, 0x3FEF72B83C7D517Bull, 0x3FEF54873168B9AAull,
    0x3FEF387A6E756238ull, 0x3FEF1E9DF51FDEE1ull, 0x3FEF06FE0A31B715ull,
    0x3FEEF1A7373AA9CBull, 0x3FEEDEA64C123422ull, 0x3FEECE086061892Dull,
    0x3FEEBFDAD5362A27ull, 0x3FEEB42B569D4F82ull, 0x3FEEAB07DD485429ull,
    0x3FEEA47EB03A5585ull, 0x3FEEA09E667F3BCDull, 0x3FEE9F75E8EC5F74ull,
    0x3FEEA11473EB0187ull, 0x3FEEA589994CCE13ull, 0x3FEEACE5422AA0DBull,
    0x3FEEB737B0CDC5E5ull, 0x3FEEC49182A3F090ull, 0x3FEED503B23E255Dull,
    0x3FEEE89F995AD3ADull, 0x3FEEFF76F2FB5E47ull, 0x3FEF199BDD85529Cull,
    0x3FEF3720DCEF9069ull, 0x3FEF5818DCFBA487ull, 0x3FEF7C97337B9B5Full,
    0x3FEFA4AFA2A490DAull, 0x3FEFD0765B6E4540ull};

// (1/c, log2(c)) of glibc's __log2f_data
__constant__ double kLog2fTab[16][2] = {
    {0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2},
    {0x1.571ed4aaf883dp+0, -0x1.b0b6832d4fca4p-2},
    {0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2},
    {0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2},
    {0x1.30d190c8864a5p+0, -0x1.01d9bf3f2b631p-2},
    {0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3},
    {0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3},
    {0x1.12358f08ae5bap+0, -0x1.960cbbf788d5cp-4},
    {0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5},
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.e608cfd9a47acp-1, 0x1.338ca9f24f53dp-4},
    {0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3},
    {0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3},
    {0x1.9c2d163a1aa2dp-1, 0x1.40645f0c6651cp-2},
    {0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2},
    {0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2}};

__device__ __forceinline__ float quiet(float x) {
  return __uint_as_float(__float_as_uint(x) | 0x00400000u);
}

// s 2^(k/32) times the cubic in r, rounded once to float
__device__ __forceinline__ float exp_tail(double kd_raw, double r, double c0,
                                          double c1, double c2) {
  const unsigned long long ki =
      static_cast<unsigned long long>(__double_as_longlong(kd_raw));
  const unsigned long long t = kExp2fTab[ki & 31] + (ki << 47);
  const double s = __longlong_as_double(static_cast<long long>(t));
  const double z = __fma_rn(r, c0, c1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(r, c2, 1.0);
  y = __fma_rn(z, r2, y);
  return __double2float_rn(__dmul_rn(y, s));
}

__device__ float glibc_expf(float x) {
  const uint32_t ix = __float_as_uint(x);
  const uint32_t abstop = (ix >> 20) & 0x7ff;
  if (abstop >= 0x42b) {
    if (ix == 0xff800000u) return 0.0f;
    if (abstop >= 0x7f8) return isnan(x) ? quiet(x) : x;
    if (x > 0x1.62e42ep+6f) return __int_as_float(0x7f800000);
    if (x < -0x1.9fe368p+6f) return 0.0f;
    if (x < -0x1.9d1d9ep+6f) return 0x1p-149f;
  }
  const double xd = static_cast<double>(x);
  const double kd_raw = __fma_rn(xd, 0x1.71547652b82fep+5, 0x1.8p+52);
  const double kd = __dsub_rn(kd_raw, 0x1.8p+52);
  const double r = __fma_rn(xd, 0x1.71547652b82fep+5, -kd);
  return exp_tail(kd_raw, r, 0x1.c6af84b912394p-20, 0x1.ebfce50fac4f3p-13,
                  0x1.62e42ff0c52d6p-6);
}

__device__ float glibc_exp2f(float x) {
  const uint32_t ix = __float_as_uint(x);
  const uint32_t abstop = (ix >> 20) & 0x7ff;
  if (abstop >= 0x430) {
    if (ix == 0xff800000u) return 0.0f;
    if (abstop >= 0x7f8) return isnan(x) ? quiet(x) : x;
    if (x > 0.0f) return __int_as_float(0x7f800000);
    if (x <= -150.0f) return 0.0f;
    if (x < -149.0f) return 0x1p-149f;
  }
  const double xd = static_cast<double>(x);
  const double kd_raw = __dadd_rn(xd, 0x1.8p+47);
  const double kd = __dsub_rn(kd_raw, 0x1.8p+47);
  const double r = __dsub_rn(xd, kd);
  return exp_tail(kd_raw, r, 0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3,
                  0x1.62e42ff0c52d6p-1);
}

__device__ float glibc_log2f(float x) {
  uint32_t ix = __float_as_uint(x);
  if (ix == 0x3f800000u) return 0.0f;
  if (ix - 0x00800000u >= 0x7f000000u) {
    if (ix * 2 == 0) return __int_as_float(0xff800000);
    if (ix == 0x7f800000u) return x;
    if ((ix & 0x80000000u) || ix * 2 >= 0xff000000u)
      return isnan(x) ? quiet(x) : __int_as_float(0xffc00000);
    // a subnormal: the bits of x 2^23, less 23 in the exponent
    ix = __float_as_uint(static_cast<float>(ix)) - (149u << 23);
  }
  const uint32_t tmp = ix - 0x3f330000u;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xff800000u;
  const uint32_t iz = ix - top;
  const int k = static_cast<int32_t>(tmp) >> 23;
  const double invc = kLog2fTab[i][0], logc = kLog2fTab[i][1];
  const double z = static_cast<double>(__uint_as_float(iz));
  const double r = __fma_rn(z, invc, -1.0);
  const double y0 = __dadd_rn(static_cast<double>(k), logc);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(r, 0x1.ecabf496832e0p-2, -0x1.715479ffae3dep-1);
  const double p = __fma_rn(r, 0x1.715475f35c8b8p+0, y0);
  y = __fma_rn(r2, -0x1.712b6f70a7e4dp-2, y);
  y = __fma_rn(r2, y, p);
  return __double2float_rn(y);
}

// One block per group.  scratch rows (each r_g floats): sorted scores,
// sorted gains, the gradient and the hessian accumulators.
__global__ void __launch_bounds__(kThreads)
lambdarank_kernel(const float* __restrict__ s, const float* __restrict__ y,
                  const int* __restrict__ order,
                  const int* __restrict__ ideal,
                  const int* __restrict__ gptr,
                  const float* __restrict__ disc, int k, int ndcg_weight,
                  int score_norm, int group_norm, float* __restrict__ scratch,
                  long long r_g, float* __restrict__ out) {
  __shared__ float buf_lam[kChunk];
  __shared__ float buf_hess[kChunk];
  __shared__ float buf_sum[kChunk];
  __shared__ float sh_idcg, sh_norm;
  const int g = blockIdx.x;
  const int lo = gptr[g];
  const int n = gptr[g + 1] - lo;
  if (n <= 1) return;  // the wrapper's zeros stand
  const int tid = threadIdx.x;
  float* s_srt = scratch + lo;
  float* gain = scratch + r_g + lo;
  float* lam_acc = scratch + 2 * r_g + lo;
  float* hess_acc = scratch + 3 * r_g + lo;

  for (int p = tid; p < n; p += kThreads) {
    const int row = order[lo + p];
    s_srt[p] = s[row];
    gain[p] = __fsub_rn(glibc_exp2f(y[row]), 1.0f);
    // the ideal product, in the hessian row until idcg is summed
    hess_acc[p] = __fmul_rn(__fsub_rn(glibc_exp2f(y[ideal[lo + p]]), 1.0f),
                            disc[p]);
  }
  __syncthreads();
  if (tid == 0) {
    float idcg = 0.0f;
    for (int p = 0; p < n; ++p) idcg = __fadd_rn(idcg, hess_acc[p]);
    sh_idcg = idcg < 1e-10f ? 1e-10f : idcg;
  }
  __syncthreads();
  for (int p = tid; p < n; p += kThreads) {
    lam_acc[p] = 0.0f;
    hess_acc[p] = 0.0f;
  }
  const float idcg = sh_idcg;
  const bool spread = s_srt[0] != s_srt[n - 1];
  const int kk = k < n ? k : n;
  // the serial lanes' running sums: lane 0 a position's gradient, lane
  // 32 its hessian, lane 64 sum_lambda over the whole group
  float acc = 0.0f;
  __syncthreads();

  for (int i = 0; i < kk; ++i) {
    const float si = s_srt[i], gi = gain[i], di = disc[i];
    if (tid == 0) acc = lam_acc[i];
    if (tid == 32) acc = hess_acc[i];
    for (int c0 = i + 1; c0 < n; c0 += kChunk) {
      const int m = (n - c0) < kChunk ? (n - c0) : kChunk;
      for (int t = tid; t < m; t += kThreads) {
        const int j = c0 + t;
        const float gj = gain[j];
        float ls = 0.0f, hv = 0.0f, m2 = 0.0f;
        if (gi != gj) {
          const bool high_is_i = gi > gj;
          const float sj = s_srt[j];
          const float s_high = high_is_i ? si : sj;
          const float s_low = high_is_i ? sj : si;
          const float diff = __fsub_rn(s_high, s_low);
          const float sig =
              __fdiv_rn(1.0f, __fadd_rn(1.0f, glibc_expf(-diff)));
          float delta = 1.0f;
          if (ndcg_weight) {
            delta = __fdiv_rn(
                fabsf(__fmul_rn(__fsub_rn(gi, gj), __fsub_rn(di, disc[j]))),
                idcg);
          }
          if (score_norm && spread) {
            delta = __fdiv_rn(delta, __fadd_rn(fabsf(diff), 0.01f));
          }
          const float lam = __fmul_rn(__fsub_rn(sig, 1.0f), delta);
          float h = __fmul_rn(__fmul_rn(sig, __fsub_rn(1.0f, sig)), delta);
          if (h < 1e-16f) h = 1e-16f;
          h = __fmul_rn(h, 2.0f);
          ls = high_is_i ? lam : -lam;
          hv = h;
          m2 = __fmul_rn(-2.0f, lam);
          lam_acc[j] = __fsub_rn(lam_acc[j], ls);
          hess_acc[j] = __fadd_rn(hess_acc[j], h);
        }
        buf_lam[t] = ls;
        buf_hess[t] = hv;
        buf_sum[t] = m2;
      }
      __syncthreads();
      if (tid == 0 || tid == 32 || tid == 64) {
        const float* b = tid == 0 ? buf_lam : tid == 32 ? buf_hess : buf_sum;
        for (int t = 0; t < m; ++t) acc = __fadd_rn(acc, b[t]);
      }
      __syncthreads();
    }
    if (tid == 0) lam_acc[i] = acc;
    if (tid == 32) hess_acc[i] = acc;
    __syncthreads();
  }

  if (tid == 64) {
    float norm = 1.0f;
    if (group_norm && acc > 0.0f) {
      const float d = acc > 1e-16f ? acc : 1e-16f;
      norm = __fdiv_rn(glibc_log2f(__fadd_rn(1.0f, acc)), d);
    }
    sh_norm = norm;
  }
  __syncthreads();
  const float norm = sh_norm;
  for (int p = tid; p < n; p += kThreads) {
    const long long row = order[lo + p];
    out[2 * row] = __fmul_rn(lam_acc[p], norm);
    out[2 * row + 1] = __fmul_rn(hess_acc[p], norm);
  }
}

int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// s, y (R,) f32; order, ideal (r_g,) int32: the rows of each group's
// stable descending sort by score, and by label; gptr (n_groups + 1,)
// int32 with gptr[n_groups] = r_g <= R; disc (largest group,) f32;
// scratch (4, r_g) f32; out (R, 2) f32, zero where no group of two or
// more docs writes.  All contiguous on the current device.  Returns a
// cudaError_t.
int xtb_lambdarank(const void* s, const void* y, const void* order,
                   const void* ideal, const void* gptr, int n_groups,
                   const void* disc, int k, int ndcg_weight, int score_norm,
                   int group_norm, void* scratch, long long r_g, void* out,
                   void* stream) {
  if (n_groups < 1 || k < 0) return (int)cudaErrorInvalidValue;
  lambdarank_kernel<<<n_groups, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(y),
      static_cast<const int*>(order), static_cast<const int*>(ideal),
      static_cast<const int*>(gptr), static_cast<const float*>(disc), k,
      ndcg_weight, score_norm, group_norm, static_cast<float*>(scratch), r_g,
      static_cast<float*>(out));
  return status(cudaGetLastError());
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
