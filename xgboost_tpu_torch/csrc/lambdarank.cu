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
// descending sort of their scores and the labels sorted descending:
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
// Groups of one doc and rows outside every group get (0, 0): the wrapper's
// zeros stand.
//
// The sum orders, which every path here keeps (native/xtb_kernels.h):
// - the sorts (:1012 std::stable_sort of the scores, :1022 std::sort of
//   the gains): a doc's sorted position is its rank under the key of
//   ops/lambdarank_cuda.py _desc_bits (the order-preserving bits of -v,
//   -0.0 as +0.0, NaN last) with ties by row; the ideal gains need only
//   their values, so the labels are ranked the same way;
// - idcg (:1024): one chain over the ideal positions in order;
// - each position p (:1032-1056, i outer, j inner): one chain, first its
//   terms as the j of a pair, over i ascending, then, if p < min(k, n), its
//   terms as the i, over j ascending;
// - sum_lambda (:1057): one chain over every pair (i, j) in that loop
//   order.  A skipped pair (equal gains) adds nothing; the kernel adds
//   +0.0 there, which leaves every chain's bits as they are (a chain that
//   starts at +0.0 is never -0.0).
// The pair terms depend only on the sorted scores and gains, disc, idcg
// and spread, never on the chains, so they are computed in parallel ahead
// of the chains.  Only the chains are serial; the longest is sum_lambda,
// about 2,640 dependent adds a group at the MSLR shape.
//
// glibc's functions are its FMA variants (e_expf-fma.c and the like, the
// ones an x86-64 CPU with FMA resolves): a table and a polynomial in
// double, rounded once to float; the fused multiply-adds of their machine
// code are __fma_rn here, every other operation a single rounded one.
// Each block copies exp2f's 32-entry table from constant memory into
// shared memory once: expf's lanes index it at random, which constant
// memory serves one address at a time; expf's four double constants are
// read from the constant bank as operands (kExpfC), which spares the
// registers that hold them.  The library is built with --fmad=false
// (ops/hist_cuda.py EXTRA_FLAGS), so nvcc contracts nothing else, and
// without fast math, so f32 division is IEEE div.rn and subnormals are
// kept, as on the CPU; sig's 1 / x is rcp.rn, the same correctly rounded
// number.
//
// Bound on an H100 SXM (3.35 TB/s; 34 TFLOP/s f64 and 67 f32 outside the
// tensor cores): chip_smoke.py _lambdarank_work counts 24 bytes a grouped
// row (scores, labels, the two sorted orders the kernel's first design
// read, the output pairs), about 90 MB and 0.027 ms at the MSLR-shaped
// main path's 3.77M rows, and, for each pair with distinct gains, an expf
// (about 15 double operations) and about 15 f32 operations: 83M pairs at
// phase 2g's MSLR case, 0.055 ms at the card's peak, so operations bound
// it.
//
// Design.  Two paths in one launch, by group size.
//
// Bundles (groups of 2 to kCap docs; every group of an MSLR-shaped set).
// The wrapper packs these groups, in order, into bundles of at most
// kBundleDocs docs and kBundleGroups groups (GroupLayout, made once; the
// entry refuses a launch beyond them, and xtb_lambdarank_geometry reads
// them out for the wrapper's check), and a block of 288 threads takes one
// bundle: eight producer warps and one
// consumer warp.  Everything a bundle needs lives in shared memory, 53
// bytes a doc: each sorted position's descriptor (score, gain, disc and
// its group's indices, one 16-byte load), the (gradient, hessian) chains,
// two row buffers of pair terms and the sort's inverse (the setup's rows,
// gains and ideal products borrow the row buffers); 54,864 bytes at 1024
// docs and 256-doc groups, which the launch opts into.  Four blocks share
// an SM (the registers of __launch_bounds__ allow four, and the shared
// memory): 32 producer warps and about 32 MSLR groups an SM, at least 16
// groups of kCap docs (four a bundle).  kCap = 256 is the largest group
// of which 16 fit an SM's 228 KB at that rate.  A block
// 1. loads its rows and computes each doc's gain once;
// 2. sorts each group, one warp a group: a bitonic network held in
//    registers, 1-8 keys a lane by the group's size, over the scores'
//    64-bit keys (the 32-bit key above the doc's index, so equal keys keep
//    row order) and beside them the labels' 32-bit keys; it scatters the
//    sorted positions' descriptors, each doc's sorted position, and the
//    ideal products (each position's gain made again from its label's
//    key);
// 3. sums each group's idcg, one lane a group;
// 4. runs a pipeline over the top rows i = 0 .. max k - 1.  Producer thread
//    t owns the docs d = t + 256 m of the bundle: for row i it computes the
//    terms (ls = lam sgn, h, -2 lam) of each owned doc j > i, writes them
//    to the row buffer i mod 2, and adds ls and h to j's own chains, in i
//    order with no race (the chains as j).  The consumer warp has three
//    lanes a group: one sums row i's ls into i's gradient chain, one its h
//    into i's hessian chain (each started from the value i's chains hold
//    after the rows before it), one its -2 lam into the group's
//    sum_lambda, over j ascending.  Producers and consumer signal
//    through named barriers (bar.arrive / bar.sync on ids 1-4, full and
//    empty for each buffer): while the consumer sums row i, the producers
//    compute row i + 1;
// 5. after one block barrier, the group's norm scales each doc's chains,
//    written by row (one float2 a row, coalesced).
//
// Large groups (more than kCap docs): one block a group, the kernel's
// first design through global scratch rows, with the wrapper's two sorts
// (order and ideal over those groups' rows): for each top row i, the block
// computes i's terms in chunks of kChunk into shared memory, subtracts each
// from its j's chains, and three lanes add the chunk in j order.  A launch
// that has such a group runs both paths, each block its own.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kProd = 256;            // producer threads: eight warps
constexpr int kThreads = kProd + 32;  // and the consumer warp
constexpr int kBlocksPerSM = 4;       // the residency the registers allow
constexpr int kCap = 256;             // largest group of the bundle path
constexpr int kBundleDocs = 1024;     // docs of a bundle
constexpr int kBundleGroups = 10;     // groups of a bundle, three lanes each
constexpr int kSlots = 2;             // row buffers of the pipeline
constexpr int kFull = 1;              // named barriers: full 1-2, empty 3-4
constexpr int kEmpty = kFull + kSlots;
constexpr int kChunk = 2048;          // the large-group path's columns

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

// expf's constants, read as operands from the constant bank
__constant__ double kExpfC[4] = {0x1.71547652b82fep+5, 0x1.c6af84b912394p-20,
                                 0x1.ebfce50fac4f3p-13,
                                 0x1.62e42ff0c52d6p-6};

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

// s 2^(k/32) times the cubic in r, rounded once to float; tab is the
// block's shared copy of kExp2fTab
__device__ __forceinline__ float exp_tail(double kd_raw, double r, double c0,
                                          double c1, double c2,
                                          const unsigned long long* tab) {
  const unsigned long long ki =
      static_cast<unsigned long long>(__double_as_longlong(kd_raw));
  const unsigned long long t = tab[ki & 31] + (ki << 47);
  const double s = __longlong_as_double(static_cast<long long>(t));
  const double z = __fma_rn(r, c0, c1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(r, c2, 1.0);
  y = __fma_rn(z, r2, y);
  return __double2float_rn(__dmul_rn(y, s));
}

__device__ float glibc_expf(float x, const unsigned long long* tab) {
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
  const double kd_raw = __fma_rn(xd, kExpfC[0], 0x1.8p+52);
  const double kd = __dsub_rn(kd_raw, 0x1.8p+52);
  const double r = __fma_rn(xd, kExpfC[0], -kd);
  return exp_tail(kd_raw, r, kExpfC[1], kExpfC[2], kExpfC[3], tab);
}

__device__ float glibc_exp2f(float x, const unsigned long long* tab) {
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
                  0x1.62e42ff0c52d6p-1, tab);
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

// One pair's terms: ls = lam sgn (i's gradient term; j's is -ls), the
// doubled, floored hessian term and sum_lambda's -2 lam.  gi != gj.
__device__ __forceinline__ void pair_terms(float si, float gi, float di,
                                           float sj, float gj, float dj,
                                           float idcg, bool ndcg_weight,
                                           bool norm_diff,
                                           const unsigned long long* tab,
                                           float& ls, float& hv, float& m2) {
  const bool high_is_i = gi > gj;
  const float diff = high_is_i ? __fsub_rn(si, sj) : __fsub_rn(sj, si);
  const float sig = __frcp_rn(__fadd_rn(1.0f, glibc_expf(-diff, tab)));
  float delta = 1.0f;
  if (ndcg_weight) {
    delta = __fdiv_rn(fabsf(__fmul_rn(__fsub_rn(gi, gj), __fsub_rn(di, dj))),
                      idcg);
  }
  if (norm_diff) delta = __fdiv_rn(delta, __fadd_rn(fabsf(diff), 0.01f));
  const float lam = __fmul_rn(__fsub_rn(sig, 1.0f), delta);
  float h = __fmul_rn(__fmul_rn(sig, __fsub_rn(1.0f, sig)), delta);
  if (h < 1e-16f) h = 1e-16f;
  hv = __fmul_rn(h, 2.0f);
  ls = high_is_i ? lam : -lam;
  m2 = __fmul_rn(-2.0f, lam);
}

__device__ __forceinline__ float group_norm_of(float sum, int group_norm) {
  float norm = 1.0f;
  if (group_norm && sum > 0.0f) {
    const float d = sum > 1e-16f ? sum : 1e-16f;
    norm = __fdiv_rn(glibc_log2f(__fadd_rn(1.0f, sum)), d);
  }
  return norm;
}

struct Args {
  const float* s;
  const float* y;
  const int* gptr;
  const float* disc;
  // bundles: bptr (n_bundles + 1) into bgroups, the groups of each bundle
  const int* bptr;
  const int* bgroups;
  int n_bundles;
  int docs;   // the largest bundle's docs, rounded up to a multiple of 4
  int max_n;  // the largest bundled group, rounded up to a multiple of 4
  int n_disc;  // the largest bundled group: disc's entries the block copies
  // large groups: big_ptr (n_big + 1) into order, ideal and the scratch
  // rows, which hold their rows, sorted by score and by label
  const int* big_ptr;
  int n_big;
  const int* order;
  const int* ideal;
  float* scratch;
  long long r_big;
  int k, ndcg_weight, score_norm, group_norm;
  float* out;
};

struct GroupInfo {
  int start;   // first doc in the bundle
  int n;       // docs
  int kk;      // top rows, min(k, n)
  int row0;    // first row in the inputs
  float idcg;  // idcg and spread (1.0f or 0.0f) side by side, one load
  float spread;
  float norm;
  int pad;
};

// a sorted position's descriptor: score, gain, disc and, in w, its
// group's start in the bundle (10 bits), the position (8 bits), the
// group's top rows (9 bits) and the group's index (4 bits)
__device__ __forceinline__ float4 descriptor(float score, float gain,
                                             float disc, int gs, int j,
                                             int kk, int g) {
  return make_float4(score, gain, disc,
                     __uint_as_float(static_cast<uint32_t>(
                         gs | (j << 10) | (kk << 18) | (g << 27))));
}

// the bundle path's shared memory for ``docs`` and ``max_n`` (multiples of
// 4): the descriptors (16 bytes a doc), acc and the row buffers' (ls, h)
// (float2 a doc), the row buffers' -2 lam and inv (4 bytes a doc), disc,
// exp2f's table, the groups, the bundle's docs and rows
__host__ __device__ constexpr size_t bundle_bytes(int docs, int max_n) {
  return 16 * size_t(docs) + 8 * size_t(docs) * (1 + kSlots) +
         4 * size_t(docs) * (kSlots + 1) + 4 * max_n + 8 * 32 +
         sizeof(GroupInfo) * kBundleGroups + 16;
}
constexpr size_t kBigBytes = 3 * 4 * kChunk + 8 * 32 + 16;
static_assert(kBlocksPerSM * (bundle_bytes(kBundleDocs, kCap) + 1024) <=
                  228 * 1024,
              "kBlocksPerSM bundles share an SM's shared memory");

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// the order-preserving bits of -v: -0.0 as +0.0, NaN (any) last
__device__ __forceinline__ uint32_t desc_key(float v) {
  const float neg = -v;
  uint32_t b = __float_as_uint(neg);
  if (neg == 0.0f) b = 0u;
  if (isnan(neg)) b = 0x7fc00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// a label's value back from its key: -0.0 comes back as +0.0 and a NaN
// as the one NaN, whose gains are the same (a NaN is the card's one NaN
// after the product with disc)
__device__ __forceinline__ float desc_value(uint32_t key) {
  const uint32_t b = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return -__uint_as_float(b);
}

template <typename T>
__device__ __forceinline__ void order2(T& lo, T& hi, bool up) {
  if ((lo > hi) == up) {
    const T t = lo;
    lo = hi;
    hi = t;
  }
}

// the lower (keep_min) or higher of x and its partner; equal keys are
// one value either way
template <typename T>
__device__ __forceinline__ T keep(T x, T other, bool keep_min) {
  return (other < x) == keep_min ? other : x;
}

// Bitonic sort of 32 E keys, ascending, two arrays side by side: element
// e of lane l is position l E + e.
template <int E>
__device__ __forceinline__ void bitonic(unsigned long long (&a)[E],
                                        uint32_t (&b)[E], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {  // both elements of a pair in this lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0) {
            const bool up = ((lane * E + e) & k) == 0;
            order2(a[e], a[e | j], up);
            order2(b[e], b[e | j], up);
          }
        }
      } else {  // the partner is element e of lane l ^ (j / E)
        const int m = j / E;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool keep_min = lower == (((lane * E + e) & k) == 0);
          a[e] = keep(a[e], __shfl_xor_sync(~0u, a[e], m), keep_min);
          b[e] = keep(b[e], __shfl_xor_sync(~0u, b[e], m), keep_min);
        }
      }
    }
  }
}

// One warp sorts one group of n <= 32 E docs starting at bundle doc gs:
// raw (score, label) and gain a doc in row order; writes the sorted
// (score, gain), each doc's sorted position, and the ideal products.  The
// scores' keys carry the doc's index below them (distinct keys, ties in
// row order); the labels' need only their values, so their 32-bit keys
// are sorted alone and each position's gain is made again from its key.
template <int E>
__device__ void sort_group(const float2* raw, const float* gain, int gs,
                           int n, int kk, int g, int lane, const float* disc,
                           const unsigned long long* tab, float4* dsc,
                           int* inv, float* prod) {
  unsigned long long ks[E];
  uint32_t ky[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = lane * E + e;
    if (p < n) {
      const float2 v = raw[gs + p];
      ks[e] = (static_cast<unsigned long long>(desc_key(v.x)) << 32) |
              static_cast<unsigned>(p);
      ky[e] = desc_key(v.y);
    } else {
      ks[e] = ~0ull;
      ky[e] = ~0u;
    }
  }
  bitonic<E>(ks, ky, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = lane * E + e;
    if (p < n) {
      const int ds = gs + static_cast<int>(ks[e] & 0xffffffffu);
      dsc[gs + p] = descriptor(raw[ds].x, gain[ds], disc[p], gs, p, kk, g);
      inv[ds] = gs + p;
      const float ideal =
          __fsub_rn(glibc_exp2f(desc_value(ky[e]), tab), 1.0f);
      prod[gs + p] = __fmul_rn(ideal, disc[p]);
    }
  }
}

__device__ __forceinline__ void bundle_block(const Args& a,
                                             unsigned char* smem, int b) {
  const int D = a.docs;
  float4* dsc = reinterpret_cast<float4*>(smem);  // sorted positions
  float2* acc = reinterpret_cast<float2*>(dsc + D);  // (gradient, hessian)
  float2* ring = acc + D;  // kSlots row buffers: (ls, h) of each j
  float* ring_m2 = reinterpret_cast<float*>(ring + kSlots * D);  // -2 lam
  int* inv = reinterpret_cast<int*>(ring_m2 + kSlots * D);
  float* disc = reinterpret_cast<float*>(inv + D);
  unsigned long long* tab =
      reinterpret_cast<unsigned long long*>(disc + a.max_n);
  GroupInfo* gi = reinterpret_cast<GroupInfo*>(tab + 32);
  int* misc = reinterpret_cast<int*>(gi + kBundleGroups);  // docs, rows

  const int tid = threadIdx.x;
  const int first = a.bptr[b];
  const int ng = a.bptr[b + 1] - first;
  if (tid < 32) {
    tab[tid] = kExp2fTab[tid];
    int n = 0, row0 = 0;
    if (tid < ng) {
      const int g = a.bgroups[first + tid];
      row0 = a.gptr[g];
      n = a.gptr[g + 1] - row0;
    }
    int start = n;  // the groups' starts: an inclusive scan, less n
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, start, o);
      if (tid >= o) start += v;
    }
    start -= n;
    if (tid < ng) {
      GroupInfo q;
      q.start = start;
      q.n = n;
      q.kk = a.k < n ? a.k : n;
      q.row0 = row0;
      q.idcg = 0.0f;
      q.spread = 0.0f;
      q.norm = 1.0f;
      q.pad = 0;
      gi[tid] = q;
    }
    if (tid == ng - 1) misc[0] = start + n;
  }
  for (int p = tid; p < a.n_disc; p += kThreads) disc[p] = a.disc[p];
  __syncthreads();

  // 1. rows: raw (score, label) in buffer 0, each doc's gain in buffer 0's
  // -2 lam row, and the ideal products (step 2) in buffer 1's
  const int nd = misc[0];
  float2* raw = ring;
  float* gain = ring_m2;
  float* prod = ring_m2 + D;
  for (int d = tid; d < nd; d += kThreads) {
    int g = 0;
    while (g + 1 < ng && d >= gi[g + 1].start) ++g;
    const long long row = gi[g].row0 + (d - gi[g].start);
    const float sv = a.s[row], yv = a.y[row];
    raw[d] = make_float2(sv, yv);
    gain[d] = __fsub_rn(glibc_exp2f(yv, tab), 1.0f);
    acc[d] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // 2. sorts, one warp a group
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < ng; g += kThreads / 32) {
    const int gs = gi[g].start, n = gi[g].n, kk = gi[g].kk;
    if (n <= 32) {
      sort_group<1>(raw, gain, gs, n, kk, g, lane, disc, tab, dsc, inv, prod);
    } else if (n <= 64) {
      sort_group<2>(raw, gain, gs, n, kk, g, lane, disc, tab, dsc, inv, prod);
    } else if (n <= 128) {
      sort_group<4>(raw, gain, gs, n, kk, g, lane, disc, tab, dsc, inv, prod);
    } else {
      sort_group<8>(raw, gain, gs, n, kk, g, lane, disc, tab, dsc, inv, prod);
    }
  }
  __syncthreads();

  // 3. idcg and spread, one lane a group; the rows of the pipeline
  if (tid < ng) {
    const int gs = gi[tid].start, n = gi[tid].n;
    float idcg = 0.0f;
#pragma unroll 8
    for (int p = 0; p < n; ++p) idcg = __fadd_rn(idcg, prod[gs + p]);
    gi[tid].idcg = idcg < 1e-10f ? 1e-10f : idcg;
    gi[tid].spread = dsc[gs].x != dsc[gs + n - 1].x ? 1.0f : 0.0f;
  }
  if (tid == 0) {
    int rows = 0;
    for (int g = 0; g < ng; ++g) rows = gi[g].kk > rows ? gi[g].kk : rows;
    misc[1] = rows;
  }
  __syncthreads();

  // 4. the pipeline over the top rows
  const int rows = misc[1];
  if (tid < kProd) {
    for (int i = 0; i < rows; ++i) {
      const int slot = i % kSlots;
      if (i >= kSlots) bar_sync(kEmpty + slot);
      float2* rs = ring + slot * D;
      float* rm = ring_m2 + slot * D;
      for (int d = tid; d < nd; d += kProd) {
        const float4 vj = dsc[d];
        const uint32_t w = __float_as_uint(vj.w);
        const int gs = w & 1023, j = (w >> 10) & 255, kk = (w >> 18) & 511;
        if (j <= i || i >= kk) continue;
        const float4 vi = dsc[gs + i];
        float ls = 0.0f, hv = 0.0f, m2 = 0.0f;
        if (vi.y != vj.y) {
          const float2 q = *reinterpret_cast<const float2*>(&gi[w >> 27].idcg);
          pair_terms(vi.x, vi.y, vi.z, vj.x, vj.y, vj.z, q.x,
                     a.ndcg_weight != 0, a.score_norm && q.y != 0.0f, tab, ls,
                     hv, m2);
          float2 c = acc[d];  // j's chains, as the j of the pair
          c.x = __fsub_rn(c.x, ls);
          c.y = __fadd_rn(c.y, hv);
          acc[d] = c;
        }
        rs[d] = make_float2(ls, hv);
        rm[d] = m2;
      }
      __syncwarp();
      bar_arrive(kFull + slot);
    }
  } else {
    const int lane3 = tid - kProd;
    const int g = lane3 / 3, c = lane3 - 3 * g;
    const bool on = g < ng;
    int gs = 0, n = 0, kk = 0;
    if (on) {
      gs = gi[g].start;
      n = gi[g].n;
      kk = gi[g].kk;
    }
    float sum = 0.0f;  // c == 0: the group's sum_lambda
    for (int i = 0; i < rows; ++i) {
      const int slot = i % kSlots;
      bar_sync(kFull + slot);
      if (on && i < kk) {
        // c == 0: sum_lambda over row i's -2 lam; c == 1: i's gradient
        // chain, c == 2: its hessian chain, each from what the rows before
        // i left in it, over row i's (ls, h)
        const int step = c == 0 ? 1 : 2;
        const float* col =
            c == 0 ? ring_m2 + slot * D
                   : reinterpret_cast<const float*>(ring + slot * D) + c - 1;
        float* own = reinterpret_cast<float*>(acc + gs + i) + (c == 2);
        float v = c == 0 ? sum : *own;
        const int end = step * (gs + n);
#pragma unroll 8
        for (int x = step * (gs + i + 1); x < end; x += step) {
          v = __fadd_rn(v, col[x]);
        }
        if (c == 0) {
          sum = v;
        } else {
          *own = v;
        }
      }
      __syncwarp();
      if (i + kSlots < rows) bar_arrive(kEmpty + slot);
    }
    if (on && c == 0) gi[g].norm = group_norm_of(sum, a.group_norm);
  }
  __syncthreads();

  // 5. the outputs, by row
  float2* out = reinterpret_cast<float2*>(a.out);
  for (int d = tid; d < nd; d += kThreads) {
    const int p = inv[d];
    const GroupInfo& q = gi[__float_as_uint(dsc[p].w) >> 27];
    const float2 v = acc[p];
    out[q.row0 + (d - q.start)] =
        make_float2(__fmul_rn(v.x, q.norm), __fmul_rn(v.y, q.norm));
  }
}

// A group of more than kCap docs: the first design's loop.  scratch rows
// (each r_big floats): sorted scores, sorted gains, the gradient and the
// hessian accumulators.
__device__ __forceinline__ void big_block(const Args& a, unsigned char* smem,
                                          int b) {
  float* buf_lam = reinterpret_cast<float*>(smem);
  float* buf_hess = buf_lam + kChunk;
  float* buf_sum = buf_hess + kChunk;
  unsigned long long* tab =
      reinterpret_cast<unsigned long long*>(buf_sum + kChunk);
  float* sh = reinterpret_cast<float*>(tab + 32);  // idcg, norm
  const int tid = threadIdx.x;
  const int lo = a.big_ptr[b];
  const int n = a.big_ptr[b + 1] - lo;
  const long long r_g = a.r_big;
  float* s_srt = a.scratch + lo;
  float* gain = a.scratch + r_g + lo;
  float* lam_acc = a.scratch + 2 * r_g + lo;
  float* hess_acc = a.scratch + 3 * r_g + lo;
  const float* disc = a.disc;
  if (tid < 32) tab[tid] = kExp2fTab[tid];
  __syncthreads();

  for (int p = tid; p < n; p += kThreads) {
    const int row = a.order[lo + p];
    s_srt[p] = a.s[row];
    gain[p] = __fsub_rn(glibc_exp2f(a.y[row], tab), 1.0f);
    // the ideal product, in the hessian row until idcg is summed
    hess_acc[p] = __fmul_rn(
        __fsub_rn(glibc_exp2f(a.y[a.ideal[lo + p]], tab), 1.0f), disc[p]);
  }
  __syncthreads();
  if (tid == 0) {
    float idcg = 0.0f;
    for (int p = 0; p < n; ++p) idcg = __fadd_rn(idcg, hess_acc[p]);
    sh[0] = idcg < 1e-10f ? 1e-10f : idcg;
  }
  __syncthreads();
  for (int p = tid; p < n; p += kThreads) {
    lam_acc[p] = 0.0f;
    hess_acc[p] = 0.0f;
  }
  const float idcg = sh[0];
  const bool norm_diff = a.score_norm && s_srt[0] != s_srt[n - 1];
  const int kk = a.k < n ? a.k : n;
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
          pair_terms(si, gi, di, s_srt[j], gj, disc[j], idcg,
                     a.ndcg_weight != 0, norm_diff, tab, ls, hv, m2);
          lam_acc[j] = __fsub_rn(lam_acc[j], ls);
          hess_acc[j] = __fadd_rn(hess_acc[j], hv);
        }
        buf_lam[t] = ls;
        buf_hess[t] = hv;
        buf_sum[t] = m2;
      }
      __syncthreads();
      if (tid == 0 || tid == 32 || tid == 64) {
        const float* bb = tid == 0 ? buf_lam : tid == 32 ? buf_hess : buf_sum;
        for (int t = 0; t < m; ++t) acc = __fadd_rn(acc, bb[t]);
      }
      __syncthreads();
    }
    if (tid == 0) lam_acc[i] = acc;
    if (tid == 32) hess_acc[i] = acc;
    __syncthreads();
  }

  if (tid == 64) sh[1] = group_norm_of(acc, a.group_norm);
  __syncthreads();
  const float norm = sh[1];
  for (int p = tid; p < n; p += kThreads) {
    const long long row = a.order[lo + p];
    a.out[2 * row] = __fmul_rn(lam_acc[p], norm);
    a.out[2 * row + 1] = __fmul_rn(hess_acc[p], norm);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
lambdarank_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < a.n_bundles) {
    bundle_block(a, smem, b);
  } else if (b - a.n_bundles < a.n_big) {
    big_block(a, smem, b - a.n_bundles);
  }
}

int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// the kernel may take ``bytes`` of dynamic shared memory on the current
// device (above 48 KB only by opting in, once a device and size, so that a
// launch captured into a CUDA graph makes no such call)
cudaError_t allow_bytes(size_t bytes) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= 48 * 1024 || (dev < 64 && bytes <= allowed[dev]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(lambdarank_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

size_t launch_bytes(int docs, int max_n, int n_bundles, int n_big) {
  size_t bytes = 0;
  if (n_bundles > 0) bytes = bundle_bytes(docs, max_n);
  if (n_big > 0 && kBigBytes > bytes) bytes = kBigBytes;
  return bytes;
}

int round4(int x) { return (x + 3) & ~3; }

}  // namespace

extern "C" {

// s, y (R,) f32; gptr (G + 1,) int32; bptr (n_bundles + 1,) into bgroups,
// the groups of 2 to 256 docs in bundles of at most 1024 docs and 10
// groups (bundle_docs the most docs of one, bundle_groups the most groups
// of one, max_n the largest such group);
// big_ptr (n_big + 1,) int32 into order, ideal (r_big,) int32, the rows of
// each group above 256 docs in a stable descending sort by score and by
// label, and scratch (4, r_big) f32 (all three unused where n_big is 0);
// disc (largest group,) f32; out (R, 2) f32, zero where no group of two or
// more docs writes.  All contiguous on the current device.  Returns a
// cudaError_t.
int xtb_lambdarank(const void* s, const void* y, const void* gptr,
                   const void* bptr, const void* bgroups, int n_bundles,
                   int bundle_docs, int bundle_groups, int max_n,
                   const void* big_ptr, int n_big,
                   const void* order, const void* ideal, void* scratch,
                   long long r_big, const void* disc, int k, int ndcg_weight,
                   int score_norm, int group_norm, void* out, void* stream) {
  if (n_bundles < 0 || n_big < 0 || k < 0 || bundle_docs < 0 ||
      bundle_docs > kBundleDocs || bundle_groups < 0 ||
      bundle_groups > kBundleGroups || max_n < 0 || max_n > kCap)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.s = static_cast<const float*>(s);
  a.y = static_cast<const float*>(y);
  a.gptr = static_cast<const int*>(gptr);
  a.disc = static_cast<const float*>(disc);
  a.bptr = static_cast<const int*>(bptr);
  a.bgroups = static_cast<const int*>(bgroups);
  a.n_bundles = n_bundles;
  a.docs = round4(bundle_docs);
  a.max_n = round4(max_n);
  a.n_disc = max_n;
  a.big_ptr = static_cast<const int*>(big_ptr);
  a.n_big = n_big;
  a.order = static_cast<const int*>(order);
  a.ideal = static_cast<const int*>(ideal);
  a.scratch = static_cast<float*>(scratch);
  a.r_big = r_big;
  a.k = k;
  a.ndcg_weight = ndcg_weight;
  a.score_norm = score_norm;
  a.group_norm = group_norm;
  a.out = static_cast<float*>(out);
  const int grid = n_bundles + n_big > 0 ? n_bundles + n_big : 1;
  const size_t bytes = launch_bytes(a.docs, a.max_n, n_bundles, n_big);
  const cudaError_t err = allow_bytes(bytes);
  if (err != cudaSuccess) return (int)err;
  lambdarank_kernel<<<grid, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return status(cudaGetLastError());
}

// The launch's dynamic shared memory and the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for a report.
int xtb_lambdarank_plan(int bundle_docs, int max_n, int n_bundles, int n_big,
                        int* bytes, int* blocks_per_sm) {
  const size_t b =
      launch_bytes(round4(bundle_docs), round4(max_n), n_bundles, n_big);
  *bytes = static_cast<int>(b);
  const cudaError_t err = allow_bytes(b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lambdarank_kernel, kThreads, b);
}

// The bundles' geometry the kernel was built for: kCap, kBundleDocs and
// kBundleGroups (ops/lambdarank_cuda.py's CAP, BUNDLE_DOCS, BUNDLE_GROUPS).
int xtb_lambdarank_geometry(int* cap, int* docs, int* groups) {
  *cap = kCap;
  *docs = kBundleDocs;
  *groups = kBundleGroups;
  return 0;
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
