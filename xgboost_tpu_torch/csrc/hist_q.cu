// Exact integer per-level histogram for Hopper (sm_90a): the
// deterministic_histogram=1 path.
//
// Replaces the TPU kernel xgboost_tpu/ops/hist_pallas.py:_hist_kernel_q
// (driven by build_histogram_pallas_q).  Computes, for one tree level,
//
//   hist[n, f, b, ch] = sum_r [bins[r, f] == b] * [pos[r] == node0 + stride*n]
//                              * gq[r, ch]
//
// where gq (R, n_ch) holds the signed base-256 int8 limbs of the 22-bit
// fixed-point gradient (n_ch = C * 3 = 6 for (g, h); ops/quantise.py), and
// the sums are int32.  The missing sentinel (bins == n_bin) and pad rows
// (pos == -1) add nothing; stride 2 builds only the left children.  The
// output is the (N, F, B, C, 3) per-limb sums, never a combined int64:
// dequantise needs the three limb sums to reproduce the reference's bits.
//
// Exactness: every add is an int32 add and |limb| <= 128, so a cell holds
// at most 128 * R < 2^31 for R <= 2^24 rows (check_row_budget).  Integer
// adds are associative, so the atomics below give the same bits as the
// plain version (quantise.hist_accumulate_q) in any order, on every run.
//
// Bound on an H100 SXM (3.35 TB/s): one int32 add per (row, feature, limb)
// and no other arithmetic, so it is memory-bound.  Per launch it must read
// 4R bytes of pos and, for the rows in the level, F*itemsize bytes of bins
// and 6 bytes of limbs, and write N*F*B*6*4 bytes: at R = 1M, F = 28, int16
// bins and the root that is about 69 MB, about 21 us (chip_smoke.py
// computes the bound of each launch from its own shapes).
//
// Design: K1's (csrc/hist.cu) with int32 cells.  Each block owns a
// shared-memory histogram for FG features and NT nodes, filled with
// shared-memory int32 atomics (zero limbs skipped), then flushed with
// global int32 atomics (non-zero cells only).  A cell is 6 words instead of
// K1's 2, so one feature's 16 nodes x 256 bins need 96 KB and the wrapper
// (ops/hist_cuda.py:choose_block with words=6) gives FG = 2 there; at the
// root all 28 features fit in 172 KB, and from N = 64 at 256 bins the
// nodes are tiled.  The TPU kernel's int8 one-hot MXU product would map to
// int8 wgmma (s8 x s8 -> s32, also exact); that is a faster design, not
// this first one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCh = 8;  // limbs per row the kernel takes (C * 3 <= 8)

template <typename BinT>
__global__ void hist_q_kernel(const BinT* __restrict__ bins,
                              const int8_t* __restrict__ gq,
                              const int* __restrict__ pos,
                              int* __restrict__ out,
                              int n_rows, int n_features, int n_bin, int n_ch,
                              int node0, int n_nodes, int stride,
                              int feat_group, int node_tile,
                              int rows_per_block) {
  extern __shared__ int smem_q[];
  const int f0 = blockIdx.x * feat_group;
  const int fg = min(feat_group, n_features - f0);  // ragged last group
  const int t0 = blockIdx.z * node_tile;
  const int nt = min(node_tile, n_nodes - t0);  // ragged last node tile
  const int hist_len = node_tile * feat_group * n_bin * n_ch;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) smem_q[i] = 0;
  __syncthreads();

  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(n_rows, r_begin + rows_per_block);
  for (int r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
    const int local = pos[r] - node0;
    if (local < 0 || local % stride != 0) continue;  // pad row / other level
    const int slot = local / stride - t0;
    if (slot < 0 || slot >= nt) continue;  // another block's node tile
    int limb[kMaxCh];
    const int8_t* g = gq + (size_t)r * n_ch;
    for (int c = 0; c < n_ch; ++c) limb[c] = (int)g[c];
    const BinT* row = bins + (size_t)r * n_features + f0;
    int* node_hist = smem_q + (size_t)slot * feat_group * n_bin * n_ch;
    for (int f = 0; f < fg; ++f) {
      const int b = (int)row[f];
      if (b < 0 || b >= n_bin) continue;  // missing sentinel
      int* cell = node_hist + ((size_t)f * n_bin + b) * n_ch;
      for (int c = 0; c < n_ch; ++c)
        if (limb[c] != 0) atomicAdd(cell + c, limb[c]);
    }
  }
  __syncthreads();

  // flush: smem [slot][f][b][ch] -> out [t0 + slot][f0 + f][b][ch]
  const int per_slot = feat_group * n_bin * n_ch;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) {
    const int v = smem_q[i];
    if (v == 0) continue;
    const int slot = i / per_slot;
    const int rem = i - slot * per_slot;
    const int f = rem / (n_bin * n_ch);
    if (slot >= nt || f >= fg) continue;
    const int rest = rem - f * n_bin * n_ch;  // b * n_ch + ch
    atomicAdd(out + ((size_t)(t0 + slot) * n_features + f0 + f) * n_bin * n_ch
                  + rest, v);
  }
}

template <typename BinT>
int launch(const void* bins, const void* gq, const void* pos, void* out,
           int n_rows, int n_features, int n_bin, int n_ch, int node0,
           int n_nodes, int stride, int feat_group, int node_tile,
           int row_blocks, int threads, cudaStream_t stream) {
  if (n_ch < 1 || n_ch > kMaxCh) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)node_tile * feat_group * n_bin * n_ch * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hist_q_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (n_features + feat_group - 1) / feat_group;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  const int rows_per_block = (n_rows + row_blocks - 1) / row_blocks;
  dim3 grid(n_groups, row_blocks, n_tiles);
  hist_q_kernel<BinT><<<grid, threads, smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int8_t*>(gq),
      static_cast<const int*>(pos), static_cast<int*>(out), n_rows,
      n_features, n_bin, n_ch, node0, n_nodes, stride, feat_group, node_tile,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_code: 0 = uint8, 1 = int16, 2 = int32.  gq holds n_rows * n_ch int8
// limbs; out must hold n_nodes * n_features * n_bin * n_ch zeroed int32.
// Returns a cudaError_t.
int xtb_hist_q(const void* bins, int bin_code, const void* gq,
               const void* pos, void* out, int n_rows, int n_features,
               int n_bin, int n_ch, int node0, int n_nodes, int stride,
               int feat_group, int node_tile, int row_blocks, int threads,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_code) {
    case 0:
      return launch<uint8_t>(bins, gq, pos, out, n_rows, n_features, n_bin,
                             n_ch, node0, n_nodes, stride, feat_group,
                             node_tile, row_blocks, threads, s);
    case 1:
      return launch<int16_t>(bins, gq, pos, out, n_rows, n_features, n_bin,
                             n_ch, node0, n_nodes, stride, feat_group,
                             node_tile, row_blocks, threads, s);
    case 2:
      return launch<int32_t>(bins, gq, pos, out, n_rows, n_features, n_bin,
                             n_ch, node0, n_nodes, stride, feat_group,
                             node_tile, row_blocks, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
