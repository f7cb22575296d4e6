// Per-level gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel xgboost_tpu/ops/hist_pallas.py:_hist_kernel
// (driven by build_histogram_pallas).  Computes, for one tree level,
//
//   hist[n, f, b, c] = sum_r [bins[r, f] == b] * [pos[r] == node0 + stride*n]
//                            * gpair[r, c]
//
// with the missing sentinel (bins == n_bin) and pad rows (pos == -1) adding
// nothing; stride 2 builds only the left children of a level.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel does one f32 add per (row,
// feature, channel) and no other arithmetic, so it is memory-bound.  Per
// launch it must read R*F*itemsize bytes of bins, 8R bytes of gpair and 4R
// bytes of pos: at R = 1M rows, F = 28 and int16 bins that is about 68 MB,
// about 20 us at 3.35 TB/s (chip_smoke.py computes the bound of each launch
// from its own shapes).
//
// Design: the Pallas kernel's one-hot (T,B)x(T,2N) MXU product is a TPU
// idiom; here the layout is the reference CUDA one
// (src/tree/gpu_hist/histogram.cu:37-120).  Each block owns a histogram in
// shared memory for a group of FG features and a tile of NT of the level's
// nodes, filled with shared-memory f32 atomics, then flushed to the output
// with global atomics (only non-zero entries).  Blocks tile (feature group x
// row range x node tile); rows outside the block's node tile are skipped
// after reading their pos, and the level's histogram never round-trips
// device memory before the flush.  The wrapper (ops/hist_cuda.py:
// choose_block) picks FG and NT from the shared-memory budget as
// choose_tiles in ops/hist_pallas.py picks its VMEM tiles, because N runs
// from 1 to 2^(depth-1) across a tree: all nodes and as many features as
// fit, or, once one feature's N nodes do not fit (N = 128 at 256 bins), one
// feature and as many nodes as fit.  Float atomics sum in no fixed order,
// so the result matches the plain version within f32 tolerance only, and
// its last bits can change from run to run (csrc/hist_q.cu is the exact
// path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename BinT>
__global__ void hist_kernel(const BinT* __restrict__ bins,
                            const float2* __restrict__ gpair,
                            const int* __restrict__ pos,
                            float* __restrict__ out,
                            int n_rows, int n_features, int n_bin,
                            int node0, int n_nodes, int stride,
                            int feat_group, int node_tile,
                            int rows_per_block) {
  extern __shared__ float smem[];
  const int f0 = blockIdx.x * feat_group;
  const int fg = min(feat_group, n_features - f0);  // ragged last group
  const int t0 = blockIdx.z * node_tile;
  const int nt = min(node_tile, n_nodes - t0);  // ragged last node tile
  const int hist_len = node_tile * feat_group * n_bin * 2;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(n_rows, r_begin + rows_per_block);
  for (int r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
    const int local = pos[r] - node0;
    if (local < 0 || local % stride != 0) continue;  // pad row / other level
    const int slot = local / stride - t0;
    if (slot < 0 || slot >= nt) continue;  // another block's node tile
    const float2 g = gpair[r];
    const BinT* row = bins + (size_t)r * n_features + f0;
    float* node_hist = smem + (size_t)slot * feat_group * n_bin * 2;
    for (int f = 0; f < fg; ++f) {
      const int b = (int)row[f];
      if (b < 0 || b >= n_bin) continue;  // missing sentinel
      float* cell = node_hist + ((size_t)f * n_bin + b) * 2;
      atomicAdd(cell, g.x);
      atomicAdd(cell + 1, g.y);
    }
  }
  __syncthreads();

  // flush: smem [slot][f][b][c] -> out [t0 + slot][f0 + f][b][c]
  const int per_slot = feat_group * n_bin * 2;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) {
    const float v = smem[i];
    if (v == 0.f) continue;
    const int slot = i / per_slot;
    const int rem = i - slot * per_slot;
    const int f = rem / (n_bin * 2);
    if (slot >= nt || f >= fg) continue;
    const int rest = rem - f * n_bin * 2;  // b * 2 + c
    atomicAdd(out + ((size_t)(t0 + slot) * n_features + f0 + f) * n_bin * 2
                  + rest, v);
  }
}

template <typename BinT>
int launch(const void* bins, const void* gpair, const void* pos, void* out,
           int n_rows, int n_features, int n_bin, int node0, int n_nodes,
           int stride, int feat_group, int node_tile, int row_blocks,
           int threads, cudaStream_t stream) {
  const size_t smem = (size_t)node_tile * feat_group * n_bin * 2 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (n_features + feat_group - 1) / feat_group;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  const int rows_per_block = (n_rows + row_blocks - 1) / row_blocks;
  dim3 grid(n_groups, row_blocks, n_tiles);
  hist_kernel<BinT><<<grid, threads, smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const float2*>(gpair),
      static_cast<const int*>(pos), static_cast<float*>(out), n_rows,
      n_features, n_bin, node0, n_nodes, stride, feat_group, node_tile,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_code: 0 = uint8, 1 = int16, 2 = int32.  out must hold
// n_nodes * n_features * n_bin * 2 zeroed floats.  Returns a cudaError_t.
int xtb_hist_f32(const void* bins, int bin_code, const void* gpair,
                 const void* pos, void* out, int n_rows, int n_features,
                 int n_bin, int node0, int n_nodes, int stride, int feat_group,
                 int node_tile, int row_blocks, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_code) {
    case 0:
      return launch<uint8_t>(bins, gpair, pos, out, n_rows, n_features, n_bin,
                             node0, n_nodes, stride, feat_group, node_tile,
                             row_blocks, threads, s);
    case 1:
      return launch<int16_t>(bins, gpair, pos, out, n_rows, n_features, n_bin,
                             node0, n_nodes, stride, feat_group, node_tile,
                             row_blocks, threads, s);
    case 2:
      return launch<int32_t>(bins, gpair, pos, out, n_rows, n_features, n_bin,
                             node0, n_nodes, stride, feat_group, node_tile,
                             row_blocks, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
