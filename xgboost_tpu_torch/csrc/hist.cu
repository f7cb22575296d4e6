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
// Bound on an H100 SXM (3.35 TB/s): one f32 add per (row, feature, channel)
// and no other arithmetic, so the bytes bound it.  Per launch it must read
// 4 bytes of pos per row and, for the rows in the level, their bins and 8
// bytes of gpair: at R = 1M rows, F = 28 and int16 bins about 71 MB at the
// root, about 21 us (chip_smoke.py computes the bound of each launch from
// its own inputs).  What holds it far above that bound is shared memory:
// Hopper has no f32 add among its shared-memory atomics and runs each as a
// compare-and-swap loop; on an H100 SXM that retires about one (row,
// feature) every 1.5-2.5 cycles of each SM (PERF.md), about 0.2 ms for the
// 1M x 28 adds of a root.
//
// Design.  The Pallas kernel's one-hot (T,B)x(T,2N) MXU product is a TPU
// idiom; here each block owns a histogram in shared memory for a group of
// FG features and a tile of NT of the level's nodes (the layout of the
// reference CUDA, src/tree/gpu_hist/histogram.cu).  Blocks tile (feature
// group x row range x node tile); the wrapper (ops/hist_cuda.py:plan_f32)
// picks FG and NT from the shared-memory budget as choose_tiles in
// ops/hist_pallas.py picks its VMEM tiles, and the row ranges, the cluster
// size C and the row loop from the card's occupancy and the level.
//
// - Cluster-reduced flush.  The row blocks of one (feature group, node
//   tile) run in thread block clusters of C <= 8 along the row-block grid
//   dimension.  After its rows, each block of a cluster sums its 1/C slice
//   of the (node, feature) pairs over the C histograms of the cluster,
//   reading the others through distributed shared memory with plain loads,
//   and adds only that slice to the output with global atomics: C times
//   fewer than one flush per block.
// - One 64-bit compare-and-swap per cell updates g and h together: the
//   same two f32 adds, half the shared-memory atomic instructions.
// - Staged row loop, for levels that skip rows (stride 2 builds only left
//   children; a node tile takes only its own nodes).  Each warp of a
//   1024-thread block reads pos for 64 rows at a time, keeps the rows of
//   its node tile in a list in shared memory (ballot and prefix), loads the
//   next 64 rows' pos while it adds, and once the list holds 32 rows gives
//   one to each lane, whose gradient and four bins at a time are loaded
//   before their adds.  Every lane adds, and rows of other nodes never load
//   their bins.  Where every row counts (stride 1, one node tile), one
//   thread per row is cheaper, and the kernel takes that loop.
//
// K1's class axis, K histograms a call, is csrc/hist_multi.cu.
//
// Float atomics sum in no fixed order, so the result matches the plain
// version within f32 tolerance only, and its last bits can change from run
// to run (csrc/hist_q.cu is the exact path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;              // the most threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 2;             // rows a lane stages at once
constexpr int kChunk = 32 * kRowsPerLane;   // rows a warp stages at once
constexpr int kQueue = 31 + kChunk;         // rows a warp's list can hold
constexpr int kUnroll = 4;                  // bins in flight per lane
constexpr int kMaxCluster = 8;              // the portable cluster limit

__device__ __forceinline__ void load_pos(int (&p)[kRowsPerLane],
                                         const int* __restrict__ pos,
                                         int chunk, int lane, int r_end) {
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int r = chunk + s * 32 + lane;
    p[s] = r < r_end ? pos[r] : -1;
  }
}

// Adds g to one (g, h) cell of a shared-memory histogram.  Hopper runs an
// f32 atomicAdd on shared memory as a compare-and-swap loop; one 64-bit
// compare-and-swap updates both channels with the same two f32 adds.
__device__ __forceinline__ void add_cell(float2* cell, float2 g) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long seen = *p, old;
  do {
    old = seen;
    const float x = __uint_as_float((unsigned)old) + g.x;
    const float y = __uint_as_float((unsigned)(old >> 32)) + g.y;
    seen = atomicCAS(p, old,
                     ((unsigned long long)__float_as_uint(y) << 32)
                         | __float_as_uint(x));
  } while (seen != old);
}

// hist: [node_tile][feat_group][n_bin] cells of (g, h) in shared memory.
template <typename BinT, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const BinT* __restrict__ bins, const float2* __restrict__ gpair,
            const int* __restrict__ pos, float* __restrict__ out, int n_rows,
            int n_features, int n_bin, int node0, int n_nodes, int stride,
            int feat_group, int node_tile, int rows_per_block) {
  extern __shared__ float2 hist[];
  // per warp, the rows of its node tile: (row, offset of its node's cells)
  __shared__ int2 queue[kStaged ? kWarps : 1][kQueue];
  const int f0 = blockIdx.x * feat_group;
  const int fg = min(feat_group, n_features - f0);  // ragged last group
  const int t0 = (int)blockIdx.z * node_tile;
  const int nt = min(node_tile, n_nodes - t0);  // ragged last node tile
  const int node_len = feat_group * n_bin;      // cells of one node
  const int hist_len = node_tile * node_len;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x)
    hist[i] = make_float2(0.f, 0.f);
  __syncthreads();

  const int r_begin = min(n_rows, (int)blockIdx.y * rows_per_block);
  const int r_end = min(n_rows, r_begin + rows_per_block);
  if constexpr (kStaged) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int2* list = queue[warp];
    const int step = (int)(blockDim.x / 32) * kChunk;
    int n = 0;  // rows in the warp's list
    int p[kRowsPerLane];
    int chunk = r_begin + warp * kChunk;
    load_pos(p, pos, chunk, lane, r_end);
    for (;;) {
      // stage chunks of 64 rows until the list holds a row for every lane
      while (n < 32 && chunk < r_end) {
#pragma unroll
        for (int s = 0; s < kRowsPerLane; ++s) {
          const int local = p[s] - node0;
          int off = -1;
          if (local >= 0 && local % stride == 0) {
            const int slot = local / stride - t0;
            if (slot >= 0 && slot < nt) off = slot * node_len;
          }
          const unsigned in = __ballot_sync(0xffffffffu, off >= 0);
          if (off >= 0)
            list[n + __popc(in & ((1u << lane) - 1u))] =
                make_int2(chunk + s * 32 + lane, off);
          n += __popc(in);
        }
        chunk = chunk < r_end - step ? chunk + step : r_end;
        load_pos(p, pos, chunk, lane, r_end);  // in flight during the adds
      }
      if (n == 0) break;
      __syncwarp();
      // one row a lane: its gradient and kUnroll bins loaded before their adds
      if (lane < n) {
        const int2 e = list[lane];
        const float2 g = gpair[e.x];
        const BinT* row = bins + (size_t)e.x * n_features + f0;
        float2* node_hist = hist + e.y;
        for (int f = 0; f < fg; f += kUnroll) {
          int b[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            b[k] = f + k < fg ? (int)row[f + k] : -1;
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            if (b[k] >= 0 && b[k] < n_bin)  // not the missing sentinel
              add_cell(node_hist + (f + k) * n_bin + b[k], g);
          }
        }
      }
      // the rows beyond the first 32 (at most 63) move to the front
      const int left = n > 32 ? n - 32 : 0;
      int2 e0 = make_int2(0, 0), e1 = make_int2(0, 0);
      if (lane < left) e0 = list[32 + lane];
      if (lane + 32 < left) e1 = list[64 + lane];
      __syncwarp();
      if (lane < left) list[lane] = e0;
      if (lane + 32 < left) list[32 + lane] = e1;
      __syncwarp();
      n = left;
    }
  } else {
    for (int r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
      const int local = pos[r] - node0;
      if (local < 0 || local % stride != 0) continue;  // pad row / other level
      const int slot = local / stride - t0;
      if (slot < 0 || slot >= nt) continue;  // another block's node tile
      const float2 g = gpair[r];
      const BinT* row = bins + (size_t)r * n_features + f0;
      float2* node_hist = hist + slot * node_len;
      for (int f = 0; f < fg; ++f) {
        const int b = (int)row[f];
        if (b < 0 || b >= n_bin) continue;  // missing sentinel
        add_cell(node_hist + f * n_bin + b, g);
      }
    }
  }

  // Cluster-reduced flush.  The cluster's C blocks share (feature group,
  // node tile); block `rank` owns (node, feature) pairs [u0, u1) of the
  // nt * fg pairs, sums their cells over the C histograms of the cluster
  // in rank order and adds the non-zero sums to the output.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every histogram of the cluster is complete
  const int n_c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const float2* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    peer[q] = q < n_c ? cluster.map_shared_rank(hist, q) : hist;
  const int n_units = nt * fg;
  const int u0 = rank * n_units / n_c, u1 = (rank + 1) * n_units / n_c;
  for (int e = u0 * n_bin + threadIdx.x; e < u1 * n_bin; e += blockDim.x) {
    const int u = e / n_bin, b = e - u * n_bin;
    const int slot = u / fg, f = u - slot * fg;
    const int cell = slot * node_len + f * n_bin + b;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < n_c) {
        const float2 v = peer[q][cell];
        acc.x += v.x;
        acc.y += v.y;
      }
    }
    float* dst = out + (((size_t)(t0 + slot) * n_features + f0 + f) * n_bin
                        + b) * 2;
    if (acc.x != 0.f) atomicAdd(dst, acc.x);
    if (acc.y != 0.f) atomicAdd(dst + 1, acc.y);
  }
  cluster.sync();  // no block leaves while another reads its histogram
}

// The first error of a call, with the runtime's last-error state cleared,
// so that a refused launch does not surface again at the next one.
int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename BinT, bool kStaged>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(hist_kernel<BinT, kStaged>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

cudaLaunchAttribute cluster_attr(int cluster) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cluster;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename BinT, bool kStaged>
int max_clusters(int smem, int cluster, int threads, int* n) {
  cudaError_t err = set_smem<BinT, kStaged>(smem);
  if (err != cudaSuccess) return status(err);
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return status(cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(hist_kernel<BinT, kStaged>), &cfg));
}

template <typename BinT, bool kStaged>
int launch(const void* bins, const void* gpair, const void* pos, void* out,
           int n_rows, int n_features, int n_bin, int node0, int n_nodes,
           int stride, int feat_group, int node_tile, int row_blocks,
           int cluster, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)node_tile * feat_group * n_bin * sizeof(float2);
  cudaError_t err = set_smem<BinT, kStaged>(smem);
  if (err != cudaSuccess) return status(err);
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_features + feat_group - 1) / feat_group, row_blocks,
                     (n_nodes + node_tile - 1) / node_tile);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int rows_per_block = (n_rows + row_blocks - 1) / row_blocks;
  return status(cudaLaunchKernelEx(
      &cfg, hist_kernel<BinT, kStaged>, static_cast<const BinT*>(bins),
      static_cast<const float2*>(gpair), static_cast<const int*>(pos),
      static_cast<float*>(out), n_rows, n_features, n_bin, node0, n_nodes,
      stride, feat_group, node_tile, rows_per_block));
}

template <typename BinT>
int launch_any(bool staged, const void* bins, const void* gpair,
               const void* pos, void* out, int n_rows, int n_features,
               int n_bin, int node0, int n_nodes, int stride, int feat_group,
               int node_tile, int row_blocks, int cluster, int threads,
               cudaStream_t s) {
  return staged
             ? launch<BinT, true>(bins, gpair, pos, out, n_rows, n_features,
                                  n_bin, node0, n_nodes, stride, feat_group,
                                  node_tile, row_blocks, cluster, threads, s)
             : launch<BinT, false>(bins, gpair, pos, out, n_rows, n_features,
                                   n_bin, node0, n_nodes, stride, feat_group,
                                   node_tile, row_blocks, cluster, threads,
                                   s);
}

}  // namespace

extern "C" {

// bin_code: 0 = uint8, 1 = int16, 2 = int32.  out must hold
// n_nodes * n_features * n_bin * 2 zeroed floats.  row_blocks must be a
// multiple of cluster (1, 2, 4 or 8); threads a multiple of 32, at most
// 1024.  staged: 1 the staged row loop, 0 one thread per row.  Returns a
// cudaError_t.
int xtb_hist_f32(const void* bins, int bin_code, const void* gpair,
                 const void* pos, void* out, int n_rows, int n_features,
                 int n_bin, int node0, int n_nodes, int stride, int feat_group,
                 int node_tile, int row_blocks, int cluster, int threads,
                 int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XTB_LAUNCH(T)                                                       \
  launch_any<T>(staged != 0, bins, gpair, pos, out, n_rows, n_features,     \
                n_bin, node0, n_nodes, stride, feat_group, node_tile,       \
                row_blocks, cluster, threads, s)
  switch (bin_code) {
    case 0: return XTB_LAUNCH(uint8_t);
    case 1: return XTB_LAUNCH(int16_t);
    case 2: return XTB_LAUNCH(int32_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef XTB_LAUNCH
}

// The most clusters of `cluster` blocks of `threads` threads and `smem`
// bytes of histogram that the current card holds at once, into *n.
int xtb_hist_f32_max_clusters(int bin_code, int smem, int cluster,
                              int threads, int staged, int* n) {
#define XTB_QUERY(T)                                                  \
  (staged ? max_clusters<T, true>(smem, cluster, threads, n)          \
          : max_clusters<T, false>(smem, cluster, threads, n))
  switch (bin_code) {
    case 0: return XTB_QUERY(uint8_t);
    case 1: return XTB_QUERY(int16_t);
    case 2: return XTB_QUERY(int32_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef XTB_QUERY
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
