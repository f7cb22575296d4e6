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
// computes the bound of each launch from its own shapes).  What holds it
// above that bound is the shared-memory atomics of the row loop: six native
// int32 adds (ATOMS.ADD) per (row, feature).
//
// Design: K1's (csrc/hist.cu) with int32 cells of n_ch words.  Each block
// owns a histogram in shared memory for a group of FG features and a tile
// of NT of the level's nodes; blocks tile (feature group x row range x
// node tile).  The wrapper (ops/hist_cuda.py:plan_q) picks FG and NT from
// the shared-memory budget left beside the row lists, and the row ranges,
// the cluster size C and the row loop from the card's occupancy and the
// level.
//
// - Cluster-reduced flush.  The row blocks of one (feature group, node
//   tile) run in thread block clusters of C <= 8 along the row-block grid
//   dimension.  After its rows, each block of a cluster sums its 1/C slice
//   of the (node, feature) pairs over the C histograms of the cluster,
//   reading the others through distributed shared memory, and adds the
//   non-zero sums of that slice to the output with global int32 atomics:
//   C times fewer than one flush per block.
// - Staged row loop, for levels that skip rows (stride 2 builds only left
//   children; a node tile takes only its own nodes).  Each warp of a
//   1024-thread block reads pos for 64 rows at a time, keeps the rows of
//   its node tile in a list in shared memory (ballot and prefix), loads the
//   next 64 rows' pos while it adds, and once the list holds 32 rows gives
//   one to each lane, which loads its limbs once and four bins at a time
//   before their adds.  Where every row counts (stride 1, one node tile),
//   one thread per row.
//
// Measured and left out (PERF.md): one 64-bit shared word per channel
// holding its three limbs (two adds per (row, feature) instead of six) is
// compiled to a compare-and-swap loop (ATOMS.CAST.SPIN.64) and was slower;
// a bulk reduction of each (node, feature) into the output
// (cp.reduce.async.bulk .add.s32) timed the same as the atomics.

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
constexpr int kMaxCh = 8;                   // limbs per row (C * 3 <= 8)

__device__ __forceinline__ void load_pos(int (&p)[kRowsPerLane],
                                         const int* __restrict__ pos,
                                         int chunk, int lane, int r_end) {
#pragma unroll
  for (int s = 0; s < kRowsPerLane; ++s) {
    const int r = chunk + s * 32 + lane;
    p[s] = r < r_end ? pos[r] : -1;
  }
}

// Adds row r's limbs to its cells of fg features: the limbs loaded once,
// then kUnroll bins loaded before their adds.
template <typename BinT>
__device__ __forceinline__ void add_row(int* node_hist,
                                        const BinT* __restrict__ bins,
                                        const int8_t* __restrict__ gq,
                                        int r, int n_features, int f0,
                                        int fg, int n_bin, int n_ch) {
  int limb[kMaxCh];
  const int8_t* g = gq + (size_t)r * n_ch;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) limb[c] = c < n_ch ? (int)g[c] : 0;
  const BinT* row = bins + (size_t)r * n_features + f0;
  for (int f = 0; f < fg; f += kUnroll) {
    int b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      b[k] = f + k < fg ? (int)row[f + k] : -1;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (b[k] < 0 || b[k] >= n_bin) continue;  // missing sentinel
      int* cell = node_hist + ((f + k) * n_bin + b[k]) * n_ch;
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c)
        if (c < n_ch) atomicAdd(cell + c, limb[c]);
    }
  }
}

// hist: [node_tile][feat_group][n_bin] cells of n_ch int32 limb sums.
template <typename BinT, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
hist_q_kernel(const BinT* __restrict__ bins, const int8_t* __restrict__ gq,
              const int* __restrict__ pos, int* __restrict__ out, int n_rows,
              int n_features, int n_bin, int n_ch, int node0, int n_nodes,
              int stride, int feat_group, int node_tile,
              int rows_per_block) {
  extern __shared__ int hist_q[];
  // per warp, the rows of its node tile: (row, offset of its node's cells)
  __shared__ int2 queue[kStaged ? kWarps : 1][kQueue];
  const int f0 = blockIdx.x * feat_group;
  const int fg = min(feat_group, n_features - f0);  // ragged last group
  const int t0 = blockIdx.z * node_tile;
  const int nt = min(node_tile, n_nodes - t0);  // ragged last node tile
  const int unit_len = n_bin * n_ch;  // words of one (node, feature)
  const int node_len = feat_group * unit_len;
  const int hist_len = node_tile * node_len;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) hist_q[i] = 0;
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
      if (lane < n) {  // one row a lane
        const int2 e = list[lane];
        add_row(hist_q + e.y, bins, gq, e.x, n_features, f0, fg, n_bin,
                n_ch);
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
      add_row(hist_q + slot * node_len, bins, gq, r, n_features, f0, fg,
              n_bin, n_ch);
    }
  }

  // Cluster-reduced flush.  The cluster's C blocks share (feature group,
  // node tile); block `rank` owns (node, feature) pairs [u0, u1) of the
  // nt * fg pairs, sums their words over the C histograms of the cluster
  // and adds the non-zero sums to the output, where each (node, feature)
  // holds the same n_bin * n_ch words.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every histogram of the cluster is complete
  const int n_c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    peer[q] = q < n_c ? cluster.map_shared_rank(hist_q, q) : hist_q;
  const int n_units = nt * fg;
  const int u0 = rank * n_units / n_c, u1 = (rank + 1) * n_units / n_c;
  for (int e = u0 * unit_len + threadIdx.x; e < u1 * unit_len;
       e += blockDim.x) {
    const int u = e / unit_len, w = e - u * unit_len;
    const int slot = u / fg, f = u - slot * fg;
    const int word = slot * node_len + f * unit_len + w;
    int acc = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < n_c) acc += peer[q][word];
    if (acc != 0)
      atomicAdd(out + ((size_t)(t0 + slot) * n_features + f0 + f) * unit_len
                    + w,
                acc);
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
  return cudaFuncSetAttribute(hist_q_kernel<BinT, kStaged>,
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
      n, reinterpret_cast<const void*>(hist_q_kernel<BinT, kStaged>), &cfg));
}

template <typename BinT, bool kStaged>
int launch(const void* bins, const void* gq, const void* pos, void* out,
           int n_rows, int n_features, int n_bin, int n_ch, int node0,
           int n_nodes, int stride, int feat_group, int node_tile,
           int row_blocks, int cluster, int threads, cudaStream_t stream) {
  if (n_ch < 1 || n_ch > kMaxCh) return status(cudaErrorInvalidValue);
  const size_t smem =
      (size_t)node_tile * feat_group * n_bin * n_ch * sizeof(int);
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
      &cfg, hist_q_kernel<BinT, kStaged>, static_cast<const BinT*>(bins),
      static_cast<const int8_t*>(gq), static_cast<const int*>(pos),
      static_cast<int*>(out), n_rows, n_features, n_bin, n_ch, node0, n_nodes,
      stride, feat_group, node_tile, rows_per_block));
}

}  // namespace

extern "C" {

// bin_code: 0 = uint8, 1 = int16, 2 = int32.  gq holds n_rows * n_ch int8
// limbs; out must hold n_nodes * n_features * n_bin * n_ch zeroed int32.
// row_blocks must be a multiple of cluster (1, 2, 4 or 8); threads a
// multiple of 32, at most 1024.  staged: 1 the staged row loop, 0 one
// thread per row.  Returns a cudaError_t.
int xtb_hist_q(const void* bins, int bin_code, const void* gq,
               const void* pos, void* out, int n_rows, int n_features,
               int n_bin, int n_ch, int node0, int n_nodes, int stride,
               int feat_group, int node_tile, int row_blocks, int cluster,
               int threads, int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XTB_LAUNCH(T)                                                        \
  (staged ? launch<T, true>(bins, gq, pos, out, n_rows, n_features, n_bin,   \
                            n_ch, node0, n_nodes, stride, feat_group,        \
                            node_tile, row_blocks, cluster, threads, s)      \
          : launch<T, false>(bins, gq, pos, out, n_rows, n_features, n_bin,  \
                             n_ch, node0, n_nodes, stride, feat_group,       \
                             node_tile, row_blocks, cluster, threads, s))
  switch (bin_code) {
    case 0: return XTB_LAUNCH(uint8_t);
    case 1: return XTB_LAUNCH(int16_t);
    case 2: return XTB_LAUNCH(int32_t);
    default: return status(cudaErrorInvalidValue);
  }
#undef XTB_LAUNCH
}

// The most clusters of `cluster` blocks of `threads` threads and `smem`
// bytes of histogram that the current card holds at once, into *n.
int xtb_hist_q_max_clusters(int bin_code, int smem, int cluster, int threads,
                            int staged, int* n) {
#define XTB_QUERY(T)                                                  \
  (staged ? max_clusters<T, true>(smem, cluster, threads, n)          \
          : max_clusters<T, false>(smem, cluster, threads, n))
  switch (bin_code) {
    case 0: return XTB_QUERY(uint8_t);
    case 1: return XTB_QUERY(int16_t);
    case 2: return XTB_QUERY(int32_t);
    default: return status(cudaErrorInvalidValue);
  }
#undef XTB_QUERY
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
