// K1's class axis for Hopper (sm_90a): K gradient histograms of one tree
// level in one call.
//
// Replaces the TPU kernel xgboost_tpu/ops/hist_pallas.py:_hist_kernel run
// once per class (the reference's build_histogram_multi,
// xgboost_tpu/ops/histogram.py:257, for the lockstep grower) or with 2K
// channels (build_level_hist_multi, xgboost_tpu/tree/grow_multi.py:164, for
// a vector-leaf tree).  Computes, for one level and classes k < K,
//
//   hist[k, n, f, b, c] = sum_r [bins[r, f] == b]
//                               * [pos_k[r] == node0 + stride*n] * g[r, k, c]
//
// with the missing sentinel (bins == n_bin) and pad rows (pos == -1) adding
// nothing.  pos_k is row k of a (K, R) array (the lockstep grower: a pos
// per class tree) or one (R,) array for every class (a vector-leaf tree).
// The output is (K, N, F, B, 2) or (N, F, B, K, 2) as the caller asks
// (class and cell strides).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the bytes, as for K1:
// pos, the bins and gradients of the level's rows, the histograms once.
// What K1's design held it to is shared memory: one compare-and-swap loop
// per (row, feature, class), about 1.5 SM-cycles each (PERF.md).
//
// Design.  The H100 has no f32 add among its shared-memory atomics, so the
// row loop uses none: every cell of a block's histogram has exactly one
// owning lane, and that lane adds to it with a plain load, add and store.
//
// - Ownership.  A block (640 threads) holds the cells of one node, a group
//   of FG features and a group of KG <= 16 classes: [unit][bin][S] f32
//   words in shared memory, n_bin + 1 bin rows a unit (row n_bin takes the
//   adds of missing bins and is never flushed).  Accumulating warp u owns
//   unit u, P features: lane fsub * 2KG + 2k + c owns channel c of class
//   k of feature u * P + fsub, for every bin.  S, the words of one bin
//   row, is 32 (or the next power of two above P * 2KG), so the lanes of
//   a warp always fall on distinct banks, whatever bins their features
//   hold.  K = 7: 14 lanes a feature, two features a warp, five warps at
//   256 bins; K = 3: five features a warp.
// - Staging.  The block's other warps stage chunks of 128 steps (64 where
//   a block takes one class at a bucketed level) into shared memory while
//   the
//   accumulating warps add the previous chunk (two buffers): each step's
//   (class, channel) gradients, zero where the class's row is outside the
//   node, and its bins for the block's features, transposed so that a
//   lane reads 4 steps of its class, channel and feature with one vector
//   load each.  A staging thread takes fixed groups of 4 steps of staged
//   rows; the loads of chunk c + 2 are in flight in its registers while
//   chunk c is added.  A row's bins and pos are read once
//   for the block's classes, and its node tested once a row under a
//   shared pos.
// - Row loop.  A lane loads the 4 cells of 4 steps, then the next 4 steps'
//   gradients and bins, then adds to each loaded cell its step's gradient
//   and those of the earlier steps of the 4 on the same cell (sums that do
//   not wait for the loads), and stores in step order: the last step on a
//   cell stores them all.  No two threads touch one cell.
// - Bucketed levels.  Where the level skips rows (stride 2, or more than
//   one node), the call first buckets the (class, row) pairs by node: a count (a block counts
//   its rows in shared memory and adds a node's count once: a global
//   atomic a warp's run of a node took 0.11 ms a lockstep level, PERF.md
//   §6), a
//   scan (one block: list offsets, and each node's items) and a scatter
//   (a block reserves one run a node, then fills it) of the row ids into
//   per-class lists (one shared list under a shared pos), three launches
//   on the same stream before the histogram's.  A block then walks only
//   its node's list: step s is row list[node][s].  Under a pos per class
//   the classes' rows differ, so a block takes one class (class_group 1):
//   its row's bins are then staged once for the one class that routes it
//   there, and its cells hold all the features (16 a warp).  Blocks of
//   seven classes, each staging its own rows' bins for a tenth of the
//   features, took longer over a lockstep round's levels (PERF.md §6).
//   Unbucketed (the root: one node, stride 1), step s is row s and the
//   classes share the block; bucketing the root in blocks of one class
//   took longer (PERF.md §6).
// - Items and rounding.  The clusters of C blocks of a feature group take
//   one queue of items in turn, item q, q + NQ, ...: every class group's
//   items, so that a class whose level holds more rows gets more clusters
//   (the class trees of a lockstep level split the rows far apart).  An
//   item is C runs of `rows` steps of one (class group, node) pair, block
//   `rank` the rank-th.  Unbucketed, rows = rows_per_block, at or below the
//   rows K1's plan gives a block.  Bucketed, a node of `count` rows takes
//   its share of K1's block of k1_rows, count * k1_rows / R (item_rows),
//   at least four staged chunks and at most rows_per_block (which keeps
//   about four items a cluster where one node holds most rows): K1's
//   block finds only that many of the node's rows among the level's
//   others; items of a fixed share of it let a block sum a small node's
//   rows whole, all in the bin of the split that made the node, and a
//   lockstep round's middle levels erred up to 2.8x K1 (PERF.md §6).
// - Cluster-reduced flush, as K1: after an item, block `rank` sums its 1/C
//   slice of the (unit, bin) rows over the cluster's C histograms through
//   distributed shared memory, in rank order, into its partial sums of the
//   pair (global memory, its own), which it adds to the output's sums with
//   global atomics at its cluster's last item of the pair.  The partial and
//   output sums are f64, rounded to f32 once at the end; the row loop's
//   adds stay f32.
//
// One call of xtb_hist_f32_multi is two CUDA launches unbucketed
// (histogram, rounding) and five (count, scan, scatter, histogram,
// rounding; and a memset) bucketed; the wrapper counts it as one launch
// of the class axis.  Atomics add the blocks' sums in no fixed order, so
// the result matches the plain version within f32 tolerance only
// (csrc/hist_q.cu is the exact path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 640;       // threads of a histogram block
constexpr int kU = 4;               // steps a lane adds at once
constexpr int kG = 4;               // steps of one staging role
constexpr int kRoles = 3;           // staging roles a thread takes at most
// steps staged at once: 64 where a block takes one class of a pos per
// class at a bucketed level (so that a chunk of 64 features' bins is at
// most kRoles groups a staging thread), else 128
__host__ __device__ constexpr int chunk_of(int mode) {
  return mode == 2 ? 64 : 128;
}
constexpr int kMaxCluster = 8;      // the portable cluster limit
constexpr int kCountThreads = 256;  // threads of a bucketing block
constexpr int kWindow = 4096;       // nodes a bucketing block counts at once
constexpr int kCountBlocks = 256;   // bucketing blocks a list at most

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of a histogram block, in bytes: the cells (n_bin + 1 bin
// rows a unit: row n_bin takes the adds of missing bins), two staging
// buffers (gradients, bins) and two slots of staged row ids.
// ops/hist_cuda.py:multi_smem computes the same.
struct Layout {
  size_t cells, grads, bins, buf, rid, total;
  int bin_pitch;  // bytes of one feature's row of staged bins
};

__host__ __device__ inline Layout layout(int units, int n_bin, int cell_row,
                                         int class_group, int feats_per_warp,
                                         int bin_bytes, int chunk) {
  Layout l;
  l.cells = align16((size_t)units * (n_bin + 1) * cell_row * 4);
  l.grads = (size_t)2 * class_group * (chunk + 4) * 4;
  l.bin_pitch = chunk * bin_bytes + 16;
  l.bins = (size_t)units * feats_per_warp * l.bin_pitch;
  l.buf = l.grads + l.bins;
  l.rid = (size_t)2 * chunk * 4;  // two slots
  l.total = l.cells + 2 * l.buf + l.rid;
  return l;
}

struct Args {
  const void* bins;
  const float* gpair;        // (R, K, 2)
  const int* pos;            // (K, R) or (R,)
  double* acc;               // the output's sums, f64 (rounded to f32 last)
  double* partial;           // a block's flushed sums of its node so far
  const int* counts;         // bucketed: (L, N) rows of each list and node
  const int* starts;         //           (L, N) offsets into `list`
  const int* items;          //           (n_cgroups * N + 1) items prefix
  const int* list;           //           (L, R) row ids
  long long pos_class_stride;  // R, or 0 when the classes share one pos
  long long out_class_stride;
  int out_cell_stride, partial_stride;
  int n_rows, n_features, n_bin, node0, n_nodes, stride, n_classes;
  int units, class_group, feats_per_warp, cell_row, rows_per_block;
  int k1_rows;  // rows of K1's block at this level
};

// Rows a block sums of a bucketed node's list in one item: the node's
// share of K1's block, which walks k1_rows of the R rows and finds count *
// k1_rows / R of them in the node, but at least `min_rows` (four staged
// chunks) and at most rows_per_block.  ops/hist_cuda.py:
// class_axis_item_rows computes the same.
__host__ __device__ inline int item_rows(int count, int n_rows,
                                         int rows_per_block, int k1_rows,
                                         int min_rows) {
  const long long share = ((long long)count * k1_rows + n_rows - 1) / n_rows;
  return (int)min((long long)rows_per_block,
                  max((long long)min_rows, share));
}

// The largest t' >= t with starts[t'] <= item (starts ascending, n + 1 of
// them, starts[t] <= item < starts[n]); every lane of the warp calls it.
__device__ __forceinline__ int find_node(const int* __restrict__ starts,
                                         int n, int item, int t) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int idx = t + 1 + lane;
    const bool beyond = idx > n || __ldg(starts + idx) > item;
    const unsigned m = __ballot_sync(0xffffffffu, beyond);
    if (m) return t + __ffs(m) - 1;
    t += 32;
  }
}

// kU staged bins of one feature, as loaded (one vector, or two) and
// unpacked.
template <typename BinT> struct Packed {
  static constexpr int kWords = kU * (int)sizeof(BinT) / 4;
  struct alignas(kWords * 4 < 16 ? kWords * 4 : 16) T {
    uint32_t w[kWords];
  };
  __device__ static void unpack(const T& raw, int (&b)[kU]) {
    constexpr int kBits = 8 * (int)sizeof(BinT);
#pragma unroll
    for (int s = 0; s < kU; ++s) {
      const uint32_t w = raw.w[s * kBits / 32];
      b[s] = kBits == 32 ? (int)w
                         : (int)((w >> (s * kBits % 32))
                                 & (uint32_t)((1ull << kBits) - 1));
    }
  }
};

__device__ __forceinline__ void stage_barrier(int n_stage) {
  asm volatile("bar.sync 1, %0;" ::"r"(n_stage) : "memory");
}

// kMode 0: unbucketed, step s is row s; 1, 2: bucketed, step s is row s
// of the block's list: 1 the shared pos's, 2 its one class's.
template <typename BinT, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
hist_multi_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Raw = typename Packed<BinT>::T;
  constexpr int kChunk = chunk_of(kMode);
  constexpr int kPitch = kChunk + 4;  // words of a staged gradient row
  constexpr int kGroups = kChunk / kG;  // staging roles of a staged row
  const int KG = a.class_group, P = a.feats_per_warp, S = a.cell_row;
  const int B = a.n_bin, F = a.n_features, N = a.n_nodes;
  const int lanes = 2 * KG;  // lanes of one feature
  const int n_cg = (a.n_classes + KG - 1) / KG;  // class groups
  const int fgp = a.units * P;               // features of the block
  const int f0 = (int)blockIdx.x * fgp;
  const int fg = min(fgp, F - f0);           // ragged last feature group
  const Layout lay = layout(a.units, B, S, KG, P, (int)sizeof(BinT), kChunk);
  float* cells = reinterpret_cast<float*>(smem);
  int* rid = reinterpret_cast<int*>(smem + lay.cells + 2 * lay.buf);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q = (int)blockIdx.y / C, n_q = (int)gridDim.y / C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool acc = warp < a.units;
  const int n_stage = kThreads - 32 * a.units;
  const int st = (int)threadIdx.x - 32 * a.units;  // staging thread index

  // this lane's feature, class and channel (accumulating warps)
  const int fsub = lane / lanes, kc = lane - fsub * lanes, k = kc >> 1;

  // A staging thread's roles, each kG steps (group g4) of staged rows, the
  // same in every chunk: kind 0 the gradients of class k of the group
  // (both channels, zero outside the node or past a ragged last group), 1
  // the bins of feature f, 2 (bucketed) the row ids.  Consecutive threads
  // take consecutive classes, features and steps, so a warp's loads fall
  // on few lines.
  const int n_r0 = KG * kGroups, n_r1 = fg * kGroups;
  const int n_roles = n_r0 + n_r1 + (kMode != 0 ? kGroups : 0);
  int kind[kRoles], ra[kRoles], rb[kRoles], g4[kRoles];
#pragma unroll
  for (int x = 0; x < kRoles; ++x) {
    int e = st + x * n_stage;
    kind[x] = -1;
    ra[x] = rb[x] = g4[x] = 0;
    if (acc || e >= n_roles) continue;
    if (e < n_r0) {
      kind[x] = 0;
      g4[x] = e / KG;
      ra[x] = e - g4[x] * KG;
    } else if ((e -= n_r0) < n_r1) {
      kind[x] = 1;
      g4[x] = e / fg;
      rb[x] = e - g4[x] * fg;
    } else {
      kind[x] = 2;
      g4[x] = e - n_r1;
    }
  }

  // Items: unbucketed, per_g of each class group in turn, each C *
  // rows_per_block rows; bucketed, the (class group, node) pairs' items in
  // turn, flat index ft = g * N + t, items[ft] the items before the
  // pair's.  The clusters of a feature group take every class group's
  // items in turn, so that classes whose level holds more rows get more of
  // them.  (Even runs of the queue, which keep a cluster on one pair
  // longer, balanced worse: items differ in rows, PERF.md §6.)
  const int per_g = (a.n_rows + C * a.rows_per_block - 1)
                    / (C * a.rows_per_block);
  const int n_items = kMode == 0 ? n_cg * per_g : __ldg(a.items + n_cg * N);
  const int min_rows = 4 * kChunk;
  const int cell_words = a.units * (B + 1) * S;
  // The flush: block `rank` owns (unit, bin) rows [r0, r1) of the
  // units * B rows; warp w takes rows r0 + w, r0 + w + 20, ..., lane l
  // word l of a row (the cell of lane l of the accumulating warps).  Its
  // partial sums of the pair so far are `part`, row by row.
  const int n_cell_rows = a.units * B;
  const int r0 = rank * n_cell_rows / C, r1 = (rank + 1) * n_cell_rows / C;
  double* part = a.partial
      + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * a.partial_stride;
  const int fs_l = lane / lanes, kk_l = (lane - fs_l * lanes) >> 1;
  const long long node_stride = (long long)F * B * a.out_cell_stride;
  // the item's (class group, node) pair, the cluster's last item's and
  // its next one's
  int ft = 0, ft_prev = -1, ft_next;
  for (int item = q; item < n_items; item += n_q) {
    int g, t = 0, j;
    if constexpr (kMode != 0) {
      ft = find_node(a.items, n_cg * N, item, ft);
      j = item - __ldg(a.items + ft);
      g = ft / N;
      t = ft - g * N;
      ft_next = item + n_q < n_items
                    ? find_node(a.items, n_cg * N, item + n_q, ft) : -1;
    } else {
      g = item / per_g;
      j = item - g * per_g;
      ft = g;
      ft_next = item + n_q < n_items ? (item + n_q) / per_g : -1;
    }
    const int k0 = g * KG;
    const int kg = min(KG, a.n_classes - k0);  // ragged last class group
    // bucketed: the block's list, its class's (one class a block) or the
    // shared one, and the node's rows a block of the item
    const int l0 = a.pos_class_stride ? g : 0;
    const int len =
        kMode == 0 ? a.n_rows : __ldg(a.counts + (size_t)l0 * N + t);
    const int rows = kMode == 0 ? a.rows_per_block
        : item_rows(len, a.n_rows, a.rows_per_block, a.k1_rows, min_rows);
    const int s_begin = (j * C + rank) * rows;
    const int s_end = min(s_begin + rows, len);
    const int n_chunks = s_end > s_begin
                             ? (s_end - s_begin + kChunk - 1) / kChunk : 0;
    const bool active = acc && fsub < P && k < kg
                        && f0 + warp * P + fsub < F;

    for (int i = 4 * (int)threadIdx.x; i < cell_words; i += 4 * kThreads)
      *reinterpret_cast<float4*>(cells + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    // The two roles in loops of their own (each warp takes one), meeting
    // at the same barriers: once after the prologue, once a chunk.
    if (acc) {
      __syncthreads();
      for (int c = 0; c < n_chunks; ++c) {
        if (active) {
          // add chunk c: per kU steps, their bins (loaded a round before)
          // unpacked, their cells loaded, the next steps' gradients and
          // bins loaded, then the adds and the stores in step order.  A
          // missing bin adds to bin row B, never flushed; a step outside
          // the node adds zero.
          const unsigned char* buf = smem + lay.cells + (c & 1) * lay.buf;
          const float* gr = reinterpret_cast<const float*>(buf)
                            + kc * kPitch;
          const Raw* br = reinterpret_cast<const Raw*>(
              buf + lay.grads + (warp * P + fsub) * lay.bin_pitch);
          float* col = cells + warp * (B + 1) * S + lane;
          float4 gv[kU / 4];
#pragma unroll
          for (int q = 0; q < kU / 4; ++q)
            gv[q] = *reinterpret_cast<const float4*>(gr + 4 * q);
          Raw raw = br[0];
#pragma unroll 1
          for (int i = 0; i < kChunk; i += kU) {
            int b[kU];
            Packed<BinT>::unpack(raw, b);
            float g4v[kU];
#pragma unroll
            for (int q = 0; q < kU / 4; ++q) {
              g4v[4 * q] = gv[q].x;
              g4v[4 * q + 1] = gv[q].y;
              g4v[4 * q + 2] = gv[q].z;
              g4v[4 * q + 3] = gv[q].w;
            }
            int at[kU];
            float x[kU];
#pragma unroll
            for (int s = 0; s < kU; ++s) {
              at[s] = b[s] * S;
              x[s] = col[at[s]];
            }
            if (i + kU < kChunk) {  // the next steps', before the stores
#pragma unroll
              for (int q = 0; q < kU / 4; ++q)
                gv[q] = *reinterpret_cast<const float4*>(gr + i + kU + 4 * q);
              raw = br[(i + kU) / kU];
            }
            // step s adds, to the cell as loaded, its own gradient and
            // those of the earlier steps on its cell: the last step on a
            // cell stores all of them (independent of the loads, so off
            // their latency)
#pragma unroll
            for (int s = 0; s < kU; ++s) {
              float v = g4v[s];
#pragma unroll
              for (int p = 0; p < s; ++p)
                if (at[s] == at[p]) v += g4v[p];
              x[s] += v;
            }
#pragma unroll
            for (int s = 0; s < kU; ++s) col[at[s]] = x[s];
          }
        }
        __syncthreads();
      }
    } else {
      // the list's rows in the item's node and where they start
      // (bucketed)
      const int first = kMode != 0 ? __ldg(a.starts + (size_t)l0 * N + t) : 0;
      // role x's values of a chunk in flight: gradients (both channels)
      // with their node (compared with node0 when stored), bins, or row
      // ids
      int v[kRoles][2 * kG], pv[kRoles][kG];
      auto fetch = [&](int x, int c) {
        if (c >= n_chunks) return;
        const int s = s_begin + c * kChunk + g4[x] * kG;
        if (kind[x] == 2) {  // row ids
#pragma unroll
          for (int u = 0; u < kG; ++u)
            v[x][u] = s + u < s_end ? __ldg(a.list + first + s + u) : -1;
          return;
        }
        int r[kG];
        if constexpr (kMode == 0) {
#pragma unroll
          for (int u = 0; u < kG; ++u) r[u] = s + u < s_end ? s + u : -1;
        } else {
          const int4 r4 = *reinterpret_cast<const int4*>(
              rid + (c & 1) * kChunk + g4[x] * kG);
          r[0] = r4.x;
          r[1] = r4.y;
          r[2] = r4.z;
          r[3] = r4.w;
        }
#pragma unroll
        for (int u = 0; u < kG; ++u) {
          const int row = r[u];
          if (kind[x] == 0) {
            pv[x][u] = -1;
            v[x][u] = v[x][kG + u] = 0;
            if (row >= 0 && ra[x] < kg) {
              pv[x][u] = kMode != 0 ? a.node0
                  : __ldg(a.pos + (size_t)(k0 + ra[x]) * a.pos_class_stride
                          + row);
              const float2 g = __ldg(reinterpret_cast<const float2*>(
                  a.gpair) + (size_t)row * a.n_classes + k0 + ra[x]);
              v[x][u] = __float_as_int(g.x);
              v[x][kG + u] = __float_as_int(g.y);
            }
          } else {
            v[x][u] = row >= 0
                ? (int)__ldg(static_cast<const BinT*>(a.bins)
                             + (size_t)row * F + f0 + rb[x])
                : B;
          }
        }
      };
      // store role x's values of chunk c: gradients and bins into buffer
      // c & 1, row ids into slot c & 1
      auto store = [&](int x, int c) {
        if (c >= n_chunks) return;
        unsigned char* buf = smem + lay.cells + (c & 1) * lay.buf;
        if (kind[x] == 0) {
          int w[2 * kG];
#pragma unroll
          for (int u = 0; u < kG; ++u) {
            w[u] = pv[x][u] == a.node0 ? v[x][u] : 0;
            w[kG + u] = pv[x][u] == a.node0 ? v[x][kG + u] : 0;
          }
          int4* dst = reinterpret_cast<int4*>(
              buf + (2 * ra[x] * kPitch + g4[x] * kG) * 4);
          dst[0] = make_int4(w[0], w[1], w[2], w[3]);
          dst[kPitch / 4] = make_int4(w[4], w[5], w[6], w[7]);
        } else if (kind[x] == 1) {
          BinT w[kG];  // a bin past n_bin reads as missing
#pragma unroll
          for (int u = 0; u < kG; ++u)
            w[u] = (BinT)min((unsigned)v[x][u], (unsigned)B);
          unsigned char* dst = buf + lay.grads + rb[x] * lay.bin_pitch
              + g4[x] * kG * (int)sizeof(BinT);
          if constexpr (sizeof(BinT) == 1)
            *reinterpret_cast<uint32_t*>(dst) =
                (uint32_t)(uint8_t)w[0] | (uint32_t)(uint8_t)w[1] << 8
                | (uint32_t)(uint8_t)w[2] << 16
                | (uint32_t)(uint8_t)w[3] << 24;
          else if constexpr (sizeof(BinT) == 2)
            *reinterpret_cast<uint2*>(dst) = make_uint2(
                (uint32_t)(uint16_t)w[0] | (uint32_t)(uint16_t)w[1] << 16,
                (uint32_t)(uint16_t)w[2] | (uint32_t)(uint16_t)w[3] << 16);
          else
            *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
        } else if (kind[x] == 2) {
          *reinterpret_cast<int4*>(rid + (c & 1) * kChunk + g4[x] * kG) =
              make_int4(v[x][0], v[x][1], v[x][2], v[x][3]);
        }
      };
      // the row ids run a chunk ahead of the rest
      auto ahead = [&](int x) { return kind[x] == 2 ? 1 : 0; };
      if constexpr (kMode != 0) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int x = 0; x < kRoles; ++x)
            if (kind[x] == 2) {
              fetch(x, c);
              store(x, c);
            }
        stage_barrier(n_stage);
      }
#pragma unroll
      for (int x = 0; x < kRoles; ++x)
        if (kind[x] == 0 || kind[x] == 1) {
          fetch(x, 0);
          store(x, 0);
        }
#pragma unroll
      for (int x = 0; x < kRoles; ++x) fetch(x, 1 + ahead(x));
      __syncthreads();
      for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
        for (int x = 0; x < kRoles; ++x)
          store(x, c + 1 + ahead(x));  // loaded while chunk c - 1 was added
        if constexpr (kMode != 0) stage_barrier(n_stage);
#pragma unroll
        for (int x = 0; x < kRoles; ++x) fetch(x, c + 2 + ahead(x));
        __syncthreads();
      }
    }

    // Cluster-reduced flush: block `rank` owns (unit, bin) rows [r0, r1)
    // of the units * B rows and sums them over the cluster's C histograms
    // in rank order, in f64, with its partial sums of the pair so far;
    // at the cluster's last item of the pair they go to the output's f64
    // sums (global atomics), else back to the partial sums.
    cluster.sync();  // every histogram of the cluster is complete
    const float* peer[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      peer[p] = p < C ? cluster.map_shared_rank(cells, p) : cells;
    const bool fresh = ft != ft_prev, last = ft_next != ft;
    if (lane < S && fs_l < P && k0 + kk_l < a.n_classes) {
      double* o = a.acc + t * node_stride
                  + (long long)(k0 + kk_l) * a.out_class_stride + (lane & 1);
#pragma unroll 4
      for (int row = r0 + warp; row < r1; row += kThreads / 32) {
        const int u = row / B, bin = row - u * B;
        const int f = f0 + u * P + fs_l;
        if (f >= F) continue;
        const int cell = (row + u) * S + lane;  // unit u's rows from u(B + 1)
        double sum = 0.0;
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p)
          if (p < C) sum += peer[p][cell];
        double* e = part + (row - r0) * S + lane;
        if (!fresh) sum += *e;
        if (!last)
          *e = sum;
        else if (sum != 0.0)
          atomicAdd(o + ((long long)f * B + bin) * a.out_cell_stride, sum);
      }
    }
    ft_prev = ft;
    cluster.sync();  // no block zeroes or leaves while another reads it
  }
}

// ------------------------------------------------------------ bucketing
// The node of each (list, row) pair at this level, -1 outside it.
__device__ __forceinline__ int level_node(const int* __restrict__ pos,
                                          long long pcs, int l, int r, int R,
                                          int node0, int N, int stride) {
  if (r >= R) return -1;
  const int local = __ldg(pos + (size_t)l * pcs + r) - node0;
  if (local < 0 || local % stride != 0) return -1;
  const int n = local / stride;
  return n < N ? n : -1;
}

// The node of row r of list l in the window of nodes [w0, w0 + W), -1
// outside it.
__device__ __forceinline__ int window_node(const int* __restrict__ pos,
                                           long long pcs, int l, int r, int R,
                                           int node0, int N, int stride,
                                           int w0, int W) {
  const int t = level_node(pos, pcs, l, r, R, node0, N, stride) - w0;
  return t >= 0 && t < W ? t : -1;
}

// counts[l][t] += the rows of list l in node t.  A block counts its rows
// in shared memory (one atomic a warp's run of a node, __match_any_sync)
// and adds each node's count once, a window of kWindow nodes at a time.
__global__ void __launch_bounds__(kCountThreads)
hist_multi_count(const int* __restrict__ pos, long long pcs, int R, int node0,
             int N, int stride, int* __restrict__ counts) {
  __shared__ int local[kWindow];
  const int l = blockIdx.y, lane = threadIdx.x & 31;
  for (int w0 = 0; w0 < N; w0 += kWindow) {
    const int W = min(kWindow, N - w0);
    for (int t = threadIdx.x; t < W; t += kCountThreads) local[t] = 0;
    __syncthreads();
    for (int r0 = blockIdx.x * kCountThreads; r0 < R;
         r0 += gridDim.x * kCountThreads) {
      const int t = window_node(pos, pcs, l, r0 + threadIdx.x, R, node0, N,
                                stride, w0, W);
      const unsigned m = __match_any_sync(0xffffffffu, t);
      if (t >= 0 && lane == __ffs(m) - 1) atomicAdd(local + t, __popc(m));
    }
    __syncthreads();
    for (int t = threadIdx.x; t < W; t += kCountThreads)
      if (local[t]) atomicAdd(counts + (size_t)l * N + w0 + t, local[t]);
    __syncthreads();
  }
}

// list[cursor[l][t]++] = each row r of list l in node t: a block counts
// its rows of each node of a window as hist_multi_count does, reserves
// one run a node with one global atomic, then writes its rows into its
// runs (in no fixed order within a node).
__global__ void __launch_bounds__(kCountThreads)
hist_multi_scatter(const int* __restrict__ pos, long long pcs, int R, int node0,
               int N, int stride, int* __restrict__ cursor,
               int* __restrict__ list) {
  __shared__ int base[kWindow], fill[kWindow];
  const int l = blockIdx.y, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int w0 = 0; w0 < N; w0 += kWindow) {
    const int W = min(kWindow, N - w0);
    for (int t = threadIdx.x; t < W; t += kCountThreads) fill[t] = 0;
    __syncthreads();
    for (int r0 = blockIdx.x * kCountThreads; r0 < R;
         r0 += gridDim.x * kCountThreads) {
      const int t = window_node(pos, pcs, l, r0 + threadIdx.x, R, node0, N,
                                stride, w0, W);
      const unsigned m = __match_any_sync(0xffffffffu, t);
      if (t >= 0 && lane == __ffs(m) - 1) atomicAdd(fill + t, __popc(m));
    }
    __syncthreads();
    for (int t = threadIdx.x; t < W; t += kCountThreads) {
      const int n = fill[t];
      base[t] = n ? atomicAdd(cursor + (size_t)l * N + w0 + t, n) : 0;
      fill[t] = 0;
    }
    __syncthreads();
    for (int r0 = blockIdx.x * kCountThreads; r0 < R;
         r0 += gridDim.x * kCountThreads) {
      const int r = r0 + threadIdx.x;
      const int t = window_node(pos, pcs, l, r, R, node0, N, stride, w0, W);
      const unsigned m = __match_any_sync(0xffffffffu, t);
      if (t >= 0) {
        const int leader = __ffs(m) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(fill + t, __popc(m));
        at = __shfl_sync(m, at, leader);
        list[base[t] + at + __popc(m & below)] = r;
      }
    }
    __syncthreads();
  }
}

// An exclusive scan of value(t), t < n, over one block of kScanThreads,
// written to out[t] (and the total to out[n] when `total`) plus `base`.
constexpr int kScanThreads = 1024;

template <typename ValueFn>
__device__ void block_scan(ValueFn value, int n, int base, int* out,
                           bool total) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = base;
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += kScanThreads) {
    const int t = c0 + (int)threadIdx.x;
    const int v = t < n ? value(t) : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int carry = carry_s;
    const int before = (warp ? warp_sum[warp - 1] : 0) + x - v;
    if (t < n) out[t] = carry + before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry_s = carry + before + v;
    __syncthreads();
  }
  if (total && threadIdx.x == 0) out[n] = carry_s;
  __syncthreads();
}

// starts[l][t] = l * R + the rows of list l in nodes before t (and
// cursor = starts); items[g * N + t] = the items of the (class group,
// node) pairs before (g, t), items[n_cgroups * N] their total: a pair's
// items cover its list (the shared one, or class g's with one class a
// group) in spans of `cluster` blocks of item_rows rows.
__global__ void __launch_bounds__(kScanThreads)
hist_multi_scan(const int* __restrict__ counts, int* __restrict__ starts,
            int* __restrict__ cursor, int* __restrict__ items, int n_lists,
            int N, int R, int n_classes, int class_group, int cluster,
            int rows_per_block, int k1_rows, int min_rows) {
  for (int l = 0; l < n_lists; ++l) {
    const int* c = counts + (size_t)l * N;
    block_scan([&](int t) { return c[t]; }, N, l * R,
               starts + (size_t)l * N, false);
    for (int t = threadIdx.x; t < N; t += kScanThreads)
      cursor[(size_t)l * N + t] = starts[(size_t)l * N + t];
  }
  const int n_groups = (n_classes + class_group - 1) / class_group;
  block_scan(
      [&](int ft) {
        const int g = ft / N, t = ft - g * N;
        const int len = counts[(size_t)(n_lists == 1 ? 0 : g) * N + t];
        const int span =
            cluster * item_rows(len, R, rows_per_block, k1_rows, min_rows);
        return (len + span - 1) / span;
      },
      n_groups * N, 0, items, true);
}

// The output: each f64 sum rounded to f32 once.
__global__ void __launch_bounds__(kCountThreads)
hist_multi_round(const double* __restrict__ acc, float* __restrict__ out,
                 long long n) {
  for (long long i = (long long)blockIdx.x * kCountThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kCountThreads)
    out[i] = (float)acc[i];
}

// ------------------------------------------------------------ launching
// The first error of a call, with the runtime's last-error state cleared,
// so that a refused launch does not surface again at the next one.
int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename BinT, int kMode>
cudaError_t set_smem(size_t smem) {
  return cudaFuncSetAttribute(hist_multi_kernel<BinT, kMode>,
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

template <typename BinT, int kMode>
int max_clusters(int smem, int cluster, int threads, int* n) {
  cudaError_t err = set_smem<BinT, kMode>(smem);
  if (err != cudaSuccess) return status(err);
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, cluster, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return status(cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(hist_multi_kernel<BinT, kMode>),
      &cfg));
}

template <typename BinT, int kMode>
int launch(const Args& a, int row_blocks, int cluster, cudaStream_t s) {
  const int KG = a.class_group;
  const Layout lay = layout(a.units, a.n_bin, a.cell_row, KG,
                            a.feats_per_warp, (int)sizeof(BinT),
                            chunk_of(kMode));
  cudaError_t err = set_smem<BinT, kMode>(lay.total);
  if (err != cudaSuccess) return status(err);
  const int fgp = a.units * a.feats_per_warp;
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_features + fgp - 1) / fgp, row_blocks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return status(cudaLaunchKernelEx(&cfg, hist_multi_kernel<BinT, kMode>, a));
}

template <typename BinT>
int launch_mode(int mode, const Args& a, int row_blocks, int cluster,
                cudaStream_t s) {
  switch (mode) {
    case 0: return launch<BinT, 0>(a, row_blocks, cluster, s);
    case 1: return launch<BinT, 1>(a, row_blocks, cluster, s);
    default: return launch<BinT, 2>(a, row_blocks, cluster, s);
  }
}

template <typename BinT>
int query_mode(int mode, int smem, int cluster, int threads, int* n) {
  switch (mode) {
    case 0: return max_clusters<BinT, 0>(smem, cluster, threads, n);
    case 1: return max_clusters<BinT, 1>(smem, cluster, threads, n);
    default: return max_clusters<BinT, 2>(smem, cluster, threads, n);
  }
}

}  // namespace

extern "C" {

// K = n_classes histograms of one level.  bin_code: 0 = uint8, 1 = int16,
// 2 = int32.  gpair (n_rows, K, 2) f32; pos (K, n_rows) int32, or
// (n_rows,) with shared_pos; class k writes its cell (n, f, b) at out +
// k * out_class_stride + ((n * n_features + f) * n_bin + b) *
// out_cell_stride floats, every one of the K * n_nodes * n_features *
// n_bin * 2 floats written; `acc`, as many f64 words zeroed beforehand,
// holds the sums until they are rounded into `out`.  The plan
// (ops/hist_cuda.py:plan_f32_multi): `units` accumulating warps of
// feats_per_warp features, class_group classes a block (one where a pos
// per class is bucketed), bin rows of cell_row words (a power of two, at
// least feats_per_warp * 2 * class_group), rows_per_block steps a block
// an item (bucketed, at most: a node takes its share of k1_rows, the rows
// of K1's block), row_blocks a multiple of cluster (1, 2, 4 or 8).  bucketed:
// count, scan and scatter the (class, row) pairs by node first, into
// `scratch` (int32, see ops/hist_cuda.py:multi_scratch); unbucketed
// takes one node at stride 1.  `partial`: f64, see
// ops/hist_cuda.py:multi_partial.  Returns a cudaError_t.
int xtb_hist_f32_multi(const void* bins, int bin_code, const void* gpair,
                       const void* pos, void* out, void* acc, void* scratch,
                       void* partial, int n_rows,
                       int n_features, int n_bin, int node0, int n_nodes,
                       int stride, int n_classes, int shared_pos,
                       long long out_class_stride, int out_cell_stride,
                       int units, int class_group, int feats_per_warp,
                       int cell_row, int rows_per_block, int k1_rows,
                       int row_blocks, int cluster, int bucketed,
                       void* stream) {
  if (n_classes < 1 || class_group < 1 || class_group > 16 || units < 1
      || units > kThreads / 32 - 8 || feats_per_warp < 1
      || feats_per_warp * 2 * class_group > cell_row || cell_row > 32
      || rows_per_block < 1 || k1_rows < 1 || cluster < 1
      || cluster > kMaxCluster
      || row_blocks % cluster != 0
      || (!bucketed && (n_nodes != 1 || stride != 1))
      || (bucketed && !shared_pos && class_group != 1))
    return (int)cudaErrorInvalidValue;
  // a chunk's staged rows, in groups of kG steps, at most kRoles a
  // staging thread
  const int mode = !bucketed ? 0 : shared_pos ? 1 : 2;
  if (chunk_of(mode) / kG
          * (class_group + units * feats_per_warp + (bucketed ? 1 : 0))
      > kRoles * (kThreads - 32 * units))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.bins = bins;
  a.gpair = static_cast<const float*>(gpair);
  a.pos = static_cast<const int*>(pos);
  a.acc = static_cast<double*>(acc);
  a.partial = static_cast<double*>(partial);
  a.partial_stride = (units * n_bin + cluster - 1) / cluster * cell_row;
  a.pos_class_stride = shared_pos ? 0 : n_rows;
  a.out_class_stride = out_class_stride;
  a.out_cell_stride = out_cell_stride;
  a.n_rows = n_rows;
  a.n_features = n_features;
  a.n_bin = n_bin;
  a.node0 = node0;
  a.n_nodes = n_nodes;
  a.stride = stride;
  a.n_classes = n_classes;
  a.units = units;
  a.class_group = class_group;
  a.feats_per_warp = feats_per_warp;
  a.cell_row = cell_row;
  a.rows_per_block = rows_per_block;
  a.k1_rows = k1_rows;
  if (bucketed) {
    const int n_lists = shared_pos ? 1 : n_classes;
    const size_t ln = (size_t)n_lists * n_nodes;
    int* counts = static_cast<int*>(scratch);
    int* starts = counts + ln;
    int* cursor = starts + ln;
    int* items = cursor + ln;
    int* list = items + (size_t)((n_classes + class_group - 1) / class_group)
                            * n_nodes + 1;
    cudaError_t err = cudaMemsetAsync(counts, 0, ln * sizeof(int), s);
    if (err != cudaSuccess) return status(err);
    const int blocks =
        min(kCountBlocks, (n_rows + kCountThreads - 1) / kCountThreads);
    const dim3 grid(blocks, n_lists);
    const long long pcs = shared_pos ? 0 : n_rows;
    hist_multi_count<<<grid, kCountThreads, 0, s>>>(
        a.pos, pcs, n_rows, node0, n_nodes, stride, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_multi_scan<<<1, kScanThreads, 0, s>>>(
        counts, starts, cursor, items, n_lists, n_nodes, n_rows, n_classes,
        class_group, cluster, rows_per_block, k1_rows, 4 * chunk_of(mode));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    hist_multi_scatter<<<grid, kCountThreads, 0, s>>>(
        a.pos, pcs, n_rows, node0, n_nodes, stride, cursor, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    a.counts = counts;
    a.starts = starts;
    a.items = items;
    a.list = list;
  }
  int rc;
  switch (bin_code) {
    case 0: rc = launch_mode<uint8_t>(mode, a, row_blocks, cluster, s);
      break;
    case 1: rc = launch_mode<int16_t>(mode, a, row_blocks, cluster, s);
      break;
    case 2: rc = launch_mode<int32_t>(mode, a, row_blocks, cluster, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const long long n = (long long)n_classes * n_nodes * n_features * n_bin * 2;
  const long long blocks = (n + kCountThreads - 1) / kCountThreads;
  hist_multi_round<<<(int)(blocks < 4096 ? blocks : 4096), kCountThreads, 0,
                     s>>>(a.acc, static_cast<float*>(out), n);
  return status(cudaSuccess);
}

// The most clusters of `cluster` blocks of `threads` threads and `smem`
// bytes of shared memory that the current card holds at once, into *n;
// staged: the bucketed kernel of one class a block, else the unbucketed
// (the three modes' resources differ little; PERF.md §6 gives ptxas's).
int xtb_hist_f32_multi_max_clusters(int bin_code, int smem, int cluster,
                                    int threads, int staged, int* n) {
  const int mode = staged ? 2 : 0;
  switch (bin_code) {
    case 0: return query_mode<uint8_t>(mode, smem, cluster, threads, n);
    case 1: return query_mode<int16_t>(mode, smem, cluster, threads, n);
    case 2: return query_mode<int32_t>(mode, smem, cluster, threads, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* xtb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
