// ZIPPER's tiled gather on Hopper (sm_90a): the four tile kernels of
// src/repro/kernels/tile_spmm/kernel.py, written again for a GPU.
//
// On the TPU each kernel is a sequential grid over tiles: the accumulator
// lives in VMEM scratch, a FIRST flag zeroes it and a LAST flag flushes it to
// the tile's partition, and the matrix unit takes dense blocks (a densified
// adjacency or score block, or a (D, E) row selector built from the CSR row
// pointers).  GPU blocks run in parallel and in no order, so that chain
// becomes a loop inside the block.  Tiles are partition-major and the
// wrapper turns part_id into partition runs part_ptr (P+1): the tiles of
// partition p are [part_ptr[p], part_ptr[p+1]).
//
// Shared design of kernels 3 and 4 (kernel 1 gives each row a warp of its
// own, kernel 2 walks a CSR plan: see their notes).  One block of 8 warps
// owns one (partition, 4 output rows, 128 output columns) piece of the
// (P, D, F) output and takes its rows one at a time.  For a row, the 8
// warps split the work — the COO softmax by column stripes of the score
// row, the CSR softmax by the partition's tiles — and
// each warp keeps its own running state in registers: the accumulator over
// its lane's 4 columns and, for the softmax, the running max m and sum l.
// The block then merges the 8 states in shared memory and writes the row.
// Blocks never share an output element: no atomics, no second pass.  A
// partition with no tile writes zeros.  Only real edges cost work: a warp
// finds them by ballot (nonzero adjacency, live score, or slot inside a row
// run) and reads each edge's 128-wide value row, four rows in flight.
// Everything is fp32 FMA on the CUDA cores; wgmma and TMA are later work.
//
// Each C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = 4;                 // output columns per lane
constexpr int kCols = 32 * kLaneCols;        // output columns per block
constexpr int kRows = 4;                     // output rows per block
constexpr int kBatch = 4;                    // edge rows loaded at once
constexpr unsigned kAll = 0xffffffffu;

constexpr float kNeg = -1e30f;       // "no edge" sentinel and running-max init
constexpr float kLive = -1e29f;      // a COO score above this is a real edge
constexpr float kMinDenom = 1e-30f;  // softmax denominator floor

// A warp's running state for one output row.
struct RowState {
  float m, l;                 // softmax running max and sum
  float acc[kLaneCols];       // this lane's columns col + 32 c
};

__device__ __forceinline__ void reset(RowState& st) {
  st.m = kNeg;
  st.l = 0.f;
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) st.acc[c] = 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Fold up to 32 scores (one per lane, `live` marks real edges) into the
// online softmax: m grows to cover them, l and acc are rescaled by
// exp(m_old - m_new).  Returns this lane's probability exp(s - m_new), or 0.
__device__ __forceinline__ float softmax_fold(RowState& st, float s, bool live) {
  const float m_new = fmaxf(st.m, warp_max(live ? s : kNeg));
  const float alpha = expf(st.m - m_new);
  const float p = live ? expf(s - m_new) : 0.f;
  st.l = st.l * alpha + warp_sum(p);
  st.m = m_new;
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) st.acc[c] *= alpha;
  return p;
}

// acc += weight[j] * rows[j][col .. col + 96 step 32] for every lane j set
// in `mask` (warp-uniform).  `weight` and `row` are per-lane registers read
// by shuffle; row(j) gives the value row's base pointer.  Loads of up to
// kBatch rows are issued before their FMAs.
template <typename RowOf>
__device__ __forceinline__ void gather_rows(RowState& st, unsigned mask,
                                            float weight, RowOf row_of,
                                            int col, int F) {
  while (mask) {
    int lane_of[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      lane_of[u] = mask ? __ffs(mask) - 1 : -1;
      if (mask) mask &= mask - 1;
    }
    float v[kBatch][kLaneCols];
    float wu[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = lane_of[u] < 0 ? lane_of[0] : lane_of[u];
      wu[u] = __shfl_sync(kAll, weight, j);
      const float* r = row_of(j);
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const int cc = col + 32 * c;
        v[u][c] = (lane_of[u] >= 0 && cc < F) ? __ldg(r + cc) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c)
        st.acc[c] = fmaf(wu[u], v[u][c], st.acc[c]);
  }
}

// Sweep row d of every tile in [t0, t1) of a row-major (T, D, W) block in
// 32-column stripes, warp w taking stripes w, w + 8, ... of each tile.
// visit(t, c0, v) gets the lane's value v of the stripe starting at column
// c0 of tile t (`fill` past the row's end).
template <typename Visit>
__device__ __forceinline__ void sweep_row(const float* __restrict__ block,
                                          int t0, int t1, int d, int D, int W,
                                          float fill, Visit visit) {
  const int lane = threadIdx.x % 32;
  for (int t = t0; t < t1; ++t) {
    const float* row = block + ((size_t)t * D + d) * W;
    for (int c0 = (threadIdx.x / 32) * 32; c0 < W; c0 += kThreads) {
      const int c = c0 + lane;
      visit(t, c0, c < W ? __ldg(row + c) : fill);
    }
  }
}

// Merge the block's 8 warp states of row d and write it: sums add; softmax
// states rescale to the common max, out = acc / max(l, 1e-30).
template <bool kSoftmax>
__device__ __forceinline__ void merge_and_store(const RowState& st,
                                                float (*s_acc)[kCols],
                                                float* s_m, float* s_l,
                                                float* __restrict__ out,
                                                int p, int d, int D, int F) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) s_acc[warp][lane + 32 * c] = st.acc[c];
  if (lane == 0) {
    s_m[warp] = st.m;
    s_l[warp] = st.l;
  }
  __syncthreads();
  const int cc = (int)(blockIdx.z * kCols + threadIdx.x);
  if (threadIdx.x < kCols && cc < F) {
    float a = 0.f;
    if constexpr (kSoftmax) {
      float m = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_m[w]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float scale = expf(s_m[w] - m);
        l = fmaf(s_l[w], scale, l);
        a = fmaf(s_acc[w][threadIdx.x], scale, a);
      }
      a /= fmaxf(l, kMinDenom);
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += s_acc[w][threadIdx.x];
    }
    out[((size_t)p * D + d) * F + cc] = a;
  }
  __syncthreads();   // shared state is reused by the next row
}

// ---------------------------------------------------------------------------
// 1. COO tile SpMM.  Replaces tile_spmm_pallas / _kernel
//    (src/repro/kernels/tile_spmm/kernel.py): out[p] = sum_{t in p} A_t X_t
//    over the densified (T, D, S) adjacency blocks.
//    Bound: bytes.  The dense A block must be read once (T D S x 4 bytes)
//    while the function needs only 2 F flops per real edge.  One warp owns
//    one output row (p, d) and all its columns: no block barrier, no merge,
//    and no shared memory but a list of its own.  It reads row d of every
//    tile of p as one stream of AV-float pieces (a float4 where S and the
//    block allow it): lane l
//    takes pieces l, l + 32, ... across the tiles, kAdjLoads of them issued
//    before the first ballot, so 4 KB a warp are in flight.  Ballots then
//    list the nonzeros (x row, a) in the warp's shared-memory list, in
//    (batch, piece, column in the piece, lane) order; the list is gathered
//    when full and at the row's end, a * X[t, s, :] for each entry with
//    kGather x rows in flight, one float4 a lane (F = 128 is 32 lanes x 4
//    columns).  So the sweep never waits on a gather, and a row's ~6 edges
//    cost one gather round trip, not six.  The sum runs in list order and
//    the row is written once: deterministic.  F past 128 is taken in
//    128-column slices, each a sweep of its own; F not a multiple of 4, or
//    x or out not 16-byte aligned, reads x a column a lane (columns c, c +
//    32, c + 64, c + 96 of the slice).  A partition with no tile writes
//    zeros.  What holds it now: the sweep alone (no list, no gather) reads
//    the block at ~2.3 TB/s, limited by the 4 KB a warp has in flight; more
//    pieces a lane cost registers, and so warps, faster than they add bytes
//    (tools/kernel_variants.py).
// ---------------------------------------------------------------------------
constexpr int kAdjLoads = 8;   // adjacency pieces a lane loads before a ballot
constexpr int kList = 256;     // nonzeros a warp lists before it gathers them
constexpr int kGather = 8;     // x rows a warp has in flight while gathering

// AV consecutive floats from p (16-byte aligned when AV == 4)
template <int AV>
__device__ __forceinline__ void load_piece(float (&v)[AV], const float* p) {
  if constexpr (AV == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

// this lane's 4 columns of a 128-column slice starting at f0: XV == 4
// holds f0 + 4 lane .. + 3, XV == 1 holds f0 + lane + 32 c
template <int XV>
__device__ __forceinline__ int lane_col(int f0, int lane, int c) {
  return XV == 4 ? f0 + 4 * lane + c : f0 + lane + 32 * c;
}

template <int XV>
__device__ __forceinline__ void load_cols(float (&v)[kLaneCols],
                                          const float* row, int f0, int F) {
  const int lane = threadIdx.x % 32;
  if constexpr (XV == 4) {
    const int c = f0 + 4 * lane;
    if (c < F) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + c));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int cc = lane_col<XV>(f0, lane, c);
      v[c] = cc < F ? __ldg(row + cc) : 0.f;
    }
  }
}

// acc += a * x[row, cols] for the n (x row, a) pairs of a warp's list, in
// list order, kGather x rows in flight
template <int XV>
__device__ __forceinline__ void gather_list(float (&acc)[kLaneCols],
                                            const int2* list, int n,
                                            const float* __restrict__ x,
                                            int f0, int F) {
  for (int g0 = 0; g0 < n; g0 += kGather) {
    float a[kGather], xv[kGather][kLaneCols];
#pragma unroll
    for (int g = 0; g < kGather; ++g) {
      if (g0 + g < n) {                                    // warp-uniform
        const int2 en = list[g0 + g];
        a[g] = __int_as_float(en.y);
        load_cols<XV>(xv[g], x + (size_t)en.x * F, f0, F);
      } else {
        a[g] = 0.f;
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) xv[g][c] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kGather; ++g)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) acc[c] = fmaf(a[g], xv[g][c], acc[c]);
  }
}

// grid ceil(P D / 8) blocks of 8 warps; warp w of block b owns row
// b 8 + w = p D + d.  AV divides S; adj 16-byte aligned when AV == 4; x
// and out 16-byte aligned and F a multiple of 4 when XV == 4; T S < 2^31.
template <int AV, int XV>
__global__ void __launch_bounds__(kThreads)
coo_spmm_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                const int* __restrict__ part_ptr, float* __restrict__ out,
                int P, int D, int S, int F) {
  __shared__ int2 s_list[kWarps][kList];                  // (x row, a) pairs
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;               // lanes under this one
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= (long long)P * D) return;                    // warp-uniform
  int2* list = s_list[threadIdx.x / 32];
  const int p = (int)(row / D), d = (int)(row - (long long)p * D);
  const int t0 = __ldg(part_ptr + p), t1 = __ldg(part_ptr + p + 1);
  const int SQ = S / AV;                                   // pieces a tile row
  float* out_row = out + (size_t)row * F;
  for (int f0 = 0; f0 < F; f0 += kCols) {
    float acc[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[c] = 0.f;
    int n = 0;                                             // listed nonzeros
    // this lane's next piece: quad q of row d of tile t
    int t = SQ > 0 ? t0 : t1, q = lane;
    while (t < t1 && q >= SQ) { q -= SQ; ++t; }
    while (__any_sync(kAll, t < t1)) {
      float v[kAdjLoads][AV];
      int xrow[kAdjLoads];                                 // x row of its first column
#pragma unroll
      for (int u = 0; u < kAdjLoads; ++u) {
        xrow[u] = t * S + q * AV;
        if (t < t1) {
          load_piece<AV>(v[u], adj + ((size_t)t * D + d) * S + (size_t)q * AV);
        } else {
#pragma unroll
          for (int e = 0; e < AV; ++e) v[u][e] = 0.f;
        }
        q += 32;
        while (t < t1 && q >= SQ) { q -= SQ; ++t; }
      }
#pragma unroll
      for (int u = 0; u < kAdjLoads; ++u) {
        bool nz = false;
#pragma unroll
        for (int e = 0; e < AV; ++e) nz |= v[u][e] != 0.f;
        if (!__any_sync(kAll, nz)) continue;
        if (n > kList - 32 * AV) {                         // room for this piece
          __syncwarp();
          gather_list<XV>(acc, list, n, x, f0, F);
          n = 0;
          __syncwarp();
        }
#pragma unroll
        for (int e = 0; e < AV; ++e) {
          const bool h = v[u][e] != 0.f;
          const unsigned m = __ballot_sync(kAll, h);
          if (h) list[n + __popc(m & below)] = make_int2(xrow[u] + e, __float_as_int(v[u][e]));
          n += __popc(m);
        }
      }
    }
    __syncwarp();
    gather_list<XV>(acc, list, n, x, f0, F);
    __syncwarp();                                          // the list is free again
    if constexpr (XV == 4) {
      const int c = f0 + 4 * lane;
      if (c < F)
        *reinterpret_cast<float4*>(out_row + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const int cc = lane_col<XV>(f0, lane, c);
        if (cc < F) out_row[cc] = acc[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. CSR tile SpMM.  Replaces tile_spmm_csr_pallas / _csr_kernel:
//    out[p, d] = sum_{t in p} sum_{e in [rp[t,d], rp[t,d+1])} w[e] x[col[e]].
//    Bound: bytes (the plan, one slot, column index and weight per edge, the
//    source rows read, the output), at 2 F flops per edge.
//    It walks a CSR plan built once per tile set (kernels/tile_spmm/plan.py)
//    instead of the per-tile row pointers, whose walk read one 32-byte
//    sector per (tile, row) of the partition, at a stride of D + 1 ints,
//    more bytes than the whole bound.  The plan lists every row's edge slots
//    (t E + e) together, cuts each row into chunks of at most 128 edges
//    and gives each edge its chunk's target row, flagged on the chunk's
//    last edge.  One warp takes one group: the whole chunks that start in
//    one 32-edge window of the list — ~10 short rows (3.3 edges a row on
//    the stand-in), or one chunk of a long row.  Lanes load 32 edges' slot,
//    target, column and weight at once; the warp then folds the edges'
//    source rows in, kInFlight rows in flight, each row one coalesced read
//    (a float4 a lane at F = 128), and stores the row at its chunk's last
//    edge.  No block barrier, no shared memory, ~10x fewer warps than one
//    a row, so the slot -> column -> row latency chain is paid per 32
//    edges.  A hub row (in-degree 37,873 on the power-law stand-in) is
//    ~300 chunks on as many warps; their partial rows land below the
//    output, and a second pass (csr_merge_kernel, a block per split row)
//    sums them in a fixed order: deterministic, no atomics.  Warps past the
//    groups write the rows with no edge as zeros.  Padded slots (at or past
//    rp[t, D]) are not in the plan and are never read: padding may be NaN.
// ---------------------------------------------------------------------------
constexpr int kInFlight = 8;   // edge rows loaded before their FMAs

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// Group g = plan edges [group_ptr[g], group_ptr[g+1]); slot[i] = t E + e
// and edge_tgt[i] = target row (bit 31: last edge of its chunk) of plan
// edge i.  Warps n_group + z write zero_row[32 z ...].  x (T, S, F); out
// (n_rows + partials, F).  Lane l holds columns [col, col + VEC), col =
// (blockIdx.y 32 + l) VEC.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const int* __restrict__ slot, const int* __restrict__ edge_tgt,
                const int* __restrict__ group_ptr,
                const int* __restrict__ zero_row,
                const int* __restrict__ col_idx, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ out,
                int n_group, int n_zero, int E, int S, int F) {
  const int lane = threadIdx.x % 32;
  const int g = (int)blockIdx.x * kWarps + (int)threadIdx.x / 32;
  const int col = ((int)blockIdx.y * 32 + lane) * VEC;
  const bool has_col = col < F;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (g >= n_group) {                            // warp-uniform
    const int z0 = (g - n_group) * 32;
    if (z0 >= n_zero) return;
    const int n = min(32, n_zero - z0);
    const int row = lane < n ? __ldg(zero_row + z0 + lane) : 0;
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kAll, row, j);
      if (has_col) store_vec<VEC>(out + (size_t)r * F + col, acc);
    }
    return;
  }
  const int e_end = __ldg(group_ptr + g + 1);
  for (int e0 = __ldg(group_ptr + g); e0 < e_end; e0 += 32) {
    // lane j holds edge e0 + j: its source row (t S + col), weight, target
    const int e = e0 + lane;
    int src = 0, tgt = 0;
    float wv = 0.f;
    if (e < e_end) {
      const int s = __ldg(slot + e);
      tgt = __ldg(edge_tgt + e);
      src = (s / E) * S + __ldg(col_idx + s);
      wv = __ldg(w + s);
    }
    const int n = min(32, e_end - e0);
    for (int j = 0; j < n; j += kInFlight) {
      float v[kInFlight][VEC];
      float wu[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int jj = j + u;                    // warp-uniform
        const int r = __shfl_sync(kAll, src, jj & 31);
        wu[u] = __shfl_sync(kAll, wv, jj & 31);
        if (jj < n && has_col) {
          load_vec<VEC>(v[u], x + (size_t)r * F + col);
        } else {
          wu[u] = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wu[u], v[u][i], acc[i]);
        const int t = __shfl_sync(kAll, tgt, (j + u) & 31);
        if (j + u < n && t < 0) {                // the chunk's last edge
          if (has_col) store_vec<VEC>(out + (size_t)(t & 0x7fffffff) * F + col, acc);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        }
      }
    }
  }
}

// Split row i = split_row[i] sums its partial rows n_rows + [split_ptr[i],
// split_ptr[i+1]): the 8 warps take every 8th partial, then add in order.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
csr_merge_kernel(const int* __restrict__ split_row,
                 const int* __restrict__ split_ptr, float* __restrict__ out,
                 int n_rows, int F) {
  __shared__ float s_acc[kWarps][32 * VEC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x;
  const int col = ((int)blockIdx.y * 32 + lane) * VEC;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (col < F) {
    const int p1 = split_ptr[i + 1];
#pragma unroll 4
    for (int p = split_ptr[i] + warp; p < p1; p += kWarps) {
      float v[VEC];
      load_vec<VEC>(v, out + (size_t)(n_rows + p) * F + col);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) s_acc[warp][VEC * lane + k] = acc[k];
  __syncthreads();
  const int cc = (int)blockIdx.y * 32 * VEC + (int)threadIdx.x;
  if (threadIdx.x < 32 * VEC && cc < F) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s_acc[w][threadIdx.x];
    out[(size_t)split_row[i] * F + cc] = a;
  }
}

// ---------------------------------------------------------------------------
// 3. COO online segment softmax.  Replaces segment_softmax_pallas /
//    _softmax_kernel: per destination row, softmax over the per-edge score
//    columns of all the partition's tiles (-1e30 marks "no edge"), then the
//    weighted sum of the edge values, in one pass with a running max m, sum
//    l and accumulator.
//    Bound: bytes.  The (T, D, E) score block is read once and dominates;
//    the real work is about 2 F flops and one exp per edge.  The warps
//    sweep the score row like kernel 1; a 32-column stripe with no live
//    score (s > -1e29) is skipped whole, a live one folds into (m, l, acc).
//    The constants are the reference's: -1e30 init and sentinel, live where
//    s > -1e29, out = acc / max(l, 1e-30), so a row with no edge gives 0.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
coo_softmax_kernel(const float* __restrict__ scores,
                   const float* __restrict__ vals,
                   const int* __restrict__ part_ptr, float* __restrict__ out,
                   int D, int E, int F) {
  __shared__ float s_acc[kWarps][kCols];
  __shared__ float s_m[kWarps], s_l[kWarps];
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x, col = (int)blockIdx.z * kCols + lane;
  const int t0 = part_ptr[p], t1 = part_ptr[p + 1];
  const int d_end = min(D, (int)(blockIdx.y + 1) * kRows);
  for (int d = (int)blockIdx.y * kRows; d < d_end; ++d) {
    RowState st;
    reset(st);
    sweep_row(scores, t0, t1, d, D, E, kNeg, [&](int t, int e0, float s) {
      const bool live = s > kLive;
      const unsigned mask = __ballot_sync(kAll, live);
      if (!mask) return;
      const float pr = softmax_fold(st, s, live);
      const float* ve = vals + ((size_t)t * E + e0) * F;
      gather_rows(st, mask, pr,
                  [&](int j) { return ve + (size_t)j * F; }, col, F);
    });
    merge_and_store<true>(st, s_acc, s_m, s_l, out, p, d, D, F);
  }
}

// ---------------------------------------------------------------------------
// 4. CSR online segment softmax.  Replaces segment_softmax_csr_pallas /
//    _csr_softmax_kernel: the same softmax over each row's CSR runs, with
//    per-edge scores (T, E) and gathered per-edge values (T, E, F).
//    Bound: bytes (row pointers, one score and one F-wide value row per
//    edge, the output), at about 2 F flops and one exp per edge.  For row d
//    the 8 warps split the partition's tiles, each lane loading one tile's
//    run [rp[t,d], rp[t,d+1]); the warp then walks the non-empty runs 32
//    edges at a time, folding each piece into (m, l, acc) like kernel 3.
//    Splitting by tile spreads a hub row over the block.  Slots at or past
//    rp[t, D] are never read: padding may be NaN.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
csr_softmax_kernel(const int* __restrict__ row_ptr,
                   const float* __restrict__ scores,
                   const float* __restrict__ vals,
                   const int* __restrict__ part_ptr, float* __restrict__ out,
                   int D, int E, int F) {
  __shared__ float s_acc[kWarps][kCols];
  __shared__ float s_m[kWarps], s_l[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x, col = (int)blockIdx.z * kCols + lane;
  const int t0 = part_ptr[p], t1 = part_ptr[p + 1];
  const int d_end = min(D, (int)(blockIdx.y + 1) * kRows);
  for (int d = (int)blockIdx.y * kRows; d < d_end; ++d) {
    RowState st;
    reset(st);
    // warp w takes tiles t0 + w + 8 k; lane j of a sweep holds tile tb + 8 j
    for (int tb = t0 + warp; tb < t1; tb += kThreads) {
      const int tl = tb + kWarps * lane;
      int rb = 0, re = 0;
      if (tl < t1) {
        const int* rp = row_ptr + (size_t)tl * (D + 1) + d;
        rb = __ldg(rp);
        re = __ldg(rp + 1);
      }
      unsigned runs = __ballot_sync(kAll, re > rb);
      while (runs) {
        const int j = __ffs(runs) - 1;
        runs &= runs - 1;
        const int t = tb + kWarps * j;
        const int e_lo = __shfl_sync(kAll, rb, j);
        const int e_hi = __shfl_sync(kAll, re, j);
        for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
          const int e = e0 + lane;
          const bool live = e < e_hi;
          const float pr = softmax_fold(
              st, live ? __ldg(scores + (size_t)t * E + e) : kNeg, live);
          const float* vt = vals + ((size_t)t * E + e0) * F;
          gather_rows(st, __ballot_sync(kAll, live), pr,
                      [&](int jj) { return vt + (size_t)jj * F; }, col, F);
        }
      }
    }
    merge_and_store<true>(st, s_acc, s_m, s_l, out, p, d, D, F);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline dim3 grid_of(int P, int D, int F) {
  return dim3(P, ceil_div(D, kRows), ceil_div(F, kCols));
}

}  // namespace

extern "C" {

int zipper_tile_spmm_coo(const void* adj, const void* x, const void* part_ptr,
                         void* out, int P, int D, int S, int F, void* stream) {
  if (P > 0 && D > 0 && F > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const bool adj4 = S % 4 == 0 && (size_t)adj % 16 == 0;
    const bool x4 = F % 4 == 0 && (size_t)x % 16 == 0 && (size_t)out % 16 == 0;
    const unsigned blocks = (unsigned)(((long long)P * D + kWarps - 1) / kWarps);
#define ZIPPER_COO(AV, XV)                                                     \
    coo_spmm_kernel<AV, XV><<<blocks, kThreads, 0, st>>>(                      \
        (const float*)adj, (const float*)x, (const int*)part_ptr, (float*)out, \
        P, D, S, F);
    if (adj4 && x4) {
      ZIPPER_COO(4, 4)
    } else if (adj4) {
      ZIPPER_COO(4, 1)
    } else if (x4) {
      ZIPPER_COO(1, 4)
    } else {
      ZIPPER_COO(1, 1)
    }
#undef ZIPPER_COO
  }
  return (int)cudaGetLastError();
}

int zipper_tile_spmm_csr(const void* slot, const void* edge_tgt,
                         const void* group_ptr, const void* zero_row,
                         const void* col, const void* w, const void* x,
                         const void* split_row, const void* split_ptr, void* out,
                         int n_group, int n_zero, int n_split, int n_rows,
                         int E, int S, int F, void* stream) {
  const int n_warps = n_group + ceil_div(n_zero, 32);
  if (n_warps > 0 && F > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec4 = F % 4 == 0 && (size_t)x % 16 == 0 && (size_t)out % 16 == 0;
    const int cols = vec4 ? 128 : 32;
    const dim3 grid(ceil_div(n_warps, kWarps), ceil_div(F, cols));
    const dim3 merge(n_split, ceil_div(F, cols));
#define ZIPPER_CSR(VEC)                                                        \
    csr_spmm_kernel<VEC><<<grid, kThreads, 0, st>>>(                           \
        (const int*)slot, (const int*)edge_tgt, (const int*)group_ptr,         \
        (const int*)zero_row, (const int*)col, (const float*)w,                \
        (const float*)x, (float*)out, n_group, n_zero, E, S, F);               \
    if (n_split > 0)                                                           \
      csr_merge_kernel<VEC><<<merge, kThreads, 0, st>>>(                       \
          (const int*)split_row, (const int*)split_ptr, (float*)out, n_rows, F);
    if (vec4) {
      ZIPPER_CSR(4)
    } else {
      ZIPPER_CSR(1)
    }
#undef ZIPPER_CSR
  }
  return (int)cudaGetLastError();
}

int zipper_segment_softmax_coo(const void* scores, const void* vals,
                               const void* part_ptr, void* out,
                               int P, int D, int E, int F, void* stream) {
  if (P > 0 && D > 0 && F > 0) {
    coo_softmax_kernel<<<grid_of(P, D, F), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)scores, (const float*)vals, (const int*)part_ptr,
        (float*)out, D, E, F);
  }
  return (int)cudaGetLastError();
}

int zipper_segment_softmax_csr(const void* row_ptr, const void* scores,
                               const void* vals, const void* part_ptr,
                               void* out, int P, int D, int E, int F,
                               void* stream) {
  if (P > 0 && D > 0 && F > 0) {
    csr_softmax_kernel<<<grid_of(P, D, F), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)row_ptr, (const float*)scores, (const float*)vals,
        (const int*)part_ptr, (float*)out, D, E, F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
