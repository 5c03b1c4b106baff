// ZIPPER's tiled gather on Hopper (sm_90a): the four tile kernels of
// src/repro/kernels/tile_spmm/kernel.py, written again for a GPU as three
// (both segment softmaxes are kernel 3).
//
// On the TPU each kernel is a sequential grid over tiles: the accumulator
// lives in VMEM scratch, a FIRST flag zeroes it and a LAST flag flushes it to
// the tile's partition, and the matrix unit takes dense blocks (a densified
// adjacency or score block, or a (D, E) row selector built from the CSR row
// pointers).  GPU blocks run in parallel and in no order, so that chain
// becomes a loop inside the block (kernel 1: tiles are partition-major and
// the wrapper turns part_id into partition runs part_ptr (P+1), the tiles
// of partition p being [part_ptr[p], part_ptr[p+1])) or a plan of the edges
// grouped by destination row (kernels 2 and 3).
//
// Kernel 1 gives each output row a warp of its own; kernels 2 and 3 walk an
// edge plan (kernels/tile_spmm/plan.py): see their notes.  No kernel uses
// atomics, and every sum runs in a fixed order: the results are
// deterministic.  Everything is fp32 FMA on the CUDA cores; wgmma and TMA
// are later work.
//
// Each C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = 4;                 // output columns per lane
constexpr int kCols = 32 * kLaneCols;        // output columns per warp
constexpr unsigned kAll = 0xffffffffu;

constexpr float kNeg = -1e30f;       // softmax running-max init
constexpr float kLive = -1e29f;      // a COO score above this is a real edge
constexpr float kMinDenom = 1e-30f;  // softmax denominator floor

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
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
//    It walks an edge plan built once per tile set (plan.py, csr_plan)
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
// edge i.  Warps n_group + z write zero_row[32 z ...].  Edge slot s reads
// source row (s / E) S + col_idx[s] of x: the tiles' replica (T, S, F)
// with tile-local columns, or the flat (V, F) store with global columns
// and S = 0, which reads the same rows with no replica built.  out
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
// 3. Online segment softmax, both layouts.  Replaces segment_softmax_pallas
//    / _softmax_kernel (COO) and segment_softmax_csr_pallas /
//    _csr_softmax_kernel (CSR) of src/repro/kernels/tile_spmm/kernel.py:
//    out[p, d] = sum over the edges e of row d in p's tiles of
//    softmax_e(score) x[t, col[t, e]], and 0 for a row with no edge.
//    Bound: bytes (the plan, a score and a column index an edge, the source
//    rows the edges name, the output and the split rows' partials), at
//    about 2 F flops and one exp an edge.
//    The TPU kernels fed the matrix unit: the COO one a dense (T, D, E)
//    score block (0.04 % live on the serving batch: 2.87 GB for 256,000
//    edges), the CSR one a (D, E) row selector built from the row pointers,
//    and both (T, E, F) values gathered beforehand.  Here both layouts walk
//    the edge plan of kernel 2 (the plan builder, csr_plan or coo_plan in
//    plan.py, does the layout's work once per tile set), read per-edge
//    scores and column indices, and gather the source rows themselves, from
//    the replica x (T, S, F) or, with global columns and S = 0, from the
//    flat (V, F) store (as kernel 2): neither block exists.  One warp takes one plan
//    group (whole chunks of at most 128 edges of one row, ~32 edges a warp).
//    For 32 edges at a time each lane loads an edge's slot, target, score
//    and column; a segmented warp scan takes the max of each chunk's piece
//    of the window, the first piece also covering the chunk left open by
//    the previous window (its l and acc are rescaled by exp(m_old - m_new)),
//    so each lane takes one exp, of its own edge.  The warp then folds the
//    edges' source rows in, kSoftInFlight rows in flight, a float4 a lane at
//    F = 128 (a 512-byte row a warp load), and at a chunk's last edge stores
//    acc / max(l, 1e-30) (an unsplit row) or its partial acc and (m, l)
//    below the output (a split row).  softmax_merge_kernel then merges each
//    split row's partials in order (m = max m_k; l and acc sum l_k and
//    acc_k scaled by e^(m_k - m)): no atomics.  Warps past the groups write
//    the rows with no edge as zeros.  The COO mode keeps the TPU kernel's
//    liveness rule (an edge counts where s > -1e29), the CSR mode counts
//    every plan edge: a template flag.  F not a multiple of 4, or x or out
//    not 16-byte aligned, takes the column-a-lane path in 32-column slices.
//    What holds it: the latency of the slot -> score/column -> row chain,
//    not bytes.  4 rows at 48 registers (5 blocks a SM) came out fastest,
//    or within 6 % of the fastest, of 2, 4, 8 and 16 rows in flight and of
//    4 or 2 rows with registers capped for 6 or 8 blocks, in each of three
//    calls (tools/softmax_ab.py).
// ---------------------------------------------------------------------------
constexpr int kSoftInFlight = 4;   // source rows a warp loads before their FMAs

template <bool kCoo, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_plan_kernel(const int* __restrict__ slot,
                    const int* __restrict__ edge_tgt,
                    const int* __restrict__ group_ptr,
                    const int* __restrict__ zero_row,
                    const int* __restrict__ col_idx,
                    const float* __restrict__ scores,
                    const float* __restrict__ x, float* __restrict__ out,
                    float2* __restrict__ ml, int n_group, int n_zero,
                    int n_rows, int E, int S, int F) {
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
  const unsigned below = (1u << lane) - 1u;      // lanes under this one
  const unsigned upto = below | (1u << lane);
  float m_run = kNeg, l_run = 0.f;               // the open chunk's max, sum
  const int e_end = __ldg(group_ptr + g + 1);
  for (int e0 = __ldg(group_ptr + g); e0 < e_end; e0 += 32) {
    // lane j holds edge e0 + j: its source row (t S + col), target, score
    const int e = e0 + lane;
    const int n = min(32, e_end - e0);
    int src = 0, tgt = 0;
    float s = kNeg;
    bool live = false;
    if (e < e_end) {
      const int sl = __ldg(slot + e);
      tgt = __ldg(edge_tgt + e);
      const float sc = __ldg(scores + sl);
      live = kCoo ? sc > kLive : true;
      if (live) s = sc;
      src = (sl / E) * S + __ldg(col_idx + sl);
    }
    // pieces: the runs of one chunk in the window, each ending at its
    // chunk's last edge or at the window's end; v = max over [head, lane]
    const unsigned ends = __ballot_sync(kAll, tgt < 0) | (1u << (n - 1));
    const int head = 31 - __clz(((ends << 1) | 1u) & upto);
    const unsigned after = ends & ~below;
    const int tail = after ? __ffs(after) - 1 : lane;
    float v = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(kAll, v, o);
      if (lane - o >= head) v = fmaxf(v, w);
    }
    float m = __shfl_sync(kAll, v, tail);        // the piece's max
    if (head == 0) m = fmaxf(m, m_run);          // the open chunk goes on
    const float pr = live ? expf(s - m) : 0.f;
    const float alpha = expf(m_run - __shfl_sync(kAll, m, 0));
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; j += kSoftInFlight) {
      float xv[kSoftInFlight][VEC];
      float pu[kSoftInFlight];
#pragma unroll
      for (int u = 0; u < kSoftInFlight; ++u) {
        const int jj = j + u;                    // warp-uniform
        const int r = __shfl_sync(kAll, src, jj & 31);
        pu[u] = __shfl_sync(kAll, pr, jj & 31);
        if (jj >= n) pu[u] = 0.f;
        if (jj < n && has_col) {
          load_vec<VEC>(xv[u], x + (size_t)r * F + col);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) xv[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSoftInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pu[u], xv[u][i], acc[i]);
        l_run += pu[u];
        const int t = __shfl_sync(kAll, tgt, (j + u) & 31);
        const float mu = __shfl_sync(kAll, m, (j + u) & 31);
        if (j + u < n && t < 0) {                // the chunk's last edge
          const int row = t & 0x7fffffff;
          if (row < n_rows) {
            const float den = fmaxf(l_run, kMinDenom);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] /= den;
          } else if (lane == 0 && blockIdx.y == 0) {
            ml[row - n_rows] = make_float2(mu, l_run);
          }
          if (has_col) store_vec<VEC>(out + (size_t)row * F + col, acc);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
          l_run = 0.f;
        }
      }
    }
    const bool closed = __shfl_sync(kAll, tgt, n - 1) < 0;
    const float m_last = __shfl_sync(kAll, m, n - 1);
    m_run = closed ? kNeg : m_last;
  }
}

// Split row i = split_row[i] merges its partials n_rows + [split_ptr[i],
// split_ptr[i+1]) (acc rows of out, (m, l) in ml): every warp takes the
// row's max, warp w sums partials w, w + 8, ... scaled to it, then the 8
// warps' sums add in order.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_merge_kernel(const int* __restrict__ split_row,
                     const int* __restrict__ split_ptr,
                     const float2* __restrict__ ml, float* __restrict__ out,
                     int n_rows, int F) {
  __shared__ float s_acc[kWarps][32 * VEC];
  __shared__ float s_l[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x;
  const int col = ((int)blockIdx.y * 32 + lane) * VEC;
  const int p0 = __ldg(split_ptr + i), p1 = __ldg(split_ptr + i + 1);
  float m = kNeg;
  for (int k = p0 + lane; k < p1; k += 32) m = fmaxf(m, ml[k].x);
  m = warp_max(m);
  float l = 0.f, acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
  for (int k = p0 + warp; k < p1; k += kWarps) {
    const float2 st = ml[k];
    const float scale = expf(st.x - m);
    l = fmaf(st.y, scale, l);
    if (col < F) {
      float v[VEC];
      load_vec<VEC>(v, out + (size_t)(n_rows + k) * F + col);
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = fmaf(v[c], scale, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c) s_acc[warp][VEC * lane + c] = acc[c];
  if (lane == 0) s_l[warp] = l;
  __syncthreads();
  const int cc = (int)blockIdx.y * 32 * VEC + (int)threadIdx.x;
  if (threadIdx.x < 32 * VEC && cc < F) {
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s_acc[w][threadIdx.x];
      den += s_l[w];
    }
    out[(size_t)split_row[i] * F + cc] = a / fmaxf(den, kMinDenom);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

int zipper_segment_softmax(const void* slot, const void* edge_tgt,
                           const void* group_ptr, const void* zero_row,
                           const void* col, const void* scores, const void* x,
                           const void* split_row, const void* split_ptr,
                           void* out, void* ml, int n_group, int n_zero,
                           int n_split, int n_rows, int E, int S, int F,
                           int coo, void* stream) {
  const int n_warps = n_group + ceil_div(n_zero, 32);
  if (n_warps > 0 && F > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec4 = F % 4 == 0 && (size_t)x % 16 == 0 && (size_t)out % 16 == 0;
    const int cols = vec4 ? 128 : 32;
    const dim3 grid(ceil_div(n_warps, kWarps), ceil_div(F, cols));
    const dim3 merge(n_split, ceil_div(F, cols));
#define ZIPPER_SOFTMAX(COO, VEC)                                               \
    softmax_plan_kernel<COO, VEC><<<grid, kThreads, 0, st>>>(                  \
        (const int*)slot, (const int*)edge_tgt, (const int*)group_ptr,         \
        (const int*)zero_row, (const int*)col, (const float*)scores,           \
        (const float*)x, (float*)out, (float2*)ml, n_group, n_zero, n_rows,    \
        E, S, F);                                                              \
    if (n_split > 0)                                                           \
      softmax_merge_kernel<VEC><<<merge, kThreads, 0, st>>>(                   \
          (const int*)split_row, (const int*)split_ptr, (const float2*)ml,     \
          (float*)out, n_rows, F);
    if (coo && vec4) {
      ZIPPER_SOFTMAX(true, 4)
    } else if (coo) {
      ZIPPER_SOFTMAX(true, 1)
    } else if (vec4) {
      ZIPPER_SOFTMAX(false, 4)
    } else {
      ZIPPER_SOFTMAX(false, 1)
    }
#undef ZIPPER_SOFTMAX
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
