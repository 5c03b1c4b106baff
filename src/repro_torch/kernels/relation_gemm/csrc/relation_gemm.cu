// Relation-grouped edge GEMM on Hopper (sm_90a): out[e] = x[e] W[type[e]],
// and the two products of its backward.
//
// Replaces no Pallas kernel: the TPU program computes R-GCN's per-edge,
// type-selected product (the IR's bmm_edge) as an einsum over a weight
// gathered for every edge (src/repro/core/executor.py:46), and the port's
// plain loop runs one masked matmul per relation over all edges.  At the 206
// relations of R-GCN as published (103 with their inverses) that is 412
// full-edge mask passes and as many host syncs a pass, so the port groups the
// edges by relation on the device (ops.relation_plan: a stable sort by type
// and the segment offsets) and runs every relation's product in one launch.
//
// What bounds it.  2 E K N FLOPs against (E (K + N) + R K N) floats moved:
// at K = N = 128, 64 FLOPs a byte, so the fp32 FMA units (67 TFLOP/s, no
// tensor cores: float32 with TF32 off is the configuration's precision)
// bound it, not the 3.35 TB/s of device memory.  The backward's two products
// do the same work each.
//
// Design.  A block computes a 128-row x 128-column tile of one relation's
// segment: the classic register-tiled SIMT GEMM, 256 threads each holding
// an 8 x 8 block of sums, so one pair of float4 shared-memory reads feeds
// 64 FMAs.  The contraction runs in 8-deep steps through two shared-memory
// stages; the next step's operands are loaded into registers while the
// current step computes.  A row of the tile is an edge of the segment: its
// x row is read through src_rows[] and its result written through
// dst_rows[] (16-byte loads, a row's 512 bytes by 32 lanes), so the
// grouping moves indices and never rows.  The grid is sized on the host
// from the row count alone, ceil(E / 128) + R row tiles, which bounds the
// tiles of any grouping (each relation adds at most one partial tile), so
// nothing syncs: a block finds its relation by a binary search of the plan's
// tile offsets and returns at once past the last tile.  Rows past the
// segment's end are zero-filled and not written.
//
// Backward.  dx[src_rows[i]] += dy[dst_rows[i]] W_r^T is the same kernel
// with the plan's row lists swapped, W transposed and the epilogue adding
// atomically (several edges read one x row).  dW_r = sum over the segment of
// x[src_rows[i]]^T dy[dst_rows[i]] is a second kernel of the same tiling
// whose contraction runs over edges: a block sums up to kWChunk edges of one
// relation into a 128 x 128 tile of dW_r and adds it atomically, on a grid
// of ceil(E / kWChunk) + R chunks found through chunk offsets made like
// the tile offsets.  Atomic sums make the gradients' last bits depend on the
// order blocks finish in.
//
// The C entry points take raw pointers, the sizes and the CUDA stream,
// launch on that stream and return the first CUDA error (0 if none).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 128;          // rows (edges) of a block's tile
constexpr int kBN = 128;          // output columns of a block's tile
constexpr int kBK = 8;            // contraction step
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 sums each
constexpr int kAStride = kBM + 4; // a transposed x row, padded against bank conflicts
constexpr int kWChunk = 1024;     // edges a weight-gradient block sums (kernel.py's WGRAD_CHUNK)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// x (M, K), w (R, K, N), out (*, N); src_rows/dst_rows (E,): the x row read
// and the out row written by the i-th edge of the grouped order; seg (R+1):
// relation r's edges are [seg[r], seg[r+1]); tile_off (R+1): relation r's
// row tiles are [tile_off[r], tile_off[r+1]).  K a multiple of 8, N of 4.
// kAccumulate: out rows are added to atomically, else stored.
template <bool kAccumulate>
__global__ void __launch_bounds__(kThreads, 2)
relation_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int* __restrict__ src_rows,
                     const int* __restrict__ dst_rows,
                     const int* __restrict__ seg,
                     const int* __restrict__ tile_off,
                     float* __restrict__ out, int R, int K, int N) {
  __shared__ __align__(16) float As[2][kBK][kAStride];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int b = blockIdx.x;
  if (b >= tile_off[R]) return;
  int lo = 0, hi = R;               // tile_off[lo] <= b < tile_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_off[mid] <= b) lo = mid; else hi = mid;
  }
  const int r = lo;
  const int row0 = seg[r] + (b - tile_off[r]) * kBM;
  const int rows = min(kBM, seg[r + 1] - row0);
  const int n0 = blockIdx.y * kBN;
  const int t = threadIdx.x;

  // loaders: x row t / 2, contraction offset 4 (t % 2); w row t / 32,
  // columns 4 (t % 32)
  const int a_row = t >> 1, a_k = (t & 1) * 4;
  const bool a_ok = a_row < rows;
  const float* a_src = x + (size_t)(a_ok ? src_rows[row0 + a_row] : 0) * K + a_k;
  const int b_k = t >> 5, b_n = (t & 31) * 4;
  const bool b_ok = n0 + b_n < N;
  const float* b_src = w + ((size_t)r * K + b_k) * N + n0 + b_n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 a_ld = a_ok ? load4(a_src) : zero;
  float4 b_ld = b_ok ? load4(b_src) : zero;
  As[0][a_k + 0][a_row] = a_ld.x;
  As[0][a_k + 1][a_row] = a_ld.y;
  As[0][a_k + 2][a_row] = a_ld.z;
  As[0][a_k + 3][a_row] = a_ld.w;
  store4(&Bs[0][b_k][b_n], b_ld);
  __syncthreads();

  // thread (ty, tx) owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, and
  // the columns likewise
  const int ty = t >> 4, tx = t & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = K / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      a_ld = a_ok ? load4(a_src + (kt + 1) * kBK) : zero;
      b_ld = b_ok ? load4(b_src + (size_t)(kt + 1) * kBK * N) : zero;
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = load4(&As[cur][k][ty * 4]);
      const float4 a1 = load4(&As[cur][k][ty * 4 + 64]);
      const float4 b0 = load4(&Bs[cur][k][tx * 4]);
      const float4 b1 = load4(&Bs[cur][k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {
      // the other stage was last read before the previous barrier
      const int nxt = cur ^ 1;
      As[nxt][a_k + 0][a_row] = a_ld.x;
      As[nxt][a_k + 1][a_row] = a_ld.y;
      As[nxt][a_k + 2][a_row] = a_ld.z;
      As[nxt][a_k + 3][a_row] = a_ld.w;
      store4(&Bs[nxt][b_k][b_n], b_ld);
      __syncthreads();
    }
  }

  const int c0 = n0 + tx * 4, c1 = c0 + 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = ty * 4 + (i < 4 ? i : 60 + i);
    if (lr >= rows) continue;
    float* o = out + (size_t)dst_rows[row0 + lr] * N;
    if (kAccumulate) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c0 < N) atomicAdd(o + c0 + q, acc[i][q]);
        if (c1 < N) atomicAdd(o + c1 + q, acc[i][4 + q]);
      }
    } else {
      if (c0 < N) store4(o + c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      if (c1 < N) store4(o + c1, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// dw (R, K, N) += per relation r: sum over its edges i of
// x[src_rows[i]]^T dy[dst_rows[i]]; x (M, K), dy (*, N).  Block b sums the
// edges [seg[r] + (b - chunk_off[r]) kWChunk, +kWChunk) of relation r (cut
// at the segment's end) into the (K, N) tile (blockIdx.z, blockIdx.y).
// K and N multiples of 4; dw zeroed by the caller.
__global__ void __launch_bounds__(kThreads, 2)
relation_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const int* __restrict__ src_rows,
                      const int* __restrict__ dst_rows,
                      const int* __restrict__ seg,
                      const int* __restrict__ chunk_off,
                      float* __restrict__ dw, int R, int K, int N) {
  __shared__ __align__(16) float As[2][kBK][kBM];   // x: [edge][k column]
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // dy: [edge][n column]

  const int b = blockIdx.x;
  if (b >= chunk_off[R]) return;
  int lo = 0, hi = R;               // chunk_off[lo] <= b < chunk_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_off[mid] <= b) lo = mid; else hi = mid;
  }
  const int r = lo;
  const int row0 = seg[r] + (b - chunk_off[r]) * kWChunk;
  const int rows = min(kWChunk, seg[r + 1] - row0);
  const int m0 = blockIdx.z * kBM, n0 = blockIdx.y * kBN;
  const int t = threadIdx.x;

  // loaders: edge t / 32 of the step, columns 4 (t % 32) of x and of dy
  const int l_e = t >> 5, l_c = (t & 31) * 4;
  const bool a_col = m0 + l_c < K, b_col = n0 + l_c < N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_step = [&](int step, float4& a, float4& bv) {
    const int e = step * kBK + l_e;
    const bool ok = e < rows;
    a = ok && a_col ? load4(x + (size_t)src_rows[row0 + e] * K + m0 + l_c) : zero;
    bv = ok && b_col ? load4(dy + (size_t)dst_rows[row0 + e] * N + n0 + l_c) : zero;
  };

  float4 a_ld, b_ld;
  load_step(0, a_ld, b_ld);
  store4(&As[0][l_e][l_c], a_ld);
  store4(&Bs[0][l_e][l_c], b_ld);
  __syncthreads();

  const int ty = t >> 4, tx = t & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (rows + kBK - 1) / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) load_step(s + 1, a_ld, b_ld);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = load4(&As[cur][k][ty * 4]);
      const float4 a1 = load4(&As[cur][k][ty * 4 + 64]);
      const float4 b0 = load4(&Bs[cur][k][tx * 4]);
      const float4 b1 = load4(&Bs[cur][k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) {
      const int nxt = cur ^ 1;
      store4(&As[nxt][l_e][l_c], a_ld);
      store4(&Bs[nxt][l_e][l_c], b_ld);
      __syncthreads();
    }
  }

  const int c0 = n0 + tx * 4, c1 = c0 + 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 4 + (i < 4 ? i : 60 + i);
    if (m >= K) continue;
    float* o = dw + ((size_t)r * K + m) * N;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 < N) atomicAdd(o + c0 + q, acc[i][q]);
      if (c1 < N) atomicAdd(o + c1 + q, acc[i][4 + q]);
    }
  }
}

}  // namespace

extern "C" int zipper_relation_gemm(const float* x, const float* w,
                                    const int* src_rows, const int* dst_rows,
                                    const int* seg, const int* tile_off,
                                    float* out, int n_edges, int R, int K,
                                    int N, int accumulate, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  if (K % kBK || N % 4) return int(cudaErrorInvalidValue);
  const dim3 grid((n_edges + kBM - 1) / kBM + R, (N + kBN - 1) / kBN);
  if (accumulate)
    relation_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, w, src_rows, dst_rows, seg, tile_off, out, R, K, N);
  else
    relation_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, w, src_rows, dst_rows, seg, tile_off, out, R, K, N);
  return int(cudaGetLastError());
}

// chunk_off (R+1): relation r's chunks of kWChunk edges are
// [chunk_off[r], chunk_off[r+1]); dw zeroed by the caller.
extern "C" int zipper_relation_wgrad(const float* x, const float* dy,
                                     const int* src_rows, const int* dst_rows,
                                     const int* seg, const int* chunk_off,
                                     float* dw, int n_edges, int R, int K,
                                     int N, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  if (K % 4 || N % 4) return int(cudaErrorInvalidValue);
  const dim3 grid((n_edges + kWChunk - 1) / kWChunk + R, (N + kBN - 1) / kBN,
                  (K + kBM - 1) / kBM);
  relation_wgrad_kernel<<<grid, kThreads, 0, stream>>>(
      x, dy, src_rows, dst_rows, seg, chunk_off, dw, R, K, N);
  return int(cudaGetLastError());
}
