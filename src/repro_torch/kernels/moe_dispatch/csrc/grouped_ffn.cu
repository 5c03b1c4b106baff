// Grouped SwiGLU FFN over expert capacity buckets on Hopper (sm_90a).
//
// Replaces grouped_ffn_pallas (src/repro/kernels/moe_dispatch/kernel.py:
// 44-73, pallas_call at :57): y[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]
// over buckets x (E, C, d), with rows at or past counts[e] written as zero.
//
// What bounds it.  The expert weights: 3 d f values per expert (94 MB in
// fp32 at DeepSeek-V2's d 5120, f 1536), against at most C live rows each.
// A decode step of batch 4 has at most 24 of 160 experts live and C = 8, so
// the work is a read of the live experts' weights at 3.35 TB/s; a prefill
// chunk (C = 48, all experts live) sits near the balance of fp32 FMA and
// bytes.
//
// Design.  Two launches of one tiled fp32 FMA GEMM.  The first computes
// act = silu(x Wg) * (x Wu) into an fp32 scratch (E, C, f), the gate and up
// products sharing each staged x tile; the second computes y = act Wd.  A
// block owns one (expert, BM-row tile, 64-column tile) and loops over the
// contraction in steps of 32: x (transposed, rows padded to BM + 4) and the
// weight tiles are staged in shared memory, and each thread keeps TM x 4
// outputs per product in registers (TM consecutive rows, 4 consecutive
// columns, each read as one float4).  Global loads go 16 bytes a thread into
// registers one step ahead, so the next step's tiles are in flight while
// this step's FMAs run (one shared-memory buffer, register prefetch).  The
// live count
// is read first: a block whose rows all lie at or past counts[e] returns at
// once (the second launch writes its zeros), so a dead expert's weights are
// never read — on the TPU the same skip is pl.when over row blocks.  Live
// rows are never padded with real work: rows past the count load as zero and
// are not stored by the first launch, and are stored as zero by the second.
// BM is 16 (TM = 1) for the small buckets of decode, so a weight tile feeds
// at most 16 rows of FMA work, and 64 (TM = 4) otherwise.  A live expert's
// weights are read once per row tile, so once when C <= BM.  wgmma, TMA and
// a multistage ring are later work.
//
// The C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns the first CUDA error (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 32;            // contraction step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float silu(float h) { return h / (1.f + expf(-h)); }

// 8 consecutive elements as floats; p is 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* r) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}

// GATED: x (E, C, Kd) of TX, w1 = Wg, w2 = Wu (E, Kd, N) of TW;
//        out = act (E, C, N) fp32, live rows only.
// else:  x = act (E, C, Kd) fp32, w1 = Wd (E, Kd, N); out (E, C, N) of TO,
//        rows past the count written as zero.
// grid (ceil(N / 64), ceil(C / BM), E).  Kd and N multiples of 8.  Thread
// (ty, tx) owns rows ty TM + i (i < TM) and columns 4 tx + j (j < 4).
template <typename TX, typename TW, typename TO, int TM, bool GATED>
__global__ void __launch_bounds__(kThreads)
ffn_tile_kernel(const TX* __restrict__ x, const TW* __restrict__ w1,
                const TW* __restrict__ w2, const int* __restrict__ counts,
                TO* __restrict__ out, int C, int Kd, int N) {
  constexpr int BM = 16 * TM;
  constexpr int XS = BM + 4;                 // row of the transposed x tile
  constexpr int XE = BM * kBK / kThreads;    // x elements per thread: 8 or 2
  __shared__ __align__(16) float xs[kBK][XS];
  __shared__ __align__(16) float w1s[kBK][kBN];
  __shared__ __align__(16) float w2s[GATED ? kBK : 1][kBN];

  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * BM, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int live = min(counts[e], C) - row0;   // live rows of this tile
  TO* out_e = out + size_t(e) * C * N;

  if (live <= 0) {
    if constexpr (!GATED) {
      for (int i = tid; i < BM * kBN; i += kThreads) {
        const int r = row0 + i / kBN, c = n0 + i % kBN;
        if (r < C && c < N) store(out_e + size_t(r) * N + c, 0.f);
      }
    }
    return;
  }

  const TX* x_e = x + (size_t(e) * C + row0) * Kd;
  const TW* w1_e = w1 + size_t(e) * Kd * N;
  const TW* w2_e = GATED ? w2 + size_t(e) * Kd * N : nullptr;

  // this thread's share of a step's tiles: x row xr_r, dims xr_k .. + XE;
  // weight row w_k, columns w_c .. + 8
  const int xr_r = tid % BM, xr_k = (tid / BM) * XE;
  const int w_k = tid / 8, w_c = (tid % 8) * 8;
  float xr[XE], w1r[8], w2r[8];

  auto fetch = [&](int k0) {   // global -> registers
    if (xr_r < live && k0 + xr_k < Kd) {
      const TX* src = x_e + size_t(xr_r) * Kd + k0 + xr_k;
      if constexpr (XE == 8) {
        load8(src, xr);
      } else {
#pragma unroll
        for (int u = 0; u < XE; ++u) xr[u] = to_f(src[u]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < XE; ++u) xr[u] = 0.f;
    }
    const bool in = k0 + w_k < Kd && n0 + w_c < N;
    const size_t off = size_t(k0 + w_k) * N + n0 + w_c;
    if (in) {
      load8(w1_e + off, w1r);
      if constexpr (GATED) load8(w2_e + off, w2r);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) w1r[u] = w2r[u] = 0.f;
    }
  };
  auto stage = [&]() {          // registers -> shared memory
#pragma unroll
    for (int u = 0; u < XE; ++u) xs[xr_k + u][xr_r] = xr[u];
    *reinterpret_cast<float4*>(&w1s[w_k][w_c]) = make_float4(w1r[0], w1r[1], w1r[2], w1r[3]);
    *reinterpret_cast<float4*>(&w1s[w_k][w_c + 4]) = make_float4(w1r[4], w1r[5], w1r[6], w1r[7]);
    if constexpr (GATED) {
      *reinterpret_cast<float4*>(&w2s[w_k][w_c]) = make_float4(w2r[0], w2r[1], w2r[2], w2r[3]);
      *reinterpret_cast<float4*>(&w2s[w_k][w_c + 4]) = make_float4(w2r[4], w2r[5], w2r[6], w2r[7]);
    }
  };

  float acc1[TM][4], acc2[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < Kd; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < Kd) fetch(k0 + kBK);   // next tile's loads fly during the FMAs
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[TM];
      if constexpr (TM == 4) {
        const float4 t = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty * TM + i];
      }
      const float4 a = *reinterpret_cast<const float4*>(&w1s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (GATED) {
        const float4 b = *reinterpret_cast<const float4*>(&w2s[kk][tx * 4]);
        bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(xv[i], av[j], acc1[i][j]);
          if constexpr (GATED) acc2[i][j] = fmaf(xv[i], bv[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;          // row within the tile
    if (row0 + r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      TO* o = out_e + size_t(row0 + r) * N + c;
      if constexpr (GATED) {
        if (r < live) store(o, silu(acc1[i][j]) * acc2[i][j]);
      } else {
        store(o, r < live ? acc1[i][j] : 0.f);
      }
    }
  }
}

template <typename T, int TM>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const int* counts, float* act, void* out, int E, int C, int d,
           int f, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 block(kThreads);
  ffn_tile_kernel<T, T, float, TM, true>
      <<<dim3((f + kBN - 1) / kBN, (C + BM - 1) / BM, E), block, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(wg),
          static_cast<const T*>(wu), counts, act, C, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ffn_tile_kernel<float, T, T, TM, false>
      <<<dim3((d + kBN - 1) / kBN, (C + BM - 1) / BM, E), block, 0, stream>>>(
          act, static_cast<const T*>(wd), nullptr, counts,
          static_cast<T*>(out), C, f, d);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wu, const void* wd,
             const int* counts, float* act, void* out, int E, int C, int d,
             int f, cudaStream_t stream) {
  if (C <= 16) return launch<T, 1>(x, wg, wu, wd, counts, act, out, E, C, d, f, stream);
  return launch<T, 4>(x, wg, wu, wd, counts, act, out, E, C, d, f, stream);
}

}  // namespace

extern "C" {

// x (E, C, d), wg / wu (E, d, f), wd (E, f, d), out (E, C, d): bfloat16 if
// bf16 != 0, else float32.  counts (E,) int32; act (E, C, f) fp32 scratch.
// d and f multiples of 8, every pointer 16-byte aligned (the wrapper checks).
int zipper_grouped_ffn(const void* x, const void* wg, const void* wu,
                       const void* wd, const int* counts, float* act, void* out,
                       int E, int C, int d, int f, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, wg, wu, wd, counts, act, out, E, C, d, f, s);
  return dispatch<float>(x, wg, wu, wd, counts, act, out, E, C, d, f, s);
}

}  // extern "C"
