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
// chunk (C = 48, all experts live) needs the weights at ~2.8 TB/s and the
// fp32 FMA units near their peak at once.
//
// Design.  Two launches of one fp32 FMA GEMM.  The first computes
// act = silu(x Wg) * (x Wu) into an fp32 scratch (E, C, f), the gate and up
// products sharing each x value; the second computes y = act Wd.  A block
// owns one (expert, row tile, column tile).  The row tile is sized to the
// bucket (8 x `slices` rows, slices = ceil(C / 8) up to 8), so one row tile
// covers C <= 64 and a live expert's weights are read once per launch.
// The block's warps are `slices` x `ksplit`: warp (rs, ks) owns rows
// [8 rs, 8 rs + 8) of the tile and the ks-th share of every 32-deep
// contraction step, over all the tile's columns.  A lane keeps 8 rows x 4
// columns x 2 products (gate/up; the down launch: 8 rows x 8 columns), 64
// fp32 sums, so one x float4 (broadcast to the warp) and one weight float4
// feed 32 or 64 FMAs.  A warp whose 8 rows all lie at or past counts[e]
// skips its FMAs (a warp-uniform branch: the TPU kernel's pl.when row-block
// skip at warp granularity), so the FMAs issued are the live rows rounded
// up to 8; a block whose rows are all dead returns at once (the down launch
// writes its zeros), so a dead expert's weights are never read.  x and the
// weight tiles stream through a ring of `slots` shared-memory stages filled
// by 16-byte cp.async copies, with one block barrier per step; rows past the
// count and the K and N tails are zero-filled by the copy without a read.
// With ksplit > 1 the warps' partial sums meet in shared memory and add in
// a fixed order.  bf16 operands are converted on the shared-memory ->
// register path.  The launch configuration (slices, ksplit, slots, dynamic
// shared-memory bytes) comes from kernel.py's launch_config; the C entry
// point refuses one it cannot run.
//
// What holds it now.  Shared memory: for each k a lane reads 8 x values
// (the same for the whole warp) and 8 weight values, 1 KB a warp for 64
// FMAs, so at the FMA peak the shared-memory pipe (128 bytes a clock)
// would be busy all the time.  Weights in flight are not the limit: the
// copies alone, with no FMA, run in half the kernel's time (see
// tools/kernel_variants.py).  More FMAs per value read need more sums a
// lane than the registers hold at 12 warps a block.
//
// The C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns the first CUDA error (0 if none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBK = 32;          // contraction step
constexpr int kSlice = 8;        // rows a warp owns
constexpr int kWarpCols = 128;   // columns a warp covers per float4 group
constexpr int kMaxWarps = 12;
constexpr int kMaxSlices = 8;

__device__ __forceinline__ float silu(float h) { return h / (1.f + expf(-h)); }

// 4 consecutive elements as floats (16 bytes of fp32, 8 of bf16, aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 16 bytes global -> shared without registers; zero-fill (no read) where
// !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// wait until at most n (0..2) copy groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

// a row of the x tile: kBK elements and 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int x_stride() { return kBK + 16 / int(sizeof(T)); }

// bytes of one ring slot: the x tile (8 slices rows) and NP weight tiles
// (kBK x BN)
template <typename TX, typename TW, bool GATED>
__host__ __device__ constexpr size_t slot_bytes(int slices) {
  return size_t(kSlice) * slices * x_stride<TX>() * sizeof(TX) +
         size_t(GATED ? 2 : 1) * kBK * kWarpCols * (GATED ? 1 : 2) * sizeof(TW);
}

// bytes of the partial sums the ks > 0 warps hand to the ks = 0 warps
inline size_t reduce_bytes(int slices, int ksplit) {
  return size_t(ksplit - 1) * slices * 32 * 64 * sizeof(float);
}

// GATED: x (E, C, Kd) of TX, w1 = Wg, w2 = Wu (E, Kd, N) of TW;
//        out = act (E, C, N) fp32, live rows only.
// else:  x = act (E, C, Kd) fp32, w1 = Wd (E, Kd, N); out (E, C, N) of TO,
//        rows past the count written as zero.
// grid (ceil(N / BN), ceil(C / (8 slices)), E), 32 slices ksplit threads.
// Kd and N multiples of 8, rows 16-byte aligned.
template <typename TX, typename TW, typename TO, bool GATED, int KSPLIT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
ffn_kernel(const TX* __restrict__ x, const TW* __restrict__ w1,
           const TW* __restrict__ w2, const int* __restrict__ counts,
           TO* __restrict__ out, int C, int Kd, int N, int slices, int slots) {
  constexpr int KW = kBK / KSPLIT;          // contraction a warp takes a step
  constexpr int NP = GATED ? 2 : 1;         // products
  constexpr int NV = GATED ? 1 : 2;         // float4 column groups a lane
  constexpr int BN = kWarpCols * NV;        // columns of the block
  constexpr int XS = x_stride<TX>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int BM = kSlice * slices;
  const int n0 = blockIdx.x * BN, row0 = blockIdx.y * BM, e = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rs = warp % slices, ks = warp / slices;
  const int live = min(counts[e], C) - row0;   // live rows of this tile
  TO* out_e = out + size_t(e) * C * N;

  if (live <= 0) {
    if constexpr (!GATED) {
      const int rows = min(BM, C - row0), groups = BN / 4;
      for (int i = tid; i < rows * groups; i += nthreads) {
        const int r = row0 + i / groups, c = n0 + 4 * (i % groups);
        if (c < N) store4(out_e + size_t(r) * N + c, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    return;
  }

  const size_t x_bytes = size_t(BM) * XS * sizeof(TX);
  const size_t w_bytes = size_t(kBK) * BN * sizeof(TW);
  const size_t s_bytes = x_bytes + NP * w_bytes;
  const TX* x_e = x + (size_t(e) * C + row0) * Kd;
  const TW* w_e[NP];
  w_e[0] = w1 + size_t(e) * Kd * N;
  if constexpr (GATED) w_e[1] = w2 + size_t(e) * Kd * N;
  const int steps = (Kd + kBK - 1) / kBK;

  // step `step`'s x rows [0, BM) and weight rows into ring slot `s`.  A
  // warp copies whole rows, a lane one or two 16-byte pieces of each: the
  // pieces' columns are fixed per lane, so a copy costs a row address and a
  // predicate.
  const int nwarps = nthreads / 32;
  auto load = [&](int step, int s) {
    unsigned char* base = smem + s * s_bytes;
    const int k0 = step * kBK;
    constexpr int XC = 16 / int(sizeof(TX)), XPR = kBK / XC, XRI = 32 / XPR;
    TX* xs = reinterpret_cast<TX*>(base);
    const int xk = (lane % XPR) * XC;
    const bool xk_in = k0 + xk < Kd;
    for (int r = warp * XRI + lane / XPR; r < BM; r += nwarps * XRI) {
      const bool ok = xk_in && r < live;
      cp_async16(xs + r * XS + xk, ok ? x_e + size_t(r) * Kd + k0 + xk : x_e, ok);
    }
    // a weight row: WPR pieces over LPR lanes, RI rows a warp at once
    constexpr int WC = 16 / int(sizeof(TW)), WPR = BN / WC;
    constexpr int LPR = WPR < 32 ? WPR : 32, RI = 32 / LPR, CPL = WPR / LPR;
    const int wc = (lane % LPR) * WC;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      TW* ws = reinterpret_cast<TW*>(base + x_bytes + p * w_bytes);
      for (int k = warp * RI + lane / LPR; k < kBK; k += nwarps * RI) {
        const bool k_in = k0 + k < Kd;
        const TW* src = w_e[p] + size_t(k0 + k) * N + n0;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = wc + q * LPR * WC;
          const bool ok = k_in && n0 + c < N;
          cp_async16(ws + k * BN + c, ok ? src + c : w_e[p], ok);
        }
      }
    }
  };

  float acc[NP][kSlice][4 * NV];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < kSlice; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[p][i][c] = 0.f;

  const bool active = kSlice * rs < live;   // warp-uniform: a live row

  for (int s = 0; s < slots - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_upto(slots - 2);
    __syncthreads();   // step's slot is full; the previous slot is free
    const int next = step + slots - 1;
    if (next < steps) load(next, next % slots);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* base = smem + (step % slots) * s_bytes;
    const TX* xs = reinterpret_cast<const TX*>(base) + kSlice * rs * XS + ks * KW;
    const TW* ws[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ws[p] = reinterpret_cast<const TW*>(base + x_bytes + p * w_bytes) + ks * KW * BN + 4 * lane;
#pragma unroll
    for (int k = 0; k < KW; k += 4) {
      float4 xv[kSlice];
#pragma unroll
      for (int i = 0; i < kSlice; ++i) xv[i] = load4(xs + i * XS + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 wv[NP][NV];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < NV; ++j)
            wv[p][j] = load4(ws[p] + (k + u) * BN + kWarpCols * j);
#pragma unroll
        for (int i = 0; i < kSlice; ++i) {
          const float xi = lane_of(xv[i], u);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              acc[p][i][4 * j] = fmaf(xi, wv[p][j].x, acc[p][i][4 * j]);
              acc[p][i][4 * j + 1] = fmaf(xi, wv[p][j].y, acc[p][i][4 * j + 1]);
              acc[p][i][4 * j + 2] = fmaf(xi, wv[p][j].z, acc[p][i][4 * j + 2]);
              acc[p][i][4 * j + 3] = fmaf(xi, wv[p][j].w, acc[p][i][4 * j + 3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block

  if constexpr (KSPLIT > 1) {   // ks > 0 hand their sums to ks = 0, in ks order
    constexpr int Q = NP * kSlice * NV;     // float4 per lane
    float4* red = reinterpret_cast<float4*>(smem);
    __syncthreads();    // every warp is done with the ring
    if (ks > 0 && active) {
      float4* dst = red + size_t((ks - 1) * slices + rs) * Q * 32 + lane;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < kSlice; ++i)
#pragma unroll
          for (int j = 0; j < NV; ++j)
            dst[((p * kSlice + i) * NV + j) * 32] =
                make_float4(acc[p][i][4 * j], acc[p][i][4 * j + 1],
                            acc[p][i][4 * j + 2], acc[p][i][4 * j + 3]);
    }
    __syncthreads();
    if (ks > 0) return;
    if (active) {
      for (int o = 1; o < KSPLIT; ++o) {
        const float4* src = red + size_t((o - 1) * slices + rs) * Q * 32 + lane;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < kSlice; ++i)
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              const float4 v = src[((p * kSlice + i) * NV + j) * 32];
              acc[p][i][4 * j] += v.x;
              acc[p][i][4 * j + 1] += v.y;
              acc[p][i][4 * j + 2] += v.z;
              acc[p][i][4 * j + 3] += v.w;
            }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    const int r = kSlice * rs + i;          // row within the tile
    if (row0 + r >= C) continue;
    TO* orow = out_e + size_t(row0 + r) * N;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = n0 + kWarpCols * j + 4 * lane;
      if (c >= N) continue;
      if constexpr (GATED) {
        if (r < live)
          store4(orow + c, make_float4(silu(acc[0][i][0]) * acc[1][i][0],
                                       silu(acc[0][i][1]) * acc[1][i][1],
                                       silu(acc[0][i][2]) * acc[1][i][2],
                                       silu(acc[0][i][3]) * acc[1][i][3]));
      } else {
        store4(orow + c, r < live
                             ? make_float4(acc[0][i][4 * j], acc[0][i][4 * j + 1],
                                           acc[0][i][4 * j + 2], acc[0][i][4 * j + 3])
                             : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  }
}

template <typename TX, typename TW, typename TO, bool GATED, int KSPLIT>
int launch(const TX* x, const TW* w1, const TW* w2, const int* counts, TO* out,
           int E, int C, int Kd, int N, int slices, int slots, size_t smem,
           cudaStream_t stream) {
  auto* kernel = ffn_kernel<TX, TW, TO, GATED, KSPLIT>;
  static size_t smem_set = 0;        // raised once per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    smem_set = smem;
  }
  const int BN = kWarpCols * (GATED ? 1 : 2), BM = kSlice * slices;
  const dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
  kernel<<<grid, 32 * slices * KSPLIT, smem, stream>>>(
      x, w1, w2, counts, out, C, Kd, N, slices, slots);
  return int(cudaGetLastError());
}

template <typename T, int KSPLIT>
int run(const void* x, const void* wg, const void* wu, const void* wd,
        const int* counts, float* act, void* out, int E, int C, int d, int f,
        int slices, int slots, size_t smem, cudaStream_t stream) {
  const int err = launch<T, T, float, true, KSPLIT>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      counts, act, E, C, d, f, slices, slots, smem, stream);
  if (err != 0) return err;
  return launch<float, T, T, false, KSPLIT>(
      act, static_cast<const T*>(wd), nullptr, counts, static_cast<T*>(out), E,
      C, f, d, slices, slots, smem, stream);
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wu, const void* wd,
             const int* counts, float* act, void* out, int E, int C, int d,
             int f, int slices, int ksplit, int slots, size_t smem,
             cudaStream_t stream) {
  const bool ok_split = (ksplit == 1 || ksplit == 2 || ksplit == 4) &&
                        slices * ksplit <= kMaxWarps;
  const size_t need = slots * (slot_bytes<T, T, true>(slices) > slot_bytes<float, T, false>(slices)
                                   ? slot_bytes<T, T, true>(slices)
                                   : slot_bytes<float, T, false>(slices));
  if (slices < 1 || slices > kMaxSlices || !ok_split || slots < 2 || slots > 4 ||
      smem < need || smem < reduce_bytes(slices, ksplit))
    return int(cudaErrorInvalidValue);
  if (ksplit == 1)
    return run<T, 1>(x, wg, wu, wd, counts, act, out, E, C, d, f, slices, slots, smem, stream);
  if (ksplit == 2)
    return run<T, 2>(x, wg, wu, wd, counts, act, out, E, C, d, f, slices, slots, smem, stream);
  return run<T, 4>(x, wg, wu, wd, counts, act, out, E, C, d, f, slices, slots, smem, stream);
}

}  // namespace

extern "C" {

// x (E, C, d), wg / wu (E, d, f), wd (E, f, d), out (E, C, d): bfloat16 if
// bf16 != 0, else float32.  counts (E,) int32; act (E, C, f) fp32 scratch.
// d and f multiples of 8, every pointer 16-byte aligned (the wrapper checks).
// (slices, ksplit, slots, smem): the launch configuration and its dynamic
// shared memory, from kernel.py's launch_config.
int zipper_grouped_ffn(const void* x, const void* wg, const void* wu,
                       const void* wd, const int* counts, float* act, void* out,
                       int E, int C, int d, int f, int bf16, int slices,
                       int ksplit, int slots, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, wg, wu, wd, counts, act, out, E, C, d, f,
                                   slices, ksplit, slots, size_t(smem), s);
  return dispatch<float>(x, wg, wu, wd, counts, act, out, E, C, d, f, slices,
                         ksplit, slots, size_t(smem), s);
}

}  // extern "C"
