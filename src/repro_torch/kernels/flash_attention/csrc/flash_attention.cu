// Blocked online-softmax attention on Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:75-130, pallas_call at :112) and covers what the LM stack gets
// from the scan path of ops.flash_attention besides: a per-batch valid length
// kv_len (ragged decode) and a value head dim Dv != D (MLA: D 192, Dv 128).
//
// What bounds it.  Prefill is bound by operations: (2 D + 2 Dv) flops per
// (query, key) pair kept by the mask, against 67 TFLOP/s of fp32 FMA (no
// tensor cores here).  Decode (one query row per head against the cache) is
// bound by the bytes of K and V up to kv_len.
//
// Design.  On the TPU the grid's kv axis runs in order and carries (m, l,
// acc) in VMEM scratch; here one block of 256 threads owns one (batch, query
// head, 64-row query tile) and walks the KV tiles itself, so nothing is
// carried between blocks.  The query tile (scaled by D^-1/2 on load) stays in
// shared memory; each 64-key K and V tile is staged there, converted to fp32
// (a warp per row, 4 values a lane per load, no index division).
// S = Q K^T is a 64 x 64 tile, 4 x 4 scores per thread with rows and keys
// strided by 16, read 4 dims at a time as float4 (rows padded to D + 4
// floats, so a quarter-warp's 8 float4 reads fall in 32 distinct banks).  One
// warp then takes 8 rows of S through the online softmax: masked scores hold
// the -1e30 sentinel and get probability 0 exactly (kernel.py:57-58); the
// row's running max m, sum l and rescale factor live in shared memory.  Each
// thread keeps 4 rows x 4 NV output columns of acc in registers (columns
// 4 tx + 64 jj, one float4 of V per read) and adds P V.  The output is
// acc / max(l, 1e-30), so a row with no valid key is 0, as in the Pallas
// kernel.  GQA reads KV head h / G (no KV copy); queries are right-aligned
// against keys (Sk - Sq); KV tiles above the causal diagonal, past kv_len or
// before the window are skipped.
// At D = 192 the tiles need 152 KB of shared memory: dynamic shared memory,
// raised with cudaFuncSetAttribute.  fp32 FMA throughout; wgmma, TMA and a
// pipelined KV ring are later work.
//
// The C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;     // padded row stride of the score tile
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;   // masked score
constexpr float kLive = -1e29f;  // a score above this is a kept key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 4 consecutive elements as floats (16 bytes of fp32, 8 of bf16, aligned)
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage n_rows x width values (width a multiple of 4) into shared memory as
// fp32 times mul; source rows at or past valid_rows load as zero.  Warp w
// takes rows w, w + 8, ...; a lane moves 4 values at a time along the row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          size_t src_stride, int valid_rows,
                                          int n_rows, int width, float mul) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n_rows; r += kThreads / 32)
    for (int c = 4 * lane; c < width; c += 128) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid_rows) {
        x = load4(src + r * src_stride + c);
        x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
      }
      *reinterpret_cast<float4*>(dst + r * dst_stride + c) = x;
    }
}

// Q and K rows are padded to D + 4 floats: 16-byte aligned, and the rows
// that a quarter-warp reads as float4 start 4 banks apart.
size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (size_t(kBQ + kBK) * (D + 4) + size_t(kBK) * Dv +
                          size_t(kBQ) * kPS + 3 * kBQ);
}

// q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv), out (B, Sq, H, Dv),
// kv_len (B,) or null.  grid (ceil(Sq / 64), H, B).  D and Dv multiples of
// 4, Dv <= 64 * NV.  Thread (ty, tx) owns query rows ty + 16 i (i < 4), keys
// tx + 16 j of each S tile, and output columns 4 tx + 64 jj + e.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ out, int Sq, int Sk, int H, int K, int D, int Dv,
             int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = D + 4;
  float* qs = smem;                    // kBQ x Dp
  float* ks = qs + kBQ * Dp;           // kBK x Dp
  float* vs = ks + kBK * Dp;           // kBK x Dv
  float* ps = vs + kBK * Dv;           // kBQ x kPS: scores, then probabilities
  float* row_m = ps + kBQ * kPS;       // running max
  float* row_l = row_m + kBQ;          // running sum
  float* row_a = row_l + kBQ;          // this tile's rescale factor

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int shift = Sk - Sq;                       // right-aligned queries
  const int len = kv_len ? min(Sk, kv_len[b]) : Sk;
  const int q_rows = min(kBQ, Sq - q0);

  load_tile(qs, Dp, q + ((size_t(b) * Sq + q0) * H + h) * D, size_t(H) * D,
            q_rows, kBQ, D, scale);
  if (tid < kBQ) {
    row_m[tid] = kNeg;
    row_l[tid] = 0.f;
  }

  // keys any row of this tile may keep: [k_lo, k_hi)
  int k_hi = len;
  if (causal) k_hi = min(k_hi, q0 + q_rows + shift);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 + shift - window + 1);

  float acc[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();   // previous tile's ks / vs / ps are consumed
    const size_t kv_row = (size_t(b) * Sk + k0) * K + kh;   // first key row
    load_tile(ks, Dp, k + kv_row * D, size_t(K) * D, Sk - k0, kBK, D, 1.f);
    load_tile(vs, Dv, v + kv_row * Dv, size_t(K) * Dv, Sk - k0, kBK, Dv, 1.f);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j, 4 dims per float4 read
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(qs + (ty + 16 * i) * Dp + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(ks + (tx + 16 * j) * Dp + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q0 + r + shift;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int k_pos = k0 + c;
        bool keep = r < q_rows && k_pos < len;
        if (causal) keep = keep && k_pos <= q_pos;
        if (window > 0) keep = keep && k_pos > q_pos - window;
        ps[r * kPS + c] = keep ? s[i][j] : kNeg;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two keys per lane
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float a = ps[r * kPS + lane], c = ps[r * kPS + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
      const float pa = a > kLive ? expf(a - m_new) : 0.f;
      const float pc = c > kLive ? expf(c - m_new) : 0.f;
      const float sum = warp_sum(pa + pc);
      ps[r * kPS + lane] = pa;
      ps[r * kPS + lane + 32] = pc;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, 4 keys per float4 read of P
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ld4(ps + (ty + 16 * i) * kPS + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          const int col = 4 * tx + 64 * jj;
          const float4 vv = col < Dv ? ld4(vs + (c + e) * Dv + col)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = at(pv[i], e);
            acc[i][4 * jj + 0] = fmaf(p, vv.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(p, vv.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p, vv.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p, vv.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }
  __syncthreads();   // row_l is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    T* o = out + (size_t(b) * Sq + q0 + r) * H * Dv + size_t(h) * Dv;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int col = 4 * tx + 64 * jj;
      if (col >= Dv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) store(o + col + e, acc[i][4 * jj + e] * inv);
    }
  }
}

template <typename T, int NV>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, int B, int Sq, int Sk, int H, int K, int D, int Dv,
           int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  auto* kernel = flash_kernel<T, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Sq, Sk, H, K, D,
      Dv, causal, window, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, int B, int Sq, int Sk, int H, int K, int D, int Dv,
             int causal, int window, cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 1>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal, window, stream);
  if (Dv <= 128)
    return launch<T, 2>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal, window, stream);
  if (Dv <= 192)
    return launch<T, 3>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal, window, stream);
  return launch<T, 4>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal, window, stream);
}

}  // namespace

extern "C" {

// window <= 0: no sliding window.  bf16 != 0: q, k, v and out are bfloat16,
// else float32.  D and Dv multiples of 4 and at most 256, q, k and v 16-byte
// aligned (the wrapper checks).
int zipper_flash_attention(const void* q, const void* k, const void* v,
                           const int* kv_len, void* out, int B, int Sq, int Sk,
                           int H, int K, int D, int Dv, int causal, int window,
                           int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D,
                                   Dv, causal, window, s);
  return dispatch<float>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal,
                         window, s);
}

}  // extern "C"
