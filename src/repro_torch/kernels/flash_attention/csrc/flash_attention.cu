// Blocked online-softmax attention on Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:75-130, pallas_call at :112) and covers what the LM stack gets
// from the scan path of ops.flash_attention besides: a per-batch valid length
// kv_len (ragged decode) and a value head dim Dv != D (MLA: D 192, Dv 128).
//
// What bounds it.  Prefill is bound by operations: (2 D + 2 Dv) flops per
// (query, key) pair kept by the mask, against 67 TFLOP/s of fp32 FMA (no
// tensor cores: TF32 stays off).  Decode (one query row per head against the
// cache) is bound by the bytes of K and V up to kv_len.
//
// Design.  On the TPU the grid's kv axis runs in order and carries (m, l,
// acc) in VMEM scratch; here one block of 8 warps owns one (batch, query
// head, 16 ROWS query rows) and walks the 64-key tiles itself.
// - Register tiles.  Warp w owns query rows [16 ROWS w/8 ...): its lane
//   (half, kx) holds rows 2 i + half (i < ROWS) of the warp's 2 ROWS rows,
//   keys kx + 16 j (j < 4) of each S tile and output columns 4 kx + 64 jj
//   (jj < NV).  In S = Q K^T a thread reads ROWS float4 of Q, which the 16
//   lanes of a half-warp share (a broadcast: one shared-memory wavefront
//   for the warp's two rows), and 4 float4 of K, for 16 ROWS FMAs; in P V
//   ROWS float4 of P (broadcast again) and 4 NV float4 of V for 16 ROWS NV
//   FMAs.  At ROWS = 8 a warp issues 8 + 8 wavefronts per 128 FMA
//   instructions in S and 8 + 16 per 256 in P V: shared memory is no
//   longer the limit (the first design read 2 bytes per FMA).
// - The softmax in registers.  A row's 64 scores of a tile lie in the 16
//   lanes of one half-warp; its max and sum take 4 xor-shuffles each, and
//   every lane keeps (m, l) of its rows.  P makes one pass through shared
//   memory, written and read by the warp that owns its rows.  Scores are
//   kept in base 2 (Q is scaled by log2(e) / sqrt(D) on load): exp2f.
// - A K/V ring.  Q (fp32, scaled) stays in shared memory for the whole
//   walk.  K and V stream through a ring of 3 slots filled by cp.async:
//   a tile is D/64 K chunks (64 keys x 64 dims) and then 64/VK V chunks
//   (VK keys x Dv, VK = 32 at Dv = 128 in fp32), so chunks g + 1 and g + 2
//   load while chunk g computes; one block barrier per chunk.  The SM
//   stalls at each barrier (one block a SM, nothing else to issue), so
//   chunks are as large as shared memory allows: halving them costs more
//   than the ring's depth gains (tools/flash_variants.py, PERF.md).  Keys
//   at or past kv_len (or Sk) are zero-filled by cp.async without reading
//   memory.
// - Masks only where needed.  A tile that crosses the causal diagonal, the
//   window's edge or kv_len takes the per-element mask; the others none.
//   KV tiles wholly above the diagonal, past kv_len or before the window
//   are not walked.  Query tiles are scheduled heaviest first (the last
//   query tile of a causal prompt has the most keys).
// - Shared memory: Q 16 ROWS x (D + 4) + P 16 ROWS x 68 floats + 3 slots
//   of 64 x (64 + 16 / sizeof(T)) elements: 187,392 B at ROWS = 8, D = 192
//   (MLA prefill), 154,624 B at D = 128 (GQA prefill), at most 220,160 B
//   (ROWS = 8, D = 256) within 227 KB: one block of 256 threads per SM.
//   ptxas gives the 8-row fp32 instantiations 212-254 registers a thread
//   and no spills (chip_smoke.py phase 2 prints the report).  Two blocks
//   a SM of 4-row tiles measured slower (tools/flash_variants.py).  The wrapper (kernel.py launch_config) picks ROWS and NV and
//   computes the same byte count; the entry point refuses a smaller one.
// Masked scores hold -1e30 and get probability 0 exactly (kernel.py:57-58);
// the output is acc / max(l, 1e-30), so a row with no valid key is 0, as in
// the Pallas kernel.  GQA reads KV head h / G (no KV copy); queries are
// right-aligned against keys (Sk - Sq).  fp32 or bf16 in, fp32 math.
//
// The C entry point takes raw pointers, the sizes and the CUDA stream,
// launches on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // keys per KV tile
constexpr int kKC = 64;          // head dims per K chunk
constexpr int kStages = 3;       // ring slots
constexpr int kPS = kBK + 4;     // P row stride (floats)
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e30f;   // masked score
constexpr float kLive = -1e29f;  // a score above this is a kept key
constexpr float kLog2e = 1.4426950408889634f;

// a K chunk row: 64 dims and 16 bytes of padding, so the 16 keys a
// half-warp reads at once fall in distinct banks
template <typename T>
__host__ __device__ constexpr int k_stride() { return kKC + 16 / int(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int slot_bytes() { return kBK * k_stride<T>() * int(sizeof(T)); }

template <typename T>
size_t smem_bytes(int rows, int D) {
  const size_t bq = 16 * size_t(rows);
  return sizeof(float) * bq * (D + 4 + kPS) + size_t(kStages) * slot_bytes<T>();
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

// copy 4 elements global -> shared without registers; zero-fill (no read)
// where !valid
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * int(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Chunk c of a KV tile starting at key k0 into a ring slot: c < nK is K's
// dims [32 c, 32 c + 32) of the tile's 64 keys (row stride k_stride), the
// rest are V's keys [VK (c - nK), + VK) (row stride Dv).  Keys at or past
// `valid` (kv_len or Sk, from k0) are zero-filled.
template <typename T>
__device__ __forceinline__ void load_chunk(T* slot, const T* kb, const T* vb,
                                           int c, int nK, int vk, int valid,
                                           size_t k_row, size_t v_row, int D,
                                           int Dv) {
  if (c < nK) {
    const int d0 = c * kKC, per_row = min(kKC, D - d0) / 4;
    for (int i = threadIdx.x; i < kBK * per_row; i += kThreads) {
      const int key = i / per_row, p = 4 * (i - key * per_row);
      const bool ok = key < valid;
      cp_async4(slot + key * k_stride<T>() + p,
                ok ? kb + key * k_row + d0 + p : kb, ok);
    }
  } else {
    const int kv0 = (c - nK) * vk, per_row = Dv / 4;
    for (int i = threadIdx.x; i < vk * per_row; i += kThreads) {
      const int key = i / per_row, p = 4 * (i - key * per_row);
      const bool ok = kv0 + key < valid;
      cp_async4(slot + key * Dv + p, ok ? vb + (kv0 + key) * v_row + p : vb, ok);
    }
  }
}

// q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv), out (B, Sq, H, Dv),
// kv_len (B,) or null.  grid (H, ceil(Sq / 16 ROWS), B).  D and Dv multiples
// of 4, Dv <= 64 NV, D <= 256.
template <typename T, int ROWS, int NV>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ kv_len,
             T* __restrict__ out, int Sq, int Sk, int H, int K, int D, int Dv,
             int causal, int window, float scale) {
  constexpr int kBQ = 16 * ROWS;
  extern __shared__ __align__(16) float smem[];
  const int Dq = D + 4;
  float* qs = smem;                                  // kBQ x Dq, scaled Q
  float* ps = qs + kBQ * Dq;                         // kBQ x kPS, P
  T* ring = reinterpret_cast<T*>(ps + kBQ * kPS);    // kStages slots
  constexpr int kSlot = slot_bytes<T>() / int(sizeof(T));

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, kx = lane & 15;
  const int row0 = warp * 2 * ROWS + half;          // rows row0 + 2 i
  const int shift = Sk - Sq;                        // right-aligned queries
  const int len = kv_len ? min(Sk, kv_len[b]) : Sk;
  const int q_rows = min(kBQ, Sq - q0);

  // Q, scaled into base 2: warp per row, 4 values a lane
  {
    const T* qb = q + ((size_t(b) * Sq + q0) * H + h) * D;
    const float mul = scale * kLog2e;
    for (int r = warp; r < kBQ; r += kThreads / 32)
      for (int c = 4 * lane; c < D; c += 128) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < q_rows) {
          x = load4(qb + size_t(r) * H * D + c);
          x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
        }
        store4(qs + r * Dq + c, x);
      }
  }

  // keys any row of this tile may keep: [k_lo, k_hi)
  int k_hi = len;
  if (causal) k_hi = min(k_hi, q0 + q_rows + shift);
  const int k_lo = window > 0 ? max(0, q0 + shift - window + 1) : 0;
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi > t_lo * kBK ? (k_hi - t_lo * kBK + kBK - 1) / kBK : 0;

  const int nK = (D + kKC - 1) / kKC;
  int vk = kBK;
  while (vk * Dv * int(sizeof(T)) > slot_bytes<T>()) vk >>= 1;
  const int nC = nK + kBK / vk;
  const int n_chunks = n_tiles * nC;
  const size_t k_row = size_t(K) * D, v_row = size_t(K) * Dv;
  const T* kb0 = k + (size_t(b) * Sk * K + kh) * D;
  const T* vb0 = v + (size_t(b) * Sk * K + kh) * Dv;

  auto issue = [&](int g) {
    if (g < n_chunks) {
      const int t = t_lo + g / nC, c = g % nC, k0 = t * kBK;
      load_chunk(ring + (g % kStages) * kSlot, kb0 + k0 * k_row,
                 vb0 + k0 * v_row, c, nK, vk, len - k0, k_row, v_row, D, Dv);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) issue(g);

  float o[ROWS][4 * NV];
  float m[ROWS], l[ROWS], s[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NV; ++j) o[i][j] = 0.f;
  }

  for (int g = 0; g < n_chunks; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // chunk g is in; chunk g - 1's slot is free
    issue(g + kStages - 1);
    const T* slot = ring + (g % kStages) * kSlot;
    const int c = g % nC, k0 = (t_lo + g / nC) * kBK;

    if (c < nK) {
      // S += Q[:, 32 c : 32 c + 32] K_chunk^T
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const int d0 = c * kKC, n4 = min(kKC, D - d0) / 4;
      const float* qr = qs + row0 * Dq + d0;
      const T* kr = slot + kx * k_stride<T>();
#pragma unroll 8
      for (int dd = 0; dd < 4 * n4; dd += 4) {
        float4 qv[ROWS], kv[4];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) qv[i] = ld4(qr + 2 * i * Dq + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = load4(kr + 16 * j * k_stride<T>() + dd);
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      if (c == nK - 1) {
        // mask (only a tile on an edge), then the online softmax
        const int q_first = q0 + shift, q_last = q0 + q_rows - 1 + shift;
        const bool edge = k0 + kBK > len || (causal && k0 + kBK - 1 > q_first) ||
                          (window > 0 && k0 <= q_last - window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int q_pos = q0 + row0 + 2 * i + shift;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k_pos = k0 + kx + 16 * j;
              bool keep = k_pos < len;
              if (causal) keep = keep && k_pos <= q_pos;
              if (window > 0) keep = keep && k_pos > q_pos - window;
              if (!keep) s[i][j] = kNeg;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = exp2f(m[i] - m_new);
          float sum = 0.f;
          float* pr = ps + (row0 + 2 * i) * kPS + kx;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = s[i][j] > kLive ? exp2f(s[i][j] - m_new) : 0.f;
            sum += p;
            pr[16 * j] = p;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(kAll, sum, off);
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int j = 0; j < 4 * NV; ++j) o[i][j] *= alpha;
        }
        __syncwarp();         // the warp's P rows are written
      }
    } else {
      // o += P[:, kv0 : kv0 + vk] V_chunk, 4 keys per float4 read of P;
      // a chunk wholly past the last kept key adds zeros and is skipped
      const int kv0 = (c - nK) * vk;
      if (k0 + kv0 < k_hi) {
        const float* pr = ps + row0 * kPS + kv0;
        for (int kk = 0; kk < vk; kk += 4) {
          float4 pv[ROWS];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) pv[i] = ld4(pr + 2 * i * kPS + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const T* vr = slot + (kk + e) * Dv;
#pragma unroll
            for (int jj = 0; jj < NV; ++jj) {
              const int col = 4 * kx + 64 * jj;
              const float4 vv = col < Dv ? load4(vr + col)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int i = 0; i < ROWS; ++i) {
                const float p = at(pv[i], e);
                o[i][4 * jj + 0] = fmaf(p, vv.x, o[i][4 * jj + 0]);
                o[i][4 * jj + 1] = fmaf(p, vv.y, o[i][4 * jj + 1]);
                o[i][4 * jj + 2] = fmaf(p, vv.z, o[i][4 * jj + 2]);
                o[i][4 * jj + 3] = fmaf(p, vv.w, o[i][4 * jj + 3]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();         // no copy outlives the block

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + 2 * i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (size_t(b) * Sq + q0 + r) * H * Dv + size_t(h) * Dv;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int col = 4 * kx + 64 * jj;
      if (col < Dv)
        store4(orow + col, make_float4(o[i][4 * jj] * inv, o[i][4 * jj + 1] * inv,
                                       o[i][4 * jj + 2] * inv, o[i][4 * jj + 3] * inv));
    }
  }
}

template <typename T, int ROWS, int NV>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, int B, int Sq, int Sk, int H, int K, int D, int Dv,
           int causal, int window, size_t smem, cudaStream_t stream) {
  auto* kernel = flash_kernel<T, ROWS, NV>;
  static size_t smem_set = 0;        // raised once per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    smem_set = smem;
  }
  const dim3 grid(H, (Sq + 16 * ROWS - 1) / (16 * ROWS), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), Sq, Sk, H, K, D,
      Dv, causal, window, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* out, int B, int Sq, int Sk, int H, int K, int D, int Dv,
             int causal, int window, int rows, int nv, size_t smem,
             cudaStream_t stream) {
  if (smem < smem_bytes<T>(rows, D) || Dv > 64 * nv || D > 256)
    return int(cudaErrorInvalidValue);
#define ZIPPER_FLASH(R, N)                                                     \
  if (rows == R && nv == N)                                                    \
    return launch<T, R, N>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv,       \
                           causal, window, smem, stream);
  ZIPPER_FLASH(1, 1) ZIPPER_FLASH(1, 2) ZIPPER_FLASH(1, 4)
  ZIPPER_FLASH(4, 1) ZIPPER_FLASH(4, 2) ZIPPER_FLASH(4, 4)
  ZIPPER_FLASH(8, 1) ZIPPER_FLASH(8, 2)
#undef ZIPPER_FLASH
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// window <= 0: no sliding window.  bf16 != 0: q, k, v and out are bfloat16,
// else float32.  D and Dv multiples of 4 and at most 256, q, k and v 16-byte
// aligned (the wrapper checks).  (rows, nv, smem): the tile configuration
// and its dynamic shared memory, from kernel.py's launch_config.
int zipper_flash_attention(const void* q, const void* k, const void* v,
                           const int* kv_len, void* out, int B, int Sq, int Sk,
                           int H, int K, int D, int Dv, int causal, int window,
                           int bf16, int rows, int nv, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D,
                                   Dv, causal, window, rows, nv, size_t(smem), s);
  return dispatch<float>(q, k, v, kv_len, out, B, Sq, Sk, H, K, D, Dv, causal,
                         window, rows, nv, size_t(smem), s);
}

}  // extern "C"
