// Length-aware flash-decode attention for Hopper, dense and int8 KV, over a
// contiguous cache (B2) or a paged block pool (B3).
//
// Replaces the TPU kernels of llmspeculativesampling_tpu/kernels/flash_decode.py
// _flash_call and _paged_flash_call (one body, _make_kernel(paged=...)). Per
// batch row b and kv head h, the G*S_new query rows (row r = g*S_new + s,
// query head h*G + g) attend under one fp32 online softmax to two sources:
//   * the prefix [0, lengths[b]) -- only live positions are read. Contiguous:
//     position p of [B, Hkv, S_max, D]. Paged: position p lives in pool block
//     tables[b, p / page] of [N, Hkv, page, D] at offset p % page; table ids
//     are clamped to [0, N-1] and p / page to the table's width, so a
//     sentinel id never addresses outside the pool;
//   * the new block's own k/v [B, Hkv, S_new, D] (compute dtype, not read
//     back from the cache) under an additive bias [B, S_new, S_new] that is
//     causal or a tree mask.
// The softmax scale is folded into q and q is rounded to its own dtype
// first, as the TPU wrapper does. The int8 variant reads int8 K/V and
// applies the per-position scales algebraically: scores * k_s, p * v_s.
//
// Bound on the H100: the live prefix K/V bytes (about 20 KB per position
// per 13B layer in bf16) plus launch latency; at the decode lengths of the
// main path (<= 256 positions) the latency dominates.
//
// Design (simple, right first): one block of 8 warps per (b, kv head, tile
// of 32 query rows); a warp owns up to 4 rows, a lane D/32 of the dims of
// each; each head size D in {32, 64, 96, 128} has its own instantiation.
// K/V chunks of 32 positions are staged in shared memory in their stored
// type; a score is a lane-partial dot product summed across the warp
// by shuffles, lane t keeps the score of position t, and p is broadcast back
// by shuffle for the PV product. The two layouts differ only in where a
// staged position's row is read from: the paged layout looks its block up
// per position (not per page), so any page size works. With B=1 and Hkv=40
// this runs 40 blocks on 132 SMs; paged serving at B=16 runs 640. The
// flash-decoding split-KV reduction across SMs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;               // query rows per warp
constexpr int ROWS = WARPS * RPW;    // query rows per block
constexpr int T = 32;                // positions per staged chunk
constexpr float MASK = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T_> __device__ __forceinline__ T_ from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Copy n_bytes (a multiple of 16, 16-byte aligned) from global to shared.
__device__ __forceinline__ void stage(void* dst, const void* src, int n_bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n_bytes / 16; i += THREADS) d[i] = s[i];
}

// Prefix layouts: row(b, h, p) is the index of position p of (batch row b,
// kv head h) in the [*, D] K/V storage and in the matching [*] scales; cap()
// bounds the positions a row can hold.
struct Contig {
  int Hkv, S_max;
  __device__ __forceinline__ size_t row(int b, int h, int p) const {
    return ((size_t)b * Hkv + h) * S_max + p;
  }
  __device__ __forceinline__ int cap() const { return S_max; }
};

struct Paged {
  const int* tables;  // [B, P]
  int P, page, Hkv, max_blk;
  __device__ __forceinline__ size_t row(int b, int h, int p) const {
    const int j = min(p / page, P - 1);
    const int blk = min(max(tables[(size_t)b * P + j], 0), max_blk);
    return ((size_t)blk * Hkv + h) * page + p % page;
  }
  __device__ __forceinline__ int cap() const { return P * page; }
};

// Stage positions [c0, c0+n) of (b, h) from src into dst, 16 bytes a thread
// (a position's D values are contiguous and 16-byte aligned in both layouts).
template <int D, typename E, typename L>
__device__ __forceinline__ void stage_prefix(void* dst, const E* src, const L& lay, int b, int h,
                                             int c0, int n) {
  constexpr int U = D * (int)sizeof(E) / 16;  // 16-byte units per position
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n * U; i += THREADS) {
    const int t = i / U;
    d[i] = reinterpret_cast<const uint4*>(src + lay.row(b, h, c0 + t) * D)[i - t * U];
  }
}

struct RowState {
  float q[RPW][4];    // D/32 <= 4 dims per lane
  float acc[RPW][4];
  float m[RPW], l[RPW];
};

// One staged chunk of n positions (kv: [n][D] of type E in shared memory).
// bias (new block only): row s of [S_new, S_new] at column t; ks/vs: int8
// scales of the chunk, or null.
template <int D, typename E>
__device__ __forceinline__ void attend_chunk(RowState& st, const E* ks_mem, const E* vs_mem, int n,
                                             int nrows, const int* srow, const float* bias,
                                             int S_new, const float* ksc, const float* vsc) {
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x & 31;
  float s_mine[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s_mine[i] = MASK;
  for (int t = 0; t < n; ++t) {
    const E* kr = ks_mem + t * D + lane * DPL;
    float kv[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) kv[j] = to_f(kr[j]);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i < nrows) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) part = fmaf(st.q[i][j], kv[j], part);
        part = warp_sum(part);
        if (lane == t) {
          float sc = ksc ? part * ksc[t] : part;
          s_mine[i] = bias ? sc + bias[srow[i] * S_new + t] : sc;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < nrows) {
      const float m_new = fmaxf(st.m[i], warp_max(s_mine[i]));
      const float corr = expf(st.m[i] - m_new);
      const float p = lane < n ? expf(s_mine[i] - m_new) : 0.f;
      st.l[i] = st.l[i] * corr + warp_sum(p);
      st.m[i] = m_new;
      const float pv = (vsc && lane < n) ? p * vsc[lane] : p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) st.acc[i][j] *= corr;
      for (int t = 0; t < n; ++t) {
        const float pt = __shfl_sync(0xffffffffu, pv, t);
        const E* vr = vs_mem + t * D + lane * DPL;
#pragma unroll
        for (int j = 0; j < DPL; ++j) st.acc[i][j] = fmaf(pt, to_f(vr[j]), st.acc[i][j]);
      }
    }
  }
}

template <int D, typename TQ, typename TC, bool QUANT, typename L>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const TQ* __restrict__ q, const TQ* __restrict__ k_new, const TQ* __restrict__ v_new,
    const TC* __restrict__ k_cache, const TC* __restrict__ v_cache,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ lengths, const float* __restrict__ bias, TQ* __restrict__ out,
    int Hkv, int G, int S_new, L lay, float scale) {
  constexpr int DPL = D / 32;
  // large enough for a chunk of T positions of the widest type (fp32)
  __shared__ __align__(16) unsigned char kbuf[T * D * 4];
  __shared__ __align__(16) unsigned char vbuf[T * D * 4];
  __shared__ float ksc[T], vsc[T];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = G * S_new;
  const int Hq = Hkv * G;
  const int len = min(max(lengths[b], 0), lay.cap());

  // rows of this warp: r = blockIdx.y*ROWS + warp + WARPS*i
  RowState st;
  int srow[RPW];
  int nrows = 0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = blockIdx.y * ROWS + warp + WARPS * i;
    if (r < R) nrows = i + 1;
    const int g = r / S_new, s = r % S_new;
    srow[i] = s;
    st.m[i] = MASK;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      st.acc[i][j] = 0.f;
      float qv = 0.f;
      if (r < R) {
        const TQ* qr = q + (((size_t)b * Hq + h * G + g) * S_new + s) * D + lane * DPL;
        qv = to_f(from_f<TQ>(to_f(qr[j]) * scale));  // scale folded, rounded to q's dtype
      }
      st.q[i][j] = qv;
    }
  }

  // ---- the new block, with its bias
  const size_t kv_row = (size_t)b * Hkv + h;
  stage(kbuf, k_new + kv_row * S_new * D, S_new * D * (int)sizeof(TQ));
  stage(vbuf, v_new + kv_row * S_new * D, S_new * D * (int)sizeof(TQ));
  __syncthreads();
  attend_chunk<D, TQ>(st, reinterpret_cast<const TQ*>(kbuf), reinterpret_cast<const TQ*>(vbuf),
                      S_new, nrows, srow, bias + (size_t)b * S_new * S_new, S_new, nullptr, nullptr);
  __syncthreads();

  // ---- the live prefix, chunk by chunk
  for (int c0 = 0; c0 < len; c0 += T) {
    const int n = min(T, len - c0);
    stage_prefix<D>(kbuf, k_cache, lay, b, h, c0, n);
    stage_prefix<D>(vbuf, v_cache, lay, b, h, c0, n);
    if (QUANT && threadIdx.x < n) {
      const size_t r = lay.row(b, h, c0 + threadIdx.x);
      ksc[threadIdx.x] = k_scales[r];
      vsc[threadIdx.x] = v_scales[r];
    }
    __syncthreads();
    attend_chunk<D, TC>(st, reinterpret_cast<const TC*>(kbuf), reinterpret_cast<const TC*>(vbuf),
                        n, nrows, srow, nullptr, S_new, QUANT ? ksc : nullptr,
                        QUANT ? vsc : nullptr);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < nrows) {
      const int r = blockIdx.y * ROWS + warp + WARPS * i;
      const int g = r / S_new, s = r % S_new;
      TQ* orow = out + (((size_t)b * Hq + h * G + g) * S_new + s) * D + lane * DPL;
      const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPL; ++j) orow[j] = from_f<TQ>(st.acc[i][j] * inv);
    }
  }
}

template <int D, typename TQ, typename L>
void launch_d(bool quant, const void* q, const void* kn, const void* vn, const void* kc,
              const void* vc, const float* ks, const float* vs, const int* lengths,
              const float* bias, void* out, int B, int Hkv, int G, int S_new, L lay,
              float scale, cudaStream_t st) {
  dim3 grid(B * Hkv, (G * S_new + ROWS - 1) / ROWS);
  const TQ* qq = static_cast<const TQ*>(q);
  const TQ* kk = static_cast<const TQ*>(kn);
  const TQ* vv = static_cast<const TQ*>(vn);
  if (quant)
    flash_decode_kernel<D, TQ, int8_t, true><<<grid, THREADS, 0, st>>>(
        qq, kk, vv, static_cast<const int8_t*>(kc), static_cast<const int8_t*>(vc), ks, vs,
        lengths, bias, static_cast<TQ*>(out), Hkv, G, S_new, lay, scale);
  else
    flash_decode_kernel<D, TQ, TQ, false><<<grid, THREADS, 0, st>>>(
        qq, kk, vv, static_cast<const TQ*>(kc), static_cast<const TQ*>(vc), nullptr, nullptr,
        lengths, bias, static_cast<TQ*>(out), Hkv, G, S_new, lay, scale);
}

template <typename L>
int launch(int D, bool q_f32, bool quant, const void* q, const void* kn, const void* vn,
           const void* kc, const void* vc, const void* k_scales, const void* v_scales,
           const void* lengths, const void* bias, void* out, int B, int Hkv, int G, int S_new,
           L lay, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* ln = static_cast<const int*>(lengths);
  const float* bs = static_cast<const float*>(bias);
#define FD_CASE(DD)                                                                          \
  case DD:                                                                                   \
    if (q_f32)                                                                               \
      launch_d<DD, float>(quant, q, kn, vn, kc, vc, ks, vs, ln, bs, out, B, Hkv, G, S_new,  \
                          lay, scale, st);                                                   \
    else                                                                                     \
      launch_d<DD, __nv_bfloat16>(quant, q, kn, vn, kc, vc, ks, vs, ln, bs, out, B, Hkv, G, \
                                  S_new, lay, scale, st);                                    \
    break;
  switch (D) {
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(96)
    FD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,S_new,D], k_new/v_new [B,Hkv,S_new,D] (bf16 when q_f32 == 0, else
// f32); caches [B,Hkv,S_max,D] in q's dtype, or int8 with scales
// [B,Hkv,S_max] f32 when quant != 0; lengths [B] i32; bias [B,S_new,S_new]
// f32; out like q. D is 32, 64, 96 or 128 (D/32 dims per lane). Returns
// cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k_new, const void* v_new,
                            const void* k_cache, const void* v_cache, const void* k_scales,
                            const void* v_scales, const void* lengths, const void* bias,
                            void* out, int B, int Hkv, int G, int S_new, int S_max, int D,
                            int q_f32, int quant, float scale, void* stream) {
  return launch(D, q_f32, quant, q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, lengths,
                bias, out, B, Hkv, G, S_new, Contig{Hkv, S_max}, scale, stream);
}

// The paged layout: pools [N,Hkv,page,D] (scales [N,Hkv,page]) and block
// tables [B,P] i32 in place of the caches; everything else as above.
extern "C" int paged_flash_decode(const void* q, const void* k_new, const void* v_new,
                                  const void* k_pool, const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* lengths, const void* tables,
                                  const void* bias, void* out, int B, int Hkv, int G, int S_new,
                                  int P, int page, int N, int D, int q_f32, int quant,
                                  float scale, void* stream) {
  const Paged lay{static_cast<const int*>(tables), P, page, Hkv, N - 1};
  return launch(D, q_f32, quant, q, k_new, v_new, k_pool, v_pool, k_scales, v_scales, lengths,
                bias, out, B, Hkv, G, S_new, lay, scale, stream);
}
