// W8A16 matmul for Hopper: y[M,N] = (bf16(x)[M,K] @ w_q[K,N] int8, fp32 sum) * s[N].
//
// Replaces the TPU kernel llmspeculativesampling_tpu/kernels/int8_matmul.py
// (_int8_matmul_2d, body _kernel): same math, the per-output-channel scale
// applied once after the K reduction, x rounded to bf16 first.
//
// Bound on the H100: reading the weights. At decode and verify shapes
// (M <= 25) the product does 2*M operations per weight byte, far below the
// card's ridge point, so the least time is K*N bytes / 3.35 TB/s.
//
// Design (simple, right first; wgmma/TMA is later work):
//   * a block owns BN=128 output columns, one row tile of up to MT<=32 rows
//     and one K range; the grid is (N/BN, ksplit, ceil(M/MT)), so every
//     weight byte is read once per row tile (the 64-row prefill reads twice).
//   * int8 weight tiles [BK=64][BN] and the matching x tile [MT][BK] (bf16)
//     stream into shared memory with 16-byte cp.async, STAGES deep, so the
//     bytes in flight do not depend on registers.
//   * 8 warps split the 64 rows of a tile (8 rows each); a lane owns 4
//     adjacent columns (one 32-bit shared load per row: a warp reads 128
//     contiguous bytes) and all MT rows, widening int8 to fp32 and
//     accumulating in fp32 registers (CUDA cores, not tensor cores).
//   * the 8 warps' partial sums meet in shared memory; with split-K
//     (ksplit > 1, chosen by the wrapper to give ~2 blocks per SM) each
//     block writes fp32 partials to a workspace [ksplit, M, N] and a second
//     small kernel sums them in a fixed order (deterministic), scales and
//     casts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BN = 128;
constexpr int BK = 64;
constexpr int TK = 8;          // warps splitting the BK rows of a tile
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int RP = 8;          // rows per reduction pass

template <int MT>
struct __align__(16) Smem {
  union {
    struct {
      int8_t w[STAGES][BK][BN];
      uint16_t x[STAGES][MT][BK];  // bf16 bits
    } p;
    float red[TK][RP][BN];
  };
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 bytes read -> 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1) w8a16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ s, OutT* __restrict__ out, float* __restrict__ ws,
    int M, int K, int N, int chunks_per_split) {
  __shared__ Smem<MT> sm;
  const int tid = threadIdx.x;
  const int tk = tid >> 5;   // warp: rows [tk*8, tk*8+8) of each tile
  const int tn = tid & 31;   // lane: columns [tn*4, tn*4+4)
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * chunks_per_split * BK;
  const int k_end = min(K, k_begin + chunks_per_split * BK);
  const int nchunks = (k_end - k_begin + BK - 1) / BK;

  auto load_chunk = [&](int stage, int c) {
    const int k0 = k_begin + c * BK;
    // weights: BK rows x 8 segments of 16 bytes
    for (int seg = tid; seg < BK * (BN / 16); seg += THREADS) {
      const int r = seg / (BN / 16), cs = seg % (BN / 16);
      const int k = k0 + r, n = n0 + cs * 16;
      const bool ok = (k < k_end) && (n < N);
      cp_async16(&sm.p.w[stage][r][cs * 16], ok ? (const void*)(w + (size_t)k * N + n) : (const void*)w, ok);
    }
    // x: MT rows x 8 segments of 8 bf16
    for (int seg = tid; seg < MT * (BK / 8); seg += THREADS) {
      const int r = seg / (BK / 8), cs = seg % (BK / 8);
      const int m = m0 + r, k = k0 + cs * 8;
      const bool ok = (m < M) && (k < k_end);
      cp_async16(&sm.p.x[stage][r][cs * 8], ok ? (const void*)(x + (size_t)m * K + k) : (const void*)x, ok);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nchunks) load_chunk(st, st);
    cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = c + STAGES - 1;
    if (nxt < nchunks) load_chunk(nxt % STAGES, nxt);
    cp_async_commit();

    const int st = c % STAGES;
    float wf[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const char4 q = *reinterpret_cast<const char4*>(&sm.p.w[st][tk * 8 + kk][tn * 4]);
      wf[kk][0] = (float)q.x; wf[kk][1] = (float)q.y;
      wf[kk][2] = (float)q.z; wf[kk][3] = (float)q.w;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint4 xv = *reinterpret_cast<const uint4*>(&sm.p.x[st][m][tk * 8]);
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float xf = __bfloat162float(xb[kk]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[m][cc] = fmaf(xf, wf[kk][cc], acc[m][cc]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // shared tiles are dead from here: reuse them as sm.red

  constexpr int ROWS = MT < RP ? MT : RP;
#pragma unroll
  for (int mb = 0; mb < MT; mb += ROWS) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) sm.red[tk][i][tn * 4 + cc] = acc[mb + i][cc];
    __syncthreads();
    for (int o = tid; o < ROWS * BN; o += THREADS) {
      const int i = o / BN, col = o % BN;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TK; ++t) sum += sm.red[t][i][col];
      const int m = m0 + mb + i, n = n0 + col;
      if (m < M && n < N) {
        if (ws) ws[((size_t)split * M + m) * N + n] = sum;
        else out[(size_t)m * N + n] = from_float<OutT>(sum * s[n]);
      }
    }
    __syncthreads();
  }
}

template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                     OutT* __restrict__ out, int M, int N, int ksplit) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < ksplit; ++k) sum += ws[(size_t)k * total + i];
    out[i] = from_float<OutT>(sum * s[i % N]);
  }
}

template <int MT, typename OutT>
void launch_mt(const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out, float* ws,
               int M, int K, int N, int ksplit, int chunks_per_split, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, ksplit, (M + MT - 1) / MT);
  w8a16_kernel<MT, OutT><<<grid, THREADS, 0, stream>>>(
      x, w, s, out, ksplit > 1 ? ws : nullptr, M, K, N, chunks_per_split);
  if (ksplit > 1) {
    const int threads = 256;
    const int blocks = (int)std::min<size_t>(1024, ((size_t)M * N + threads - 1) / threads);
    splitk_reduce_kernel<OutT><<<blocks, threads, 0, stream>>>(ws, s, out, M, N, ksplit);
  }
}

template <typename OutT>
void launch(int mt, const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out, float* ws,
            int M, int K, int N, int ksplit, int cps, cudaStream_t st) {
  switch (mt) {
    case 1: launch_mt<1, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
    case 2: launch_mt<2, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
    case 4: launch_mt<4, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
    case 8: launch_mt<8, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
    case 16: launch_mt<16, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
    default: launch_mt<32, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st); break;
  }
}

}  // namespace

// x [M,K] bf16, w [K,N] int8, s [N] f32, out [M,N] (bf16 when out_f32 == 0,
// else f32), ws [ksplit,M,N] f32 scratch (unused when ksplit == 1).
// Requires K % 8 == 0 and N % 16 == 0 (16-byte copies). Returns
// cudaGetLastError() after the launches.
extern "C" int w8a16_matmul(const void* x, const void* w, const void* s, void* out, void* ws,
                            int M, int K, int N, int mt, int ksplit, int chunks_per_split,
                            int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(s);
  float* wsf = static_cast<float*>(ws);
  if (out_f32)
    launch<float>(mt, xb, wq, sc, static_cast<float*>(out), wsf, M, K, N, ksplit, chunks_per_split, st);
  else
    launch<__nv_bfloat16>(mt, xb, wq, sc, static_cast<__nv_bfloat16*>(out), wsf, M, K, N, ksplit,
                          chunks_per_split, st);
  return (int)cudaGetLastError();
}
