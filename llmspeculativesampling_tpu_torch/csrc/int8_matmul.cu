// W8A16 matmul for Hopper: y[M,N] = (bf16(x)[M,K] @ w_q[K,N] int8, fp32 sum) * s[N].
//
// Replaces the TPU kernel llmspeculativesampling_tpu/kernels/int8_matmul.py
// (_int8_matmul_2d, pallas_call at :75, body _kernel): same math, the
// per-output-channel scale applied once after the K reduction, x rounded to
// bf16 first.
//
// What bounds it on the H100, by path:
//   * decode, verify and draft calls (M <= 144): the weight bytes. A call
//     does 2*M operations per weight byte, at most 288, under the card's
//     ridge of ~295 bf16 tensor operations a byte, so the least time is
//     K*N bytes / 3.35 TB/s -- if each weight byte is read once and the
//     products run on the tensor cores (on CUDA cores at 67 TFLOP/s the
//     operations outlast the bytes from M ~ 10 on).
//   * serving prefill (M = 512): operations, 2*M*K*N at 989 TFLOP/s.
//
// Design: tensor cores through wgmma, each weight byte read once per row
// tile of up to 256 rows.
//   * Operands swapped: out^T[N,M] = w^T[N,K] . x^T[K,M]. The weight tile is
//     wgmma's A operand, held in registers: each thread reads its int8
//     weights from shared memory as 16-bit words and widens them to bf16
//     pairs (exact: |q| <= 127 fits bf16's 8-bit significand). The
//     activation tile x[MT][BK] is the B operand, read by wgmma from shared
//     memory through a descriptor (K-major, 128-byte swizzle).
//   * wgmma.m64n{MT}k16 with MT, the row tile, the smallest of 8, 16, 32,
//     64, 128, 160, 256 that covers M (above 256, M split evenly over
//     ceil(M/256) tiles): every call with M <= 256 reads the weights once.
//   * A block is two warpgroups over BN = 128 weight columns. Accumulator
//     rows 16w+g and 16w+g+8 of warp w, lane group g hold columns 2(8w+g)
//     and 2(8w+g)+1, so a thread's two columns are one 16-bit word of a
//     weight row; the 128-byte swizzle of the weight tile puts the 4 k-rows
//     a warp reads in one instruction in distinct banks. The epilogue maps
//     the rows back to columns.
//   * Copies by TMA, one box of each tile per chunk of BK = 64 k-rows (a
//     weight box of 64 x 128 bytes, an x box of MT rows x 128 bytes), into a
//     ring of STAGES chunks, STAGES-1 ahead, completing on one mbarrier a
//     stage: each SM keeps 32-80 KB of weight bytes in flight (two blocks
//     an SM up to MT = 160, one at 256). The boxes' rows are 128 bytes
//     because copies of 16-byte rows (cp.async or TMA) are bound by their
//     request count. Dynamic shared memory, its limit raised once by
//     w8a16_init(), which also fetches the driver's tensor-map encoder.
//   * Deterministic split-K where the column tiles alone do not fill the
//     card: the wrapper's plan picks ksplit (at least one block per SM, an
//     fp32 workspace [ksplit, M, N] of at most 16 MB, inside the 50 MB L2);
//     a second kernel sums the partials in a fixed order, scales and casts.
//     With ksplit = 1 the epilogue scales and writes the output itself.
//   * Ragged edges: TMA fills boxes past M, K or N with zeros; the epilogue
//     masks.
#include "w8a16_body.cuh"

#include <algorithm>

namespace {

template <int MT, typename OutT>
__global__ void __launch_bounds__(THREADS, Cfg<MT>::MIN_BLOCKS) w8a16_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ s, OutT* __restrict__ out, float* __restrict__ ws,
    int M, int K, int N, int chunks_per_split) {
  w8a16_block<MT, OutT>(wmap, xmap, s, out, ws, M, K, N, chunks_per_split, blockIdx.x * BN,
                        blockIdx.y, blockIdx.z * MT, 0);
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
cudaError_t init_mt() {
  return cudaFuncSetAttribute(w8a16_kernel<MT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<MT>::SMEM);
}

template <typename OutT>
cudaError_t init_all() {
  const cudaError_t errs[] = {init_mt<8, OutT>(),   init_mt<16, OutT>(),  init_mt<32, OutT>(),
                              init_mt<64, OutT>(),  init_mt<128, OutT>(), init_mt<160, OutT>(),
                              init_mt<256, OutT>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <int MT, typename OutT>
int launch_mt(const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out, float* ws,
              int M, int K, int N, int ksplit, int chunks_per_split, cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, BN, BK) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BK, MT))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, ksplit, (M + MT - 1) / MT);
  w8a16_kernel<MT, OutT><<<grid, THREADS, Cfg<MT>::SMEM, stream>>>(
      wmap, xmap, s, out, ksplit > 1 ? ws : nullptr, M, K, N, chunks_per_split);
  if (ksplit > 1) {
    const int threads = 256;
    const int blocks = (int)std::min<size_t>(1024, ((size_t)M * N + threads - 1) / threads);
    splitk_reduce_kernel<OutT><<<blocks, threads, 0, stream>>>(ws, s, out, M, N, ksplit);
  }
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(int mt, const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out, float* ws,
           int M, int K, int N, int ksplit, int cps, cudaStream_t st) {
  switch (mt) {
    case 8: return launch_mt<8, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 16: return launch_mt<16, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 32: return launch_mt<32, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 64: return launch_mt<64, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 128: return launch_mt<128, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 160: return launch_mt<160, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    case 256: return launch_mt<256, OutT>(x, w, s, out, ws, M, K, N, ksplit, cps, st);
    default: return (int)cudaErrorInvalidValue;  // no row tile of that size is built
  }
}

}  // namespace

// Raises the dynamic shared-memory limit of every instantiation and fetches
// the driver's tensor-map encoder; call once after loading, before the first
// w8a16_matmul. Returns a cudaError_t.
extern "C" int w8a16_init() {
  cudaDriverEntryPointQueryResult found;
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode_tiled),
                                          cudaEnableDefault, &found);
  if (e == cudaSuccess && found != cudaDriverEntryPointSuccess) e = cudaErrorSymbolNotFound;
  if (e == cudaSuccess) e = init_all<float>();
  if (e == cudaSuccess) e = init_all<__nv_bfloat16>();
  return (int)e;
}

// x [M,K] bf16, w [K,N] int8, s [N] f32, out [M,N] (bf16 when out_f32 == 0,
// else f32), ws [ksplit,M,N] f32 scratch (unused when ksplit == 1), mt one of
// 8, 16, 32, 64, 128, 160, 256. Requires K % 8 == 0 and N % 16 == 0 (TMA
// strides) and 16-byte aligned x and w. Returns cudaGetLastError() after
// the launches.
extern "C" int w8a16_matmul(const void* x, const void* w, const void* s, void* out, void* ws,
                            int M, int K, int N, int mt, int ksplit, int chunks_per_split,
                            int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(s);
  float* wsf = static_cast<float*>(ws);
  if (out_f32)
    return launch<float>(mt, xb, wq, sc, static_cast<float*>(out), wsf, M, K, N, ksplit,
                         chunks_per_split, st);
  return launch<__nv_bfloat16>(mt, xb, wq, sc, static_cast<__nv_bfloat16*>(out), wsf, M, K, N,
                               ksplit, chunks_per_split, st);
}
