// B4: the grouped W8A16 product of a routed expert layer (Mellum 2's sparse
// MLP), and the routing's alignment that feeds it.
//
// Replaces no TPU kernel: the JAX package has no expert layer. It exists
// because one B1 call per expert cannot serve the port's captured steps:
// the rows each expert gets change from step to step, and 64 experts x 3
// products x 28 layers would be 5,376 launches a forward. Here an expert
// layer is one align launch and two B4 launches, on buffers of a static
// worst-case size, with no host read.
//
// What bounds it on the H100: at the serving verify (64 rows x 5 tokens x
// top-8 = 2,560 token-expert pairs, ~40 rows an expert, every expert
// touched) the expert weights, 6.2 MB an expert a layer, 11.1 GB a target
// forward: bytes at 3.35 TB/s, since 2 x 40 operations a weight byte are
// far under the card's ridge of ~295. At a 2,048-token prefill (~256 rows
// an expert) operations, 2 x pairs x K x N at 989 TFLOP/s.
//
// Design, right and simple first (tuning is later work):
//   * expert_align_kernel (one block): counts each expert's pairs, pads
//     each expert's rows up to the row tile MT, lays the experts' padded
//     segments end to end, and writes the sorted slot of every (token, k)
//     pair (inv), the token row of every slot (rows; a pad slot reads row
//     0, and its output is never read), the expert of every row tile, the
//     number of live tiles, and adds the counts to a per-(layer, expert)
//     total (tracing) -- in the same launch, as vLLM's moe_align_block_size
//     does. A pair's place within its expert's segment comes from a shared
//     atomic and may change from run to run; each output row depends only
//     on its own input row, so the results do not.
//   * expert_matmul_kernel: B1's body (w8a16_body.cuh) on the rows of one
//     tile, gathered by the caller into expert order, against its expert's
//     [K, N] int8 codes (a stacked [E*K, N] tensor map, K a multiple of 64
//     so a box never crosses two experts) and [N] scales. Grid (N / 128,
//     worst-case tiles); a block past the live tiles exits at once. No
//     split-K: the tiles of 64 experts fill the card.
#include "w8a16_body.cuh"

namespace {

constexpr int ALIGN_THREADS = 1024;

__global__ void __launch_bounds__(ALIGN_THREADS) expert_align_kernel(
    const int64_t* __restrict__ ids, int n, int k, int E, int mt, int slots, int* __restrict__ rows,
    int* __restrict__ inv, int* __restrict__ tile_expert, int* __restrict__ live,
    long long* __restrict__ totals) {
  extern __shared__ int sh[];  // cnt[E], off[E]
  int* cnt = sh;
  int* off = sh + E;
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += blockDim.x) cnt[e] = 0;
  for (int i = tid; i < slots; i += blockDim.x) rows[i] = 0;
  for (int t = tid; t < slots / mt; t += blockDim.x) tile_expert[t] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) inv[i] = atomicAdd(&cnt[(int)ids[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = run;
      run += (cnt[e] + mt - 1) / mt * mt;
    }
    *live = run / mt;
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    const int t0 = off[e] / mt, t1 = (off[e] + (cnt[e] + mt - 1) / mt * mt) / mt;
    for (int t = t0; t < t1; ++t) tile_expert[t] = e;
    if (totals) totals[e] += cnt[e];
  }
  for (int i = tid; i < n; i += blockDim.x) {
    const int slot = off[(int)ids[i]] + inv[i];
    inv[i] = slot;
    rows[slot] = i / k;
  }
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(THREADS, Cfg<MT>::MIN_BLOCKS) expert_matmul_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ s, OutT* __restrict__ out, const int* __restrict__ tile_expert,
    const int* __restrict__ live, int M, int K, int N) {
  const int tile = blockIdx.z;
  if (tile >= *live) return;  // past the live tiles: nothing routed here
  const int e = tile_expert[tile];
  w8a16_block<MT, OutT>(wmap, xmap, s + (size_t)e * N, out, nullptr, M, K, N,
                        (K + BK - 1) / BK, blockIdx.x * BN, 0, tile * MT, e * K);
}

template <int MT, typename OutT>
cudaError_t init_mt() {
  return cudaFuncSetAttribute(expert_matmul_kernel<MT, OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<MT>::SMEM);
}

template <int MT, typename OutT>
int launch_mt(const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out,
              const int* tile_expert, const int* live, int M, int K, int N, int E,
              cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, E * K, N, BN, BK) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BK, MT))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, 1, M / MT);
  expert_matmul_kernel<MT, OutT><<<grid, THREADS, Cfg<MT>::SMEM, stream>>>(
      wmap, xmap, s, out, tile_expert, live, M, K, N);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(int mt, const __nv_bfloat16* x, const int8_t* w, const float* s, OutT* out,
           const int* tile_expert, const int* live, int M, int K, int N, int E, cudaStream_t st) {
  switch (mt) {
    case 64: return launch_mt<64, OutT>(x, w, s, out, tile_expert, live, M, K, N, E, st);
    case 128: return launch_mt<128, OutT>(x, w, s, out, tile_expert, live, M, K, N, E, st);
    default: return (int)cudaErrorInvalidValue;  // no row tile of that size is built
  }
}

}  // namespace

// Raises the dynamic shared-memory limit of every instantiation and fetches
// the driver's tensor-map encoder; call once after loading. Returns a
// cudaError_t.
extern "C" int expert_init() {
  cudaDriverEntryPointQueryResult found;
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode_tiled),
                                          cudaEnableDefault, &found);
  if (e == cudaSuccess && found != cudaDriverEntryPointSuccess) e = cudaErrorSymbolNotFound;
  const cudaError_t errs[] = {e, init_mt<64, float>(), init_mt<128, float>(),
                              init_mt<64, __nv_bfloat16>(), init_mt<128, __nv_bfloat16>()};
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return (int)err;
  return (int)cudaSuccess;
}

// ids [n] i64 (n = tokens * k, each in [0, E)), k experts a token, mt the
// row tile, slots the worst-case padded rows (a multiple of mt). Writes rows
// [slots] i32, inv [n] i32, tile_expert [slots / mt] i32, live [1] i32, and
// adds each expert's count to totals [E] i64 (null: no total). E <= 4096.
extern "C" int expert_align(const void* ids, int n, int k, int E, int mt, int slots, void* rows,
                            void* inv, void* tile_expert, void* live, void* totals, void* stream) {
  if (E < 1 || E > 4096 || mt < 1 || slots % mt) return (int)cudaErrorInvalidValue;
  expert_align_kernel<<<1, ALIGN_THREADS, 2 * E * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), n, k, E, mt, slots, static_cast<int*>(rows),
      static_cast<int*>(inv), static_cast<int*>(tile_expert), static_cast<int*>(live),
      static_cast<long long*>(totals));
  return (int)cudaGetLastError();
}

// x [M, K] bf16 in expert order (M = slots, a multiple of mt), w [E, K, N]
// int8, s [E, N] f32, out [M, N] (bf16 when out_f32 == 0, else f32),
// tile_expert and live from expert_align. mt 64 or 128; K % 64 == 0,
// N % 16 == 0, 16-byte aligned x and w. Returns cudaGetLastError().
extern "C" int expert_matmul(const void* x, const void* w, const void* s, void* out,
                             const void* tile_expert, const void* live, int M, int K, int N, int E,
                             int mt, int out_f32, void* stream) {
  if (K % BK || M % mt) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(s);
  const auto* te = static_cast<const int*>(tile_expert);
  const auto* lv = static_cast<const int*>(live);
  if (out_f32)
    return launch<float>(mt, xb, wq, sc, static_cast<float*>(out), te, lv, M, K, N, E, st);
  return launch<__nv_bfloat16>(mt, xb, wq, sc, static_cast<__nv_bfloat16*>(out), te, lv, M, K, N,
                               E, st);
}
