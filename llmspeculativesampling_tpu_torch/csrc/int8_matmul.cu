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
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BN = 128;  // weight columns of a block: two warpgroups of 64
constexpr int BK = 64;   // k-rows of one pipeline chunk
constexpr int THREADS = 256;

template <int MT>
struct Cfg {
  static constexpr int MIN_BLOCKS = MT <= 160 ? 2 : 1;  // resident blocks per SM
  static constexpr int STAGES = MT <= 64 ? 6 : (MT <= 128 ? 4 : (MT <= 160 ? 3 : 5));
  static constexpr int W_BYTES = BK * BN;      // a stage of weights [BK][BN] int8, swizzled
  static constexpr int X_BYTES = MT * BK * 2;  // a stage of x [MT][BK] bf16, swizzled
  static constexpr int BARS = STAGES * (W_BYTES + X_BYTES);  // one mbarrier a stage after the tiles
  static constexpr int SMEM = 1024 + BARS + STAGES * 8;      // 1024: slack to align the tiles
};

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled = nullptr;  // from the driver, in w8a16_init

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// TMA: the box of map at coordinates (c0 innermost, c1) into dst, completing
// on bar; parts of the box past the tensor's edges arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// Byte I of b (an int8 weight biased by +128) as the fp32 bits of q: the byte
// sits in the mantissa of 2^23, and 2^23 + 128 is subtracted. Exact, and the
// low 16 bits of the result are 0, so its top half is q in bf16.
template <int I>
__device__ __forceinline__ uint32_t widen_byte(uint32_t b) {
  return __float_as_uint(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 | I)) - 8388736.f);
}

// lo, hi: 16-bit words of k-rows k and k+1 at this thread's two columns ->
// the bf16 pairs (k, k+1) of the first column (c0) and of the second (c1).
__device__ __forceinline__ void widen_pairs(uint32_t lo, uint32_t hi, uint32_t& c0, uint32_t& c1) {
  const uint32_t b = __byte_perm(lo, hi, 0x5410) ^ 0x80808080u;  // [k,c0] [k,c1] [k+1,c0] [k+1,c1]
  c0 = __byte_perm(widen_byte<0>(b), widen_byte<2>(b), 0x7632);
  c1 = __byte_perm(widen_byte<1>(b), widen_byte<3>(b), 0x7632);
}

// Shared-memory descriptor of an x stage [MT][BK] bf16 as TMA wrote it with
// the 128-byte swizzle (1024-byte aligned): K-major, rows of 128 bytes, 8-row
// groups 1024 bytes apart (stride offset, in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t x_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from reading the accumulators before the wait above
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64n{N}k16, A (4 bf16x2 registers) from registers, B from
// shared memory through desc, d += A.B in fp32.
template <int N>
struct Wgmma;
#define ACC4(i) "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)
#define ACC32(i) ACC16(i), ACC16((i) + 16)
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : ACC4(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : ACC4(0), ACC4(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : ACC16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : ACC32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : ACC32(0), ACC32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
        : ACC32(0), ACC32(32), ACC16(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
};
#undef ACC32
#undef ACC16
#undef ACC4

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(THREADS, Cfg<MT>::MIN_BLOCKS) w8a16_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    const float* __restrict__ s, OutT* __restrict__ out, float* __restrict__ ws,
    int M, int K, int N, int chunks_per_split) {
  using C = Cfg<MT>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle patterns repeat every 1024 bytes from a 1024-byte boundary
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* sw = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* sx = sw + C::STAGES * C::W_BYTES;  // [STAGES][MT][BK] bf16
  const uint32_t sw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sw));
  const uint32_t sx_addr = sw_addr + C::STAGES * C::W_BYTES;
  const uint32_t bars = sw_addr + C::BARS;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int col = (tid >> 7) * 64 + (warp * 8 + g) * 2;  // this thread's columns col, col+1
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int k_begin = split * chunks_per_split * BK;
  const int k_end = min(K, k_begin + chunks_per_split * BK);
  const int nchunks = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) mbar_init(bars + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 copies chunk c: a weight box (n0.., k rows) and an x box (k.., m0 rows)
  auto load_chunk = [&](int c) {
    const int stage = c % C::STAGES, k0 = k_begin + c * BK;
    const uint32_t bar = bars + 8 * stage;
    mbar_expect(bar, C::W_BYTES + C::X_BYTES);
    tma_load(sw_addr + stage * C::W_BYTES, &wmap, n0, k0, bar);
    tma_load(sx_addr + stage * C::X_BYTES, &xmap, k0, m0, bar);
  };

  float d[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) d[i] = 0.f;

  if (tid == 0)
    for (int c = 0; c < C::STAGES - 1 && c < nchunks; ++c) load_chunk(c);

  // k-row r of the weight tile holds 16-byte segment j at position j ^ (r % 8).
  // This thread reads rows 16ks + {2t, 2t+1, 2t+8, 2t+9}: r % 8 is 2t or 2t+1.
  const int seg = col >> 4, lo = col & 15;
  const uint32_t off_even = ((seg ^ (2 * t)) << 4) + lo + 2 * t * BN;
  const uint32_t off_odd = ((seg ^ (2 * t + 1)) << 4) + lo + (2 * t + 1) * BN;
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % C::STAGES;
    mbar_wait(bars + 8 * st, (c / C::STAGES) & 1);
    __syncthreads();  // chunk c landed; every thread is done with chunk c-1 and its stage
    if (tid == 0 && c + C::STAGES - 1 < nchunks) load_chunk(c + C::STAGES - 1);

    const uint8_t* wt = sw + st * C::W_BYTES;
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint8_t* p = wt + ks * 16 * BN;
      const uint32_t q0 = *reinterpret_cast<const uint16_t*>(p + off_even);
      const uint32_t q1 = *reinterpret_cast<const uint16_t*>(p + off_odd);
      const uint32_t q8 = *reinterpret_cast<const uint16_t*>(p + 8 * BN + off_even);
      const uint32_t q9 = *reinterpret_cast<const uint16_t*>(p + 8 * BN + off_odd);
      widen_pairs(q0, q1, a[ks][0], a[ks][1]);  // k = 2t, 2t+1
      widen_pairs(q8, q9, a[ks][2], a[ks][3]);  // k = 2t+8, 2t+9
    }
    const uint64_t desc = x_desc(sx_addr + st * C::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)  // k16 step ks: 32 bytes further along each row
      Wgmma<MT>::mma(d, a[ks], desc + (uint64_t)(2 * ks));
    wgmma_commit();
    wgmma_wait_all();  // A's registers and the stage are free again
    fence_acc<MT / 2>(d);
  }

  // d[4j+h] is (column col, row m0+8j+2t+h), d[4j+2+h] (column col+1, same row)
  const int n = n0 + col;
  if (n >= N) return;
  const float s0 = ws ? 1.f : s[n], s1 = ws ? 1.f : s[n + 1];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * t + h;
      if (m < M) {
        if (ws) store2<float>(ws + ((size_t)split * M + m) * N + n, d[4 * j + h], d[4 * j + 2 + h]);
        else store2<OutT>(out + (size_t)m * N + n, d[4 * j + h] * s0, d[4 * j + 2 + h] * s1);
      }
    }
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

// A 2-D row-major tensor [rows][cols] for TMA, read in boxes of box_cols x
// box_rows (box_cols * elem_bytes == 128) with the 128-byte swizzle.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled && encode_tiled(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
