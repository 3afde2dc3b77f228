// The W8A16 product's shared body: B1 (int8_matmul.cu) and B4's grouped
// product (moe_matmul.cu) include it. Copies by TMA into a ring of shared
// memory, the int8 weight tile widened to bf16 in registers as wgmma's A
// operand, x from shared memory as its B operand (int8_matmul.cu's header
// says why), fp32 sums; then the epilogue scales and writes, or writes
// split-K partials.
#pragma once
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// One block's work: weight columns n0.. of the k-range of split `split`
// against rows m0.. of x, the weight tile's k-rows offset by w_k0 in wmap
// (an expert's first row in a stacked [E*K, N] map; 0 for one matrix).
template <int MT, typename OutT>
__device__ __forceinline__ void w8a16_block(
    const CUtensorMap& wmap, const CUtensorMap& xmap, const float* __restrict__ s,
    OutT* __restrict__ out, float* __restrict__ ws, int M, int K, int N, int chunks_per_split,
    int n0, int split, int m0, int w_k0) {
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
    tma_load(sw_addr + stage * C::W_BYTES, &wmap, n0, w_k0 + k0, bar);
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

}  // namespace
