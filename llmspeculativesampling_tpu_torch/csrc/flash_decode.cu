// Length-aware flash-decode attention for Hopper, dense and int8 KV, over a
// contiguous cache (B2) or a paged block pool (B3): split-KV on the tensor
// cores, one launch a call.
//
// Replaces the TPU kernels of llmspeculativesampling_tpu/kernels/flash_decode.py
// _flash_call and _paged_flash_call (one body, _make_kernel(paged=...)). Per
// batch row b and kv head h, the G*S_new query rows (row r = g*S_new + s,
// query head h*G + g) attend under one fp32 softmax to two sources:
//   * the prefix [0, lengths[b]) -- only live positions are read. Contiguous:
//     position p of [B, Hkv, S_max, D]. Paged: position p lives in pool block
//     tables[b, p / page] of [N, Hkv, page, D] at offset p % page; table ids
//     are clamped to [0, N-1], so a sentinel id never addresses outside the
//     pool;
//   * the new block's own k/v (compute dtype, not read back from the cache)
//     under an additive bias [B, S_new, S_new] that is causal or a tree mask.
// The softmax scale is folded into q and q is rounded to its own dtype
// first, as the TPU wrapper does. The int8 variant reads int8 K/V and
// applies the per-position scales algebraically: scores * k_s, p * v_s.
//
// Bound on the H100: the live prefix K/V bytes (about 20 KB per position per
// 13B layer in bf16, half that in int8) plus launch latency; at the decode
// lengths of both paths (<= 640 positions) a call moves 0.1-13 MB, a few
// microseconds at 3.35 TB/s, so the design aims at filling the card and at
// one launch.
//
// Design:
//   * Split-KV grid (split, row tile, b * Hkv). The prefix is cut into splits
//     of `ps` positions (kernels/flash_decode.py::plan picks ps from the
//     host's shapes); a paged split never crosses a page, so it looks its
//     block up once. The new block under its bias is one more split, the
//     last. A split past lengths[b] exits at once: the host never reads a
//     length.
//   * A row tile is 16 query rows a warp, 1-4 warps. Inside a split, K/V
//     chunks of T positions are staged by cp.async, 16 bytes a thread,
//     double-buffered where a split takes more than one chunk; the first
//     chunk's copies go out before q is read. int8 chunks stay int8 in
//     shared memory (half the bytes) with their scales beside them. Shared
//     memory is sized per launch (smem_bytes), so int8 and one-chunk splits
//     leave room for more blocks an SM.
//   * bf16: QK^T and PV run on the tensor cores (mma.sync.m16n8k16, bf16 in,
//     fp32 accumulate). The score fragment is the A fragment of the PV
//     product, so no score is reduced across lanes; only a row's max and sum
//     cross the four lanes that hold it. int8 K/V are widened exactly to bf16
//     as fragments are read; scores are multiplied by k_s per column in fp32
//     after the product, p by v_s before P is rounded to bf16.
//   * fp32 q keeps the split and combine structure but scores and
//     accumulates on the CUDA cores in fp32 (tensor cores would round q and
//     P).
//   * Combine in the same launch: each split writes fp32 partials (acc[D],
//     m, l) per row into the caller's workspace, then takes a ticket from
//     the per-(b, kv head, row tile) counter (__threadfence, atomicAdd). The
//     last split to arrive merges the partials in split order -- the output
//     is bit-identical whatever the arrival order -- and resets the counter
//     to 0, so the zeroed counter buffer stays zeroed between calls (and
//     across CUDA-graph replays). Calls sharing a counter buffer must run in
//     stream order.
//   * q, k_new, v_new and out are read and written through their strides
//     (the forward passes [B, S, H, D] projections as [B, H, S, D] views).
//   * A window (window layers, e.g. Mellum 2's 1024 positions; window > 0,
//     bf16 q): new row s of a row of length len sees prefix positions
//     > len + s - window. A split that ends at or before len - window + 1
//     is not read and not merged, like a split past the length; a split
//     across that edge masks its early positions per row. The window is a
//     template parameter, so a call without one (window = 0) runs the
//     instructions it ran before windows existed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float MASK = -1e30f;  // the initial running max; finite
constexpr int MAX_WARPS = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T_> __device__ __forceinline__ T_ from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16, row) * b (16x8, col): bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Positions a staged chunk: 32 (two k-steps of the PV product) in bf16, 16
// in fp32 (the same bytes).
template <typename TQ> __host__ __device__ constexpr int chunk() {
  return std::is_same<TQ, float>::value ? 16 : 32;
}

// Staged rows: a position's D values, then 16 bytes of pad (conflict-free
// fragment reads).
template <int D, typename E> struct Row {
  static constexpr int BYTES = D * (int)sizeof(E) + 16;
  static constexpr int UNITS = D * (int)sizeof(E) / 16;  // 16-byte copies a row
};

// Two adjacent dims (d, d+1) of a staged K row, as a bf16 pair.
__device__ __forceinline__ uint32_t kpair(const unsigned char* row, int d, __nv_bfloat16) {
  return *reinterpret_cast<const uint32_t*>(row + 2 * d);
}
__device__ __forceinline__ uint32_t kpair(const unsigned char* row, int d, int8_t) {
  const uint16_t w = *reinterpret_cast<const uint16_t*>(row + d);
  return pack_bf16((float)(int8_t)(w & 0xff), (float)(int8_t)(w >> 8));  // exact
}
// One dim d of two staged V rows (r0, r0 + 1), as a bf16 pair.
template <int RB>
__device__ __forceinline__ uint32_t vpair(const unsigned char* buf, int r0, int d, __nv_bfloat16) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(buf + r0 * RB + 2 * d);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(buf + (r0 + 1) * RB + 2 * d);
  return lo | (hi << 16);
}
template <int RB>
__device__ __forceinline__ uint32_t vpair(const unsigned char* buf, int r0, int d, int8_t) {
  return pack_bf16((float)(int8_t)buf[r0 * RB + d], (float)(int8_t)buf[(r0 + 1) * RB + d]);
}
__device__ __forceinline__ float ld(const unsigned char* row, int d, float) {
  return reinterpret_cast<const float*>(row)[d];
}
__device__ __forceinline__ float ld(const unsigned char* row, int d, int8_t) {
  return (float)reinterpret_cast<const int8_t*>(row)[d];
}

// Prefix layouts: base(b, h, pg) is the row index, in the [*, D] K/V storage
// and the matching [*] scales, of the first position of page pg of (b, h).
// The contiguous cache is one page of S_max positions.
struct Contig {
  int Hkv, S_max;
  __device__ __forceinline__ size_t base(int b, int h, int) const {
    return ((size_t)b * Hkv + h) * S_max;
  }
};

struct Paged {
  const int* tables;  // [B, P]
  int P, page, Hkv, max_blk;
  __device__ __forceinline__ size_t base(int b, int h, int pg) const {
    const int blk = min(max(tables[(size_t)b * P + pg], 0), max_blk);
    return ((size_t)blk * Hkv + h) * page;
  }
};

struct Args {
  const void *q, *k_new, *v_new, *k_pre, *v_pre;
  const float *k_sc, *v_sc, *bias;
  const int* lengths;
  void* out;
  float* ws;
  int* counters;
  long long st[12];  // element strides (b, h, s) of q, k_new, v_new, out
  int Hkv, G, S_new, R;
  int page, pages, ps, ppp, n_split;  // prefix splits: pages * ppp, each <= ps positions
  int window;                         // > 0: a window layer's positions (the WIN kernels)
  float scale;
};

// One split's source rows: position i of the split is row k + i * k_st (and
// v + i * v_st); its scales ksc[i], vsc[i] (int8 prefix only).
template <typename E> struct Src {
  const E* k;
  const E* v;
  long long k_st, v_st;
  const float* ksc;
  const float* vsc;
};

// Stage positions [c0, c0 + n) of a split into chunk buffers kd / vd of T
// rows; rows n..T-1 are zeroed, so a padded column multiplies p = 0 by a
// finite value.
template <int D, int T, typename E, bool SCALED>
__device__ __forceinline__ void stage(const Src<E>& src, int c0, int n, unsigned char* kd,
                                      unsigned char* vd, float* ks, float* vs) {
  using RW = Row<D, E>;
  for (int i = threadIdx.x; i < T * RW::UNITS; i += blockDim.x) {
    const int t = i / RW::UNITS, u = i - t * RW::UNITS;
    unsigned char* kdst = kd + t * RW::BYTES + u * 16;
    unsigned char* vdst = vd + t * RW::BYTES + u * 16;
    if (t < n) {
      cp16(kdst, reinterpret_cast<const unsigned char*>(src.k + (c0 + t) * src.k_st) + u * 16);
      cp16(vdst, reinterpret_cast<const unsigned char*>(src.v + (c0 + t) * src.v_st) + u * 16);
    } else {
      *reinterpret_cast<uint4*>(kdst) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vdst) = make_uint4(0, 0, 0, 0);
    }
  }
  if (SCALED)
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      ks[i] = i < n ? src.ksc[c0 + i] : 0.f;
      vs[i] = i < n ? src.vsc[c0 + i] : 0.f;
    }
  cp_commit();
}

// The partials of this warp's 16 rows over the n positions of one split:
// acc[D] (unnormalised), the running max m and the sum l, D + 2 floats a row
// at ws. A thread holds rows g and g + 8 of the warp (the mma fragment
// layout). bias: the new block's [S_new, S_new] bias of batch row b, or null
// for a prefix split. WIN: a prefix split starting at position pos0 masks
// the positions p <= lo + s of new row s (lo = len - window).
template <int D, int T, typename TQ, typename E, bool SCALED, bool WIN = false>
__device__ __forceinline__ void attend(const Args& a, const Src<E>& src, int n, const float* bias,
                                       int b, int h, int row0, float* ws, unsigned char* smem,
                                       float* scl, int pos0 = 0, int lo = 0) {
  constexpr bool TC = std::is_same<TQ, __nv_bfloat16>::value;  // the tensor-core path
  constexpr int NT = T / 8;                                     // 8-position column tiles
  constexpr int RBE = Row<D, E>::BYTES;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool active = row0 < a.R;  // uniform over the warp
  const int n_chunks = (n + T - 1) / T;
  // the first chunk's copies go out before q is read, so the two overlap
  stage<D, T, E, SCALED>(src, 0, min(T, n), smem, smem + T * RBE, scl, scl + T);

  const TQ* qrow[2];
  int srow[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    srow[rr] = r % a.S_new;
    qrow[rr] = r < a.R ? static_cast<const TQ*>(a.q) + b * a.st[0] +
                             (h * a.G + r / a.S_new) * a.st[1] + srow[rr] * a.st[2]
                       : nullptr;
  }
  uint32_t qf[TC ? D / 16 : 1][4];  // q as the A fragments of QK^T, scale folded
  if constexpr (TC) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const TQ* qr = qrow[i & 1];
        const int d = kk * 16 + (i >> 1) * 8 + 2 * t4;
        const float q0 = qr ? to_f(from_f<TQ>(to_f(qr[d]) * a.scale)) : 0.f;
        const float q1 = qr ? to_f(from_f<TQ>(to_f(qr[d + 1]) * a.scale)) : 0.f;
        qf[kk][i] = pack_bf16(q0, q1);
      }
  }
  float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1;
    if (c + 1 < n_chunks) {
      unsigned char* nb = smem + (cur ^ 1) * 2 * T * RBE;
      float* ns = scl + (cur ^ 1) * 2 * T;
      stage<D, T, E, SCALED>(src, (c + 1) * T, min(T, n - (c + 1) * T), nb, nb + T * RBE, ns,
                             ns + T);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const unsigned char* kb = smem + cur * 2 * T * RBE;
      const unsigned char* vb = kb + T * RBE;
      const float* ks = scl + cur * 2 * T;
      const float* vs = ks + T;
      const int c0 = c * T, nc = min(T, n - c0);
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (TC) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* kr = kb + (nt * 8 + g) * RBE;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma16816(s[nt], qf[kk], kpair(kr, kk * 16 + 2 * t4, E{}),
                     kpair(kr, kk * 16 + 8 + 2 * t4, E{}));
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float qa = qrow[0] ? to_f(qrow[0][d]) * a.scale : 0.f;
          const float qb = qrow[1] ? to_f(qrow[1][d]) * a.scale : 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float kv = ld(kb + (nt * 8 + 2 * t4 + e2) * RBE, d, E{});
              s[nt][e2] = fmaf(qa, kv, s[nt][e2]);
              s[nt][2 + e2] = fmaf(qb, kv, s[nt][2 + e2]);
            }
        }
      }
      // scales, padding, bias; then the online softmax of rows g and g + 8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t4 + (e & 1);
          float x = s[nt][e];
          if (SCALED) x *= ks[col];
          if (col >= nc)
            x = -INFINITY;
          else if (bias)
            x += bias[srow[e >> 1] * a.S_new + c0 + col];
          else if (WIN && pos0 + c0 + col <= lo + srow[e >> 1])
            x = -INFINITY;
          s[nt][e] = x;
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        const float corr = expf(m[rr] - m_new);
        m[rr] = m_new;
        l[rr] *= corr;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          o[dn][2 * rr] *= corr;
          o[dn][2 * rr + 1] *= corr;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[nt][e] = SCALED ? p * vs[nt * 8 + 2 * t4 + (e & 1)] : p;
        }
      if constexpr (TC) {
        // the score fragments of column tiles 2kk, 2kk+1 are P's A fragment
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn)
            mma16816(o[dn], pa, vpair<RBE>(vb, kk * 16 + 2 * t4, dn * 8 + g, E{}),
                     vpair<RBE>(vb, kk * 16 + 8 + 2 * t4, dn * 8 + g, E{}));
        }
      } else {
#pragma unroll
        for (int k = 0; k < T; ++k) {
          const int from = (lane & ~3) | ((k & 7) >> 1);
          const float p0 = __shfl_sync(0xffffffffu, s[k >> 3][k & 1], from);
          const float p1 = __shfl_sync(0xffffffffu, s[k >> 3][2 + (k & 1)], from);
          const unsigned char* vr = vb + k * RBE;
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float v = ld(vr, dn * 8 + 2 * t4 + e2, E{});
              o[dn][e2] = fmaf(p0, v, o[dn][e2]);
              o[dn][2 + e2] = fmaf(p1, v, o[dn][2 + e2]);
            }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (row0 + g + 8 * rr >= a.R) continue;
    float* w = ws + (size_t)(g + 8 * rr) * (D + 2);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(w + dn * 8 + 2 * t4) = make_float2(o[dn][2 * rr], o[dn][2 * rr + 1]);
    if (t4 == 0) {
      w[D] = m[rr];
      w[D + 1] = lt;
    }
  }
}

// Whether prefix split j holds a position some row sees: it starts before
// the length and, with a window, ends after lo + 1 (lo = len - window).
template <bool WIN>
__device__ __forceinline__ bool live_split(const Args& a, int j, int len, int lo) {
  const int pg = j / a.ppp, start = pg * a.page + (j - pg * a.ppp) * a.ps;
  if (!WIN) return start < len;
  const int end = min(min(start + a.ps, (pg + 1) * a.page), len);
  return start < end && end > lo + 1;
}

// The last split of a row tile to arrive merges every live split's
// partials, in split order, and writes the output rows.
template <int D, typename TQ, bool WIN = false>
__device__ __forceinline__ void combine(const Args& a, const float* ws_tile, int rt, int b, int h,
                                        int row0, int len, int lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, warp = threadIdx.x >> 5;
  const int n_spl = a.n_split + 1;
  const size_t split_st = (size_t)rt * (D + 2);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g + 8 * rr;
    if (r >= a.R) continue;
    const float* w0 = ws_tile + (size_t)(warp * 16 + g + 8 * rr) * (D + 2);
    // two passes over the live splits, each unrolled so that the L2 reads
    // of several splits are in flight together
    float M = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < n_spl; ++j) {
      if (j == a.n_split || live_split<WIN>(a, j, len, lo))
        M = fmaxf(M, __ldcg(w0 + j * split_st + D));
    }
    float L = 0.f, acc[D / 8][2];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_spl; ++j) {
      if (j != a.n_split && !live_split<WIN>(a, j, len, lo)) continue;
      const float* w = w0 + j * split_st;
      const float f = expf(__ldcg(w + D) - M);
      L = fmaf(f, __ldcg(w + D + 1), L);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const float2 v = __ldcg(reinterpret_cast<const float2*>(w + dn * 8 + 2 * t4));
        acc[dn][0] = fmaf(f, v.x, acc[dn][0]);
        acc[dn][1] = fmaf(f, v.y, acc[dn][1]);
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    TQ* orow = static_cast<TQ*>(a.out) + b * a.st[9] + (h * a.G + r / a.S_new) * a.st[10] +
               (r % a.S_new) * a.st[11];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      orow[dn * 8 + 2 * t4] = from_f<TQ>(acc[dn][0] * inv);
      orow[dn * 8 + 2 * t4 + 1] = from_f<TQ>(acc[dn][1] * inv);
    }
  }
}

// grid (prefix splits + 1, row tiles, B * Hkv), 32 threads per 16-row warp
template <int D, typename TQ, typename E, bool QUANT, typename L, bool WIN = false>
__global__ void __launch_bounds__(MAX_WARPS * 32) flash_decode_kernel(const Args a, const L lay) {
  constexpr int T = chunk<TQ>();
  extern __shared__ __align__(16) unsigned char smem[];  // K and V chunks: smem_bytes()
  __shared__ float scl[2 * 2 * T];
  __shared__ int last;
  const int j = blockIdx.x, bh = blockIdx.z;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int warp = threadIdx.x >> 5;
  const int rt = blockDim.x / 2;  // rows of a tile: 16 a warp
  const int row0 = blockIdx.y * rt + warp * 16;
  const int len = min(max(a.lengths[b], 0), a.page * a.pages);
  const int lo = WIN ? len - a.window : 0;
  const int n_spl = a.n_split + 1;
  const size_t tile = (size_t)bh * gridDim.y + blockIdx.y;
  float* ws_tile = a.ws + tile * n_spl * rt * (D + 2);
  float* ws_warp = ws_tile + ((size_t)j * rt + warp * 16) * (D + 2);
  if (j < a.n_split) {
    const int pg = j / a.ppp, start = pg * a.page + (j - pg * a.ppp) * a.ps;
    const int end = min(min(start + a.ps, (pg + 1) * a.page), len);
    if (start < end && (!WIN || end > lo + 1)) {  // else: nothing any row sees
      const size_t base = lay.base(b, h, pg) + (start - pg * a.page);
      const Src<E> src{static_cast<const E*>(a.k_pre) + base * D,
                       static_cast<const E*>(a.v_pre) + base * D, D, D,
                       QUANT ? a.k_sc + base : nullptr, QUANT ? a.v_sc + base : nullptr};
      attend<D, T, TQ, E, QUANT, WIN>(a, src, end - start, nullptr, b, h, row0, ws_warp, smem,
                                      scl, start, lo);
    }
  } else {
    const Src<TQ> src{static_cast<const TQ*>(a.k_new) + b * a.st[3] + h * a.st[4],
                      static_cast<const TQ*>(a.v_new) + b * a.st[6] + h * a.st[7], a.st[5],
                      a.st[8], nullptr, nullptr};
    attend<D, T, TQ, TQ, false>(a, src, a.S_new, a.bias + (size_t)b * a.S_new * a.S_new, b,
                                    h, row0, ws_warp, smem, scl);
  }
  __threadfence();  // this split's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + tile, 1) == n_spl - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine<D, TQ, WIN>(a, ws_tile, rt, b, h, row0, len, lo);
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// Shared memory of a block: K and V chunks of T positions, two stages where
// a split takes more than one chunk; prefix rows in their stored type, the
// new block's in q's.
template <int D, typename TQ, typename E>
int smem_bytes(int ps, int S_new) {
  constexpr int T = chunk<TQ>();
  const int pre = (ps > T ? 2 : 1) * 2 * T * Row<D, E>::BYTES;
  const int blk = (S_new > T ? 2 : 1) * 2 * T * Row<D, TQ>::BYTES;
  return pre > blk ? pre : blk;
}

template <int D, typename TQ, typename L>
void launch_d(bool quant, const Args& a, const L& lay, dim3 grid, dim3 block, cudaStream_t st) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
    if (a.window > 0) {  // the window kernels (bf16 q only; launch refuses fp32)
      if (quant)
        flash_decode_kernel<D, TQ, int8_t, true, L, true>
            <<<grid, block, smem_bytes<D, TQ, int8_t>(a.ps, a.S_new), st>>>(a, lay);
      else
        flash_decode_kernel<D, TQ, TQ, false, L, true>
            <<<grid, block, smem_bytes<D, TQ, TQ>(a.ps, a.S_new), st>>>(a, lay);
      return;
    }
  }
  if (quant)
    flash_decode_kernel<D, TQ, int8_t, true, L>
        <<<grid, block, smem_bytes<D, TQ, int8_t>(a.ps, a.S_new), st>>>(a, lay);
  else
    flash_decode_kernel<D, TQ, TQ, false, L>
        <<<grid, block, smem_bytes<D, TQ, TQ>(a.ps, a.S_new), st>>>(a, lay);
}

// Completes the split geometry of a, checks the workspace and counter sizes
// against the grid, and launches.
template <typename L>
int launch(Args a, const L& lay, int B, int D, int q_f32, int quant, int warps,
           long long ws_floats, long long n_counters, void* stream) {
  if (warps < 1 || warps > MAX_WARPS || a.ps < 1 || a.page < 1 || a.pages < 1 || a.S_new < 1 ||
      a.G < 1 || a.window < 0 || (a.window > 0 && q_f32))
    return (int)cudaErrorInvalidValue;
  a.ppp = (a.page + a.ps - 1) / a.ps;
  a.n_split = a.pages * a.ppp;
  a.R = a.G * a.S_new;
  const int rt = 16 * warps, tiles = (a.R + rt - 1) / rt;
  const long long n_tiles = (long long)B * a.Hkv * tiles;
  if (n_tiles > n_counters || n_tiles * (a.n_split + 1) * rt * (D + 2) > ws_floats)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.n_split + 1, tiles, B * a.Hkv), block(32 * warps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_CASE(DD)                                              \
  case DD:                                                       \
    if (q_f32)                                                   \
      launch_d<DD, float>(quant, a, lay, grid, block, st);       \
    else                                                         \
      launch_d<DD, __nv_bfloat16>(quant, a, lay, grid, block, st); \
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

Args make_args(const void* q, const void* k_new, const void* v_new, const void* k_pre,
               const void* v_pre, const void* k_scales, const void* v_scales, const void* lengths,
               const void* bias, void* out, void* ws, void* counters, const long long* strides,
               int Hkv, int G, int S_new, int page, int pages, int ps, int window, float scale) {
  Args a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_pre = k_pre;
  a.v_pre = v_pre;
  a.k_sc = static_cast<const float*>(k_scales);
  a.v_sc = static_cast<const float*>(v_scales);
  a.bias = static_cast<const float*>(bias);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  a.Hkv = Hkv;
  a.G = G;
  a.S_new = S_new;
  a.page = page;
  a.pages = pages;
  a.ps = ps;
  a.window = window;
  a.scale = scale;
  return a;
}

}  // namespace

// q [B,Hq,S_new,D], k_new/v_new [B,Hkv,S_new,D] and out [B,Hq,S_new,D] at any
// element strides (`strides`: b, h, s of each, in that order; D contiguous,
// rows 16-byte aligned), bf16 when q_f32 == 0, else f32; caches
// [B,Hkv,S_max,D] in q's dtype, or int8 with scales [B,Hkv,S_max] f32 when
// quant != 0; lengths [B] i32; bias [B,S_new,S_new] f32. ws: f32 workspace;
// counters: i32, zero on entry and on exit. ps: prefix positions a split;
// warps: 16-row warps a row tile; window: 0, or a window layer's positions
// (bf16 q only). D is 32, 64, 96 or 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry, workspace or
// counter buffer the call cannot take.
extern "C" int flash_decode(const void* q, const void* k_new, const void* v_new,
                            const void* k_cache, const void* v_cache, const void* k_scales,
                            const void* v_scales, const void* lengths, const void* bias, void* out,
                            void* ws, void* counters, const long long* strides,
                            long long ws_floats, long long n_counters, int B, int Hkv, int G,
                            int S_new, int S_max, int D, int q_f32, int quant, int ps, int warps,
                            int window, float scale, void* stream) {
  const Args a = make_args(q, k_new, v_new, k_cache, v_cache, k_scales, v_scales, lengths, bias,
                           out, ws, counters, strides, Hkv, G, S_new, S_max, 1, ps, window, scale);
  return launch(a, Contig{Hkv, S_max}, B, D, q_f32, quant, warps, ws_floats, n_counters, stream);
}

// The paged layout: pools [N,Hkv,page,D] (scales [N,Hkv,page]) and block
// tables [B,P] i32 in place of the caches; everything else as above.
extern "C" int paged_flash_decode(const void* q, const void* k_new, const void* v_new,
                                  const void* k_pool, const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* lengths, const void* tables,
                                  const void* bias, void* out, void* ws, void* counters,
                                  const long long* strides, long long ws_floats,
                                  long long n_counters, int B, int Hkv, int G, int S_new, int P,
                                  int page, int N, int D, int q_f32, int quant, int ps, int warps,
                                  int window, float scale, void* stream) {
  const Args a = make_args(q, k_new, v_new, k_pool, v_pool, k_scales, v_scales, lengths, bias,
                           out, ws, counters, strides, Hkv, G, S_new, page, P, ps, window, scale);
  const Paged lay{static_cast<const int*>(tables), P, page, Hkv, N - 1};
  return launch(a, lay, B, D, q_f32, quant, warps, ws_floats, n_counters, stream);
}
