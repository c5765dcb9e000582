// paged_attention — attention of a query window through a page table, over
// a pool of KV pages, for Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/paged_attention.py::_kernel (entries
// paged_attention and paged_attention_multi, via _paged_call).  For slot b,
// window row j < t and query head h (kv head h / G):
//
//   key p of slot b lives in page table[b, p / PS] at offset p % PS
//   s_p = (q_{j,h} . k_p) * kscale_p        allowed: p <= base[b] + j
//   out_{j,h} = sum_p softmax(s)_p * vscale_p * v_p
//
// Pages are head-major [P+1, Hkv, PS, D]: int8 with f32 scale planes
// [P+1, Hkv, PS], or f32 or bf16 without (bf16 elements are widened with
// __bfloat162float; the output stays f32 and the caller casts it to q's
// type, as the TPU kernel writes q's type for unquantized pages).  q arrives scaled by the softmax scale.
// Decode is t = 1 with base = length - 1; speculative verify, chunked
// prefill and prefix-cache suffixes are windows of t rows whose own keys
// are already in the pages.  A masked key weighs exactly 0, and a row with
// no allowed key returns 0 (base = -1: an empty slot).  No key at or past a
// row's limit is read: table entries there may name the trash page or
// stale pages.  All arithmetic is f32.
//
// What bounds it on the H100.  Decode reads the live pages once, per (key,
// kv head) 2*D + 8 bytes for int8 pages, 2*D*2 for bf16, 2*D*4 for f32: at
// chip_smoke.py's phase-2 decode shape (B=8, Hkv=32, D=128, lengths up to
// 512, some 2900 live keys a kv head) about 25 MB for int8 pages, 7.4 us at
// 3.35 TB/s, and 47 MB for bf16 pages, 14 us.  A window of t >= ~64 rows is bound by its operations: 4*D
// multiply-adds per (row, allowed key); a 256-row chunk at base 1024 takes
// 4.8e9 per slot at Hq=32, 72 us at 67 TFLOP/s f32.
//
// Design.  The TPU grid walks a slot's pages in order and carries (m, l,
// acc) in VMEM; here one block owns (slot, kv head, a tile of up to 64
// window rows), the G query heads of that kv head included, and loops over
// the slot's keys itself, reading the page ids from the table (the TPU's
// scalar prefetch).  Rows are tiled: a warp carries RW rows (RW = 1, 2, 4
// or 8, the least that holds the window at decode) in registers, and the 8
// warps of a block split either the rows (long windows: 8 warps x 8 rows)
// or the keys (short windows: each warp takes every 8th step of 32 keys,
// so a decode block has 8 steps in flight), merging their online-softmax
// states in shared memory at the end.  A step covers 32 keys, one a lane:
// the lane reads its key's K row with 16-byte loads and dots it with the
// warp's q rows, broadcast from shared memory; after the softmax update the
// weights (V scale folded in) go to shared memory and the warp reads the
// step's V rows coalesced, a lane owning 4 of the D columns.  f32 CUDA
// cores; tensor cores and a split over keys across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int KT = 32;  // keys a warp takes per step: one a lane
constexpr int MAXD = 128;
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Row;

template <>
struct Row<int8_t> {
  static constexpr int EPL = 16;  // elements of one 16-byte load
  __device__ static void load(const int8_t* p, float* out) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) out[4 * i + b] = (float)(int8_t)(ws[i] >> (8 * b));
    }
  }
  __device__ static void load4(const int8_t* p, float* out) {
    const int w = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int b = 0; b < 4; ++b) out[b] = (float)(int8_t)(w >> (8 * b));
  }
};

template <>
struct Row<float> {
  static constexpr int EPL = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void load4(const float* p, float* out) { load(p, out); }
};

template <>
struct Row<__nv_bfloat16> {
  static constexpr int EPL = 8;  // one 16-byte load
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void load4(const __nv_bfloat16* p, float* out) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Window row r of a kv head is (j, g) = (r / G, r % G): query head kvh*G+g.
template <typename T, bool QUANT, int RW>
__global__ void __launch_bounds__(32 * WARPS)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ table,
                       const int* __restrict__ base, float* __restrict__ out, int t, int Hq,
                       int Hkv, int D, int PS, int maxp, int wk_log2) {
  __shared__ __align__(16) float sq[WARPS][RW][MAXD];  // q rows; then the warps' accumulators
  __shared__ float sp[WARPS][RW][KT];                  // one step's weights
  __shared__ int srow[WARPS][KT];                      // one step's key rows in the pool
  __shared__ float sml[WARPS][RW][2];                  // the warps' (m, l)

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int NR = t * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int WK = 1 << wk_log2;          // warps that split one row group's keys
  const int wk = warp & (WK - 1);
  const int BR = (WARPS >> wk_log2) * RW;
  const int r0 = blockIdx.z * BR + (warp >> wk_log2) * RW;
  const int bs = base[b];
  const int nkeys = maxp * PS;

  float* qw = &sq[warp][0][0];
  for (int e = lane * 4; e < RW * MAXD; e += 32 * 4) {
    const int r = e / MAXD, d = e % MAXD;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < NR && d < D) {
      const int j = (r0 + r) / G, g = (r0 + r) % G;
      v = *reinterpret_cast<const float4*>(q + (((size_t)b * t + j) * Hq + kvh * G + g) * D + d);
    }
    *reinterpret_cast<float4*>(qw + e) = v;
  }
  __syncwarp();

  int lim[RW];  // keys p < lim[r] are allowed for row r
  int kend = 0;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    lim[r] = r0 + r < NR ? min(bs + 1 + (r0 + r) / G, nkeys) : 0;
    kend = max(kend, lim[r]);
  }

  float m[RW], l[RW], acc[RW][4];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  const int c0 = lane * 4;  // this lane's 4 output columns

  for (int k0 = wk * KT; k0 < kend; k0 += WK * KT) {
    const int key = k0 + lane;
    const bool kin = key < kend;
    int row = 0;
    if (kin) row = (table[(size_t)b * maxp + key / PS] * Hkv + kvh) * PS + key % PS;
    srow[warp][lane] = row;

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    if (kin) {
      const T* kr = kp + (size_t)row * D;
#pragma unroll 2
      for (int d = 0; d < D; d += Row<T>::EPL) {
        float kf[Row<T>::EPL];
        Row<T>::load(kr + d, kf);
#pragma unroll
        for (int e = 0; e < Row<T>::EPL; e += 4) {
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(qw + r * MAXD + d + e);
            s[r] = fmaf(qv.x, kf[e], s[r]);
            s[r] = fmaf(qv.y, kf[e + 1], s[r]);
            s[r] = fmaf(qv.z, kf[e + 2], s[r]);
            s[r] = fmaf(qv.w, kf[e + 3], s[r]);
          }
        }
      }
    }
    const float ksc = (QUANT && kin) ? ks[row] : 1.f;
    const float vsc = (QUANT && kin) ? vs[row] : 1.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool ok = kin && key < lim[r];
      const float sc = ok ? s[r] * ksc : NEG_INF;
      const float m_next = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_next);
      const float p = ok ? expf(sc - m_next) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_next;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
      sp[warp][r][lane] = p * vsc;
    }
    __syncwarp();
    const int nk = min(KT, kend - k0);
    if (c0 < D) {
      for (int c = 0; c < nk; ++c) {
        float vf[4];
        Row<T>::load4(vp + (size_t)srow[warp][c] * D + c0, vf);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float p = sp[warp][r][c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

  // merge the WK warps of each row group (the q rows are no longer read)
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (c0 < D) *reinterpret_cast<float4*>(qw + r * MAXD + c0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    if (lane == 0) {
      sml[warp][r][0] = m[r];
      sml[warp][r][1] = l[r];
    }
  }
  __syncthreads();
  const int groups = WARPS >> wk_log2;
  for (int e = threadIdx.x; e < groups * RW * D; e += 32 * WARPS) {
    const int gr = e / (RW * D);
    const int r = (e / D) % RW;
    const int d = e % D;
    const int rr = blockIdx.z * BR + gr * RW + r;
    if (rr >= NR) continue;
    float mx = NEG_INF;
    for (int w = gr * WK; w < (gr + 1) * WK; ++w) mx = fmaxf(mx, sml[w][r][0]);
    float lt = 0.f, a = 0.f;
    for (int w = gr * WK; w < (gr + 1) * WK; ++w) {
      const float f = expf(sml[w][r][0] - mx);
      lt = fmaf(sml[w][r][1], f, lt);
      a = fmaf(sq[w][r][d], f, a);
    }
    const int j = rr / G, g = rr % G;
    out[(((size_t)b * t + j) * Hq + kvh * G + g) * D + d] = a * (lt == 0.f ? 1.f : 1.f / lt);
  }
}

template <typename T, bool QUANT, int RW>
int launch(dim3 grid, cudaStream_t st, const float* q, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* table, const int* base, float* out, int t,
           int Hq, int Hkv, int D, int PS, int maxp, int wk_log2) {
  paged_attention_kernel<T, QUANT, RW><<<grid, 32 * WARPS, 0, st>>>(
      q, (const T*)kp, (const T*)vp, ks, vs, table, base, out, t, Hq, Hkv, D, PS, maxp, wk_log2);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int dispatch(int rw, dim3 grid, cudaStream_t st, const float* q, const void* kp, const void* vp,
             const float* ks, const float* vs, const int* table, const int* base, float* out,
             int t, int Hq, int Hkv, int D, int PS, int maxp, int wk_log2) {
  switch (rw) {
    case 1:
      return launch<T, QUANT, 1>(grid, st, q, kp, vp, ks, vs, table, base, out, t, Hq, Hkv, D, PS,
                                 maxp, wk_log2);
    case 2:
      return launch<T, QUANT, 2>(grid, st, q, kp, vp, ks, vs, table, base, out, t, Hq, Hkv, D, PS,
                                 maxp, wk_log2);
    case 4:
      return launch<T, QUANT, 4>(grid, st, q, kp, vp, ks, vs, table, base, out, t, Hq, Hkv, D, PS,
                                 maxp, wk_log2);
    case 8:
      return launch<T, QUANT, 8>(grid, st, q, kp, vp, ks, vs, table, base, out, t, Hq, Hkv, D, PS,
                                 maxp, wk_log2);
  }
  return (int)cudaErrorInvalidValue;
}

enum KvType { KV_F32 = 0, KV_INT8 = 1, KV_BF16 = 2 };

}  // namespace

// q: f32 [B, t, Hq, D], scaled; k_pages, v_pages: [P+1, Hkv, PS, D] of
// kv_type KV_INT8 (with f32 ks/vs [P+1, Hkv, PS]), KV_F32 or KV_BF16;
// table: int32 [B, maxp]; base: int32 [B]; out: f32 [B, t, Hq, D].  rw in
// {1, 2, 4, 8} rows a warp, 2**wk_log2 warps split one row group's keys; a
// block covers (8 >> wk_log2) * rw window rows (the wrapper chooses both).
extern "C" int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                               const void* ks, const void* vs, const void* table,
                               const void* base, void* out, int B, int t, int Hq, int Hkv, int D,
                               int PS, int maxp, int kv_type, int rw, int wk_log2,
                               void* stream) {
  const int epl = kv_type == KV_INT8 ? 16 : kv_type == KV_BF16 ? 8 : 4;
  if (D % epl != 0 || D > MAXD || Hkv <= 0 || Hq % Hkv != 0 || wk_log2 < 0 || wk_log2 > 3)
    return (int)cudaErrorInvalidValue;
  const int rows = t * (Hq / Hkv);
  const int br = (WARPS >> wk_log2) * rw;
  dim3 grid(B, Hkv, (rows + br - 1) / br);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_type) {
    case KV_INT8:
      return dispatch<int8_t, true>(rw, grid, st, (const float*)q, k_pages, v_pages,
                                    (const float*)ks, (const float*)vs, (const int*)table,
                                    (const int*)base, (float*)out, t, Hq, Hkv, D, PS, maxp,
                                    wk_log2);
    case KV_F32:
      return dispatch<float, false>(rw, grid, st, (const float*)q, k_pages, v_pages, nullptr,
                                    nullptr, (const int*)table, (const int*)base, (float*)out, t,
                                    Hq, Hkv, D, PS, maxp, wk_log2);
    case KV_BF16:
      return dispatch<__nv_bfloat16, false>(rw, grid, st, (const float*)q, k_pages, v_pages,
                                            nullptr, nullptr, (const int*)table, (const int*)base,
                                            (float*)out, t, Hq, Hkv, D, PS, maxp, wk_log2);
  }
  return (int)cudaErrorInvalidValue;
}
