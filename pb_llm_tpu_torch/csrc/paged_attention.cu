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
// stale pages.  Sums are f32 in both arms (below).
//
// What bounds it on the H100.  Decode reads the live pages once, per (key,
// kv head) 2*D + 8 bytes for int8 pages, 2*D*2 for bf16, 2*D*4 for f32: at
// chip_smoke.py's phase-2 decode shape (B=8, Hkv=32, D=128, lengths up to
// 512, some 2900 live keys a kv head) about 25 MB for int8 pages, 7.4 us at
// 3.35 TB/s, and 47 MB for bf16 pages, 14 us.  A window of t >= ~64 rows is
// bound by its operations: 4*D multiply-adds per (row, allowed key); a
// 256-row chunk at base 1024 takes 4.8e9 per slot at Hq=32, 72 us at
// 67 TFLOP/s f32, or 10 us as bf16 tensor-core operations with two terms
// a product (see the window arm below) at 989 TFLOP/s.
//
// Three arms.  The split arm (paged_attention_split) takes decode (t = 1)
// over every page type where G = Hq / Hkv <= 8 and D is a multiple of 8
// (it also takes windows of t * G <= 8 rows a kv head, by name, for timing);
// the tensor-core arm (paged_attention_window) takes windows (t > 1) over
// int8 and bf16 pages; the CUDA-core arm the rest (f32-page windows), and
// stays reachable for decode as the yardstick the split arm replaced.  The
// wrapper picks by that fixed rule (ops/paged_attention.window_arm).
//
// Split arm (decode).  The CUDA-core arm gives a decode block a whole slot:
// the longest slot sets the time, and each key's loads wait on the previous
// step's softmax.  Here a slot's keys are cut into splits of whole pages
// (SPLIT_KEYS = 128 keys, 8 pages of 16; one page above it), SPLIT_GRID = 4
// blocks a (kv head, slot), block c taking splits c, c + 4, ...: a grid
// fixed by the table's width (max_seq), so a captured decode step's grid
// holds at every length; a block with no split below its slot's limit
// returns at once.  The G query heads of the kv head share every K and V
// load.  A split runs in chunks of 64 keys (16 lane groups x 4 keys): the
// block requests all of a chunk's K and V slices (and int8 scales) before
// its first dot, every address clamped to the chunk's last live key, so no
// key at or past the limit is read (a stale or trash page's rows never
// reach a product); then one max a chunk over the block and one set of
// exponentials, the running max rescaled between chunks.  A lane holds 16
// bytes of an int8 row (8 elements of a bf16 or f32 row; 8 of int8 for more
// than two window rows, as the registers allow).  Each split's
// (unnormalised output, max, sum) goes to a workspace [B, t, Hq, splits,
// D + 2]; a merge launch adds each (slot, head)'s splits in split order, no
// atomics, so a graph replay equals an eager launch bit for bit.  The lanes
// load the rows themselves, with vector loads (a copy of this source that
// moves each page segment by cp.async.bulk onto an mbarrier instead is
// timed by scripts/torch_paged_split_variants.py).  Arithmetic stays f32:
// int8 codes and bf16 elements widen exactly, the K scale multiplies the
// score after the dot and the V scale folds into p.
//
// CUDA-core arm.  The TPU grid walks a slot's pages in order and carries
// (m, l, acc) in VMEM; here one block owns (slot, kv head, a tile of up to
// 64 window rows), the G query heads of that kv head included, and loops
// over the slot's keys itself, reading the page ids from the table (the
// TPU's scalar prefetch).  Rows are tiled: a warp carries RW rows (RW = 1,
// 2, 4 or 8, the least that holds the window at decode) in registers, and
// the 8 warps of a block split either the rows (long windows: 8 warps x 8
// rows) or the keys (short windows: each warp takes every 8th step of 32
// keys, so a decode block has 8 steps in flight), merging their
// online-softmax states in shared memory at the end.  A step covers 32
// keys, one a lane: the lane reads its key's K row with 16-byte loads and
// dots it with the warp's q rows, broadcast from shared memory; after the
// softmax update the weights (V scale folded in) go to shared memory and
// the warp reads the step's V rows coalesced, a lane owning 4 of the D
// columns.  All arithmetic is f32 on the CUDA cores.
//
// Tensor-core arm.  A block owns (slot, kv head, 64 window rows), four
// warps of 16 rows.  It walks the slot's keys in tiles of 64 (four pages
// of 16), reading the page ids from the table itself, and copies each
// tile's K and V rows (and int8 scales) into shared memory with cp.async,
// double-buffered; a key at or past the block's largest limit is
// zero-filled, never loaded, and key tiles past it are not visited, so a
// causal window reads nothing past its end.  int8 codes and bf16 elements
// are exact in bf16 (int8 tiles are widened once per tile for all warps).
// S = q.K^T and O += P.V run as mma.sync m16n8k16 bf16 -> f32, fragments
// through ldmatrix (.trans for V); the K scale multiplies S after the dot
// and the V scale folds into P, as the TPU kernel does; the limit masks,
// the online softmax and O stay in registers.  Precision: q (f32, scaled)
// and P are each split into two bf16 terms (hi = bf16(x), lo = bf16(x -
// hi): x to 2^-18), each term its own mma, so S and P.V keep near-f32
// accuracy.  In an emulation of this arithmetic against the plain version
// (tests/test_torch_paged_attention.py::test_window_arm_needs_two_bf16_terms)
// one term misses the bound (rtol = atol = 2e-5) by 100-200x and two
// terms stay within a third of it, so a third term buys nothing.  Later
// work: wgmma and TMA, and splitting long windows' keys across blocks.

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

// ---------------------------------------------------------------------------
// The window arm on the tensor cores (t > 1 over int8 or bf16 pages).
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_ROWS = 16 * TC_WARPS;  // window rows a block: 16 a warp
constexpr int TC_BK = 64;               // keys a tile
constexpr int TC_KSTEPS = MAXD / 16;    // q.k depth steps at most
constexpr int TC_DTILES = MAXD / 8;     // output column tiles at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo to 2^-18 of each value: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in f32)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const float ah = __bfloat162float(__float2bfloat16_rn(a));
  const float bh = __bfloat162float(__float2bfloat16_rn(b));
  hi = pack_bf16(ah, bh);
  lo = pack_bf16(a - ah, b - bh);
}

// not volatile: the compiler may interleave independent accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// cp.async of 16 (or 4) bytes; a false predicate writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float2 ld_q2(const float* row, int d, int D) {
  return (row != nullptr && d < D) ? *reinterpret_cast<const float2*>(row + d)
                                   : make_float2(0.f, 0.f);
}

// Shared memory of one block, in bytes (DP = D rounded up to 16): two
// stages of K and V tiles as stored ([64 keys][DP*esize + 16]: the 16-byte
// pad spreads ldmatrix's rows over the banks) and, for int8 pages, the
// stages' scales and the tile's K and V as bf16 ([64][DP*2 + 16]).
__host__ __device__ inline int tc_row_bytes(int D, bool int8) {
  return ((D + 15) & ~15) * (int8 ? 1 : 2) + 16;
}
__host__ __device__ inline int tc_stage_bytes(int D, bool int8) {
  return 2 * TC_BK * tc_row_bytes(D, int8) + (int8 ? 2 * TC_BK * 4 : 0);
}
__host__ inline int tc_smem_bytes(int D, bool int8) {
  return 2 * tc_stage_bytes(D, int8) + (int8 ? 2 * TC_BK * tc_row_bytes(D, false) : 0);
}

// Start one tile's copies: keys [k0, k0 + 64) of K and V (and the int8
// scales) into ``stage``.  ``srow`` (64 ints of shared memory) receives
// each key's row in the pool, or -1 at or past the block's limit L.
template <bool INT8>
__device__ void tc_load_tile(unsigned char* stage, int* srow, int k0, int L, const void* kp,
                             const void* vp, const float* ks, const float* vs, const int* table,
                             int b, int kvh, int Hkv, int D, int PS, int maxp) {
  constexpr int ESZ = INT8 ? 1 : 2;
  const int RS = tc_row_bytes(D, INT8);
  const int chunks = D * ESZ / 16;
  if (threadIdx.x < TC_BK) {
    const int key = k0 + threadIdx.x;
    srow[threadIdx.x] =
        key < L ? (table[(size_t)b * maxp + key / PS] * Hkv + kvh) * PS + key % PS : -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TC_BK * chunks; e += 32 * TC_WARPS) {
    const int kr = e / chunks, c = e - kr * chunks;
    const int row = srow[kr];
    const bool ok = row >= 0;  // past the block's limit: zeros, never loaded
    const size_t off = (size_t)max(row, 0) * D * ESZ + c * 16;
    cp_async16(smem_u32(stage + kr * RS + c * 16), static_cast<const unsigned char*>(kp) + off,
               ok);
    cp_async16(smem_u32(stage + (TC_BK + kr) * RS + c * 16),
               static_cast<const unsigned char*>(vp) + off, ok);
  }
  if (INT8 && threadIdx.x < TC_BK) {
    float* sc = reinterpret_cast<float*>(stage + 2 * TC_BK * RS);
    const int row = srow[threadIdx.x];
    cp_async4(smem_u32(sc + threadIdx.x), ks + max(row, 0), row >= 0);
    cp_async4(smem_u32(sc + TC_BK + threadIdx.x), vs + max(row, 0), row >= 0);
  }
}

// Window row r of a kv head is (j, g) = (r / G, r % G), as in the CUDA-core
// arm.  Block (b, kvh, z) takes rows [64 z, 64 z + 64); warp w rows
// 16 w .. 16 w + 15, a lane rows lane/4 and lane/4 + 8 of those (the mma
// accumulator's rows).
template <bool INT8>
__global__ void __launch_bounds__(32 * TC_WARPS)
paged_window_tc_kernel(const float* __restrict__ q, const void* __restrict__ kp,
                       const void* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ table,
                       const int* __restrict__ base, float* __restrict__ out, int t, int Hq,
                       int Hkv, int D, int PS, int maxp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int srow[TC_BK];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = Hq / Hkv;
  const int NR = t * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int DP = (D + 15) & ~15;
  const int RS = tc_row_bytes(D, INT8);
  const int CS = tc_row_bytes(D, false);
  const int STAGE = tc_stage_bytes(D, INT8);
  unsigned char* stages[2] = {smem, smem + STAGE};
  unsigned char* kconv = smem + 2 * STAGE;  // int8 pages: the tile's K and V as bf16
  unsigned char* vconv = kconv + TC_BK * CS;
  const int bs = base[b];
  const int nkeys = maxp * PS;
  const int r0 = blockIdx.z * TC_ROWS;

  auto limit = [&](int r) { return r < NR ? max(min(bs + 1 + r / G, nkeys), 0) : 0; };
  const int L = limit(min(r0 + TC_ROWS, NR) - 1);                 // the block's largest
  const int WL = r0 + 16 * warp < NR ? limit(min(r0 + 16 * warp + 15, NR - 1)) : 0;  // the warp's
  const int ra = r0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const int lima = limit(ra), limb = limit(rb);

  if (!INT8 && DP != D) {  // the K rows' columns [D, DP) stay zero (q is zero there too)
    for (int e = threadIdx.x; e < 2 * TC_BK; e += 32 * TC_WARPS)
      *reinterpret_cast<uint4*>(stages[e / TC_BK] + (e % TC_BK) * RS + D * 2) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // q (f32, scaled) as two bf16 terms: A fragments of the 16 rows, held
  // for the whole key loop
  const float* qa = ra < NR ? q + (((size_t)b * t + ra / G) * Hq + kvh * G + ra % G) * D : nullptr;
  const float* qb = rb < NR ? q + (((size_t)b * t + rb / G) * Hq + kvh * G + rb % G) * D : nullptr;
  const int nks = DP / 16, ndt = D / 8;
  uint32_t qh[TC_KSTEPS][4], ql[TC_KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < TC_KSTEPS; ++kk) {
    const int d = kk * 16 + (lane & 3) * 2;
    const float2 v[4] = {ld_q2(qa, d, D), ld_q2(qb, d, D), ld_q2(qa, d + 8, D),
                         ld_q2(qb, d + 8, D)};
#pragma unroll
    for (int i = 0; i < 4; ++i) split2(v[i].x, v[i].y, qh[kk][i], ql[kk][i]);
  }

  float acc[TC_DTILES][4];
#pragma unroll
  for (int dn = 0; dn < TC_DTILES; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;

  const int ntiles = (L + TC_BK - 1) / TC_BK;
  if (ntiles > 0)
    tc_load_tile<INT8>(stages[0], srow, 0, L, kp, vp, ks, vs, table, b, kvh, Hkv, D, PS, maxp);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles)
      tc_load_tile<INT8>(stages[(it + 1) & 1], srow, (it + 1) * TC_BK, L, kp, vp, ks, vs, table, b,
                         kvh, Hkv, D, PS, maxp);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    unsigned char* st = stages[it & 1];
    const unsigned char* kt = st;
    const unsigned char* vt = st + TC_BK * RS;
    int stride = RS;
    if (INT8) {  // int8 codes are exact in bf16: widen the tile once for all warps
      const int chunks = D / 16;
      for (int e = threadIdx.x; e < 2 * TC_BK * chunks; e += 32 * TC_WARPS) {
        const int kr = e / chunks, c = e - kr * chunks;  // kr: rows of K, then of V
        const int4 w = *reinterpret_cast<const int4*>(st + kr * RS + c * 16);
        const int ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[2 * i] = pack_bf16((float)(int8_t)(ws[i]), (float)(int8_t)(ws[i] >> 8));
          o[2 * i + 1] = pack_bf16((float)(int8_t)(ws[i] >> 16), (float)(int8_t)(ws[i] >> 24));
        }
        unsigned char* dst = kconv + kr * CS + c * 32;  // vconv = kconv + 64 rows
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst + 16) = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
      kt = kconv;
      vt = vconv;
      stride = CS;
    }
    const int k0 = it * TC_BK;
    if (k0 < WL) {
      // S = (q_hi + q_lo) . K^T, 16 rows x 64 keys: a depth step's 8 key
      // tiles in turn, so consecutive products feed different accumulators
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const uint32_t krow = smem_u32(kt + (lane & 7) * stride) + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < TC_KSTEPS; ++kk) {
        if (kk < nks) {
          uint32_t b[8][2];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) ldsm_x2(krow + nt * 8 * stride + kk * 32, b[nt][0], b[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_bf16(sc[nt], qh[kk], b[nt][0], b[nt][1]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_bf16(sc[nt], ql[kk], b[nt][0], b[nt][1]);
        }
      }
      // K scale after the dot, per-row limits, online softmax in registers
      const float* ksc = reinterpret_cast<const float*>(st + 2 * TC_BK * RS);
      const float* vsc = ksc + TC_BK;
      float mxa = NEG_INF, mxb = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = nt * 8 + (lane & 3) * 2 + e;
          const float kscale = INT8 ? ksc[kc] : 1.f;
          sc[nt][e] = k0 + kc < lima ? sc[nt][e] * kscale : NEG_INF;
          sc[nt][2 + e] = k0 + kc < limb ? sc[nt][2 + e] * kscale : NEG_INF;
          mxa = fmaxf(mxa, sc[nt][e]);
          mxb = fmaxf(mxb, sc[nt][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
      }
      const float mna = fmaxf(ma, mxa), mnb = fmaxf(mb, mxb);
      const float aa = expf(ma - mna), ab = expf(mb - mnb);
      ma = mna;
      mb = mnb;
      la *= aa;
      lb *= ab;
#pragma unroll
      for (int dn = 0; dn < TC_DTILES; ++dn) {
        acc[dn][0] *= aa;
        acc[dn][1] *= aa;
        acc[dn][2] *= ab;
        acc[dn][3] *= ab;
      }
      // P (V scale folded in) as two bf16 terms, in the A-fragment layout:
      // the accumulator of key tiles 2s and 2s+1 is the A fragment of step s
      uint32_t ph[8][2], pl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kc = nt * 8 + (lane & 3) * 2;
        const bool a0 = k0 + kc < lima, a1 = k0 + kc + 1 < lima;
        const bool b0 = k0 + kc < limb, b1 = k0 + kc + 1 < limb;
        const float p0 = a0 ? expf(sc[nt][0] - mna) : 0.f;
        const float p1 = a1 ? expf(sc[nt][1] - mna) : 0.f;
        const float p2 = b0 ? expf(sc[nt][2] - mnb) : 0.f;
        const float p3 = b1 ? expf(sc[nt][3] - mnb) : 0.f;
        la += p0 + p1;
        lb += p2 + p3;
        const float v0 = INT8 ? vsc[kc] : 1.f, v1 = INT8 ? vsc[kc + 1] : 1.f;
        split2(p0 * v0, p1 * v1, ph[nt][0], pl[nt][0]);
        split2(p2 * v0, p3 * v1, ph[nt][1], pl[nt][1]);
      }
      // O += P . V, 16 rows x D
#pragma unroll
      for (int s = 0; s < TC_BK / 16; ++s) {
        const uint32_t ah[4] = {ph[2 * s][0], ph[2 * s][1], ph[2 * s + 1][0], ph[2 * s + 1][1]};
        const uint32_t al[4] = {pl[2 * s][0], pl[2 * s][1], pl[2 * s + 1][0], pl[2 * s + 1][1]};
        const uint32_t vrow = smem_u32(vt + (s * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * stride);
#pragma unroll
        for (int dn = 0; dn < TC_DTILES; dn += 4) {  // 4 column tiles at a time
          uint32_t b[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (dn + i < ndt) ldsm_x2_trans(vrow + (dn + i) * 16, b[i][0], b[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (dn + i < ndt) mma_bf16(acc[dn + i], ah, b[i][0], b[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (dn + i < ndt) mma_bf16(acc[dn + i], al, b[i][0], b[i][1]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  const float ia = la == 0.f ? 1.f : 1.f / la, ib = lb == 0.f ? 1.f : 1.f / lb;
  const int c = (lane & 3) * 2;
  if (ra < NR) {
    float* o = out + (((size_t)b * t + ra / G) * Hq + kvh * G + ra % G) * D;
#pragma unroll
    for (int dn = 0; dn < TC_DTILES; ++dn)
      if (dn < ndt)
        *reinterpret_cast<float2*>(o + dn * 8 + c) = make_float2(acc[dn][0] * ia, acc[dn][1] * ia);
  }
  if (rb < NR) {
    float* o = out + (((size_t)b * t + rb / G) * Hq + kvh * G + rb % G) * D;
#pragma unroll
    for (int dn = 0; dn < TC_DTILES; ++dn)
      if (dn < ndt)
        *reinterpret_cast<float2*>(o + dn * 8 + c) = make_float2(acc[dn][2] * ib, acc[dn][3] * ib);
  }
}

template <bool INT8>
int launch_window_tc(dim3 grid, cudaStream_t st, const float* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* table, const int* base,
                     float* out, int t, int Hq, int Hkv, int D, int PS, int maxp) {
  const int smem = tc_smem_bytes(D, INT8);
  cudaError_t err = cudaFuncSetAttribute(paged_window_tc_kernel<INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_window_tc_kernel<INT8><<<grid, 32 * TC_WARPS, smem, st>>>(q, kp, vp, ks, vs, table, base,
                                                                 out, t, Hq, Hkv, D, PS, maxp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The decode arm "split" (t = 1): a slot's keys cut into splits of whole pages
// ---------------------------------------------------------------------------

namespace split {

constexpr int GROUPS = 16;             // lane groups a block: one key each a step
constexpr int STEPS = 4;               // keys a lane group reads a chunk, all requested at once
constexpr int CHUNK = GROUPS * STEPS;  // keys a chunk (a split of up to 64 keys is one chunk)
constexpr int SMAXD = 128;

// elements of a key row a lane holds: 16 bytes of int8 for one or two
// window rows a block, else 8 elements (8 bytes of int8, as the registers of
// more rows allow; 16 of bf16, 32 of f32)
template <typename T, int MG>
__host__ __device__ constexpr int epl() {
  return sizeof(T) == 1 && MG <= 2 ? 16 : 8;
}

// a lane's slice of a row as stored, BYTES of it in 32-bit words
template <int BYTES>
struct Raw {
  unsigned w[BYTES / 4];
};

// from device memory, on the read-only path
template <int BYTES>
__device__ __forceinline__ void raw(const void* p, Raw<BYTES>& r) {
  if constexpr (BYTES == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  }
}

// a raw slice of T as f32, element by element (exact)
template <typename T, int BYTES>
__device__ __forceinline__ void widen(const Raw<BYTES>& r, float* out) {
#pragma unroll
  for (int i = 0; i < BYTES / 4; ++i) {
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int b = 0; b < 4; ++b) out[4 * i + b] = (float)(int8_t)(r.w[i] >> (8 * b));
    } else if constexpr (sizeof(T) == 2) {  // a bf16 is the high half of its f32
      out[2 * i] = __uint_as_float(r.w[i] << 16);
      out[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    } else {
      out[i] = __uint_as_float(r.w[i]);
    }
  }
}

// Splits c = blockIdx.x, + gridDim.x, ... of slot b = blockIdx.z, kv head
// blockIdx.y, split c the keys c*sk .. c*sk + sk - 1 below the slot's limit
// (a block with none returns at once; the grid follows the table's width,
// never the lengths), for the R = t*G window rows of the kv head (row r =
// (j, g) = (r / G, r % G), query head kvh*G + g, keys below base + 1 + j
// allowed; MG >= R, rows past R idle): decode is t = 1, the G heads sharing
// every load.  In chunks of 16 * STEPS keys: lane group g takes keys k0 +
// st*16 + g, st < STEPS, every address clamped to the chunk's last live
// key, so nothing at or past the limit is read and no load waits on a
// branch; all of the chunk's K and V slices (and scales) are requested
// before the first dot.  Then the scores of the R rows, one max a chunk
// over the block, one set of exponentials, and the P.V sums per lane
// group; at the end the groups' sums added in group order and the split's
// unnormalised output, max and sum written to part[b, j, h, c, :D], [D],
// [D+1].
template <typename T, bool QUANT, int MG>
__global__ void __launch_bounds__(GROUPS * 16, MG <= 4 ? 2 : 1)
split_kernel(const float* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ table, const int* __restrict__ base,
             float* __restrict__ part, int t, int Hq, int Hkv, int D, int PS, int maxp, int sk,
             int ns, int lpr_log2) {
  constexpr int EPL = epl<T, MG>();
  constexpr int LB = EPL * (int)sizeof(T);  // bytes of a lane's slice
  __shared__ float sm_m[GROUPS][MG];
  __shared__ float sm_l[GROUPS];
  __shared__ __align__(16) float sm_acc[GROUPS * SMAXD];

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int R = t * G;
  const int bs = base[b];
  const int len = min(max(bs + t, 0), maxp * PS);  // the last row's limit: the block's keys
  if ((int)blockIdx.x * sk >= len) return;
  const int lpr = 1 << lpr_log2;
  const int grp = threadIdx.x >> lpr_log2;
  const int d0 = (threadIdx.x & (lpr - 1)) * EPL;
  const bool lane_on = d0 < D;            // D % EPL == 0: a lane is wholly in or out
  const int dl = lane_on ? d0 : D - EPL;  // the slice an idle lane reads (and discards)
  const int* trow = table + (size_t)b * maxp;

  float qr[MG][EPL];
  int lim[MG];  // keys below lim[r] are allowed for row r
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    const int r = min(g, R - 1);
    const float* qh = q + (((size_t)b * t + r / G) * Hq + kvh * G + r % G) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = (g < R && lane_on) ? qh[d0 + e] : 0.f;
    lim[g] = g < R ? min(max(bs + 1 + g / G, 0), len) : 0;
  }
  // splits c, c + gridDim.x, ... that hold keys
  for (int c = blockIdx.x; c * sk < len; c += gridDim.x) {
    const int k_begin = c * sk;
    const int k_end = min(k_begin + sk, len);
    float mrun[MG], l[MG], acc[MG][EPL];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      mrun[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }

    for (int k0 = k_begin; k0 < k_end; k0 += CHUNK) {
      const int kc_end = min(k0 + CHUNK, k_end);  // the chunk's live keys: k0 .. kc_end - 1
      Raw<LB> kr[STEPS], vr[STEPS];
      float ksc[STEPS], vsc[STEPS];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const int kcl = min(k0 + st * GROUPS + grp, kc_end - 1);
        const int pg = kcl / PS;
        const size_t row = ((size_t)__ldg(trow + pg) * Hkv + kvh) * PS + (kcl - pg * PS);
        raw(kp + row * D + dl, kr[st]);
        raw(vp + row * D + dl, vr[st]);
        if (QUANT) {
          ksc[st] = __ldg(ks + row);
          vsc[st] = __ldg(vs + row);
        }
      }

      // the scores of the G heads; the chunk's max a head over the block
      float score[STEPS][MG], mx[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) mx[g] = NEG_INF;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float kf[EPL];
        widen<T>(kr[st], kf);
        const int key = k0 + st * GROUPS + grp;
        const bool in = key < kc_end;  // a key of this chunk (a split of 60 keys ends inside one)
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          for (int off = lpr >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          score[st][g] = in && key < lim[g] ? (QUANT ? dot * ksc[st] : dot) : NEG_INF;
          mx[g] = fmaxf(mx[g], score[st][g]);
        }
      }
      if ((threadIdx.x & (lpr - 1)) == 0) {
#pragma unroll
        for (int g = 0; g < MG; ++g) sm_m[grp][g] = mx[g];
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        float cm = NEG_INF;
#pragma unroll
        for (int gr = 0; gr < GROUPS; ++gr) cm = fmaxf(cm, sm_m[gr][g]);
        const float m_next = fmaxf(mrun[g], cm);
        const float alpha = expf(mrun[g] - m_next);  // 0 at the first chunk
        mrun[g] = m_next;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      }
      // one set of exponentials; the V scale folds into p; a masked key weighs 0
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float vf[EPL];
        widen<T>(vr[st], vf);
        const int key = k0 + st * GROUPS + grp;
        const bool in = key < kc_end;
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          float p = in && key < lim[g] ? expf(score[st][g] - mrun[g]) : 0.f;
          l[g] += p;
          if (QUANT) p *= vsc[st];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
      __syncthreads();  // sm_m is read before the next chunk writes it
    }

    // the lane groups' sums in group order, a row at a time
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < R) {
        if (lane_on) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) sm_acc[grp * D + d0 + e] = acc[g][e];
        }
        if ((threadIdx.x & (lpr - 1)) == 0) sm_l[grp] = l[g];
        __syncthreads();
        float* pp = part + ((((size_t)b * t + g / G) * Hq + kvh * G + g % G) * ns + c) * (D + 2);
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
          float a = 0.f;
#pragma unroll
          for (int gr = 0; gr < GROUPS; ++gr) a += sm_acc[gr * D + d];
          pp[d] = a;
        }
        if (threadIdx.x == 0) {
          float lt = 0.f;
#pragma unroll
          for (int gr = 0; gr < GROUPS; ++gr) lt += sm_l[gr];
          pp[D] = mrun[g];
          pp[D + 1] = lt;
        }
        __syncthreads();
      }
    }
  }  // the splits
}

// The splits of slot b, window row j, query head h merged in split order:
// out = sum_c w_c * acc_c / sum_c w_c * l_c, w_c = exp(m_c - max_c m_c) (a
// split with no key the row may see has m_c = NEG_INF and l_c = 0); zeros
// for a row with no allowed key.  One thread an element of the head.
__global__ void merge_kernel(const float* __restrict__ part, const int* __restrict__ base,
                             float* __restrict__ out, int t, int Hq, int D, int ns, int sk,
                             int nkeys) {
  const int h = blockIdx.x, bj = blockIdx.y, d = threadIdx.x;
  const int len = min(max(base[bj / t] + t, 0), nkeys);
  const int n = (len + sk - 1) / sk;  // the splits that hold keys
  const float* p0 = part + ((size_t)bj * Hq + h) * ns * (D + 2);
  float mx = NEG_INF;
  for (int c = 0; c < n; ++c) mx = fmaxf(mx, p0[(size_t)c * (D + 2) + D]);
  float lt = 0.f, a = 0.f;
  for (int c = 0; c < n; ++c) {
    const float* pc = p0 + (size_t)c * (D + 2);
    const float w = expf(pc[D] - mx);
    lt = fmaf(w, pc[D + 1], lt);
    if (d < D) a = fmaf(w, pc[d], a);
  }
  if (d < D) out[((size_t)bj * Hq + h) * D + d] = lt == 0.f ? 0.f : a / lt;
}

template <typename T, bool QUANT, int MG>
int launch(cudaStream_t st, const float* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* table, const int* base, float* out, float* part, int B,
           int t, int Hq, int Hkv, int D, int PS, int maxp, int sk, int grid_x) {
  constexpr int EPL = epl<T, MG>();
  if (D % EPL != 0) return (int)cudaErrorInvalidValue;
  int lpr_log2 = 0;  // lanes a row: the least power of two that covers D
  while ((EPL << lpr_log2) < D) ++lpr_log2;
  const int ns = (maxp * PS + sk - 1) / sk;
  split_kernel<T, QUANT, MG><<<dim3(min(ns, grid_x), Hkv, B), GROUPS << lpr_log2, 0, st>>>(
      q, (const T*)kp, (const T*)vp, ks, vs, table, base, part, t, Hq, Hkv, D, PS, maxp, sk, ns,
      lpr_log2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<dim3(Hq, B * t), (D + 31) & ~31, 0, st>>>(part, base, out, t, Hq, D, ns, sk,
                                                          maxp * PS);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int by_rows(int R, cudaStream_t st, const float* q, const void* kp, const void* vp,
            const float* ks, const float* vs, const int* table, const int* base, float* out,
            float* part, int B, int t, int Hq, int Hkv, int D, int PS, int maxp, int sk,
            int grid_x) {
#define PA_SPLIT(MG) launch<T, QUANT, MG>(st, q, kp, vp, ks, vs, table, base, out, part, B, \
                                                t, Hq, Hkv, D, PS, maxp, sk, grid_x)
  if (R <= 1) return PA_SPLIT(1);
  if (R <= 2) return PA_SPLIT(2);
  if (R <= 4) return PA_SPLIT(4);
  if (R <= 8) return PA_SPLIT(8);
#undef PA_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

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

// The window arm on the tensor cores: the same contract as paged_attention
// for t > 1 over int8 (kv_type KV_INT8, with ks/vs) or bf16 (KV_BF16)
// pages; D a multiple of 16 (int8) or 8 (bf16), at most 128.
extern "C" int paged_attention_window(const void* q, const void* k_pages, const void* v_pages,
                                      const void* ks, const void* vs, const void* table,
                                      const void* base, void* out, int B, int t, int Hq, int Hkv,
                                      int D, int PS, int maxp, int kv_type, void* stream) {
  const bool int8 = kv_type == KV_INT8;
  if ((!int8 && kv_type != KV_BF16) || D % (int8 ? 16 : 8) != 0 || D > MAXD || Hkv <= 0 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = t * (Hq / Hkv);
  dim3 grid(B, Hkv, (rows + TC_ROWS - 1) / TC_ROWS);
  cudaStream_t st = (cudaStream_t)stream;
  if (int8)
    return launch_window_tc<true>(grid, st, (const float*)q, k_pages, v_pages, (const float*)ks,
                                  (const float*)vs, (const int*)table, (const int*)base,
                                  (float*)out, t, Hq, Hkv, D, PS, maxp);
  return launch_window_tc<false>(grid, st, (const float*)q, k_pages, v_pages, nullptr, nullptr,
                                 (const int*)table, (const int*)base, (float*)out, t, Hq, Hkv, D,
                                 PS, maxp);
}

// The arm "split": the contract of paged_attention (q f32 [B, t, Hq, D]
// scaled, out f32 [B, t, Hq, D]) for any page type, D a multiple of 8 up to
// 128 and t * G <= 8 window rows a kv head (decode: t = 1, G = Hq / Hkv <=
// 8); sk keys a split (whole pages: the wrapper's split_keys), grid_x
// blocks a (slot, kv head) taking every grid_x-th split, part f32 [B, t,
// Hq, ceil(maxp * PS / sk), D + 2] (each split's unnormalised output, max
// and sum).  Two launches: the splits, the merge.
extern "C" int paged_attention_split(const void* q, const void* k_pages, const void* v_pages,
                                     const void* ks, const void* vs, const void* table,
                                     const void* base, void* out, void* part, int B, int t,
                                     int Hq, int Hkv, int D, int PS, int maxp, int kv_type, int sk,
                                     int grid_x, void* stream) {
  if (D % 8 != 0 || D > split::SMAXD || Hkv <= 0 || Hq % Hkv != 0 || t < 1 ||
      t * (Hq / Hkv) > 8 ||
      sk <= 0 || sk % PS != 0 || grid_x < 1 || (kv_type == KV_INT8) != (ks != nullptr))
    return (int)cudaErrorInvalidValue;
  const int R = t * (Hq / Hkv);
  cudaStream_t st = (cudaStream_t)stream;
#define PA_ARGS R, st, (const float*)q, k_pages, v_pages, (const float*)ks, \
    (const float*)vs, (const int*)table, (const int*)base, (float*)out, (float*)part, B, t, Hq, \
    Hkv, D, PS, maxp, sk, grid_x
  switch (kv_type) {
    case KV_INT8:
      return split::by_rows<int8_t, true>(PA_ARGS);
    case KV_F32:
      return split::by_rows<float, false>(PA_ARGS);
    case KV_BF16:
      return split::by_rows<__nv_bfloat16, false>(PA_ARGS);
  }
#undef PA_ARGS
  return (int)cudaErrorInvalidValue;
}
