// flash_attention — causal or full attention over whole windows for Hopper
// (sm_90a), with an online softmax.
//
// Replaces: pb_llm_tpu/ops/flash_attention.py::_kernel (entry
// flash_attention).  For each batch b, head h and query row i of q, k, v
// [B, T|S, H, D] (equal head counts; callers repeat GQA heads first):
//
//   s_j = (q_i . k_j) * scale     allowed: j < kv_len and (causal: j <= i)
//   out_i = sum_j softmax(s)_j * v_j
//
// with the running max m, normalizer l and rescaled accumulator of the
// flash recurrence, all f32.  A masked score is NEG_INF = -1e30 and its
// weight is 0, so a row with no allowed key gives 0 (l == 0), never NaN.
// DOTS_BF16 rounds q, k, v and the weights p to bf16 before the two
// products (the sums and statistics stay f32).  RESIDUALS also writes m and
// l [B, T, H] (what a ring merge needs).
//
// What bounds it on the H100: operations.  The two products take 4*D
// multiply-adds per (row, allowed key) pair: at B=4, T=2048, H=32, D=128,
// causal, 1.4e11 f32 operations, 2 ms at 67 TFLOP/s; the q, k, v and out
// bytes (537 MB) take 0.16 ms at 3.35 TB/s.  On the bf16 tensor cores each
// product runs once per pair of terms it issues (below): 9 products of 2*D
// operations a pair for f32, 0.62 ms at 989 TFLOP/s; 2 for dots_bf16.
//
// Two arms; flash_attention.flash_arm picks "tc" for every call, "cores"
// only when asked by name.
//
// Arm "cores" (flash_attention): one block of 256 threads per (b*h, 64
// query rows); k and v arrive in tiles of 64 rows; q, k and v tiles sit in
// shared memory in rows padded to 132 floats, so the 16-byte loads of
// neighbouring threads fall on distinct banks.  A thread owns a 4x4 patch
// of the scores tile (rows ty+16i, keys tx+16j) and 4 rows by 8 columns of
// the output; the 16 threads of a row reduce its max and sum with shuffles.
// Key tiles past the causal diagonal or kv_len are skipped.  f32 CUDA cores.
//
// Arm "tc" (flash_attention_tc): the bf16 tensor cores, wgmma bf16 -> f32,
// shaped after FlashAttention-3.  One fused launch (terms_kernel) writes
// q's, k's and v's bf16 terms (t0 = bf16(x), t1 = bf16(x - t0), ..., each
// nearest even, each remainder exact in f32), the head dim padded with zeros
// to DP = 64 or 128, v transposed so that it is a K-major B.  A block owns
// 128 query rows of one (b, h), 64 a warpgroup; q's terms arrive once by TMA
// (128-byte swizzled), k and v in tiles of 64 keys, in two buffers where they
// fit (one for f32 at DP = 128: three q and k terms take 176 KB), each with
// its own mbarriers: k tile j + 2 (or j + 1) is asked for into tile j's
// buffer once both warpgroups have taken S from it, v tile j + 2 once both
// have taken P.V, so each copy overlaps other work.  S = Q.K^T runs
// with A (Q) and B (K) from shared memory into a fresh accumulator per tile;
// the online softmax runs on the accumulator in registers (row max and sum
// over a quad by shuffles, NEG_INF masking of keys at or past kv_len or past
// the row); P's terms are A straight from registers (S's accumulator layout
// is A's fragment layout), v's terms B; each tile's P.V sums into a fresh
// partial, which joins O as fmaf(O, alpha, partial): the tensor cores' f32
// sums truncate (pb_bf16_tc.cuh), so no long sum stays on them.
//   Terms (flash_attention.FLASH_TERMS; the fewest products whose CPU
//   emulation keeps out, l and the running max m within a third of their
//   bounds, tests/test_torch_tc_terms.py): f32 takes q and k in three terms
//   and issues the six products (q, k) = (2,0) (1,1) (0,2) (1,0) (0,1)
//   (0,0), the small ones first (m's 1e-5 bound asks for about 2^-20 of a
//   score); p and v in two terms, three products (1,0) (0,1) (0,0).
//   dots_bf16 takes one term of each, bf16(q).bf16(k) and bf16(p).bf16(v):
//   the plain version's roundings, each product exact in f32.
//   Causal blocks skip key tiles past their last row, a warpgroup those past
//   its own; the grid starts the longest rows first.
//   What holds it back: the terms launch's bytes (0.94 GB at B=4, T=2048,
//   H=32, D=128), one k and v buffer for f32 at DP = 128, and both
//   warpgroups running the softmax at once while the tensor cores wait
//   (PERF.md, §6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAXD = 128;
constexpr int DP = MAXD + 4;  // padded row stride (floats)
constexpr int PP = BK + 1;    // padded weights row stride
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM = (size_t)(3 * BQ * DP + BQ * PP) * sizeof(float);
static_assert(BQ == BK, "one tile shape for q, k and v");

template <bool BF16>
__device__ __forceinline__ float dot_in(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// rows [r0, r0 + BQ) of one (b, h) slice of a [B, N, H, D] tensor into
// dst [BQ][DP]; rows at or past n are zero
template <bool BF16>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int n, int H, int D) {
  const int per_row = D / 4;
  for (int e = threadIdx.x; e < BQ * per_row; e += THREADS) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * H * D + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) =
        make_float4(dot_in<BF16>(v.x), dot_in<BF16>(v.y), dot_in<BF16>(v.z), dot_in<BF16>(v.w));
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int T, int S, int H,
                       int D, int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* qb = q + ((size_t)b * T * H + h) * D;
  const float* kb = k + ((size_t)b * S * H + h) * D;
  const float* vb = v + ((size_t)b * S * H + h) * D;

  load_tile<BF16>(Qs, qb, q0, T, H, D);

  float o[4][8];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  const int kend = causal ? min(kv_len, q0 + BQ) : kv_len;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    load_tile<BF16>(Ks, kb, k0, S, H, D);
    load_tile<BF16>(Vs, vb, k0, S, H, D);
    __syncthreads();

    // scores patch: rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // online softmax, one row at a time over its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < kv_len && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_next) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = dot_in<BF16>(p);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_next;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // o += P . V over this tile: columns tx*4 .. +3 and 64 + tx*4 .. +3
    const int nk = min(BK, kend - k0);
    for (int c = 0; c < nk; ++c) {
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + c * DP + tx * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + c * DP + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + c];
        o[i][0] = fmaf(p, v0.x, o[i][0]);
        o[i][1] = fmaf(p, v0.y, o[i][1]);
        o[i][2] = fmaf(p, v0.z, o[i][2]);
        o[i][3] = fmaf(p, v0.w, o[i][3]);
        o[i][4] = fmaf(p, v1.x, o[i][4]);
        o[i][5] = fmaf(p, v1.y, o[i][5]);
        o[i][6] = fmaf(p, v1.z, o[i][6]);
        o[i][7] = fmaf(p, v1.w, o[i][7]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    float* orow = out + ((size_t)(b * T + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
      if (col < D) orow[col] = o[i][c] * inv;
    }
    if (m_out != nullptr && tx == 0) {
      const size_t r = (size_t)(b * T + row) * H + h;
      m_out[r] = m_i[i];
      l_out[r] = l_i[i];
    }
  }
}

template <bool BF16>
int launch(dim3 grid, cudaStream_t st, const float* q, const float* k, const float* v,
           float* out, float* m_out, float* l_out, int T, int S, int H, int D, int kv_len,
           int causal, float scale) {
  static bool attr_set = false;  // the block needs more than the default 48 KB
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  flash_attention_kernel<BF16><<<grid, THREADS, SMEM, st>>>(q, k, v, out, m_out, l_out, T, S, H,
                                                            D, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {
namespace fatc {

using namespace sm90;

constexpr int THREADS = 256;  // 2 warpgroups, 64 query rows each
constexpr int BQ = 128;       // query rows a block
constexpr int BKEY = 64;      // keys a tile

// the products (q term, k term) of S and (p term, v term) of P.V in issue
// order, the small ones first (flash_attention.FLASH_TERMS); dots_bf16 issues
// (0, 0) alone in both
__host__ __device__ constexpr int qk_products(bool f32) { return f32 ? 6 : 1; }
__host__ __device__ constexpr int pv_products(bool f32) { return f32 ? 3 : 1; }
__device__ constexpr int qk_q(bool f32, int p) { return !f32 ? 0 : p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0; }
__device__ constexpr int qk_k(bool f32, int p) { return !f32 ? 0 : p == 1 || p == 4 ? 1 : p == 2 ? 2 : 0; }
__device__ constexpr int pv_p(bool f32, int p) { return f32 && p == 0 ? 1 : 0; }
__device__ constexpr int pv_v(bool f32, int p) { return f32 && p == 1 ? 1 : 0; }

// shared memory: q's terms [QT][panels][BQ rows x 128 bytes], then nbuf buffers of k's
// terms [KT][panels][BKEY x 128] and v's, transposed, [VT][DP rows x 128 bytes (BKEY
// keys)]; a panel is 64 of the DP columns.  Two buffers where they fit, else one.
template <bool F32, int DP>
struct Cfg {
  static constexpr int qt = F32 ? 3 : 1, kt = qt, pt = F32 ? 2 : 1, vt = pt;
  static constexpr int panels = DP / 64;
  static constexpr int q_bytes = qt * panels * BQ * 128;
  static constexpr int k_bytes = kt * panels * BKEY * 128;
  static constexpr int v_bytes = vt * DP * 128;
  static constexpr int extra = 1024 + 5 * 8;  // alignment, mbarriers (q, k and v per buffer)
  static constexpr int nbuf = q_bytes + 2 * (k_bytes + v_bytes) + extra <= 232448 ? 2 : 1;
  static constexpr int k_at = q_bytes;
  static constexpr int v_at = k_at + nbuf * k_bytes;
  static constexpr int total = v_at + nbuf * v_bytes + extra;
};

// q [B, T, H, D] -> qt [QT, B*H, T, DP]; k -> kt [KT, B*H, S, DP]; v -> vt
// [VT, B*H, DP, Sp] (transposed, keys padded with zeros to Sp): each value in
// its bf16 terms (nearest even, each the rounding of what the earlier left),
// head dim padded with zeros to DP.  blockIdx.z picks q, k or v; a block
// takes 64 rows of one (b, h).
template <int QKT, int VT>
__global__ void __launch_bounds__(256)
terms_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, __nv_bfloat16* __restrict__ qt,
             __nv_bfloat16* __restrict__ kt, __nv_bfloat16* __restrict__ vt, int B, int T, int S,
             int H, int D, int DP, int Sp) {
  __shared__ float tile[64][129];
  const int which = blockIdx.z, bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int BH = B * H, r0 = blockIdx.x * 64;
  if (which < 2) {
    const int n = which == 0 ? T : S;
    const float* src = which == 0 ? q : k;
    __nv_bfloat16* dst = which == 0 ? qt : kt;
    if (r0 >= n) return;
    for (int e = threadIdx.x; e < 64 * DP; e += 256) {
      const int r = r0 + e / DP, d = e % DP;
      if (r >= n) break;
      float x = d < D ? src[((size_t)(b * n + r) * H + h) * D + d] : 0.f;
#pragma unroll
      for (int t = 0; t < QKT; ++t) {
        const __nv_bfloat16 hb = __float2bfloat16_rn(x);
        dst[(((size_t)t * BH + bh) * n + r) * DP + d] = hb;
        x = __fsub_rn(x, __bfloat162float(hb));
      }
    }
    return;
  }
  if (r0 >= Sp) return;
  for (int e = threadIdx.x; e < 64 * D; e += 256) {
    const int r = e / D, d = e % D;
    tile[r][d] = r0 + r < S ? v[((size_t)(b * S + r0 + r) * H + h) * D + d] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < DP * 64; e += 256) {
    const int d = e / 64, r = e % 64;
    if (r0 + r >= Sp) continue;
    float x = d < D ? tile[r][d] : 0.f;
#pragma unroll
    for (int t = 0; t < VT; ++t) {
      const __nv_bfloat16 hb = __float2bfloat16_rn(x);
      vt[(((size_t)t * BH + bh) * DP + d) * Sp + r0 + r] = hb;
      x = __fsub_rn(x, __bfloat162float(hb));
    }
  }
}

template <bool F32, int DP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
       const __grid_constant__ CUtensorMap mv, float* __restrict__ out,
       float* __restrict__ m_out, float* __restrict__ l_out, int T, int H, int D, int BH,
       int kv_len, int causal, float scale) {
  using C = Cfg<F32, DP>;
  constexpr int NQK = qk_products(F32), NPV = pv_products(F32), PT = C::pt;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  constexpr int NB = C::nbuf;
  // mbarriers: q, then k and v of buffer b at 1 + 2b, 2 + 2b
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::v_at + NB * C::v_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, qd = lane & 3, wg = warp >> 2;
  const int qtile = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int q0 = qtile * BQ, bh = blockIdx.y;
  // this thread's two query rows (accumulator rows gid and gid + 8 of its warp)
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + gid;
  const int rows[2] = {row0, row0 + 8};
  const int kend = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int n_tiles = (kend + BKEY - 1) / BKEY;

  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * NB; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // key tile j lies in buffer j % NB
  auto k_buf = [&](int j) { return smem + C::k_at + (j % NB) * C::k_bytes; };
  auto v_buf = [&](int j) { return smem + C::v_at + (j % NB) * C::v_bytes; };
  auto load_k = [&](int j) {
    uint64_t* bar = bars + 1 + 2 * (j % NB);
    expect(bar, C::k_bytes);
#pragma unroll
    for (int t = 0; t < C::kt; ++t)
#pragma unroll
      for (int p = 0; p < C::panels; ++p)
        tma3(k_buf(j) + (t * C::panels + p) * BKEY * 128, &mk, 64 * p, BKEY * j, t * BH + bh,
             bar);
  };
  auto load_v = [&](int j) {
    uint64_t* bar = bars + 2 + 2 * (j % NB);
    expect(bar, C::v_bytes);
#pragma unroll
    for (int t = 0; t < C::vt; ++t) tma3(v_buf(j) + t * DP * 128, &mv, BKEY * j, 0, t * BH + bh, bar);
  };
  if (tid == 0 && n_tiles > 0) {  // nothing is copied for a block that reads no key
    expect(bars, C::q_bytes);
#pragma unroll
    for (int t = 0; t < C::qt; ++t)
#pragma unroll
      for (int p = 0; p < C::panels; ++p)
        tma3(smem + (t * C::panels + p) * BQ * 128, &mq, 64 * p, q0, t * BH + bh, bars);
    for (int j = 0; j < NB && j < n_tiles; ++j) {
      load_k(j);
      load_v(j);
    }
  }

  float o[DP / 2];    // O: element 4i + c is row rows[c/2], column 8i + 2qd + c%2
  float op[DP / 2];   // a tile's P.V, a fresh partial
  float s[BKEY / 2];  // S: element 4i + c is row rows[c/2], key 8i + 2qd + c%2
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
  if (n_tiles > 0) wait_phase(bars, 0);

#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKEY;
    // a tile wholly past this warpgroup's last causal row changes nothing
    const bool active = !causal || k0 <= q0 + 64 * wg + 63;
    wait_phase(bars + 1 + 2 * (j % NB), (j / NB) & 1);
    if (active) {
      fence();
#pragma unroll
      for (int p = 0; p < NQK; ++p)
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          const int pa = kd >> 2, off = 32 * (kd & 3);
          const uint8_t* qa = smem + (qk_q(F32, p) * C::panels + pa) * BQ * 128 + wg * 64 * 128;
          const uint8_t* kb = k_buf(j) + (qk_k(F32, p) * C::panels + pa) * BKEY * 128;
          Bf16Ss<BKEY>::run(s, desc(qa + off), desc(kb + off), p + kd > 0);
        }
      commit();
      wait<0>();
    }
    __syncthreads();  // both warpgroups are done with k tile j
    if (tid == 0 && j + NB < n_tiles) load_k(j + NB);

    unsigned a[PT][BKEY / 16][4];  // P's terms as A: k16 step kk, registers r
    float alpha[2] = {1.f, 1.f};
    if (active) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < BKEY / 2; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * qd + (e & 1), r = rows[(e >> 1) & 1];
        const bool ok = key < kv_len && (!causal || key <= r);
        s[e] = ok ? s[e] * scale : NEG_INF;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
      float sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        m_new[hr] = fmaxf(m_i[hr], mx[hr]);
        alpha[hr] = expf(m_i[hr] - m_new[hr]);
      }
#pragma unroll
      for (int e = 0; e < BKEY / 2; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * qd + (e & 1), r = rows[(e >> 1) & 1];
        const bool ok = key < kv_len && (!causal || key <= r);
        s[e] = ok ? expf(s[e] - m_new[(e >> 1) & 1]) : 0.f;
        sum[(e >> 1) & 1] += s[e];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
        sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
        l_i[hr] = alpha[hr] * l_i[hr] + sum[hr];
        m_i[hr] = m_new[hr];
      }
      // A register r of k16 step kk: row rows[r & 1], keys 16kk + 2qd + 8(r >> 1), +1,
      // which S holds as elements 4(2kk + (r >> 1)) + 2(r & 1), +1
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          float lo = s[e], hi = s[e + 1];
#pragma unroll
          for (int t = 0; t < PT; ++t) {
            const __nv_bfloat162 hb = __floats2bfloat162_rn(lo, hi);
            a[t][kk][r] = *reinterpret_cast<const unsigned*>(&hb);
            lo = __fsub_rn(lo, __low2float(hb));
            hi = __fsub_rn(hi, __high2float(hb));
          }
        }
    }
    wait_phase(bars + 2 + 2 * (j % NB), (j / NB) & 1);
    if (active) {
      fence();
#pragma unroll
      for (int p = 0; p < NPV; ++p)
#pragma unroll
        for (int kk = 0; kk < BKEY / 16; ++kk)
          Bf16Rs<DP>::run(op, a[pv_p(F32, p)][kk],
                          desc(v_buf(j) + pv_v(F32, p) * DP * 128 + 32 * kk), p + kk > 0);
      commit();
      wait<0>();
    }
    __syncthreads();  // both warpgroups are done with v tile j
    if (tid == 0 && j + NB < n_tiles) load_v(j + NB);
    if (active) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] = fmaf(o[e], alpha[(e >> 1) & 1], op[e]);
    }
  }

  const int b = bh / H, h = bh - b * H;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = rows[hr];
    if (row >= T) continue;
    const float inv = l_i[hr] == 0.f ? 1.f : 1.f / l_i[hr];
    float* orow = out + ((size_t)(b * T + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * qd;  // D % 4 == 0: col < D holds col + 1 < D too
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(__fmul_rn(o[4 * i + 2 * hr], inv), __fmul_rn(o[4 * i + 2 * hr + 1], inv));
    }
    if (m_out != nullptr && qd == 0) {
      const size_t rr = (size_t)(b * T + row) * H + h;
      m_out[rr] = m_i[hr];
      l_out[rr] = l_i[hr];
    }
  }
}

struct Args {
  const float *q, *k, *v;
  float *out, *m_out, *l_out;
  __nv_bfloat16 *qt, *kt, *vt;
  int B, T, S, H, D, kv_len, causal;
  float scale;
};

template <bool F32>
int launch_terms(const Args& A, int DP, int Sp, cudaStream_t st) {
  const int n = A.T > Sp ? A.T : Sp;
  dim3 grid((n + 63) / 64, A.B * A.H, 3);
  terms_kernel<F32 ? 3 : 1, F32 ? 2 : 1><<<grid, 256, 0, st>>>(
      A.q, A.k, A.v, A.qt, A.kt, A.vt, A.B, A.T, A.S, A.H, A.D, DP, Sp);
  return (int)cudaGetLastError();
}

template <bool F32, int DP>
int launch(const Args& A, cudaStream_t st) {
  using C = Cfg<F32, DP>;
  auto kern = kernel<F32, DP>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int BH = A.B * A.H, Sp = (A.S + 7) / 8 * 8;
  const cuuint64_t q_dims[3] = {DP, (cuuint64_t)A.T, (cuuint64_t)C::qt * BH};
  const cuuint64_t q_strides[2] = {DP * 2, (cuuint64_t)A.T * DP * 2};
  const cuuint32_t q_box[3] = {64, BQ, 1};
  const cuuint64_t k_dims[3] = {DP, (cuuint64_t)A.S, (cuuint64_t)C::kt * BH};
  const cuuint64_t k_strides[2] = {DP * 2, (cuuint64_t)A.S * DP * 2};
  const cuuint32_t k_box[3] = {64, BKEY, 1};
  const cuuint64_t v_dims[3] = {(cuuint64_t)Sp, DP, (cuuint64_t)C::vt * BH};
  const cuuint64_t v_strides[2] = {(cuuint64_t)Sp * 2, (cuuint64_t)Sp * DP * 2};
  const cuuint32_t v_box[3] = {BKEY, DP, 1};
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, A.qt, q_dims, q_strides, q_box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, A.kt, k_dims, k_strides, k_box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, A.vt, v_dims, v_strides, v_box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int e = launch_terms<F32>(A, DP, Sp, st);
  if (e != 0) return e;
  dim3 grid((A.T + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, C::total, st>>>(mq, mk, mv, A.out, A.m_out, A.l_out, A.T, A.H, A.D, BH,
                                        A.kv_len, A.causal, A.scale);
  return (int)cudaGetLastError();
}

}  // namespace fatc
}  // namespace

// q: f32 [B, T, H, D]; k, v: f32 [B, S, H, D]; out: f32 [B, T, H, D];
// m_out, l_out: f32 [B, T, H] or null.  D % 4 == 0, D <= 128, kv_len <= S.
// Arm "cores".
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* m_out, void* l_out, int B, int T, int S, int H, int D,
                               int kv_len, int causal, int dots_bf16, float scale,
                               void* stream) {
  if (D % 4 != 0 || D > MAXD || kv_len > S) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  cudaStream_t st = (cudaStream_t)stream;
  if (dots_bf16)
    return launch<true>(grid, st, (const float*)q, (const float*)k, (const float*)v, (float*)out,
                        (float*)m_out, (float*)l_out, T, S, H, D, kv_len, causal, scale);
  return launch<false>(grid, st, (const float*)q, (const float*)k, (const float*)v, (float*)out,
                       (float*)m_out, (float*)l_out, T, S, H, D, kv_len, causal, scale);
}

// Arm "tc".  q: f32 [B, T, H, D]; k, v: f32 [B, S, H, D]; out: f32 [B, T, H,
// D]; m_out, l_out: f32 [B, T, H] or null; qt, kt, vt: bf16 scratch for the
// terms (flash_attention.tc_scratch: [QT, B*H, T, DP], [KT, B*H, S, DP], [VT,
// B*H, DP, Sp] with DP = 64 for D <= 64, else 128, and Sp = S rounded up to
// 8), written here by the terms launch; each 16-byte aligned.  D % 4 == 0,
// D <= 128, kv_len <= S.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                  void* m_out, void* l_out, void* qt, void* kt, void* vt, int B,
                                  int T, int S, int H, int D, int kv_len, int causal,
                                  int dots_bf16, float scale, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D % 4 != 0 || D > MAXD || kv_len < 0 ||
      kv_len > S)
    return (int)cudaErrorInvalidValue;
  const fatc::Args A{(const float*)q, (const float*)k, (const float*)v, (float*)out,
                     (float*)m_out, (float*)l_out, (__nv_bfloat16*)qt, (__nv_bfloat16*)kt,
                     (__nv_bfloat16*)vt, B, T, S, H, D, kv_len, causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64) return dots_bf16 ? fatc::launch<false, 64>(A, st) : fatc::launch<true, 64>(A, st);
  return dots_bf16 ? fatc::launch<false, 128>(A, st) : fatc::launch<true, 128>(A, st);
}
