// pb_select_v1 — PBW-v1 select matmul for Hopper (sm_90a): prefill and eval
// (m >= 256, or layers the planar kernel does not take).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_select_kernel and
// _reconstruct_tile (entry _select_call).  Each weight tile is rebuilt from
// the packed planes and the per-group scales, then multiplied:
//
//   w_bin = mean_g + (2*C - 1)*scale_g      (1-bit lows)
//         = scale_g*(C - zero_g)            (2- and 4-bit lows; low_mean
//                                            holds the zero point)
//   w_hi  = hs*(V - hz)
//   w     = w_bin + M*(w_hi - w_bin)
//   y     = x . w + bias
//
// C = sum_j 2^j * B_j is the low code, M the salient mask bit, V the high
// code (bytes, or nibbles: byte row q of a pack block holds rows q and
// q + rows/2).  Every operation of the rebuild is one f32 rounding, written
// with __fmul_rn/__fadd_rn/__fsub_rn so that no FMA contraction changes it:
// the blend rounds otherwise than a select would, and the plain PyTorch
// version (pb_llm_tpu_torch/ops/packed_matmul_v1.py::select_weight) rebuilds
// the same bits.  BF16 (prefill "hybrid_bf16") rounds x and w to bf16; the
// products of two bf16 values are exact in f32, and the sums stay f32.
//
// What bounds it on the H100: operations, 2*m*ic*oc multiply-adds: at m =
// 512, 4096x11008 is 46.2 GFLOP, 0.69 ms on the f32 CUDA cores at 67
// TFLOP/s; on the bf16 tensor cores each product runs once per pair of
// terms it issues (below), 6 for an f32 dot: 0.28 ms at 989 TFLOP/s.
//
// Two arms; packed_matmul_v1.select_arm picks one per call.
//
// Arm "cores" (pb_select_v1): the TPU kernel walks m as its innermost
// sequential grid axis and rebuilds a tile once for every m tile.  Blocks
// here run in no order, so the grid covers (oc tiles, m tiles) and each
// block rebuilds the weight tiles it multiplies.  A block computes 128 rows
// by 64 columns; per step of 32 input rows it stages x (k-major) and the
// rebuilt w tile in shared memory, and each thread accumulates 8 rows by 4
// columns on the f32 CUDA cores.
//
// Arm "tc" (pb_select_v1_tc): the bf16 tensor cores (wgmma bf16 -> f32),
// after pb_bf16_tc.cuh.  The product is taken transposed: the rebuilt
// weights are wgmma's A (M = 128 output columns a block, 64 a warpgroup),
// made in registers; x rows are its N (128 rows a block), B in shared
// memory.  Each weight is rebuilt once a block, for all of its rows.
//   K order.  Inside a pack block of g words, weight row b*g + i is bit b of
//   word i; x's columns are taken word by word (k = 32*W + b for global word
//   W), so a k16 step covers 16 bits of one word and a thread's A registers
//   hold bits 2q, 2q+1, 2q+8, 2q+9 (+16) of two columns' words.  One fused
//   launch (terms_kernel) writes x's bf16 terms in that order: [terms, m, ic].
//   Terms.  An f32 operand v splits into bf16 terms t0 = bf16(v), t1 =
//   bf16(v - t0), t2 = bf16(v - t0 - t1), each nearest even, each
//   remainder exact in f32; three terms sum to v exactly (|v| >= 2^-100).
//   An f32 dot takes x and w in three terms each and issues the six
//   products (x term, w term) = (2,0) (1,1) (0,2) (1,0) (0,1) (0,0), the
//   small ones first (packed_matmul_v1.SELECT_TERMS; the fewest whose CPU
//   emulation stays within a third of the 1e-4 bound,
//   tests/test_torch_tc_terms.py).  All of w's terms meet x's first term,
//   so an x that is one exact term (the identity) reads back w bit for bit.
//   A bf16 dot takes one term each, bf16(x).bf16(w): the plain version's
//   roundings, each product exact in f32.
//   Stages.  A stage is two sign words (64 k): x's term boxes (TMA, 128-byte
//   swizzled, read as K-major B), the two words' sidecar rows (a 4-d TMA
//   box of the 32 rows b*g + i, or 16 nibble-byte rows), their sign and mask
//   words; a ring of 3 (f32) or 4 (bf16) stages on mbarriers, thread 0
//   refilling a slot once both warpgroups are done with it.  The rebuild
//   keeps the cores arm's operations; group scales are read per word where a
//   pack block lies in one group, else per weight.  Two A register sets
//   alternate, one read by the wgmmas in flight while the next is rebuilt.
//   Each stage's products sum on the tensor cores into a fresh f32 partial,
//   which adds into the accumulator with __fadd_rn in stage order: the
//   tensor cores' own f32 sums truncate (pb_bf16_tc.cuh), and a stage's
//   partial is small.
//   K split.  A grid of fewer blocks than the card has multiprocessors
//   (OPT-1.3B's 2048-column layers: 16 column tiles) cuts the stages into
//   ksplit ranges, one a block (blockIdx.z; packed_matmul_v1.select_ksplit);
//   each writes its range's sum, and a second launch (reduce) adds them in
//   range order, then the bias.
//   What holds it back: the rebuild, about 20 instructions a weight for every
//   128 rows of x, which on a warpgroup adds to its wgmmas' time rather than
//   overlapping it (a bf16 dot, one product, takes nearly the six-product
//   time; PERF.md, §6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_sm90.cuh"

namespace {

constexpr int BM = 128;   // rows of x per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 32;    // input rows per step
constexpr int THREADS = 256;
constexpr int RM = 8;     // rows a thread accumulates
constexpr int RN = 4;     // columns a thread accumulates
constexpr int XS = BM + 4;  // floats per staged x row (padded)
constexpr int XLOADS = BM * BK / 4 / THREADS;  // float4 loads of x a thread issues per step
constexpr int WBUILD = BK * BN / THREADS;      // weights a thread rebuilds per step
static_assert((BM / RM) * (BN / RN) == THREADS && THREADS % BN == 0, "tile shape");

template <bool BF16>
__device__ __forceinline__ float dot_in(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int LOW_BITS, int SIDE_BITS, bool BF16>
__global__ void __launch_bounds__(THREADS)
pb_select_v1_kernel(const float* __restrict__ x, const uint32_t* __restrict__ sign,
                    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ side,
                    const float* __restrict__ lscale, const float* __restrict__ lmean,
                    const float* __restrict__ hs, const float* __restrict__ hz,
                    const float* __restrict__ bias, float* __restrict__ out, int m, int ic,
                    int oc, int pack_block, int groupsize, int n_groups) {
  __shared__ __align__(16) float xs[BK][XS];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / RN);  // columns tx*RN ..
  const int ty = tid / (BN / RN);  // rows ty*RM ..
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nwords = ic / 32;
  // the rebuild: this thread's column and its first row in a step
  const int wc = tid % BN;
  const int wk0 = tid / BN;
  const int gcol = n0 + wc;
  const float h_s = hs[gcol];
  const float h_z = hz[gcol];

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < ic; k0 += BK) {
    // stage x[m0 .. m0+BM, k0 .. k0+BK) k-major; rows past m are clamped
#pragma unroll
    for (int q = 0; q < XLOADS; ++q) {
      const int e = tid + q * THREADS;
      const int i = e / (BK / 4);
      const int kq = e % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(
          x + (size_t)min(m0 + i, m - 1) * ic + k0 + kq * 4);
      xs[kq * 4 + 0][i] = dot_in<BF16>(v.x);
      xs[kq * 4 + 1][i] = dot_in<BF16>(v.y);
      xs[kq * 4 + 2][i] = dot_in<BF16>(v.z);
      xs[kq * 4 + 3][i] = dot_in<BF16>(v.w);
    }
    // rebuild w[k0 .. k0+BK, n0 .. n0+BN)
#pragma unroll
    for (int q = 0; q < WBUILD; ++q) {
      const int kk = wk0 + q * (THREADS / BN);
      const int r = k0 + kk;
      const int blk_off = (r / pack_block) * pack_block;
      const int g = min(pack_block, ic - blk_off) / 32;
      const int rl = r - blk_off;
      const int b = rl / g;
      const int word = blk_off / 32 + rl % g;
      int code = 0;
#pragma unroll
      for (int j = 0; j < LOW_BITS; ++j)
        code |= (int)((sign[((size_t)j * nwords + word) * oc + gcol] >> b) & 1u) << j;
      const float mb = (float)((mask[(size_t)word * oc + gcol] >> b) & 1u);
      uint32_t v;
      if (SIDE_BITS == 8) {
        v = side[(size_t)r * oc + gcol];
      } else {
        const int h = 16 * g;  // half the block's rows
        const uint32_t byte = side[(size_t)(blk_off / 2 + rl % h) * oc + gcol];
        v = rl < h ? (byte & 15u) : (byte >> 4);
      }
      const int gi = min(r / groupsize, n_groups - 1);
      const float sc = lscale[(size_t)gi * oc + gcol];
      const float mu = lmean[(size_t)gi * oc + gcol];
      const float c = (float)code;
      const float w_bin = LOW_BITS == 1 ? __fadd_rn(mu, __fmul_rn(2.f * c - 1.f, sc))
                                        : __fmul_rn(sc, __fsub_rn(c, mu));
      const float w_hi = __fmul_rn(h_s, __fsub_rn((float)v, h_z));
      const float w = __fadd_rn(w_bin, __fmul_rn(mb, __fsub_rn(w_hi, w_bin)));
      ws[kk][wc] = dot_in<BF16>(w);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * RM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * RM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[k][tx * RN]);
      const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[RN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = n0 + tx * RN + j;
      out[(size_t)row * oc + col] = bias ? __fadd_rn(acc[i][j], bias[col]) : acc[i][j];
    }
  }
}

template <int LOW_BITS, int SIDE_BITS>
void launch(dim3 grid, cudaStream_t st, bool bf16, const float* x, const uint32_t* sign,
            const uint32_t* mask, const uint8_t* side, const float* lscale, const float* lmean,
            const float* hs, const float* hz, const float* bias, float* out, int m, int ic,
            int oc, int pack_block, int groupsize, int n_groups) {
  if (bf16) {
    pb_select_v1_kernel<LOW_BITS, SIDE_BITS, true><<<grid, THREADS, 0, st>>>(
        x, sign, mask, side, lscale, lmean, hs, hz, bias, out, m, ic, oc, pack_block,
        groupsize, n_groups);
  } else {
    pb_select_v1_kernel<LOW_BITS, SIDE_BITS, false><<<grid, THREADS, 0, st>>>(
        x, sign, mask, side, lscale, lmean, hs, hz, bias, out, m, ic, oc, pack_block,
        groupsize, n_groups);
  }
}

}  // namespace

namespace {
namespace seltc {

using namespace sm90;

constexpr int THREADS = 256;  // 2 warpgroups, each 64 output columns x all TN rows
constexpr int OC = 128;       // output columns a block (wgmma M)
constexpr int TN = 128;       // x rows a block (wgmma N)
constexpr int WPS = 2;        // sign words a stage
constexpr int KS = 32 * WPS;  // k a stage: one 128-byte swizzled box row of bf16 x

// the products (x term, w term) of an f32 dot in issue order
// (packed_matmul_v1.SELECT_TERMS); a bf16 dot issues (0, 0) alone
__host__ __device__ constexpr int n_products(int terms) { return terms == 3 ? 6 : 1; }
__device__ constexpr int px(int terms, int p) {
  return terms == 1 ? 0 : p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0;
}
__device__ constexpr int pw(int terms, int p) {
  return terms == 1 ? 0 : p == 1 || p == 4 ? 1 : p == 2 ? 2 : 0;
}

// a stage: x's term boxes (TERMS x TN rows x 128 bytes), the sidecar rows of
// its WPS words (SR byte rows of 128 columns each, 128-byte swizzled), the
// sign words [LOW_BITS][WPS][OC] and the mask words [WPS][OC]
template <int TERMS, int LOW_BITS, int SIDE_BITS>
struct Cfg {
  static constexpr int sr = SIDE_BITS == 8 ? 32 : 16;
  static constexpr int side_at = TERMS * TN * 128;
  static constexpr int sign_at = side_at + WPS * sr * 128;
  static constexpr int mask_at = sign_at + LOW_BITS * WPS * OC * 4;
  static constexpr int bytes = mask_at + WPS * OC * 4;  // what one stage's copies bring
  static constexpr int stage = up1024(bytes);
  static constexpr int stages = TERMS == 3 ? 3 : 4;
  static constexpr int total = stages * stage + 1024 + stages * 8;  // + alignment, mbarriers
};

// an integer below 2^23 as f32 on the FP32 pipe (exact)
__device__ __forceinline__ float u2f(unsigned v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f);
}

__device__ __forceinline__ unsigned bits2(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// the bf16 terms of a pair (lo, hi) of neighbouring k into out[0..TERMS)
template <int TERMS>
__device__ __forceinline__ void split(float lo, float hi, unsigned* out) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    out[t] = bits2(h);
    lo = __fsub_rn(lo, __low2float(h));
    hi = __fsub_rn(hi, __high2float(h));
  }
}

// xt [TERMS, m, ic] bf16: x's terms with the columns taken word by word
// (k = 32*W + b holds x at weight row (W / g)*32g + b*g + W % g)
template <int TERMS>
__global__ void __launch_bounds__(256)
terms_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xt, int m, int ic, int g) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= ic) return;
  const int w = k >> 5, b = k & 31, blk = w / g;
  const int src = blk * 32 * g + b * g + (w - blk * g);
  for (int row = blockIdx.y; row < m; row += gridDim.y) {
    float v = x[(size_t)row * ic + src];
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      xt[((size_t)t * m + row) * ic + k] = h;
      v = __fsub_rn(v, __bfloat162float(h));
    }
  }
}

template <int TERMS, int LOW_BITS, int SIDE_BITS>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap msg,
       const __grid_constant__ CUtensorMap mmk, const __grid_constant__ CUtensorMap msd,
       const float* __restrict__ lscale, const float* __restrict__ lmean,
       const float* __restrict__ hs, const float* __restrict__ hz,
       const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ part, int m,
       int ic, int oc, int g, int groupsize, int n_groups) {
  using C = Cfg<TERMS, LOW_BITS, SIDE_BITS>;
  constexpr int STAGE = C::stage;
  constexpr int STAGES = C::stages;
  constexpr int NP = n_products(TERMS);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const int nwords = ic / 32;
  const int n_st = (nwords + WPS - 1) / WPS;
  const int pbs = 32 * g;  // rows of a pack block
  const bool word_groups = groupsize >= pbs;  // a pack block lies in one scale group
  const int oc0 = blockIdx.x * OC;
  const int m0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, q = lane & 3;
  // warpgroup warp/4 owns columns 64*(warp/4)..; its warp w%4 the 16 from 16*(w%4);
  // a thread's A registers hold columns cl[0] = wo + gid and cl[1] = cl[0] + 8
  const int wo = 64 * (warp >> 2) + 16 * (warp & 3);
  const int cl[2] = {wo + gid, wo + gid + 8};
  const int cg[2] = {oc0 + cl[0], oc0 + cl[1]};
  const float h_s[2] = {__ldg(hs + cg[0]), __ldg(hs + cg[1])};
  const float h_z[2] = {__ldg(hz + cg[0]), __ldg(hz + cg[1])};

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's stages [s0, s1): the K split's range blockIdx.z; stage s lies in slot
  // (s - s0) % STAGES of the ring
  const int per = (n_st + gridDim.z - 1) / gridDim.z;
  const int s0 = min(n_st, (int)blockIdx.z * per), s1 = min(n_st, s0 + per);

  // stage s: words WPS*s.., its copies, issued by thread 0, which states the bytes first
  auto load = [&](int s) {
    uint8_t* sb = smem + ((s - s0) % STAGES) * STAGE;
    uint64_t* bar = bars + (s - s0) % STAGES;
    expect(bar, C::bytes);
#pragma unroll
    for (int t = 0; t < TERMS; ++t) tma3(sb + t * TN * 128, &mx, KS * s, m0, t, bar);
#pragma unroll
    for (int wl = 0; wl < WPS; ++wl) {  // a word past the last reads zeros
      const int w = WPS * s + wl, blk = w / g;
      tma4(sb + C::side_at + wl * C::sr * 128, &msd, oc0, w - blk * g, 0, blk, bar);
    }
    tma3(sb + C::sign_at, &msg, oc0, WPS * s, 0, bar);
    tma2(sb + C::mask_at, &mmk, oc0, WPS * s, bar);
  };

  float acc[TN / 2];
  float stg[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;

  if (tid == 0)
    for (int i = s0; i < s0 + STAGES - 1 && i < s1; ++i) load(i);
#pragma unroll 1
  for (int s = s0; s < s1; ++s) {
    wait_phase(bars + (s - s0) % STAGES, ((s - s0) / STAGES) & 1);
    __syncthreads();  // every warpgroup is done with stage s-1: its slot is free
    if (tid == 0 && s + STAGES - 1 < s1) load(s + STAGES - 1);
    const uint8_t* sb = smem + ((s - s0) % STAGES) * STAGE;
    const uint32_t* sg = reinterpret_cast<const uint32_t*>(sb + C::sign_at);
    const uint32_t* mk = reinterpret_cast<const uint32_t*>(sb + C::mask_at);
    unsigned a[2][TERMS][4];  // two sets: one read by the wgmmas in flight, one being made
#pragma unroll
    for (int wl = 0; wl < WPS; ++wl) {
      const int w = WPS * s + wl, blk = w / g;
      const int row0 = blk * pbs + (w - blk * g);  // weight row of bit 0; bit b: row0 + b*g
      uint32_t sw[LOW_BITS][2], mw[2];
      float sc[2] = {0.f, 0.f}, mu[2] = {0.f, 0.f};
#pragma unroll
      for (int cr = 0; cr < 2; ++cr) {
#pragma unroll
        for (int j = 0; j < LOW_BITS; ++j) sw[j][cr] = sg[(j * WPS + wl) * OC + cl[cr]];
        mw[cr] = mk[wl * OC + cl[cr]];
        if (word_groups) {
          const size_t gi = (size_t)min(row0 / groupsize, n_groups - 1) * oc + cg[cr];
          sc[cr] = __ldg(lscale + gi);
          mu[cr] = __ldg(lmean + gi);
        }
      }
      const uint8_t* sd = sb + C::side_at + wl * C::sr * 128;
      // the weight at bit b of column cl[cr], as the cores arm rebuilds it
      auto weight = [&](int b, int cr) -> float {
        int code = 0;
#pragma unroll
        for (int j = 0; j < LOW_BITS; ++j) code |= (int)((sw[j][cr] >> b) & 1u) << j;
        float s_c = sc[cr], m_u = mu[cr];
        if (!word_groups) {
          const size_t gi = (size_t)min((row0 + b * g) / groupsize, n_groups - 1) * oc + cg[cr];
          s_c = __ldg(lscale + gi);
          m_u = __ldg(lmean + gi);
        }
        const int r = SIDE_BITS == 8 ? b : (b & 15), c = cl[cr];
        // the 128-byte swizzle: 16-byte chunk ^ row % 8
        unsigned v = sd[r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))];
        if (SIDE_BITS == 4) v = b >= 16 ? v >> 4 : v & 15u;
        const float w_bin = LOW_BITS == 1 ? __fadd_rn(m_u, code ? s_c : -s_c)
                                          : __fmul_rn(s_c, __fsub_rn(u2f(code), m_u));
        const float w_hi = __fmul_rn(h_s[cr], __fsub_rn(u2f(v), h_z[cr]));
        return (mw[cr] >> b) & 1u ? __fadd_rn(w_bin, __fsub_rn(w_hi, w_bin)) : w_bin;
      };
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * wl + h;  // k16 step of the stage
        unsigned(&as)[TERMS][4] = a[kk & 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: column cl[r & 1], bits 16h + 2q + 8(r >> 1), +1
          const int b = 16 * h + 2 * q + 8 * (r >> 1);
          unsigned t[TERMS];
          split<TERMS>(weight(b, r & 1), weight(b + 1, r & 1), t);
#pragma unroll
          for (int i = 0; i < TERMS; ++i) as[i][r] = t[i];
        }
        fence();
#pragma unroll
        for (int p = 0; p < NP; ++p)
          Bf16Rs<TN>::run(stg, as[pw(TERMS, p)], desc(sb + px(TERMS, p) * TN * 128 + 32 * kk),
                          kk + p > 0);
        commit();
        wait<1>();  // the set made next is free
      }
    }
    wait<0>();  // the stage's shared memory is read before the ring reuses it
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[e] = __fadd_rn(acc[e], stg[e]);
  }

  // accumulator element 4i + e is column wo + gid + 8(e/2), x row 8i + 2q + e%2
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int col = cg[hr];
    const float bc = bias ? __ldg(bias + col) : 0.f;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * i + 2 * q + e;
        if (row >= m) continue;
        const float y = acc[4 * i + 2 * hr + e];
        if (gridDim.z > 1)  // the K split: this range's raw sum, added in order by reduce
          part[((size_t)blockIdx.z * m + row) * oc + col] = y;
        else
          out[(size_t)row * oc + col] = bias ? __fadd_rn(y, bc) : y;
      }
    }
  }
}

// the K split's second pass: the ranges' sums in range order, then the bias
__global__ void __launch_bounds__(256)
reduce(const float* __restrict__ part, const float* __restrict__ bias, float* __restrict__ out,
       int m, int oc, int ksplit) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)m * oc;
  if (idx >= n) return;
  float y = part[idx];
  for (int z = 1; z < ksplit; ++z) y = __fadd_rn(y, part[z * n + idx]);
  out[idx] = bias ? __fadd_rn(y, bias[idx % oc]) : y;
}

struct Args {
  const void *x, *sign, *mask, *side, *lscale, *lmean, *hs, *hz, *bias;
  void *xt, *out, *part;
  int m, ic, oc, g, groupsize, n_groups, ksplit;
};

template <int TERMS>
int launch_terms(const Args& A, cudaStream_t st) {
  dim3 grid((A.ic + 255) / 256, A.m < 65535 ? A.m : 65535);
  terms_kernel<TERMS><<<grid, 256, 0, st>>>((const float*)A.x, (__nv_bfloat16*)A.xt, A.m, A.ic,
                                            A.g);
  return (int)cudaGetLastError();
}

template <int TERMS, int LOW_BITS, int SIDE_BITS>
int launch(const Args& A, cudaStream_t st) {
  using C = Cfg<TERMS, LOW_BITS, SIDE_BITS>;
  auto kern = kernel<TERMS, LOW_BITS, SIDE_BITS>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nwords = A.ic / 32, nblk = A.ic / (32 * A.g);
  const cuuint64_t x_dims[3] = {(cuuint64_t)A.ic, (cuuint64_t)A.m, TERMS};
  const cuuint64_t x_strides[2] = {(cuuint64_t)A.ic * 2, (cuuint64_t)A.ic * 2 * A.m};
  const cuuint32_t x_box[3] = {64, TN, 1};
  const cuuint64_t sg_dims[3] = {(cuuint64_t)A.oc, (cuuint64_t)nwords, LOW_BITS};
  const cuuint64_t sg_strides[2] = {(cuuint64_t)A.oc * 4, (cuuint64_t)A.oc * 4 * nwords};
  const cuuint32_t sg_box[3] = {OC, WPS, LOW_BITS};
  const cuuint64_t mk_dims[2] = {(cuuint64_t)A.oc, (cuuint64_t)nwords};
  const cuuint64_t mk_strides[1] = {(cuuint64_t)A.oc * 4};
  const cuuint32_t mk_box[2] = {OC, WPS};
  // the sidecar as [blocks][SR][g][oc] bytes: word i of a block is SR rows g apart
  const cuuint64_t sd_dims[4] = {(cuuint64_t)A.oc, (cuuint64_t)A.g, (cuuint64_t)C::sr,
                                 (cuuint64_t)nblk};
  const cuuint64_t sd_strides[3] = {(cuuint64_t)A.oc, (cuuint64_t)A.oc * A.g,
                                    (cuuint64_t)A.oc * A.g * C::sr};
  const cuuint32_t sd_box[4] = {128, 1, C::sr, 1};
  CUtensorMap mx, msg, mmk, msd;
  if (!encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, A.xt, x_dims, x_strides, x_box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&msg, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, A.sign, sg_dims, sg_strides, sg_box,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&mmk, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, A.mask, mk_dims, mk_strides, mk_box,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&msd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, A.side, sd_dims, sd_strides, sd_box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int e = launch_terms<TERMS>(A, st);
  if (e != 0) return e;
  dim3 grid(A.oc / OC, (A.m + TN - 1) / TN, A.ksplit);
  kern<<<grid, THREADS, C::total, st>>>(mx, msg, mmk, msd, (const float*)A.lscale,
                                        (const float*)A.lmean, (const float*)A.hs,
                                        (const float*)A.hz, (const float*)A.bias, (float*)A.out,
                                        (float*)A.part, A.m, A.ic, A.oc, A.g, A.groupsize,
                                        A.n_groups);
  e = (int)cudaGetLastError();
  if (e != 0 || A.ksplit == 1) return e;
  const size_t n = (size_t)A.m * A.oc;
  reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)A.part, (const float*)A.bias,
                                                      (float*)A.out, A.m, A.oc, A.ksplit);
  return (int)cudaGetLastError();
}

template <int TERMS>
int launch_bits(const Args& A, int low_bits, int side_bits, cudaStream_t st) {
  const bool s8 = side_bits == 8;
  if (low_bits == 1) return s8 ? launch<TERMS, 1, 8>(A, st) : launch<TERMS, 1, 4>(A, st);
  if (low_bits == 2) return s8 ? launch<TERMS, 2, 8>(A, st) : launch<TERMS, 2, 4>(A, st);
  if (low_bits == 4) return s8 ? launch<TERMS, 4, 8>(A, st) : launch<TERMS, 4, 4>(A, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace seltc
}  // namespace

// x: f32 [m, ic] (16-byte aligned); sign: u32 [low_bits * ic/32, oc]; mask:
// u32 [ic/32, oc]; side: u8 [ic, oc] or [ic/2, oc]; lscale, lmean: f32
// [n_groups, oc]; hs, hz: f32 [oc]; bias: f32 [oc] or null; out: f32
// [m, oc].  oc a multiple of 64, ic and pack_block of 32.  Arm "cores".
extern "C" int pb_select_v1(const void* x, const void* sign, const void* mask, const void* side,
                            const void* lscale, const void* lmean, const void* hs,
                            const void* hz, const void* bias, void* out, int m, int ic, int oc,
                            int pack_block, int low_bits, int side_bits, int groupsize,
                            int n_groups, int dot_bf16, void* stream) {
  if (m <= 0 || ic <= 0 || ic % BK || oc % BN || pack_block <= 0 || pack_block % 32 ||
      groupsize <= 0 || n_groups <= 0 || (side_bits != 8 && side_bits != 4) ||
      ((uintptr_t)x % 16))
    return (int)cudaErrorInvalidValue;
  dim3 grid(oc / BN, (m + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = dot_bf16 != 0;
#define PB_ARGS grid, st, bf, (const float*)x, (const uint32_t*)sign, (const uint32_t*)mask, \
    (const uint8_t*)side, (const float*)lscale, (const float*)lmean, (const float*)hs,      \
    (const float*)hz, (const float*)bias, (float*)out, m, ic, oc, pack_block, groupsize, n_groups
  const bool s8 = side_bits == 8;
  if (low_bits == 1) {
    s8 ? launch<1, 8>(PB_ARGS) : launch<1, 4>(PB_ARGS);
  } else if (low_bits == 2) {
    s8 ? launch<2, 8>(PB_ARGS) : launch<2, 4>(PB_ARGS);
  } else if (low_bits == 4) {
    s8 ? launch<4, 8>(PB_ARGS) : launch<4, 4>(PB_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PB_ARGS
  return (int)cudaGetLastError();
}

// Arm "tc".  x: f32 [m, ic]; xt: bf16 scratch [terms, m, ic] (terms 3, or 1
// for dot_bf16), written here by its first launch (terms_kernel); the planes
// as for pb_select_v1, each 16-byte aligned; part: f32 [ksplit, m, oc] for
// ksplit > 1 (packed_matmul_v1.select_ksplit), else unused; oc a multiple of
// 128, ic and pack_block of 32, pack_block dividing ic or at least ic.
extern "C" int pb_select_v1_tc(const void* x, void* xt, const void* sign, const void* mask,
                               const void* side, const void* lscale, const void* lmean,
                               const void* hs, const void* hz, const void* bias, void* out,
                               void* part, int m, int ic, int oc, int pack_block, int low_bits,
                               int side_bits, int groupsize, int n_groups, int dot_bf16,
                               int ksplit, void* stream) {
  const int rows = pack_block < ic ? pack_block : ic;
  if (m <= 0 || ic <= 0 || ic % 32 || oc % seltc::OC || pack_block <= 0 || pack_block % 32 ||
      ic % rows || groupsize <= 0 || n_groups <= 0 || (side_bits != 8 && side_bits != 4) ||
      ksplit < 1 || (ksplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const seltc::Args A{x, sign, mask, side, lscale, lmean, hs, hz, bias, xt, out, part,
                      m, ic, oc, rows / 32, groupsize, n_groups, ksplit};
  cudaStream_t st = (cudaStream_t)stream;
  return dot_bf16 ? seltc::launch_bits<1>(A, low_bits, side_bits, st)
                  : seltc::launch_bits<3>(A, low_bits, side_bits, st);
}

