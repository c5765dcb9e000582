// pb_pair_v2 — PBW-v2 "pair" decode matmul for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_planar_v2_pair_kernel (entry
// _planar_v2_call with pair=True, decode_dot "pair"), with its sidecar
// helper _v2_salient_terms.  For x [m, ic] f32, the packed sign plane B'
// (1-bit lows) and the salient sidecar V:
//
//   y = rs*beta + (bf16(x) . B'02)*alpha + (bf16(xg) . V)*hs + rsg*gamma + bias
//
// B'02 holds bf16 {0, 2.0}; the kernel folds the 2 back with
// alpha = coef[0]/2 (coef row 0 is 2*scale), which is exact.  The products
// are exact in f32 (bf16 x times {0, 2} or a code <= 255) and sum in f32.
// rs and rsg are the f32 row sums of the unrounded x and xg, from the
// wrapper.  xg [n_rg, m, k_pad] is x gathered at each row group's salient
// columns; a column reads the group col / col_tile (fused layers: one group
// per part).  8-bit codes are bytes; 4-bit codes nibbles that pair slot row
// r with r + kps/2 per shard segment (sharded sidecars).
//
// The layout is made for the tensor cores.  One shift and one AND with
// 0x40004000 turn bits p and p+16 of a sign word into two bf16 values
// {0, 2} in one 32-bit register, which is one B-fragment register of
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (two neighbouring k values
// of one column).  A k16 step covers 8 sign words at one p: k = 2j, 2j+1
// are bits p and p+16 of word j.  The wrapper lays x out pair-permuted
// (pallas_pb.pair_permute_x: in each pack block, column p*2g + 2i + h holds
// x of weight row (p + 16h)*g + i), in bf16, rows padded to 16, so an A
// fragment register is one 32-bit load of two neighbouring bf16.  Each
// thread loads its two sign words per 8-column tile once and makes the B
// registers of all 16 p from them in registers.
//
// What bounds it on the H100: at decode m (8 rows, padded to the MMA's 16)
// bytes, the packed planes (4096x11008: 5.6 MB of sign words, 4.6 MB of
// codes), about 3 us at 3.35 TB/s; the tensor cores' work is 2*16*ic*oc.
// Design, simple first: a block owns 16 rows and 32 output columns (four
// n8 tiles); its 8 warps split the sign words by octets, each warp keeping
// a 16x32 f32 accumulator in registers; the sidecar product stays on the
// CUDA cores (its codes are exact in bf16; one column a lane, the code rows
// split over the warps); the warps' partial sums are reduced in shared
// memory in a fixed order.  No copy pipeline and no wgmma: later work.
//
// The f32 epilogue uses __fmul_rn/__fadd_rn in the plain PyTorch version's
// order (pb_llm_tpu_torch/ops/packed_matmul.py::pb_f32_matmul_plain with
// dot_dtype bf16); the products sum in another order than its torch.matmul.
//
// That kernel is the "mma" arm (decode_arms.pair_arm).  pb_pair_v2_tc runs
// the same function on wgmma and TMA (pb_bf16_tc.cuh, one bf16 term of x,
// with its notes): the "tc" arm from decode_arms.PAIR_TC rows on, and
// below them the "split" arm, the same device code with its K loop split
// over blocks (the ranges' sums added in a fixed order by a second kernel),
// so that a decode launch fills the card.  Layouts the tensor-core code does
// not take stay on the "mma" arm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_bf16_tc.cuh"
#include "pb_v2_side.cuh"

namespace {

constexpr int TM = 16;     // rows of x per block (one m16 MMA tile)
constexpr int NT = 4;      // n8 MMA tiles per block
constexpr int TN = 8 * NT; // output columns per block
constexpr int WARPS = 8;   // the sign-word octets are split over the warps
constexpr int THREADS = 32 * WARPS;
static_assert(TN == 32 && TM * TN == 2 * THREADS, "tile shape");

// bits p and p+16 of w as bf16 {0, 2.0} in the low and high halves
__device__ __forceinline__ uint32_t pair_bits(uint32_t w, int p) {
  const uint32_t s = p <= 14 ? (w << (14 - p)) : (w >> (p - 14));
  return s & 0x40004000u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int SIDE_BITS>
__global__ void __launch_bounds__(THREADS)
pb_pair_v2_kernel(const uint32_t* __restrict__ xp, const float* __restrict__ xg,
                  const float* __restrict__ rs, const float* __restrict__ rsg,
                  const uint32_t* __restrict__ sign, const uint8_t* __restrict__ side,
                  const float* __restrict__ coef, float* __restrict__ out, int m, int ic,
                  int oc, int pack_block, int k_pad, int kps, int col_tile) {
  __shared__ float red_b[WARPS][TM][TN];
  __shared__ float red_v[WARPS][TM][TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // the fragments' row (A, C) and column (B) in the tile
  const int tig = lane & 3;   // the fragments' k pair (A, B) and column pair (C)
  const int c0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int nwords = ic / 32;
  const size_t xrow = (size_t)ic / 2;  // 32-bit bf16 pairs per row of xp

  // ---- bit-plane product on the tensor cores ----
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const uint32_t* xr_lo = xp + (size_t)(m0 + grp) * xrow;      // rows grp and grp + 8
  const uint32_t* xr_hi = xp + (size_t)(m0 + grp + 8) * xrow;  // of the m16 tile
  for (int oct = warp; oct * 8 < nwords; oct += WARPS) {
    // this thread's words j = tig and tig + 4 of the octet: its B columns'
    // sign words and where bit pair p of each sits in the rows of xp
    uint32_t w[2][NT];
    int base[2], g[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wr = oct * 8 + tig + 4 * h;
      const int wc = min(wr, nwords - 1);  // a word past the plane adds 0
      const int blk_off = (wc * 32 / pack_block) * pack_block;
      g[h] = min(pack_block, ic - blk_off) / 32;
      base[h] = blk_off / 2 + (wc - blk_off / 32);  // pair p of word gi: base + p*g
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint32_t v = sign[(size_t)wc * oc + c0 + 8 * t + grp];
        w[h][t] = wr < nwords ? v : 0u;
      }
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const uint32_t a0 = __ldg(xr_lo + base[0] + p * g[0]);
      const uint32_t a1 = __ldg(xr_hi + base[0] + p * g[0]);
      const uint32_t a2 = __ldg(xr_lo + base[1] + p * g[1]);
      const uint32_t a3 = __ldg(xr_hi + base[1] + p * g[1]);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        mma_bf16(acc[t], a0, a1, a2, a3, pair_bits(w[0][t], p), pair_bits(w[1][t], p));
    }
  }
  // C fragment: rows grp / grp + 8, columns 2*tig, 2*tig + 1 of each n8 tile
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    red_b[warp][grp][8 * t + 2 * tig] = acc[t][0];
    red_b[warp][grp][8 * t + 2 * tig + 1] = acc[t][1];
    red_b[warp][grp + 8][8 * t + 2 * tig] = acc[t][2];
    red_b[warp][grp + 8][8 * t + 2 * tig + 1] = acc[t][3];
  }

  // ---- sidecar product on the CUDA cores: one column a lane ----
  {
    const int col = c0 + lane;
    const int grpi = col / col_tile;
    const float* xgr[TM];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi)
      xgr[mi] = xg + ((size_t)grpi * m + min(m0 + mi, m - 1)) * k_pad;
    float av[TM];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) av[mi] = 0.f;
    for (int j = warp; j < k_pad; j += WARPS) {
      const float c = side_code<SIDE_BITS>(side, j, col, oc, kps);
#pragma unroll
      for (int mi = 0; mi < TM; ++mi) av[mi] = fmaf(to_bf16(__ldg(xgr[mi] + j)), c, av[mi]);
    }
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) red_v[warp][mi][lane] = av[mi];
  }
  __syncthreads();

  // ---- epilogue: two outputs per thread ----
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    const int mi = idx / TN;
    const int cl = idx % TN;
    const int row = m0 + mi;
    const int ocol = c0 + cl;
    if (row >= m || ocol >= oc) continue;
    float ab = 0.f, av = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) {
      ab += red_b[w8][mi][cl];
      av += red_v[w8][mi][cl];
    }
    ab *= 0.5f;  // {0, 2} planes: the sum of the {0, 1} product, exactly
    const float g_rs = rsg[(size_t)(ocol / col_tile) * m + row];
    const float alpha2 = coef[ocol];
    const float beta = coef[oc + ocol];
    const float gamma = coef[2 * oc + ocol];
    const float hs = coef[3 * oc + ocol];
    const float bias = coef[4 * oc + ocol];
    float y = __fadd_rn(__fmul_rn(rs[row], beta), __fmul_rn(ab, alpha2));
    y = __fadd_rn(y, __fmul_rn(av, hs));
    y = __fadd_rn(y, __fmul_rn(g_rs, gamma));
    y = __fadd_rn(y, bias);
    out[(size_t)row * oc + ocol] = y;
  }
}

}  // namespace

// xp: bf16 pairs [m_pad, ic/2] (x pair-permuted, rows zero-padded to a
// multiple of 16); xg: f32 [n_rg, m, k_pad]; rs: f32 [m]; rsg: f32 [n_rg, m];
// sign: u32 [ic/32, oc]; side: u8 [k_pad (/2), oc]; coef: f32 [5, oc]
// (2*alpha, beta, gamma, hs, bias); out: f32 [m, oc].  oc % 32 == 0.
extern "C" int pb_pair_v2(const void* xp, const void* xg, const void* rs, const void* rsg,
                          const void* sign, const void* side, const void* coef, void* out,
                          int m, int m_pad, int ic, int oc, int pack_block, int side_bits,
                          int k_pad, int kps, int col_tile, void* stream) {
  if (oc % TN || m_pad % TM || m > m_pad || ic % 32) return (int)cudaErrorInvalidValue;
  dim3 grid(oc / TN, m_pad / TM);
  cudaStream_t st = (cudaStream_t)stream;
#define PB_ARGS (const uint32_t*)xp, (const float*)xg, (const float*)rs, (const float*)rsg, \
    (const uint32_t*)sign, (const uint8_t*)side, (const float*)coef, (float*)out, m, ic, oc, \
    pack_block, k_pad, kps, col_tile
  if (side_bits == 8) {
    pb_pair_v2_kernel<8><<<grid, THREADS, 0, st>>>(PB_ARGS);
  } else if (side_bits == 4) {
    pb_pair_v2_kernel<4><<<grid, THREADS, 0, st>>>(PB_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PB_ARGS
  return (int)cudaGetLastError();
}

// the tensor-core arms: xp bf16 [1, m, icp] (packed_matmul.tc_pair_columns'
// order); xgp bf16 [1, n_rg, m, kst], kst = round_up(k_pad, 64)
// zero-padded; part f32 [ksplit, 2, m, oc], the K split's workspace
// (unused at ksplit 1); the rest as pb_pair_v2.  A 16-row x tile up to 16
// rows, else 64.
extern "C" int pb_pair_v2_tc(const void* xp, const void* xgp, const void* rs, const void* rsg,
                             const void* sign, const void* side, const void* coef, void* out,
                             void* part, int m, int ic, int oc, int pack_block, int side_bits,
                             int k_pad, int kps, int col_tile, int n_rg, int ksplit,
                             void* stream) {
  const bf16tc::Args A{xp, xgp, rs, rsg, sign, side, coef, out, part, m, ic, oc, pack_block,
                       k_pad, kps, col_tile, n_rg, 1, ksplit, nullptr};
  if ((side_bits != 8 && side_bits != 4) || !bf16tc::layout_ok(A, side_bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 16)
    return side_bits == 8 ? bf16tc::launch<1, 8, false, 16>(A, st)
                          : bf16tc::launch<1, 4, false, 16>(A, st);
  return side_bits == 8 ? bf16tc::launch<1, 8, false, 64>(A, st)
                        : bf16tc::launch<1, 4, false, 64>(A, st);
}
