// pb_planar_v1 — PBW-v1 planar matmul for Hopper (sm_90a), decode (m < 256).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_planar_kernel (entry _planar_call).
// For x [m, ic] f32, the low-code bit planes B_j, the salient mask plane M
// and the element-wise high codes V (zero where not salient):
//
//   y = sum_g [rs_g*beta_g + (x . C)_g*alpha2_g + (x . M)_g*gamma2_g]
//       + (x . V)*hs + bias
//
// g runs over the low-scale groups, C = sum_j 2^j * B_j is the low code
// ({0,1} planes; the TPU kernel's {0,2} planes carry the factor 2 that lives
// in alpha2 = 2*alpha and gamma2 = 2*gamma here, which is exact), rs_g the
// row sum of x over the group's rows.  A pack block never straddles a group,
// so one word row of a plane (32 weight rows, one per bit) has one group.
// 8-bit codes are bytes; 4-bit codes are nibbles, byte row q of a pack block
// holding rows q (low nibble) and q + rows/2 (high nibble).
//
// Layout read as stored: bit b of word gi in pack block blk holds weight
// row blk_off + b*g + gi (g = rows_in_block / 32).
//
// What bounds it on the H100: bytes.  10 bits a weight (sign, mask and an
// 8-bit code) plus x: at m = 8, 2048x8192 is 21.0 MB (6.3 us at 3.35 TB/s)
// and 4096x11008 56.4 MB (16.8 us).  Design, simple first: a block owns 32
// output columns (one a lane) and 8 rows of x; its 8 warps take one word row
// each of a chunk of 8 word rows.  Each chunk's x (256 weight rows by 8) is
// staged in shared memory as [word][bit][row], so a lane reads the 8 rows of
// one weight row with two 16-byte broadcast loads, and the chunk's codes (256
// rows by 32 columns) are staged with 16-byte loads; neighbouring lanes read
// neighbouring plane words.  Addresses past the planes are clamped and their
// values zeroed.  A warp folds each word row's three products into its running
// sum with the row's group coefficients; the warps' sums are reduced in
// shared memory in a fixed order.  Rows of m past 8 take more blocks.  No
// tensor cores and no copy pipeline: that is later work.
//
// The epilogue (total + acc_v*hs) + bias uses __fmul_rn/__fadd_rn in the
// plain PyTorch version's order (pb_llm_tpu_torch/ops/packed_matmul_v1.py::
// pb_planar_v1_plain); the products sum in another order than its
// torch.matmul.
//
// That kernel is the arm "cores" (packed_matmul_v1.planar_arm), kept as a
// yardstick and for the layouts the arm "tc" does not take.  Measured on an
// "NVIDIA H100 80GB HBM3, 700.00 W" (chip_smoke.py phase 2): 0.0561 ms at
// m = 8 on 2048x8192 against a 0.0064 ms byte bound; its arithmetic (3
// CUDA-core operations a weight and row) alone comes to about 13 us there.
//
// Arm "tc" (pb_planar_v1_tc): the same function on the bf16 tensor cores
// (wgmma bf16 -> f32, TMA, mbarriers), after pb_select_v1.cu's arm "tc".
//   Exact operands.  C (a low code <= 15), M (0/1) and V (a code <= 255)
//   are small integers, exact in bf16: they are wgmma's A as they are,
//   built in registers from the planes (the product taken transposed: M =
//   the block's output columns, 64 a warpgroup; N = x rows).  x goes in as
//   three bf16 terms (pb_v1_terms.cuh: nearest even, summing to x exactly),
//   in the K order that reads a word's 32 bits as 32 neighbouring k, written
//   with the stage row sums by one launch before the matmul.  Every
//   product is exact in f32; no real-valued weight is rebuilt.
//   Terms stacked.  The three terms' TN x rows are one wgmma N of 3*TN
//   rows (TN = 8 up to 8 rows, else 16), so a k step builds each plane's A
//   once and one m64n(3TN)k16 product a plane yields the three term
//   partials apart: a stage's partials (C, M, V, each fresh) sum t2 + t1,
//   then + t0, in f32.
//   Group folds.  A stage is four sign words (128 k) inside one scale group
//   (the arm takes groups of a multiple of 128 rows, or one group:
//   packed_matmul_v1.planar_tc_ok); at its end each row and column folds
//   rs*beta + xc*2alpha + xm*2gamma of the stage's group into a running f32
//   sum, in the plain version's order, and xv into a second.  rs is the
//   stage's row sum from the terms launch.
//   Copies.  The 8-bit code plane is 80% of the bytes, and a word's 32 code
//   rows lie g rows apart: each is a run of the block's columns.  A block
//   owns OCT = 128 columns (two warpgroups): 128-byte runs, one swizzled TMA
//   box a word (256-byte runs, two boxes side by side on 256 columns, took
//   longer on every shape measured: PERF.md; scripts/torch_tc_arm_variants.py
//   times that copy).  A ring of up to 8 stages on mbarriers keeps about 96 KB in
//   flight a block, thread 0 refilling a slot once every warpgroup is done
//   with it.
//   K split.  The stages of a tile are cut into ks ranges
//   (packed_matmul_v1.planar_ksplit: from the layer's shape alone, so a
//   row's sums run in one order whatever m is), one block each, the ks
//   blocks of a tile one cluster; each leaves its range's two sums in its
//   shared memory, and each adds, for OCT/ks of the tile's columns, the
//   ranges' sums in range order through distributed shared memory and runs
//   the epilogue.  No partial sum goes through device memory, and oc = 2048
//   (OPT-1.3B's fc2 and attention outputs) makes 128 blocks where the arm
//   "cores" made 64.
//   What bounds it: the bytes, as above; the tensor cores' work is
//   3 planes * 2*3TN*ic*oc, 0.0026 ms at m = 8 on 2048x8192.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_sm90.cuh"
#include "pb_v1_terms.cuh"

namespace {

constexpr int TM = 8;                 // rows of x per block
constexpr int TN = 32;                // output columns per block (one a lane)
constexpr int WARPS = 8;              // word rows per chunk, one a warp
constexpr int THREADS = TN * WARPS;
constexpr int CW = WARPS;
constexpr int XSTRIDE = 32 * TM + 4;  // floats per staged word row (padded)
constexpr int XSTAGE = CW * 32 * TM / THREADS;       // x values a thread stages per chunk
constexpr int VSTAGE = CW * 32 * TN / 16 / THREADS;  // 16-byte code loads a thread issues
static_assert(TM * TN == THREADS && TN % 16 == 0, "tile shape");

// first row and word-row stride of the pack block holding word row wr
__device__ __forceinline__ void block_of(int wr, int ic, int pack_block, int& blk_off, int& g) {
  blk_off = (wr * 32 / pack_block) * pack_block;
  g = min(pack_block, ic - blk_off) / 32;
}

template <int LOW_BITS, int SIDE_BITS>
__global__ void __launch_bounds__(THREADS)
pb_planar_v1_kernel(const float* __restrict__ x, const uint32_t* __restrict__ sign,
                    const uint32_t* __restrict__ mask, const uint8_t* __restrict__ side,
                    const float* __restrict__ coef, float* __restrict__ out, int m, int ic,
                    int oc, int pack_block, int groupsize, int n_groups) {
  __shared__ __align__(16) float xs[CW * XSTRIDE];
  __shared__ __align__(16) uint8_t vs[CW * 32 * TN];
  __shared__ float red_t[WARPS][TM][TN];
  __shared__ float red_v[WARPS][TM][TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * TN;
  const int col = col0 + lane;
  const int m0 = blockIdx.y * TM;
  const int nwords = ic / 32;

  float tot[TM];
  float acc_v[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { tot[i] = 0.f; acc_v[i] = 0.f; }

  for (int w0 = 0; w0 < nwords; w0 += CW) {
    // this warp's plane words (loaded before the staging so that their
    // latency overlaps it)
    const int wr = w0 + warp;
    const int wrc = min(wr, nwords - 1);
    uint32_t words[LOW_BITS];
#pragma unroll
    for (int j = 0; j < LOW_BITS; ++j) words[j] = sign[((size_t)j * nwords + wrc) * oc + col];
    const uint32_t mword = mask[(size_t)wrc * oc + col];

    // stage xs[wl][b][mi] = x[m0 + mi, row of bit b of word w0 + wl]
#pragma unroll
    for (int k = 0; k < XSTAGE; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int wl = e % CW;
      const int b = (e / CW) % 32;
      const int mi = e / (CW * 32);
      const int ws = min(w0 + wl, nwords - 1);
      int blk_off, g;
      block_of(ws, ic, pack_block, blk_off, g);
      const float v = x[(size_t)min(m0 + mi, m - 1) * ic + blk_off + b * g + (ws - blk_off / 32)];
      xs[wl * XSTRIDE + b * TM + mi] = w0 + wl < nwords ? v : 0.f;
    }
    // stage vs[wl][b][c] = code of (row of bit b of word w0 + wl, column col0 + c)
#pragma unroll
    for (int k = 0; k < VSTAGE; ++k) {
      const int q = threadIdx.x + k * THREADS;
      const int half = q & 1;
      const int rowid = q >> 1;  // wl * 32 + b
      const int wl = rowid >> 5;
      const int b = rowid & 31;
      const int ws = min(w0 + wl, nwords - 1);
      int blk_off, g;
      block_of(ws, ic, pack_block, blk_off, g);
      const int c = ws - blk_off / 32;
      const size_t srow = SIDE_BITS == 8 ? (size_t)(blk_off + b * g + c)
                                         : (size_t)(blk_off / 2 + (b & 15) * g + c);
      uint4 v = *reinterpret_cast<const uint4*>(side + srow * oc + col0 + half * 16);
      if (w0 + wl >= nwords) v = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs + rowid * TN + half * 16) = v;
    }
    __syncthreads();

    if (wr < nwords) {  // warp-uniform
      // row sums of this word row's 32 weight rows, one m row a lane
      float part = 0.f;
      if (lane < TM) {
#pragma unroll 8
        for (int b = 0; b < 32; ++b) part += xs[warp * XSTRIDE + b * TM + lane];
      }
      float rs[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) rs[i] = __shfl_sync(0xffffffffu, part, i);

      float acc_b[TM];
      float acc_m[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) { acc_b[i] = 0.f; acc_m[i] = 0.f; }
      const float* xw = xs + warp * XSTRIDE;
      const uint8_t* vw = vs + warp * 32 * TN + lane;
#pragma unroll 4
      for (int b = 0; b < 32; ++b) {
        const float4 lo = *reinterpret_cast<const float4*>(xw + b * TM);
        const float4 hi = *reinterpret_cast<const float4*>(xw + b * TM + 4);
        const float xv[TM] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint32_t vb = vw[b * TN];
        const float vf = (float)(SIDE_BITS == 8 ? vb : (b < 16 ? (vb & 15u) : (vb >> 4)));
        const bool salient = (mword >> b) & 1u;
        if (LOW_BITS == 1) {
          const bool on = (words[0] >> b) & 1u;
#pragma unroll
          for (int i = 0; i < TM; ++i) acc_b[i] += on ? xv[i] : 0.f;
        } else {
          int code = 0;
#pragma unroll
          for (int j = 0; j < LOW_BITS; ++j) code |= (int)((words[j] >> b) & 1u) << j;
          const float cf = (float)code;
#pragma unroll
          for (int i = 0; i < TM; ++i) acc_b[i] = fmaf(cf, xv[i], acc_b[i]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc_m[i] += salient ? xv[i] : 0.f;
          acc_v[i] = fmaf(xv[i], vf, acc_v[i]);
        }
      }
      // fold the word row's three products with its group's coefficients
      int blk_off, g;
      block_of(wr, ic, pack_block, blk_off, g);
      const int gi = min(blk_off / groupsize, n_groups - 1);
      const float alpha2 = coef[(size_t)gi * oc + col];
      const float beta = coef[(size_t)(n_groups + gi) * oc + col];
      const float gamma2 = coef[(size_t)(2 * n_groups + gi) * oc + col];
#pragma unroll
      for (int i = 0; i < TM; ++i) tot[i] += rs[i] * beta + acc_b[i] * alpha2 + acc_m[i] * gamma2;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_t[warp][i][lane] = tot[i];
    red_v[warp][i][lane] = acc_v[i];
  }
  __syncthreads();

  // ---- epilogue: one output per thread (TM * TN == THREADS) ----
  const int mi = threadIdx.x / TN;
  const int c = threadIdx.x % TN;
  const int row = m0 + mi;
  if (row >= m) return;
  float t = 0.f, v = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    t += red_t[w][mi][c];
    v += red_v[w][mi][c];
  }
  const int ocol = col0 + c;
  const float hs = coef[(size_t)(3 * n_groups) * oc + ocol];
  const float bias = coef[(size_t)(3 * n_groups + 1) * oc + ocol];
  out[(size_t)row * oc + ocol] = __fadd_rn(__fadd_rn(t, __fmul_rn(v, hs)), bias);
}

template <int LOW_BITS, int SIDE_BITS>
void launch(dim3 grid, cudaStream_t st, const float* x, const uint32_t* sign,
            const uint32_t* mask, const uint8_t* side, const float* coef, float* out, int m,
            int ic, int oc, int pack_block, int groupsize, int n_groups) {
  pb_planar_v1_kernel<LOW_BITS, SIDE_BITS><<<grid, THREADS, 0, st>>>(
      x, sign, mask, side, coef, out, m, ic, oc, pack_block, groupsize, n_groups);
}

}  // namespace

// x: f32 [m, ic]; sign: u32 [low_bits * ic/32, oc]; mask: u32 [ic/32, oc];
// side: u8 [ic, oc] or [ic/2, oc]; coef: f32 [3G+2, oc] (2*alpha, beta,
// 2*gamma by group, hs, bias); out: f32 [m, oc].  oc a multiple of 32, ic and
// pack_block of 32, side 16-byte aligned, every pack block inside one group.
extern "C" int pb_planar_v1(const void* x, const void* sign, const void* mask, const void* side,
                            const void* coef, void* out, int m, int ic, int oc, int pack_block,
                            int low_bits, int side_bits, int groupsize, int n_groups,
                            void* stream) {
  if (m <= 0 || ic <= 0 || ic % 32 || oc % TN || pack_block <= 0 || pack_block % 32 ||
      groupsize <= 0 || n_groups <= 0 || (side_bits != 8 && side_bits != 4) ||
      ((uintptr_t)side % 16))
    return (int)cudaErrorInvalidValue;
  dim3 grid(oc / TN, (m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
#define PB_ARGS grid, st, (const float*)x, (const uint32_t*)sign, (const uint32_t*)mask, \
    (const uint8_t*)side, (const float*)coef, (float*)out, m, ic, oc, pack_block, groupsize, n_groups
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

// ---------------------------------------------------------------------------
// arm "tc" (see the note at the top)
// ---------------------------------------------------------------------------

namespace {
namespace v1tc {

using namespace sm90;

constexpr int WPS = 4;        // sign words a stage
constexpr int KS = 32 * WPS;  // k a stage
constexpr int XB = KS / 64;   // x boxes a term and stage: 64 k, one 128-byte swizzled row
constexpr int NS = 2;         // A register sets: one read by the wgmmas in flight, one made
constexpr int RING = 96 * 1024;  // bytes of stages a block keeps
constexpr int MAX_KS = 8;     // K ranges a tile: a portable cluster
constexpr int OCT = 128;      // output columns a block

// a stage: x's term boxes (per 64 k, the three terms' TN rows of 128 bytes
// stacked: 3TN rows), the code
// rows of its WPS words (per word: sr rows x 128 bytes, 128-byte swizzled),
// the sign words [LOW_BITS][WPS][OCT], the mask words [WPS][OCT]
template <int TN, int LOW_BITS, int SIDE_BITS>
struct Cfg {
  static constexpr int threads = 2 * OCT;  // a warpgroup each 64 columns
  static constexpr int N = 3 * TN;
  static constexpr int sr = SIDE_BITS == 8 ? 32 : 16;
  static constexpr int x_box = N * 128;
  static constexpr int x_bytes = XB * x_box;
  static constexpr int side_at = up1024(x_bytes);
  static constexpr int side_bytes = WPS * sr * 128;
  static constexpr int sign_at = side_at + side_bytes;
  static constexpr int sign_bytes = LOW_BITS * WPS * OCT * 4;
  static constexpr int mask_at = sign_at + sign_bytes;
  static constexpr int mask_bytes = WPS * OCT * 4;
  static constexpr int bytes = x_bytes + side_bytes + sign_bytes + mask_bytes;  // a stage's copies
  static constexpr int stage = up1024(mask_at + mask_bytes);
  static constexpr int fit = RING / stage;
  static constexpr int stages = fit < 2 ? 2 : fit > 8 ? 8 : fit;
  static constexpr int total = stages * stage + 1024 + stages * 8;  // + alignment, mbarriers
  static_assert(TN % 8 == 0 && 2 * TN * OCT * 4 <= stages * stage, "tile shape");
};

// the bf16 bits of an integer below 2^8 (exact), on the FP32 pipe: an
// integer-to-float conversion runs at a quarter of its rate, and the A
// registers convert two values a weight
__device__ __forceinline__ unsigned bf(unsigned v) {
  return __float_as_uint(__fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f)) >> 16;
}

// bits b and b+1 of w as bf16 {0, 1} in the low and high halves
__device__ __forceinline__ unsigned bit_pair(uint32_t w, int b) {
  return ((w >> b) & 1u) * 0x3F80u | ((w >> (b + 1)) & 1u) * 0x3F800000u;
}

// One block: OCT columns, TN x rows, the stages of K range blockIdx.z; the
// ks = gridDim.z blocks of a tile are one cluster.
template <int TN, int LOW_BITS, int SIDE_BITS>
__global__ void __launch_bounds__(2 * OCT, 1)
kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap msg,
       const __grid_constant__ CUtensorMap mmk, const __grid_constant__ CUtensorMap msd,
       const float* __restrict__ sums, const float* __restrict__ coef, float* __restrict__ out,
       int m, int ic, int oc, int g, int groupsize, int n_groups) {
  namespace cg = cooperative_groups;
  using C = Cfg<TN, LOW_BITS, SIDE_BITS>;
  constexpr int N = C::N;
  constexpr int STAGE = C::stage;
  constexpr int STAGES = C::stages;
  constexpr int THREADS = C::threads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const int nwords = ic / 32;
  const int n_all = (nwords + WPS - 1) / WPS;
  const int ks = gridDim.z, rg = blockIdx.z;
  const int s0 = rg * n_all / ks, s1 = (rg + 1) * n_all / ks;
  const int oc0 = blockIdx.x * OCT;
  const int m0 = blockIdx.y * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, q = lane & 3;
  // warpgroup warp/4 owns columns 64*(warp/4)..; its warp w%4 the 16 from 16*(w%4);
  // a thread's A registers hold columns cl[0] = wo + gid and cl[1] = cl[0] + 8
  const int wo = 64 * (warp >> 2) + 16 * (warp & 3);
  const int cl[2] = {wo + gid, wo + gid + 8};

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s (words WPS*s..) in slot (s - s0) % STAGES; its copies, issued by
  // thread 0, which states the bytes first; a word past the last reads zeros
  auto load = [&](int s) {
    uint8_t* sb = smem + ((s - s0) % STAGES) * STAGE;
    uint64_t* bar = bars + (s - s0) % STAGES;
    expect(bar, C::bytes);
#pragma unroll
    for (int bx = 0; bx < XB; ++bx)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        tma3(sb + bx * C::x_box + t * TN * 128, &mx, KS * s + 64 * bx, m0, t, bar);
#pragma unroll
    for (int wl = 0; wl < WPS; ++wl) {
      const int w = WPS * s + wl, blk = w / g;
      tma4(sb + C::side_at + wl * C::sr * 128, &msd, oc0, w - blk * g, 0, blk, bar);
    }
    tma3(sb + C::sign_at, &msg, oc0, WPS * s, 0, bar);
    tma2(sb + C::mask_at, &mmk, oc0, WPS * s, bar);
  };

  // the running sums: element e is column cl[(e/2)%2], x row 8(e/4) + 2q + e%2;
  // a stage's partials pc (C), pm (M), pv (V): term t (t0, t1, t2) at t*TN/2..
  float tot[TN / 2];
  float accv[TN / 2];
  float pc[N / 2];
  float pm[N / 2];
  float pv[N / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    tot[e] = 0.f;
    accv[e] = 0.f;
  }
  int cur = -1;  // the group whose coefficients a2, be, g2 hold
  float a2[2] = {0.f, 0.f}, be[2] = {0.f, 0.f}, g2[2] = {0.f, 0.f};

  if (tid == 0)
    for (int s = s0; s < s0 + STAGES - 1 && s < s1; ++s) load(s);
#pragma unroll 1
  for (int s = s0; s < s1; ++s) {
    wait_phase(bars + (s - s0) % STAGES, ((s - s0) / STAGES) & 1);
    __syncthreads();  // every warpgroup is done with stage s-1: its slot is free
    if (tid == 0 && s + STAGES - 1 < s1) load(s + STAGES - 1);
    const uint8_t* sb = smem + ((s - s0) % STAGES) * STAGE;
    // the stage's row sums (asked for before the products, used after them)
    float rsv[TN / 4];
#pragma unroll
    for (int i = 0; i < TN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * i + 2 * q + e;
        rsv[2 * i + e] = row < m ? __ldg(sums + (size_t)s * m + row) : 0.f;
      }
    // the stage's scale group (both words lie in it)
    const int gi = min(((WPS * s) / g) * 32 * g / groupsize, n_groups - 1);
    if (gi != cur) {
#pragma unroll
      for (int cr = 0; cr < 2; ++cr) {
        const int col = oc0 + cl[cr];
        a2[cr] = __ldg(coef + (size_t)gi * oc + col);
        be[cr] = __ldg(coef + (size_t)(n_groups + gi) * oc + col);
        g2[cr] = __ldg(coef + (size_t)(2 * n_groups + gi) * oc + col);
      }
      cur = gi;
    }
    const uint32_t* sg = reinterpret_cast<const uint32_t*>(sb + C::sign_at);
    const uint32_t* mk = reinterpret_cast<const uint32_t*>(sb + C::mask_at);
    unsigned a[NS][3][4];  // two sets: one read by the wgmmas in flight, one being made
#pragma unroll
    for (int wl = 0; wl < WPS; ++wl) {
      uint32_t sw[LOW_BITS][2], mw[2];
#pragma unroll
      for (int cr = 0; cr < 2; ++cr) {
#pragma unroll
        for (int j = 0; j < LOW_BITS; ++j) sw[j][cr] = sg[(j * WPS + wl) * OCT + cl[cr]];
        mw[cr] = mk[wl * OCT + cl[cr]];
      }
      const uint8_t* sd = sb + C::side_at + wl * C::sr * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * wl + h;  // k16 step of the stage
        unsigned(&as)[3][4] = a[kk & 1];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: column cl[r & 1], bits 16h + 2q + 8(r >> 1), +1
          const int cr = r & 1, b = 16 * h + 2 * q + 8 * (r >> 1);
          if (LOW_BITS == 1) {
            as[0][r] = bit_pair(sw[0][cr], b);
          } else {
            unsigned c0 = 0, c1 = 0;
#pragma unroll
            for (int j = 0; j < LOW_BITS; ++j) {
              c0 |= ((sw[j][cr] >> b) & 1u) << j;
              c1 |= ((sw[j][cr] >> (b + 1)) & 1u) << j;
            }
            as[0][r] = bf(c0) | (bf(c1) << 16);
          }
          as[1][r] = bit_pair(mw[cr], b);
          // code rows b, b+1 (nibbles: rows b % 16, b % 16 + 1, one nibble half); the
          // 128-byte swizzle: 16-byte chunk ^ row % 8
          const int r0 = SIDE_BITS == 8 ? b : (b & 15), c = cl[cr];
          unsigned v0 = sd[r0 * 128 + ((((c >> 4) ^ (r0 & 7)) << 4) | (c & 15))];
          unsigned v1 = sd[(r0 + 1) * 128 + ((((c >> 4) ^ ((r0 + 1) & 7)) << 4) | (c & 15))];
          if (SIDE_BITS == 4) {
            v0 = b >= 16 ? v0 >> 4 : v0 & 15u;
            v1 = b >= 16 ? v1 >> 4 : v1 & 15u;
          }
          as[2][r] = bf(v0) | (bf(v1) << 16);
        }
        fence();
        // the three terms' rows of k16 step kk
        const uint64_t d = desc(sb + (kk >> 2) * C::x_box + 32 * (kk & 3));
        Bf16Rs<N>::run(pc, as[0], d, kk > 0);
        Bf16Rs<N>::run(pm, as[1], d, kk > 0);
        Bf16Rs<N>::run(pv, as[2], d, kk > 0);
        commit();
        wait<1>();  // the set made next is free
      }
    }
    wait<0>();  // the stage's shared memory is read before the ring reuses it
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) {  // the terms t2 + t1, then + t0; the group's fold
      const int cr = (e >> 1) & 1;
      const float xc = __fadd_rn(__fadd_rn(pc[TN + e], pc[TN / 2 + e]), pc[e]);
      const float xm = __fadd_rn(__fadd_rn(pm[TN + e], pm[TN / 2 + e]), pm[e]);
      const float xv = __fadd_rn(__fadd_rn(pv[TN + e], pv[TN / 2 + e]), pv[e]);
      const float t = __fadd_rn(__fadd_rn(__fmul_rn(rsv[2 * (e >> 2) + (e & 1)], be[cr]),
                                          __fmul_rn(xc, a2[cr])),
                                __fmul_rn(xm, g2[cr]));
      tot[e] = __fadd_rn(tot[e], t);
      accv[e] = __fadd_rn(accv[e], xv);
    }
  }

  // the range's sums: red[row][col], the folded total, then x.V
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    const int idx = (8 * (e >> 2) + 2 * q + (e & 1)) * OCT + cl[(e >> 1) & 1];
    red[idx] = tot[e];
    red[TN * OCT + idx] = accv[e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every range's sums are in its block's shared memory
  const int cw = OCT / ks;  // this block's columns: rg*cw..
  for (int idx = tid; idx < TN * cw; idx += THREADS) {
    const int row = idx / cw, lc = rg * cw + idx % cw, col = oc0 + lc;
    const float* r0 = cluster.map_shared_rank(red, 0);
    float t = r0[row * OCT + lc], v = r0[TN * OCT + row * OCT + lc];
    for (int k = 1; k < ks; ++k) {  // range order
      const float* rr = cluster.map_shared_rank(red, k);
      t = __fadd_rn(t, rr[row * OCT + lc]);
      v = __fadd_rn(v, rr[TN * OCT + row * OCT + lc]);
    }
    if (m0 + row < m) {
      const float hs = __ldg(coef + (size_t)(3 * n_groups) * oc + col);
      const float bias = __ldg(coef + (size_t)(3 * n_groups + 1) * oc + col);
      out[(size_t)(m0 + row) * oc + col] = __fadd_rn(__fadd_rn(t, __fmul_rn(v, hs)), bias);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

struct Args {
  const void *x, *sign, *mask, *side, *coef;
  void *xt, *sums, *out;
  int m, ic, oc, g, groupsize, n_groups, ksplit;
};

template <int TN, int LOW_BITS, int SIDE_BITS>
int launch(const Args& A, cudaStream_t st) {
  using C = Cfg<TN, LOW_BITS, SIDE_BITS>;
  auto kern = kernel<TN, LOW_BITS, SIDE_BITS>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nwords = A.ic / 32, nblk = A.ic / (32 * A.g);
  const cuuint64_t x_dims[3] = {(cuuint64_t)A.ic, (cuuint64_t)A.m, 3};
  const cuuint64_t x_strides[2] = {(cuuint64_t)A.ic * 2, (cuuint64_t)A.ic * 2 * A.m};
  const cuuint32_t x_box[3] = {64, TN, 1};
  const cuuint64_t sg_dims[3] = {(cuuint64_t)A.oc, (cuuint64_t)nwords, LOW_BITS};
  const cuuint64_t sg_strides[2] = {(cuuint64_t)A.oc * 4, (cuuint64_t)A.oc * 4 * nwords};
  const cuuint32_t sg_box[3] = {OCT, WPS, LOW_BITS};
  const cuuint64_t mk_dims[2] = {(cuuint64_t)A.oc, (cuuint64_t)nwords};
  const cuuint64_t mk_strides[1] = {(cuuint64_t)A.oc * 4};
  const cuuint32_t mk_box[2] = {OCT, WPS};
  // the codes as [blocks][SR][g][oc] bytes: word i of a block is SR rows g apart
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
  int e = v1terms::launch_terms<3, WPS>((const float*)A.x, A.xt, (float*)A.sums, A.m, A.ic, A.g,
                                         st);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(A.oc / OCT, (A.m + TN - 1) / TN, A.ksplit);
  cfg.blockDim = dim3(C::threads);
  cfg.dynamicSmemBytes = C::total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = A.ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t ce = cudaLaunchKernelEx(&cfg, kern, mx, msg, mmk, msd, (const float*)A.sums,
                                            (const float*)A.coef, (float*)A.out, A.m, A.ic, A.oc,
                                            A.g, A.groupsize, A.n_groups);
  return ce != cudaSuccess ? (int)ce : (int)cudaGetLastError();
}

template <int TN>
int launch_bits(const Args& A, int low_bits, int side_bits, cudaStream_t st) {
  const bool s8 = side_bits == 8;
  if (low_bits == 1) return s8 ? launch<TN, 1, 8>(A, st) : launch<TN, 1, 4>(A, st);
  if (low_bits == 2) return s8 ? launch<TN, 2, 8>(A, st) : launch<TN, 2, 4>(A, st);
  if (low_bits == 4) return s8 ? launch<TN, 4, 8>(A, st) : launch<TN, 4, 4>(A, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace v1tc
}  // namespace

// Arm "tc".  x: f32 [m, ic]; xt: bf16 scratch [3, m, ic] and sums: f32
// scratch [ceil(ic/128), m], written here first (pb_v1_terms.cuh); the planes
// as for pb_planar_v1 (each 16-byte aligned); coef f32 [3G+2, oc]; out f32
// [m, oc], oc a multiple of 128; ksplit 1, 2, 4 or 8; pack_block dividing ic
// or at least ic; every scale group a multiple of 128 rows, or one group.  8
// x rows a block up to 8 rows, else 16.
extern "C" int pb_planar_v1_tc(const void* x, void* xt, void* sums, const void* sign,
                               const void* mask, const void* side, const void* coef, void* out,
                               int m, int ic, int oc, int pack_block, int low_bits,
                               int side_bits, int groupsize, int n_groups, int ksplit,
                               void* stream) {
  const int rows = pack_block < ic ? pack_block : ic;
  if (m <= 0 || ic <= 0 || ic % 32 || pack_block <= 0 || pack_block % 32 || ic % rows ||
      groupsize <= 0 || n_groups <= 0 || (n_groups > 1 && groupsize % v1tc::KS) ||
      (side_bits != 8 && side_bits != 4) || oc % v1tc::OCT || ksplit < 1 ||
      ksplit > v1tc::MAX_KS || (ksplit & (ksplit - 1)))
    return (int)cudaErrorInvalidValue;
  const v1tc::Args A{x, sign, mask, side, coef, xt, sums, out,
                     m, ic, oc, rows / 32, groupsize, n_groups, ksplit};
  cudaStream_t st = (cudaStream_t)stream;
  return m > 8 ? v1tc::launch_bits<16>(A, low_bits, side_bits, st)
               : v1tc::launch_bits<8>(A, low_bits, side_bits, st);
}
