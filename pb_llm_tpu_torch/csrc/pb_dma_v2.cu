// pb_dma_v2 — exact f32 PBW-v2 decode matmul with a pipelined copy of its
// operands, for Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_planar_v2_dma_kernel (entry
// _planar_v2_dma_call, decode_dot "dma").  It computes the exact f32 arm's
// function (pb_f32_matmul.cu) for 1-bit lows and one row group:
//
//   y = rs*beta + (x . B')*alpha2 + (xg . V)*hs + rsg*gamma + bias
//
// on the CUDA cores (TF32 would break the exact arm's parity).  B' is the
// {0,1} sign plane (the 2 of the TPU kernel's {0,2} planes lives in alpha2 =
// coef[0]); xg [1, m, k_pad] is x gathered at the salient columns; 8-bit
// codes are bytes, 4-bit codes nibbles that pair slot row r with r + kps/2
// per shard segment.  rs and rsg are the f32 row sums of x and xg.
//
// The TPU kernel exists to overlap the sign-plane stream with the bit-plane
// dots.  Here each block owns 32 output columns and 8 rows of x and streams
// its operands through a two-stage shared-memory ring with the Tensor
// Memory Accelerator's bulk copies (cp.async.bulk, one mbarrier a stage):
// a stage holds CW = 16 word rows of the block's 32 sign-word columns
// (16 x 128 B) and the x values those words multiply (16 words x 32 bits x
// 8 rows of f32, 16 KB, contiguous in the wrapper's [m tile][word][bit][row]
// layout `xt`).  Thread 0 issues chunk c+1 into one stage while the block
// computes on chunk c in the other; a __syncthreads after each chunk frees
// its stage.  The sidecar codes of the block's columns are copied first, on
// their own mbarrier, and waited for only before the salient dot, as the
// TPU kernel does.  Shared memory: 2 x 18 KB for the ring, 32 B a code row
// for up to SIDE_SMEM_ROWS code rows (rows past that are read from device
// memory), and 16 KB for the warps' partial sums.  Blocks run in no order;
// oc is split into 32-column blocks (4096: 128 blocks, 11008: 344), and m
// into 8-row tiles.
//
// What bounds it on the H100: at decode m bytes, the packed planes
// (4096x11008: 5.6 MB of sign words, 4.6 MB of codes), about 3 us at
// 3.35 TB/s.  The select-and-add product (one add a set bit and row, the
// exact f32 arm's arithmetic) costs 2*m*ic*oc f32 operations, which at
// m = 8 is 0.7 GFLOP, about 11 us at 67 TFLOP/s: the CUDA cores' issue rate
// bounds it before the bytes do, as it bounds pb_f32_matmul.
//
// The f32 epilogue uses __fmul_rn/__fadd_rn in the plain PyTorch version's
// order (pb_llm_tpu_torch/ops/packed_matmul.py::pb_f32_matmul_plain); the
// products sum in another order than its torch.matmul.
//
// That kernel is the arm "cores" (decode_arms.dma_arm), kept as a
// yardstick and for the layouts the tensor cores do not take.  The arm
// "split" (pb_dma_v2_split) computes the same function on the bf16 tensor
// cores, after pb_bf16_tc.cuh (its notes hold here: the product taken
// transposed, A the sign words or codes built in registers, B x's terms in
// packed_matmul.tc_pair_columns' order through a TMA ring of stages, one
// unit a stage: a word group of 8 sign words, or 64 sidecar slots):
//   Terms.  x and xg in three exact bf16 terms hi, mid, lo
//   (packed_matmul.split_terms: x = hi + mid*2^-8 + lo*2^-16).  The three
//   terms' x rows are stacked as one wgmma N of 3*TN rows (TN = 8 or 16 x
//   rows a block), so a unit's A is built once, {0, 2} from the sign bits
//   or the code, and one m64n(3TN)k16 product a k step yields the three
//   term partials apart.  Each unit's partials are fresh (the wgmma
//   overwrites them at its first k step) and add into the row's f32
//   accumulator lo * 2^-16, then mid * 2^-8, then hi (exact scalings), with
//   __fadd_rn: the same sums as pb_bf16_tc.cuh's one-term stages, lo ->
//   mid -> hi, which that header explains (the whole K summed on the
//   tensor cores put 3.4e-4 on y).  A k step's A registers are one set for
//   the three terms where pb_bf16_tc.cuh builds three.
//   K split.  A 128-column tile's units are cut into ks ranges
//   (decode_arms.dma_ksplit: 1, 2, 4 or 8, from the layer's shape alone, so
//   a row's sums run in one order whatever m is; decode_arms.dma_ranges),
//   one block each, and the ks blocks of a tile form one cluster.  Each
//   leaves its range's sums in its shared memory; then each block adds, for
//   128/ks of the tile's columns, the ranges' sums in range order through
//   distributed shared memory and runs the epilogue.  No partial sum goes
//   through device memory (a workspace would cost a second launch and
//   ks*m*oc*8 bytes written and read), and at m = 8 the grid is 256-344
//   blocks on llama-7b's shapes where one block a tile made 32-86.
//   Preparation.  pb_prep_dma writes the arm's operands in one launch:
//   x's three terms in tc_pair_columns' order (a block each 1024 places
//   of a row), xg's (gathered by side_idx, zero-padded to 64 slots), and
//   the f32 row sums rs and rsg (accumulated in f64, rounded once).  The terms equal
//   packed_matmul.prepare_tc's bit for bit; the sums lie within
//   packed_matmul.sum_bound of its torch.sum.
//   What bounds it: the bytes of the planes (4096x11008: 5.6 MB of sign
//   words, 4.6 MB of codes, 3 us at 3.35 TB/s); the tensor cores' work,
//   2*3TN*oc*(ic + k_pad) a launch, is 0.003 ms at 8 rows.
//   One code for two TPU kernels.  The same device code (and the same C
//   entry, pb_dma_v2_split) is the exact f32 kernel's arm "split" below
//   packed_matmul.F32_TC rows (pb_f32_matmul.cu's note): it reads each
//   128-column tile's row group (xg's plane t * n_rg + group, rsg's row, as
//   pb_bf16_tc.cuh does) and, for the stacked entry, the layer li from a
//   device int32, offsetting the sign and code rows of maps that span all L
//   layers and the coefficients, so every layer's launch has the same
//   arguments.  At one row group the dma arm and the flat f32 arm make the
//   same launch on the same operands, bit for bit
//   (tests/test_torch_cuda_kernels.py::test_dma_and_f32_split_are_one_code).
//   It replaces pallas_pb.py::_planar_v2_kernel below F32_TC rows and
//   _stacked_f32_kernel at decode rows too.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_bf16_tc.cuh"

namespace {
namespace cores {

constexpr int TM = 8;      // rows of x per block
constexpr int TN = 32;     // output columns per block (one per lane)
constexpr int WARPS = 8;   // each chunk's word rows are split over the warps
constexpr int THREADS = TN * WARPS;
constexpr int CW = 16;     // sign-word rows per stage
constexpr int STAGES = 2;
constexpr int SIGN_BYTES = CW * TN * 4;
constexpr int X_BYTES = CW * 32 * TM * 4;
constexpr int STAGE_BYTES = SIGN_BYTES + X_BYTES;
constexpr int SIDE_SMEM_ROWS = 4096;  // code rows kept in shared memory (128 KB)
static_assert(TM * TN == THREADS && CW % WARPS == 0, "tile shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory; the mbarrier counts them on arrival
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

template <int SIDE_BITS>
__global__ void __launch_bounds__(THREADS)
pb_dma_v2_kernel(const float* __restrict__ xt, const float* __restrict__ xg,
                 const float* __restrict__ rs, const float* __restrict__ rsg,
                 const uint32_t* __restrict__ sign, const uint8_t* __restrict__ side,
                 const float* __restrict__ coef, float* __restrict__ out, int m, int ic, int oc,
                 int k_pad, int kps, int side_smem_rows) {
  extern __shared__ __align__(128) unsigned char smem[];  // [stage 0][stage 1][codes]
  __shared__ __align__(8) uint64_t bars[STAGES + 1];       // the two stages, the codes
  __shared__ float red_b[WARPS][TM][TN];
  __shared__ float red_v[WARPS][TM][TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TN;
  const int mt = blockIdx.y;
  const int m0 = mt * TM;
  const int nwords = ic / 32;
  const int nchunks = (nwords + CW - 1) / CW;
  uint8_t* side_s = smem + STAGES * STAGE_BYTES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES + 1; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c's sign rows (a row past the plane re-reads the last one; its
  // word counts as 0) and its x values into stage c % 2
  auto issue_chunk = [&](int c) {
    unsigned char* st = smem + (c % STAGES) * STAGE_BYTES;
    uint64_t* bar = &bars[c % STAGES];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, STAGE_BYTES);
    for (int r = 0; r < CW; ++r) {
      const int wr = min(c * CW + r, nwords - 1);
      bulk_copy(st + r * TN * 4, sign + (size_t)wr * oc + c0, TN * 4, bar);
    }
    bulk_copy(st + SIGN_BYTES, xt + ((size_t)mt * nchunks + c) * (CW * 32 * TM), X_BYTES, bar);
  };

  // the sidecar codes first, then chunk 0
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(&bars[STAGES], (uint32_t)side_smem_rows * TN);
    __syncwarp();
    for (int j = lane; j < side_smem_rows; j += 32)
      bulk_copy(side_s + j * TN, side + (size_t)j * oc + c0, TN, &bars[STAGES]);
    if (lane == 0) issue_chunk(0);
  }

  // ---- bit-plane product: sum_r x[mi, r] * B'[r, col], select-and-add ----
  float acc_b[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc_b[i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    if (threadIdx.x == 0 && c + 1 < nchunks) issue_chunk(c + 1);
    mbar_wait(&bars[c % STAGES], (c / STAGES) & 1);
    const unsigned char* st = smem + (c % STAGES) * STAGE_BYTES;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st);
    const float* xs = reinterpret_cast<const float*>(st + SIGN_BYTES);
#pragma unroll
    for (int u = 0; u < CW / WARPS; ++u) {
      const int wl = warp + u * WARPS;
      const uint32_t word = c * CW + wl < nwords ? ws[wl * TN + lane] : 0u;
      const float* xw = xs + wl * 32 * TM;
#pragma unroll 4
      for (int b = 0; b < 32; ++b) {
        const float4 lo = *reinterpret_cast<const float4*>(xw + b * TM);
        const float4 hi = *reinterpret_cast<const float4*>(xw + b * TM + 4);
        const float xv[TM] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const bool on = (word >> b) & 1u;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc_b[i] += on ? xv[i] : 0.f;
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // ---- sidecar product: sum_j xg[0, mi, j] * code(j, col) ----
  mbar_wait(&bars[STAGES], 0);
  float acc_v[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc_v[i] = 0.f;
  {
    const float* xgr[TM];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) xgr[mi] = xg + (size_t)min(m0 + mi, m - 1) * k_pad;
    const int half = kps / 2;
    for (int j = warp; j < k_pad; j += WARPS) {
      int prow = j;  // the stored row of slot row j, and its nibble
      bool hi_nib = false;
      if (SIDE_BITS == 4) {
        const int s = j / kps;
        const int r = j - s * kps;
        prow = s * half + (r % half);
        hi_nib = r >= half;
      }
      const uint8_t v = prow < side_smem_rows ? side_s[prow * TN + lane]
                                               : side[(size_t)prow * oc + c0 + lane];
      const float code = SIDE_BITS == 8 ? (float)v : (float)(hi_nib ? (v >> 4) : (v & 15));
#pragma unroll
      for (int mi = 0; mi < TM; ++mi) acc_v[mi] = fmaf(__ldg(xgr[mi] + j), code, acc_v[mi]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < TM; ++mi) {
    red_b[warp][mi][lane] = acc_b[mi];
    red_v[warp][mi][lane] = acc_v[mi];
  }
  __syncthreads();

  // ---- epilogue: one output per thread (TM * TN == THREADS) ----
  const int mi = threadIdx.x / TN;
  const int row = m0 + mi;
  const int ocol = c0 + (threadIdx.x % TN);
  if (row >= m || ocol >= oc) return;
  float ab = 0.f, av = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    ab += red_b[w][mi][threadIdx.x % TN];
    av += red_v[w][mi][threadIdx.x % TN];
  }
  const float alpha2 = coef[ocol];
  const float beta = coef[oc + ocol];
  const float gamma = coef[2 * oc + ocol];
  const float hs = coef[3 * oc + ocol];
  const float bias = coef[4 * oc + ocol];
  float y = __fadd_rn(__fmul_rn(rs[row], beta), __fmul_rn(ab, alpha2));
  y = __fadd_rn(y, __fmul_rn(av, hs));
  y = __fadd_rn(y, __fmul_rn(rsg[row], gamma));
  y = __fadd_rn(y, bias);
  out[(size_t)row * oc + ocol] = y;
}

template <int SIDE_BITS>
int launch(dim3 grid, size_t smem_bytes, cudaStream_t st, const float* xt, const float* xg,
           const float* rs, const float* rsg, const uint32_t* sign, const uint8_t* side,
           const float* coef, float* out, int m, int ic, int oc, int k_pad, int kps,
           int side_smem_rows) {
  cudaError_t err = cudaFuncSetAttribute(pb_dma_v2_kernel<SIDE_BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  pb_dma_v2_kernel<SIDE_BITS><<<grid, THREADS, smem_bytes, st>>>(
      xt, xg, rs, rsg, sign, side, coef, out, m, ic, oc, k_pad, kps, side_smem_rows);
  return (int)cudaGetLastError();
}

}  // namespace cores
}  // namespace

// xt: f32 [ceil(m/8), ceil(ic/32/16)*16, 32, 8], x in [m tile][word][bit][row]
// order (weight row of bit b of word w, zero past ic and m); xg: f32 [1, m,
// k_pad]; rs, rsg: f32 [m]; sign: u32 [ic/32, oc]; side: u8 [k_pad (/2), oc];
// coef: f32 [5, oc] (2*alpha, beta, gamma, hs, bias); out: f32 [m, oc].
// oc % 32 == 0.
extern "C" int pb_dma_v2(const void* xt, const void* xg, const void* rs, const void* rsg,
                         const void* sign, const void* side, const void* coef, void* out,
                         int m, int ic, int oc, int side_bits, int k_pad, int kps, void* stream) {
  using namespace cores;
  if (oc % TN || ic % 32 || (side_bits != 8 && side_bits != 4)) return (int)cudaErrorInvalidValue;
  const int side_rows = side_bits == 4 ? k_pad / 2 : k_pad;
  const int side_smem_rows = side_rows < SIDE_SMEM_ROWS ? side_rows : SIDE_SMEM_ROWS;
  const size_t smem_bytes = (size_t)STAGES * STAGE_BYTES + (size_t)side_smem_rows * TN;
  dim3 grid(oc / TN, (m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
#define PB_ARGS grid, smem_bytes, st, (const float*)xt, (const float*)xg, (const float*)rs, \
    (const float*)rsg, (const uint32_t*)sign, (const uint8_t*)side, (const float*)coef, \
    (float*)out, m, ic, oc, k_pad, kps, side_smem_rows
  const int err = side_bits == 8 ? launch<8>(PB_ARGS) : launch<4>(PB_ARGS);
#undef PB_ARGS
  return err;
}

// ---------------------------------------------------------------------------
// arm "split": the bf16 tensor cores, x in three exact terms, a K split over
// a cluster of blocks (see the note at the top)
// ---------------------------------------------------------------------------

namespace {
namespace split {

using namespace sm90;
using bf16tc::BK;
using bf16tc::GROUP;
using bf16tc::OC;
using bf16tc::SK;

constexpr int THREADS = 256;  // 2 warpgroups, each 64 columns x the 3TN stacked term rows
constexpr int NS = 2;         // A register sets: one read by the wgmma in flight, one made
constexpr int MAX_KS = 8;     // K ranges a tile: a portable cluster

// a stage: a word group (4 boxes of 64 k, each the three terms' TN rows of
// 128 bytes stacked, then the group's 8 sign-word rows of OC words) or a
// sidecar chunk (one such box of xg, then the codes at codes_at: SK rows of
// 128 bytes)
template <int TN>
struct Cfg {
  static constexpr int N = 3 * TN;
  static constexpr int box = N * 128;
  static constexpr int sign_at = 4 * box;
  static constexpr int main_bytes = sign_at + 8 * OC * 4;
  static constexpr int codes_at = up1024(box);
  static constexpr int side_bytes = codes_at + SK * 128;
  static constexpr int stage = up1024(main_bytes > side_bytes ? main_bytes : side_bytes);
  static constexpr int stages = TN == 8 ? 4 : 3;  // two blocks an SM
  static constexpr int total = stages * stage + 1024 + stages * 8;
  static_assert(TN % 8 == 0 && 2 * TN * OC * 4 <= stages * stage, "tile shape");
};

// the bf16 bits of a code below 2^8 (exact), on the FP32 pipe (an
// integer-to-float conversion runs at a quarter of its rate)
__device__ __forceinline__ unsigned code_bits(unsigned v) {
  return __float_as_uint(__fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f)) >> 16;
}

// the three bf16 terms of v (packed_matmul.split_terms), as bf16 bits
__device__ __forceinline__ void trunc_terms(float v, unsigned short* t) {
  const float hi = __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
  const float r = __fmul_rn(__fsub_rn(v, hi), 256.f);
  const float mid = __uint_as_float(__float_as_uint(r) & 0xFFFF0000u);
  const float lo = __fmul_rn(__fsub_rn(r, mid), 256.f);  // exact in bf16
  t[0] = (unsigned short)(__float_as_uint(hi) >> 16);
  t[1] = (unsigned short)(__float_as_uint(mid) >> 16);
  t[2] = (unsigned short)(__float_as_uint(lo) >> 16);
}

__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) v += red[w];
  return v;
}

constexpr int PREP_CHUNK = 4 * THREADS;  // places of x's row a preparation block writes

// the operands, by block (r, y, z): y = 0, x's row r at the places
// PREP_CHUNK*z.. of cols (its terms; a place holding ic reads zero); y = 1
// (z = 0), the row's sum; y = 2 + g (z = 0), row group g's gathered row (its
// terms, kst slots, and its sum)
__global__ void __launch_bounds__(THREADS)
prep_kernel(const float* __restrict__ x, const long long* __restrict__ cols,
            const int* __restrict__ side_idx, unsigned short* __restrict__ xp,
            unsigned short* __restrict__ xgp, float* __restrict__ rs, float* __restrict__ rsg,
            int m, int ic, int icp, int kst, int shards, int kps, int n_rg) {
  __shared__ double red[THREADS / 32];
  const int r = blockIdx.x, y = blockIdx.y, z = blockIdx.z;
  const float* xr = x + (size_t)r * ic;
  unsigned short t[3];
  if (y == 0) {
    const int k0 = z * PREP_CHUNK;
#pragma unroll
    for (int i = 0; i < PREP_CHUNK / THREADS; ++i) {
      const int k = k0 + i * THREADS + threadIdx.x;
      if (k >= icp) break;
      const long long c = __ldg(cols + k);
      trunc_terms(c < ic ? xr[c] : 0.f, t);
#pragma unroll
      for (int j = 0; j < 3; ++j) xp[((size_t)j * m + r) * icp + k] = t[j];
    }
    return;
  }
  if (z != 0) return;
  double sum = 0.0;
  if (y == 1) {
#pragma unroll 4
    for (int i = threadIdx.x; i < ic; i += THREADS) sum += (double)xr[i];
  } else {
    const int g = y - 2, K = shards * kps, ic_s = ic / shards;
#pragma unroll 2
    for (int k = threadIdx.x; k < kst; k += THREADS) {
      const int idx = k < K ? __ldg(side_idx + (size_t)k * n_rg + g) : ic_s;
      const float v = idx < ic_s ? xr[(k / kps) * ic_s + idx] : 0.f;
      sum += (double)v;
      trunc_terms(v, t);
#pragma unroll
      for (int j = 0; j < 3; ++j) xgp[(((size_t)j * n_rg + g) * m + r) * kst + k] = t[j];
    }
  }
  sum = block_sum(sum, red);
  if (threadIdx.x == 0) {
    if (y == 1)
      rs[r] = (float)sum;
    else
      rsg[(size_t)(y - 2) * m + r] = (float)sum;
  }
}

// One block: a 128-column tile (inside row group rgp = its first column /
// col_tile), TN x rows, the units [u0, u1) of K range blockIdx.z; the ks =
// gridDim.z blocks of a tile are one cluster.  STACKED: layer li = *layer
// of the maps' [L] planes (sign rows and code rows offset by li) and of
// coef [L, 5, oc].
template <int SIDE_BITS, int TN, bool STACKED>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const __grid_constant__ bf16tc::Maps M, const float* __restrict__ rs,
       const float* __restrict__ rsg, const float* __restrict__ coef, float* __restrict__ out,
       int m, int ic, int oc, int pack_block, int k_pad, int kps, int col_tile, int n_rg,
       const int* __restrict__ layer) {
  namespace cg = cooperative_groups;
  using C = Cfg<TN>;
  int li = 0;
  if (STACKED) {
    li = __ldg(layer);
    coef += (size_t)li * 5 * oc;
  }
  constexpr int N = C::N;
  constexpr int STAGE = C::stage;
  constexpr int STAGES = C::stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const bf16tc::Geo G = bf16tc::geometry(ic, pack_block);
  const int kst = (k_pad + SK - 1) / SK * SK;
  const int code_rows = SIDE_BITS == 4 ? k_pad / 2 : k_pad;
  const int oc0 = blockIdx.x * OC;
  const int rgp = oc0 / col_tile;  // the tile's row group (a tile lies in one group)
  const int m0 = blockIdx.y * TN;
  const int ks = gridDim.z, rg = blockIdx.z;
  const int n_units = G.ng + kst / SK;
  const int u0 = rg * n_units / ks, n_st = (rg + 1) * n_units / ks - u0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, q = lane & 3;
  const int wo = 64 * (warp >> 2) + 16 * (warp & 3);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage i: unit u0 + i; its copies, issued by thread 0, which states the bytes first
  auto load = [&](int i) {
    uint8_t* sb = smem + (i % STAGES) * STAGE;
    uint64_t* bar = bars + i % STAGES;
    const int u = u0 + i;
    if (u < G.ng) {  // word group u: bf16 256u.. of the three term rows; 8 word rows
      expect(bar, 12 * TN * 128 + 8 * OC * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          tma3(sb + a * C::box + t * TN * 128, &M.x, GROUP * u + BK * a, m0, t, bar);
      const bool full = u < G.nfull * G.ngf;
      const int blk = full ? u / G.ngf : G.nfull;
      const int s = u - blk * G.ngf;
      tma2(sb + C::sign_at, &M.sg, oc0, li * (ic / 32) + blk * G.gf + 8 * s, bar);  // past g: zero x
    } else {  // sidecar slots j0..j0+63: xg's three terms; the code rows of those slots
      const int j0 = (u - G.ng) * SK;
      expect(bar, 3 * TN * 128 + SK * 128);
#pragma unroll
      for (int t = 0; t < 3; ++t) tma3(sb + t * TN * 128, &M.xg, j0, m0, t * n_rg + rgp, bar);
      uint8_t* cs = sb + C::codes_at;
      if (SIDE_BITS == 8) {  // slots past k_pad meet zero xg
        tma2(cs, &M.cd, oc0, li * code_rows + j0, bar);
      } else {  // 8 slots at a time: the packed rows of a shard segment's nibble half
        for (int g = 0; g < SK / 8; ++g) {
          const int j = j0 + 8 * g, sh = j / kps, r = j - sh * kps, half = kps / 2;
          tma2(cs + g * 1024, &M.cd, oc0, li * code_rows + sh * half + (r % half), bar);
        }
      }
    }
  };

  // stg: a unit's fresh partials, term t (hi, mid, lo) at t*TN/2.. (accumulator
  // element 4i + e of term t is column wo + gid + 8(e/2), x row 8(i - t*TN/8) + 2q + e%2)
  float acc_b[TN / 2];
  float acc_v[TN / 2];
  float stg[N / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    acc_b[e] = 0.f;
    acc_v[e] = 0.f;
  }

  if (tid == 0)
    for (int i = 0; i < STAGES - 1 && i < n_st; ++i) load(i);
#pragma unroll 1
  for (int i = 0; i < n_st; ++i) {
    wait_phase(bars + i % STAGES, (i / STAGES) & 1);
    __syncthreads();  // every warpgroup is done with stage i-1: its slot is free
    if (tid == 0 && i + STAGES - 1 < n_st) load(i + STAGES - 1);
    const uint8_t* sb = smem + (i % STAGES) * STAGE;
    const bool words = u0 + i < G.ng;  // a word group, else a sidecar chunk
    unsigned a[NS][4];
    if (words) {
      // the A register of k pair (2j, 2j+1) of column c holds bits p and
      // p+16 of word j as bf16 {0, 2}: columns gid, gid+8; words q, q+4
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(sb + C::sign_at);
      const int c = wo + gid;
      const uint32_t w[4] = {ws[q * OC + c], ws[q * OC + c + 8], ws[(q + 4) * OC + c],
                             ws[(q + 4) * OC + c + 8]};
#pragma unroll
      for (int p = 0; p < 16; ++p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[p % NS][r] = ((w[r] >> p) & 0x00010001u) * 0x4000u;
        fence();
        // bit pair p: box p/4, bytes 32(p%4)..
        Bf16Rs<N>::run(stg, a[p % NS], desc(sb + (p >> 2) * C::box + 32 * (p & 3)), p > 0);
        commit();
        wait<NS - 1>();  // the set made next is free
      }
    } else {
      const uint8_t* cs = sb + C::codes_at;
      const int j0 = (u0 + i - G.ng) * SK;
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: column + 8*(r&1), slots + 8*(r>>1)
          const int col = wo + gid + 8 * (r & 1);
          const int j = kk * 16 + 8 * (r >> 1) + 2 * q;
          // the 128-byte swizzle: 16-byte chunk ^ row % 8
          unsigned v0 = cs[j * 128 + (((col >> 4) ^ (j & 7)) << 4) + (col & 15)];
          unsigned v1 = cs[(j + 1) * 128 + (((col >> 4) ^ ((j + 1) & 7)) << 4) + (col & 15)];
          if (SIDE_BITS == 4) {  // slots j, j+1 lie in one nibble half
            const int nib = ((j0 + j) % kps) >= kps / 2 ? 4 : 0;
            v0 = (v0 >> nib) & 15u;
            v1 = (v1 >> nib) & 15u;
          }
          a[kk % NS][r] = code_bits(v0) | (code_bits(v1) << 16);
        }
        fence();
        Bf16Rs<N>::run(stg, a[kk % NS], desc(sb + 32 * kk), kk > 0);
        commit();
        wait<NS - 1>();
      }
    }
    wait<0>();  // the stage's shared memory is read before the ring reuses it
    auto fold = [&](float s, int e) {  // lo, mid, hi, each scaled exactly
      s = __fadd_rn(s, stg[TN + e] * 0x1p-16f);
      s = __fadd_rn(s, stg[TN / 2 + e] * 0x1p-8f);
      return __fadd_rn(s, stg[e]);
    };
    if (words) {
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc_b[e] = fold(acc_b[e], e);
    } else {
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc_v[e] = fold(acc_v[e], e);
    }
  }

  // the range's sums: red[row][col], the bit plane's, then the sidecar's
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    const int idx = (8 * (e >> 2) + 2 * q + (e & 1)) * OC + wo + gid + 8 * ((e >> 1) & 1);
    red[idx] = acc_b[e];
    red[TN * OC + idx] = acc_v[e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every range's sums are in its block's shared memory
  const int cw = OC / ks;  // this block's columns: rg*cw..
  for (int idx = tid; idx < TN * cw; idx += THREADS) {
    const int row = idx / cw, lc = rg * cw + idx % cw, col = oc0 + lc;
    const float* r0 = cluster.map_shared_rank(red, 0);
    float ab = r0[row * OC + lc], av = r0[TN * OC + row * OC + lc];
    for (int k = 1; k < ks; ++k) {  // range order
      const float* rr = cluster.map_shared_rank(red, k);
      ab = __fadd_rn(ab, rr[row * OC + lc]);
      av = __fadd_rn(av, rr[TN * OC + row * OC + lc]);
    }
    if (m0 + row < m && col < oc)
      out[(size_t)(m0 + row) * oc + col] =
          bf16tc::epilogue(ab, av, m0 + row, col, m, oc, rgp, rs, rsg, coef);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int SIDE_BITS, int TN, bool STACKED>
int launch(const void* xp, const void* xgp, const void* rs, const void* rsg, const void* sign,
           const void* side, const void* coef, void* out, const int* layer, int m, int ic, int oc,
           int pack_block, int k_pad, int kps, int col_tile, int n_rg, int n_layers, int ks,
           cudaStream_t st) {
  using C = Cfg<TN>;
  auto kern = kernel<SIDE_BITS, TN, STACKED>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e == cudaSuccess)  // two blocks an SM: all of its shared memory
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  bf16tc::Maps M;
  if (!bf16tc::maps(&M, TN, 3, SIDE_BITS, xp, xgp, sign, side, m, ic, oc, pack_block, k_pad,
                    n_rg, n_layers))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((oc + OC - 1) / OC, (m + TN - 1) / TN, ks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, M, (const float*)rs, (const float*)rsg,
                                           (const float*)coef, (float*)out, m, ic, oc,
                                           pack_block, k_pad, kps, col_tile, n_rg, layer);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace split
}  // namespace

// Arm "split"'s operands in one launch.  x: f32 [m, ic]; cols: int64 [icp]
// (packed_matmul.tc_pair_columns: the natural column of each place, ic for a
// zero); side_idx: int32 [shards * kps, n_rg]; out: xp bf16 [3, m, icp], xgp
// bf16 [3, n_rg, m, kst] (kst a multiple of 64 >= shards * kps), rs f32 [m],
// rsg f32 [n_rg, m].  All contiguous, on one device.
extern "C" int pb_prep_dma(const void* x, const void* cols, const void* side_idx, void* xp,
                           void* xgp, void* rs, void* rsg, int m, int ic, int icp, int kst,
                           int shards, int kps, int n_rg, void* stream) {
  if (m <= 0 || ic <= 0 || icp <= 0 || shards <= 0 || ic % shards || kps <= 0 || n_rg <= 0 ||
      n_rg >= 65534 || kst < shards * kps || kst % bf16tc::SK)
    return (int)cudaErrorInvalidValue;
  dim3 grid(m, 2 + n_rg, (icp + split::PREP_CHUNK - 1) / split::PREP_CHUNK);
  split::prep_kernel<<<grid, split::THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const long long*)cols, (const int*)side_idx, (unsigned short*)xp,
      (unsigned short*)xgp, (float*)rs, (float*)rsg, m, ic, icp, kst, shards, kps, n_rg);
  return (int)cudaGetLastError();
}

// Arm "split", for the dma kernel and for the exact f32 kernel below
// packed_matmul.F32_TC rows, flat and stacked (one device code: at one row
// group the dma arm and the flat f32 arm make the same launch).  xp: bf16
// [3, m, icp]; xgp: bf16 [3, n_rg, m, kst] (pb_prep_dma); rs f32 [m]; rsg f32
// [n_rg, m]; sign: u32 [n_layers * ic/32, oc]; side: u8 [n_layers * k_pad
// (/2), oc]; coef: f32 [n_layers, 5, oc]; out: f32 [m, oc].  layer: null for
// a flat layer (n_layers 1), else a device int32, the layer li of the
// stack.  A 128-column tile must lie in one row group (col_tile >= oc or a
// multiple of 128); oc a multiple of 16; nibble shard segments of 16
// slots; ksplit 1, 2, 4 or 8.  8 x rows a block up to 8 rows, else 16.
extern "C" int pb_dma_v2_split(const void* xp, const void* xgp, const void* rs, const void* rsg,
                               const void* sign, const void* side, const void* coef, void* out,
                               const void* layer, int m, int ic, int oc, int pack_block,
                               int side_bits, int k_pad, int kps, int col_tile, int n_rg,
                               int n_layers, int ksplit, void* stream) {
  if (m <= 0 || oc % 16 || ic % 32 || pack_block % 32 || (side_bits != 8 && side_bits != 4) ||
      (side_bits == 4 && kps % 16) || ksplit < 1 || ksplit > split::MAX_KS ||
      (ksplit & (ksplit - 1)) || col_tile <= 0 || (col_tile < oc && col_tile % bf16tc::OC) ||
      n_rg < 1 || (oc + col_tile - 1) / col_tile > n_rg || n_layers < 1 ||
      (layer == nullptr && n_layers != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* li = (const int*)layer;
#define PB_SPLIT(SB, TN, ST) split::launch<SB, TN, ST>(xp, xgp, rs, rsg, sign, side, coef, out, \
    li, m, ic, oc, pack_block, k_pad, kps, col_tile, n_rg, n_layers, ksplit, st)
  if (li == nullptr) {
    if (m <= 8) return side_bits == 8 ? PB_SPLIT(8, 8, false) : PB_SPLIT(4, 8, false);
    return side_bits == 8 ? PB_SPLIT(8, 16, false) : PB_SPLIT(4, 16, false);
  }
  if (m <= 8) return side_bits == 8 ? PB_SPLIT(8, 8, true) : PB_SPLIT(4, 8, true);
  return side_bits == 8 ? PB_SPLIT(8, 16, true) : PB_SPLIT(4, 16, true);
#undef PB_SPLIT
}
