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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// xt: f32 [ceil(m/8), ceil(ic/32/16)*16, 32, 8], x in [m tile][word][bit][row]
// order (weight row of bit b of word w, zero past ic and m); xg: f32 [1, m,
// k_pad]; rs, rsg: f32 [m]; sign: u32 [ic/32, oc]; side: u8 [k_pad (/2), oc];
// coef: f32 [5, oc] (2*alpha, beta, gamma, hs, bias); out: f32 [m, oc].
// oc % 32 == 0.
extern "C" int pb_dma_v2(const void* xt, const void* xg, const void* rs, const void* rsg,
                         const void* sign, const void* side, const void* coef, void* out,
                         int m, int ic, int oc, int side_bits, int k_pad, int kps, void* stream) {
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
