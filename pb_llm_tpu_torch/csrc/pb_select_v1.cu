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
// What bounds it on the H100: operations, 2*m*ic*oc f32 FMAs on the CUDA
// cores (TF32 would not keep the 1e-4 parity): at m = 512, 2048x8192 is
// 17.2 GFLOP, 0.256 ms at 67 TFLOP/s; 4096x11008 46.2 GFLOP, 0.69 ms.
//
// Design: the TPU kernel walks m as its innermost sequential grid axis and
// rebuilds a tile once for every m tile.  Blocks here run in no order, so
// the grid covers (oc tiles, m tiles) and each block rebuilds the weight
// tiles it multiplies: the rebuild is ~15 operations a weight against 2*128
// flops a weight for the block's 128 rows, and covering m with blocks fills
// the 132 SMs where one block per oc tile would not (32 blocks at oc 2048).
// A block computes 128 rows by 64 columns; per step of 32 input rows it
// stages x (k-major) and the rebuilt w tile in shared memory, and each
// thread accumulates 8 rows by 4 columns in registers.  No tensor cores and
// no copy pipeline: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// x: f32 [m, ic] (16-byte aligned); sign: u32 [low_bits * ic/32, oc]; mask:
// u32 [ic/32, oc]; side: u8 [ic, oc] or [ic/2, oc]; lscale, lmean: f32
// [n_groups, oc]; hs, hz: f32 [oc]; bias: f32 [oc] or null; out: f32
// [m, oc].  oc a multiple of 64, ic and pack_block of 32.
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
