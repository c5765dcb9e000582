// pb_dequant_v2 — binary-part dequant of a PBW-v2 layer for Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_v2_dequant_kernel (entry
// _dequant_v2_binary).  Writes the binary part of the weight, w_bin [ic, oc]
// in f32 or bf16, from the packed low planes:
//
//   low_bits 1:    w = (mean - scale) + (2*scale) * bit
//   low_bits 2, 4: w = (code - zero) * scale,  code = sum_j 2^j * bit_j
//
// coef row 0 holds 2*scale (1 bit) or scale (2, 4 bits), row 1 holds
// mean - scale (1 bit) or the zero point (2, 4 bits).  Salient rows carry
// what their zeroed bits give (the caller adds the sidecar separately).
// Each value is one f32 multiply and one f32 add or subtract, rounded
// separately (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would contract them into an
// FMA), in the order of the plain version
// (pb_llm_tpu_torch/ops/prefill.py::dequant_v2_binary_plain), so the two
// agree bit for bit; bf16 output rounds that f32 value to nearest even.
//
// Layout read as stored: bit b of word gi in pack block blk holds weight
// row blk_off + b*g + gi (g = rows_in_block / 32); rows land in natural order.
//
// What bounds it on the H100: bytes.  It reads 1 bit per weight and plane and
// writes 4 (f32) or 2 (bf16) bytes per weight: at 4096x11008 in f32 about
// 186 MB, some 56 us at 3.35 TB/s.  Design for that: one thread per (word
// row, output column) reads one u32 per plane and writes its 32 values; the
// lanes of a warp sit on neighbouring columns, so every word load and every
// row of stores is one contiguous run of the row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int LOW_BITS, typename T>
__global__ void __launch_bounds__(THREADS)
pb_dequant_v2_kernel(const uint32_t* __restrict__ sign, const float* __restrict__ coef,
                     T* __restrict__ out, int ic, int oc, int pack_block) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const int wr = blockIdx.y;  // word row of every plane
  if (col >= oc) return;
  const int nwords = ic / 32;
  uint32_t w[LOW_BITS];
#pragma unroll
  for (int j = 0; j < LOW_BITS; ++j) w[j] = sign[((size_t)j * nwords + wr) * oc + col];
  const int blk_off = (wr * 32 / pack_block) * pack_block;
  const int g = min(pack_block, ic - blk_off) / 32;
  const int gi = wr - blk_off / 32;
  const float a = coef[col];
  const float b = coef[oc + col];
  T* o = out + (size_t)(blk_off + gi) * oc + col;
#pragma unroll 8
  for (int bit = 0; bit < 32; ++bit) {
    float v;
    if (LOW_BITS == 1) {
      v = __fadd_rn(b, __fmul_rn(a, (float)((w[0] >> bit) & 1u)));
    } else {
      int code = 0;
#pragma unroll
      for (int j = 0; j < LOW_BITS; ++j) code |= (int)((w[j] >> bit) & 1u) << j;
      v = __fmul_rn(__fsub_rn((float)code, b), a);
    }
    store(o + (size_t)bit * g * oc, v);
  }
}

template <typename T>
int launch(const void* sign, const void* coef, void* out, int ic, int oc, int pack_block,
           int low_bits, cudaStream_t st) {
  dim3 grid((oc + THREADS - 1) / THREADS, ic / 32);
  const uint32_t* s = (const uint32_t*)sign;
  const float* c = (const float*)coef;
  T* o = (T*)out;
  if (low_bits == 1) {
    pb_dequant_v2_kernel<1, T><<<grid, THREADS, 0, st>>>(s, c, o, ic, oc, pack_block);
  } else if (low_bits == 2) {
    pb_dequant_v2_kernel<2, T><<<grid, THREADS, 0, st>>>(s, c, o, ic, oc, pack_block);
  } else if (low_bits == 4) {
    pb_dequant_v2_kernel<4, T><<<grid, THREADS, 0, st>>>(s, c, o, ic, oc, pack_block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sign: u32 [low_bits * ic/32, oc] (plane-major); coef: f32 [2, oc];
// out: [ic, oc] f32 (out_bf16 == 0) or bf16.
extern "C" int pb_dequant_v2(const void* sign, const void* coef, void* out, int ic, int oc,
                             int pack_block, int low_bits, int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) return launch<__nv_bfloat16>(sign, coef, out, ic, oc, pack_block, low_bits, st);
  return launch<float>(sign, coef, out, ic, oc, pack_block, low_bits, st);
}
