// pb_v1_terms.cuh — x's bf16 terms in the K order of the PBW-v1 tensor-core
// arms (pb_select_v1.cu's "tc", pb_planar_v1.cu's "tc"), written by one
// launch before the matmul.
//
// K order.  Inside a pack block of g words, weight row b*g + i is bit b of
// word i; the arms take x's columns word by word: k = 32*W + b (global word
// W) holds x at weight row (W / g)*32g + b*g + W % g
// (packed_matmul_v1.tc_x_order), so a k16 step covers 16 bits of one word.
// Terms.  An f32 value v splits into bf16 terms t0 = bf16(v), t1 =
// bf16(v - t0), t2 = bf16(v - t0 - t1), each nearest even, each remainder
// exact in f32; three terms sum to v exactly (|v| >= 2^-100)
// (ops/bf16_terms.py::split).
// Sums (SW words a sum; 0: none): the planar arm folds its group
// coefficients once a stage of SW words, and takes the row sum of x over
// the stage's 32*SW weight rows from here: sums [ceil(ic/(32*SW)), m], each
// the f32 sum of the stage's words (a warp's tree of shuffles per word,
// then the words added in order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace v1terms {

constexpr int THREADS = 256;  // 256 k a block: 8 words, 4 stages of 64

// the weight row of x's column k in the K order
__device__ __forceinline__ int source_row(int k, int g) {
  const int w = k >> 5, b = k & 31, blk = w / g;
  return blk * 32 * g + b * g + (w - blk * g);
}

// xt [TERMS, m, ic] bf16: x's terms in the K order; with SW, sums
// [ceil(ic/(32*SW)), m] f32.  Grid (ceil(ic/256), rows at a time).
template <int TERMS, int SW>
__global__ void __launch_bounds__(THREADS)
terms_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xt,
             float* __restrict__ sums, int m, int ic, int g) {
  __shared__ float word_sums[THREADS / 32];
  const int k = blockIdx.x * THREADS + threadIdx.x;
  static_assert(SW == 0 || (THREADS / 32) % SW == 0, "a block's words hold whole stages");
  if (SW == 0 && k >= ic) return;
  const bool in = k < ic;
  const int src = in ? source_row(k, g) : 0;
  const int n_st = SW ? (ic + 32 * SW - 1) / (32 * SW) : 0;
  for (int row = blockIdx.y; row < m; row += gridDim.y) {
    float v = in ? x[(size_t)row * ic + src] : 0.f;
    if (SW) {
      float s = v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((threadIdx.x & 31) == 0) word_sums[threadIdx.x >> 5] = s;
      __syncthreads();
      const int st = blockIdx.x * (THREADS / 32 / (SW ? SW : 1)) + threadIdx.x;
      if (threadIdx.x < THREADS / 32 / (SW ? SW : 1) && st < n_st) {
        float t = word_sums[SW * threadIdx.x];
#pragma unroll
        for (int w = 1; w < SW; ++w) t = __fadd_rn(t, word_sums[SW * threadIdx.x + w]);
        sums[(size_t)st * m + row] = t;
      }
      __syncthreads();
    }
    if (!in) continue;
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      xt[((size_t)t * m + row) * ic + k] = h;
      v = __fsub_rn(v, __bfloat162float(h));
    }
  }
}

template <int TERMS, int SW>
int launch_terms(const float* x, void* xt, float* sums, int m, int ic, int g, cudaStream_t st) {
  dim3 grid((ic + THREADS - 1) / THREADS, m < 65535 ? m : 65535);
  terms_kernel<TERMS, SW><<<grid, THREADS, 0, st>>>(x, (__nv_bfloat16*)xt, sums, m, ic, g);
  return (int)cudaGetLastError();
}

}  // namespace v1terms
}  // namespace
