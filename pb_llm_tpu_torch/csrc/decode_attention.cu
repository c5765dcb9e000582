// decode_attention — one-token GQA attention over the strip KV cache for
// Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/decode_attention.py::_kernel (entry
// decode_attention).  For each slot b and query head h (kv head h / G):
//
//   s_r = (q_h . k_r) * kscale_r          r < lengths[b]
//   out = sum_r softmax(s)_r * vscale_r * v_r
//
// q arrives scaled by the softmax scale.  int8 caches carry f32 scales per
// (token, kv head); f32 caches carry none.  Empty slots (length 0) return
// zeros.  All arithmetic is f32 (the TPU kernel rounds q and p to bf16).
//
// What bounds it on the H100: the cache read — B * len * Hkv * D bytes for
// K and V each (int8) plus 8 bytes of scales per (row, kv head); at B=8,
// Hkv=32, D=128 and lengths up to 512 that is some 15 MB, about 5 us at
// 3.35 TB/s.  Design for that: one block of 8 warps per (slot, q head); a
// row of K or V is read by a group of LPR lanes, 16 bytes a lane in one
// vector load (D=128 int8: 8 lanes a row, 4 rows a warp, 32 rows a block
// per step), so a warp keeps several rows in flight and every load is a
// full 128-byte line.  Each lane group keeps its own online-softmax state
// (max, sum, f32 accumulators in registers), reduces its dot product with
// log2(LPR) shuffles, and the states merge in shared memory at the end.  No
// row at or past a slot's own length is read, which takes the place of the
// TPU path's power-of-two window switch.  The G query heads of one kv head
// re-read the same rows (from L2); sharing them inside one block is later
// work, as is splitting long rows over several blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_EPL = 16;
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Row;

// int8 rows: 16 elements a lane, one 16-byte load
template <>
struct Row<int8_t> {
  static constexpr int EPL = 16;
  __device__ static void load(const int8_t* p, float* out) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) out[4 * i + b] = (float)(int8_t)(ws[i] >> (8 * b));
    }
  }
};

// f32 rows: 8 elements a lane, two 16-byte loads
template <>
struct Row<float> {
  static constexpr int EPL = 8;
  __device__ static void load(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

template <typename T, bool QUANT>
__global__ void __launch_bounds__(32 * WARPS)
decode_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        float* __restrict__ out, int S, int Hq, int Hkv, int D, int lpr_log2) {
  constexpr int EPL = Row<T>::EPL;
  __shared__ float sm_m[WARPS * 32];
  __shared__ float sm_l[WARPS * 32];
  __shared__ float sm_w[WARPS * 32];
  __shared__ float sm_acc[WARPS * 32 * MAX_EPL];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lpr = 1 << lpr_log2;     // lanes reading one row
  const int rpw = 32 >> lpr_log2;    // rows a warp reads per step
  const int sub = lane >> lpr_log2;  // this lane's row within the step
  const int d0 = (lane & (lpr - 1)) * EPL;
  const bool lane_on = d0 < D;       // D % EPL == 0: a lane is wholly in or out
  const int len = min(lengths[b], S);

  float qr[EPL];
  float acc[EPL];
  const float* qh = q + ((size_t)b * Hq + h) * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qr[e] = lane_on ? qh[d0 + e] : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  for (int s0 = warp * rpw; s0 < len; s0 += WARPS * rpw) {
    const int s = s0 + sub;
    const bool valid = s < len;
    const size_t row = ((size_t)b * S + s) * Hkv + kvh;
    float dot = 0.f;
    if (valid && lane_on) {
      float kf[EPL];
      Row<T>::load(k + row * D + d0, kf);
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kf[e], dot);
    }
    for (int off = lpr >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (valid) {
      const float score = QUANT ? dot * ks[row] : dot;
      const float m_next = fmaxf(m, score);
      const float alpha = expf(m - m_next);
      float p = expf(score - m_next);
      l = l * alpha + p;
      m = m_next;
      if (QUANT) p *= vs[row];
      if (lane_on) {
        float vf[EPL];
        Row<T>::load(v + row * D + d0, vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[e], acc[e] * alpha);
      }
    }
  }

  // merge the WARPS * rpw lane-group states
  const int nst = WARPS * rpw;
  const int st = warp * rpw + sub;
  if ((lane & (lpr - 1)) == 0) {
    sm_m[st] = m;
    sm_l[st] = l;
  }
  if (lane_on) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[st * D + d0 + e] = acc[e];
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int i = 0; i < nst; ++i) mx = fmaxf(mx, sm_m[i]);
  for (int i = threadIdx.x; i < nst; i += 32 * WARPS) sm_w[i] = expf(sm_m[i] - mx);
  __syncthreads();
  float lt = 0.f;
  for (int i = 0; i < nst; ++i) lt += sm_l[i] * sm_w[i];
  const float inv = lt == 0.f ? 1.f : 1.f / lt;
  float* oh = out + ((size_t)b * Hq + h) * D;
  for (int d = threadIdx.x; d < D; d += 32 * WARPS) {
    float a = 0.f;
    for (int i = 0; i < nst; ++i) a = fmaf(sm_acc[i * D + d], sm_w[i], a);
    oh[d] = a * inv;
  }
}

}  // namespace

// lpr_log2: log2 of the lanes that read one row, ceil(log2(D / EPL)) with
// EPL = 16 for int8 caches and 8 for f32 caches (the wrapper computes it).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* lengths, void* out, int B, int S,
                                int Hq, int Hkv, int D, int quantized, int lpr_log2,
                                void* stream) {
  dim3 grid(B, Hq);
  cudaStream_t st = (cudaStream_t)stream;
  if (quantized) {
    decode_attention_kernel<int8_t, true><<<grid, 32 * WARPS, 0, st>>>(
        (const float*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks, (const float*)vs,
        (const int*)lengths, (float*)out, S, Hq, Hkv, D, lpr_log2);
  } else {
    decode_attention_kernel<float, false><<<grid, 32 * WARPS, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, nullptr, nullptr,
        (const int*)lengths, (float*)out, S, Hq, Hkv, D, lpr_log2);
  }
  return (int)cudaGetLastError();
}
