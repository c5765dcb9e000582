// decode_attention — one-token GQA attention over the strip KV cache for
// Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/decode_attention.py::_kernel (entry
// decode_attention).  For each slot b and query head h (kv head h / G):
//
//   s_r = (q_h . k_r) * kscale_r          r < lengths[b]
//   out = sum_r softmax(s)_r * vscale_r * v_r
//
// q arrives scaled by the softmax scale.  Four arms, by the cache's type:
//   f32 strips, no scales;
//   bf16 strips, no scales (the TPU kernel's unquantized branch), each
//     element widened with __bfloat162float;
//   int8 strips with f32 scales per (token, kv head);
//   q8: int8 strips whose scores are exact int32 dots of int8 q codes
//     against the uncast int8 key row (__dp4a over the lane's four 32-bit
//     words), then (s * kscale) * qscale in f32, the TPU kernel's order.
//     The block quantizes its own q head in its prologue, as the TPU
//     entry does outside its kernel: qscale = max(max|q|, 1e-30) / 127,
//     code = clip(rint(q / qscale), -127, 127), IEEE division and
//     round-half-even, so the codes equal the plain version's.  The V side
//     is the int8 arm's.
// Empty slots (length 0) return zeros.  q and p stay f32 in every arm (the
// TPU kernel rounds them to bf16 in its bf16 and int8 dots).
//
// What bounds it on the H100: the cache read.  Per (row, kv head) an int8
// or q8 row costs 2*D bytes of K and V plus 8 bytes of scales, a bf16 row
// 2*D*2 bytes, an f32 row 2*D*4.  At chip_smoke.py's phase-2 shape (B=8,
// Hkv=32, D=128, lengths up to 512, some 1800 rows read a kv head) that is
// about 15 MB (int8, q8) or 29 MB (bf16): 4.5 us or 8.8 us at 3.35 TB/s.
//
// Two arms.  "slot" (decode_attention_kernel, the first design): one block
// of 8 warps per (slot, q head); a row of K or V is read by a group of LPR
// lanes, 16 bytes a lane in one vector load (D=128 int8: 8 lanes a row, 4
// rows a warp; bf16: 16 lanes a row), each lane group keeps its own
// online-softmax state and the states merge in shared memory at the end.
// It reached 12% of the bound (0.0366 ms int8, 0.0490 bf16 on an "NVIDIA
// H100 80GB HBM3, 700.00 W"): the longest slot sets the time (512 rows
// against a mean of 220), and each row's loads wait on the previous row's
// dot, shuffles and softmax update.
//
// "split" (split_kernel + merge_kernel, the default): each slot's rows cut
// into splits of R = 64 rows, SPLIT_GRID blocks a (slot, head) taking splits
// c, c + SPLIT_GRID, ...; the grid follows max_seq alone (a captured decode
// step's grid holds for every length), and a block past its slot's length
// returns at once.  A lane group requests all STEPS of its K and V slices
// (and scales) before its first dot, every address clamped into the slot's
// rows so no load waits on a branch; then one max and one set of
// exponentials for the split, the P.V sums added over the lane groups in
// group order, and the split's (max, sum, unnormalised output) written to a
// workspace.  The merge launch adds the splits of each (slot, head) in
// split order (no atomics: the graph equals eager bit for bit).  Measured
// on an "NVIDIA H100 80GB HBM3, 700.00 W" at the phase-2 shape (chip_smoke.py,
// CUDA events, the launch's ~5 us included): int8 0.024-0.025 ms, bf16
// 0.026 ms against the slot arm's 0.036 / 0.049 and SDPA bf16's 0.046; at
// 8 x 1000 rows 0.059 / 0.066 against 0.071 / 0.092.  Split grids of 4-16
// blocks, 2-8 steps a lane group and a grid of every split moved it by at
// most 15%.  No row at or past a slot's own length is read, which takes the
// place of the TPU path's power-of-two window switch.  The G query heads of
// one kv head re-read the same rows (from L2); sharing them inside one
// block is later work.

#include <cuda_bf16.h>
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
  // element 4*i + b is byte b (least significant first) of word i
  __device__ static void words(const int8_t* p, int* ws) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    ws[0] = w.x; ws[1] = w.y; ws[2] = w.z; ws[3] = w.w;
  }
  __device__ static void load(const int8_t* p, float* out) {
    int ws[4];
    words(p, ws);
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

// bf16 rows: 8 elements a lane, one 16-byte load
template <>
struct Row<__nv_bfloat16> {
  static constexpr int EPL = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// q8: the lane's 16 int8 codes of q, packed as Row<int8_t>::words packs K,
// and the head's q scale; lanes past D hold zero codes
__device__ __forceinline__ float quantize_q(const float* qr, bool lane_on, int lpr, int* qw) {
  float mx = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(qr[e]));
  for (int off = lpr >> 1; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float qsc = __fdiv_rn(fmaxf(mx, 1e-30f), 127.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float c = lane_on ? fminf(fmaxf(rintf(__fdiv_rn(qr[4 * i + b], qsc)), -127.f), 127.f)
                              : 0.f;
      w |= ((unsigned)(int)c & 0xffu) << (8 * b);
    }
    qw[i] = (int)w;
  }
  return qsc;
}

// QUANT: int8 strips with scales; Q8 (with QUANT): int8 q codes, int32 scores
template <typename T, bool QUANT, bool Q8>
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
  int qw[4];
  float qsc = 1.f;
  if constexpr (Q8) qsc = quantize_q(qr, lane_on, lpr, qw);

  for (int s0 = warp * rpw; s0 < len; s0 += WARPS * rpw) {
    const int s = s0 + sub;
    const bool valid = s < len;
    const size_t row = ((size_t)b * S + s) * Hkv + kvh;
    float dot = 0.f;
    int idot = 0;
    if (valid && lane_on) {
      if constexpr (Q8) {
        int kw[4];
        Row<int8_t>::words(reinterpret_cast<const int8_t*>(k) + row * D + d0, kw);
#pragma unroll
        for (int i = 0; i < 4; ++i) idot = __dp4a(kw[i], qw[i], idot);
      } else {
        float kf[EPL];
        Row<T>::load(k + row * D + d0, kf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kf[e], dot);
      }
    }
    if (Q8) {
      for (int off = lpr >> 1; off > 0; off >>= 1) idot += __shfl_xor_sync(0xffffffffu, idot, off);
      dot = (float)idot;
    } else {
      for (int off = lpr >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (valid) {
      const float score = Q8 ? __fmul_rn(__fmul_rn(dot, ks[row]), qsc)
                             : QUANT ? dot * ks[row] : dot;
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

// ---------------------------------------------------------------------------
// the split arm: a slot's rows cut into splits of R rows, one block each
// ---------------------------------------------------------------------------

constexpr int GROUPS = 16;           // lane groups a block (one row each a step)
constexpr int STEPS = 4;             // rows a lane group reads, all requested at once
constexpr int R = GROUPS * STEPS;    // rows a split
constexpr int SPLIT_GRID = 8;        // blocks a (slot, head): block c takes splits c, c + 8, ...
constexpr int MAX_D = 256;

// raw row slices: a lane's 16 bytes of a row (two 16-byte halves for f32)
template <typename T>
struct Raw {
  uint4 w[sizeof(T) == 4 ? 2 : 1];
};

template <typename T>
__device__ __forceinline__ void raw_load(const T* p, Raw<T>& r) {
  const uint4* u = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r.w) / sizeof(uint4)); ++i) r.w[i] = __ldg(u + i);
}

// a raw slice as f32, element by element (Row<T>::load's order)
__device__ __forceinline__ void widen(const Raw<int8_t>& r, float* out) {
  const unsigned ws[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) out[4 * i + b] = (float)(int8_t)(ws[i] >> (8 * b));
  }
}
__device__ __forceinline__ void widen(const Raw<float>& r, float* out) {
  const unsigned ws[8] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                          r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __uint_as_float(ws[i]);
}
__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r, float* out) {
  const unsigned ws[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    out[2 * i] = __uint_as_float(ws[i] << 16);
    out[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
  }
}

// Splits c = blockIdx.x, + gridDim.x, ... of slot b, query head h, each rows
// c*R .. c*R + R - 1 below the slot's length (a block with no such split
// returns at once; the grid follows max_seq, never the lengths).  Lane
// group g (lpr lanes) reads rows c*R + st*GROUPS + g, st < STEPS: it
// requests all its K and V slices (and scales) before the first dot, every
// address clamped into the slot's rows so no load waits on a branch.  Then
// the scores, one max and one set of exponentials for the split's R rows,
// the P.V sum per lane group, and the groups' sums added in group order.
// Writes the split's max, exponential sum and unnormalised output to
// part_ml[b, h, c] and part[b, h, c, :].
template <typename T, bool QUANT, bool Q8>
__global__ void __launch_bounds__(GROUPS * 32)
split_kernel(const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ lengths, float* __restrict__ part,
             float* __restrict__ part_ml, int S, int Hq, int Hkv, int D, int lpr_log2) {
  constexpr int EPL = Row<T>::EPL;
  __shared__ float sm_m[GROUPS];
  __shared__ float sm_l[GROUPS];
  __shared__ float sm_acc[GROUPS * MAX_D];

  const int h = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], S);
  const int ns = (S + R - 1) / R;
  const int kvh = h / (Hq / Hkv);
  const int lpr = 1 << lpr_log2;
  const int grp = threadIdx.x >> lpr_log2;
  const int d0 = (threadIdx.x & (lpr - 1)) * EPL;
  const bool lane_on = d0 < D;               // D % EPL == 0: a lane is wholly in or out
  const int dl = lane_on ? d0 : D - EPL;     // the slice an idle lane loads (and discards)
  float qr[EPL];
  const float* qh = q + ((size_t)b * Hq + h) * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] = lane_on ? qh[d0 + e] : 0.f;
  int qw[4];
  float qsc = 1.f;
  if constexpr (Q8) qsc = quantize_q(qr, lane_on, lpr, qw);

  for (int c = blockIdx.x; c * R < len; c += gridDim.x) {
    const int r0 = c * R;
    // every load first: K and V slices and the scales of the group's rows
    Raw<T> kr[STEPS], vr[STEPS];
    float ksc[STEPS], vsc[STEPS];
  #pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int s = min(r0 + st * GROUPS + grp, len - 1);
      const size_t row = ((size_t)b * S + s) * Hkv + kvh;
      raw_load(k + row * D + dl, kr[st]);
      raw_load(v + row * D + dl, vr[st]);
      if (QUANT) {
        ksc[st] = __ldg(ks + row);
        vsc[st] = __ldg(vs + row);
      }
    }
    float score[STEPS];
    float mx = NEG_INF;
  #pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      float dot = 0.f;
      if constexpr (Q8) {
        const int kw[4] = {(int)kr[st].w[0].x, (int)kr[st].w[0].y, (int)kr[st].w[0].z,
                           (int)kr[st].w[0].w};
        int idot = 0;
  #pragma unroll
        for (int i = 0; i < 4; ++i) idot = __dp4a(kw[i], qw[i], idot);
        for (int off = lpr >> 1; off > 0; off >>= 1) idot += __shfl_xor_sync(0xffffffffu, idot, off);
        dot = (float)idot;
      } else {
        float kf[EPL];
        widen(kr[st], kf);
  #pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[e], kf[e], dot);
        for (int off = lpr >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const bool valid = r0 + st * GROUPS + grp < len;
      const float sc = Q8 ? __fmul_rn(__fmul_rn(dot, ksc[st]), qsc) : QUANT ? dot * ksc[st] : dot;
      score[st] = valid ? sc : NEG_INF;
      mx = fmaxf(mx, score[st]);
    }
    // the split's max: one per lane group, then over the groups
    if ((threadIdx.x & (lpr - 1)) == 0) sm_m[grp] = mx;
    __syncthreads();
  #pragma unroll
    for (int g = 0; g < GROUPS; ++g) mx = fmaxf(mx, sm_m[g]);

    float l = 0.f;
    float acc[EPL];
  #pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  #pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const bool valid = r0 + st * GROUPS + grp < len;
      float p = valid ? expf(score[st] - mx) : 0.f;
      l += p;
      if (QUANT) p *= vsc[st];
      float vf[EPL];
      widen(vr[st], vf);
  #pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    if ((threadIdx.x & (lpr - 1)) == 0) sm_l[grp] = l;
    if (lane_on) {
  #pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[grp * D + d0 + e] = acc[e];
    }
    __syncthreads();
    const size_t pi = ((size_t)b * Hq + h) * ns + c;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float a = 0.f;
  #pragma unroll
      for (int g = 0; g < GROUPS; ++g) a += sm_acc[g * D + d];
      part[pi * D + d] = a;
    }
    if (threadIdx.x == 0) {
      float lt = 0.f;
  #pragma unroll
      for (int g = 0; g < GROUPS; ++g) lt += sm_l[g];
      part_ml[2 * pi] = mx;
      part_ml[2 * pi + 1] = lt;
    }
    __syncthreads();  // the shared sums are read before the next split writes them
  }
}

// The splits of slot b, head h merged in split order: out = sum_c w_c *
// part_c / sum_c w_c * l_c, w_c = exp(m_c - max_c m_c); zeros for an empty
// slot.  One thread an element of the head.
__global__ void merge_kernel(const float* __restrict__ part, const float* __restrict__ part_ml,
                             const int* __restrict__ lengths, float* __restrict__ out, int S,
                             int Hq, int D, int ns) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n = (min(lengths[b], S) + R - 1) / R;  // the splits that hold rows
  const size_t p0 = ((size_t)b * Hq + h) * ns;
  float mx = NEG_INF;
  for (int c = 0; c < n; ++c) mx = fmaxf(mx, part_ml[2 * (p0 + c)]);
  float lt = 0.f, a = 0.f;
  for (int c = 0; c < n; ++c) {
    const float w = expf(part_ml[2 * (p0 + c)] - mx);
    lt = fmaf(w, part_ml[2 * (p0 + c) + 1], lt);
    if (d < D) a = fmaf(w, part[(p0 + c) * D + d], a);
  }
  if (d < D) out[((size_t)b * Hq + h) * D + d] = lt == 0.f ? 0.f : a / lt;
}

enum KvType { KV_F32 = 0, KV_INT8 = 1, KV_BF16 = 2 };

template <typename T, bool QUANT, bool Q8>
int launch_split(cudaStream_t st, const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* lengths, void* out, void* part, void* part_ml,
                 int B, int S, int Hq, int Hkv, int D, int lpr_log2) {
  const int ns = (S + R - 1) / R;
  split_kernel<T, QUANT, Q8><<<dim3(min(ns, SPLIT_GRID), Hq, B), GROUPS << lpr_log2, 0, st>>>(
      (const float*)q, (const T*)k, (const T*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, (float*)part, (float*)part_ml, S, Hq, Hkv, D, lpr_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<dim3(Hq, B), (D + 31) & ~31, 0, st>>>((const float*)part, (const float*)part_ml,
                                                      (const int*)lengths, (float*)out, S, Hq, D,
                                                      ns);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT, bool Q8>
int launch(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, void* out, int S, int Hq, int Hkv, int D,
           int lpr_log2) {
  decode_attention_kernel<T, QUANT, Q8><<<grid, 32 * WARPS, 0, st>>>(
      (const float*)q, (const T*)k, (const T*)v, (const float*)ks, (const float*)vs,
      (const int*)lengths, (float*)out, S, Hq, Hkv, D, lpr_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// kv_type: KV_F32, KV_INT8 (ks/vs: f32 [B, S, Hkv]) or KV_BF16; q_int8 (int8
// only): the q8 arm.  lpr_log2: log2 of the lanes that read one row,
// ceil(log2(D / EPL)) with EPL = 16 for int8, 8 for f32 and bf16 (the
// wrapper computes it).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* lengths, void* out, int B, int S,
                                int Hq, int Hkv, int D, int kv_type, int q_int8, int lpr_log2,
                                void* stream) {
  dim3 grid(B, Hq);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_type) {
    case KV_INT8:
      if (q_int8)
        return launch<int8_t, true, true>(grid, st, q, k, v, ks, vs, lengths, out, S, Hq, Hkv, D,
                                          lpr_log2);
      return launch<int8_t, true, false>(grid, st, q, k, v, ks, vs, lengths, out, S, Hq, Hkv, D,
                                         lpr_log2);
    case KV_F32:
      if (q_int8) break;
      return launch<float, false, false>(grid, st, q, k, v, nullptr, nullptr, lengths, out, S, Hq,
                                         Hkv, D, lpr_log2);
    case KV_BF16:
      if (q_int8) break;
      return launch<__nv_bfloat16, false, false>(grid, st, q, k, v, nullptr, nullptr, lengths,
                                                 out, S, Hq, Hkv, D, lpr_log2);
  }
  return (int)cudaErrorInvalidValue;
}

// The split arm, same arguments as decode_attention, plus its workspace:
// part f32 [B, Hq, ceil(S / 64), D] and part_ml f32 [B, Hq, ceil(S / 64), 2]
// (split_rows() rows a split).  Two launches: the splits, then the merge.
extern "C" int decode_attention_split(const void* q, const void* k, const void* v, const void* ks,
                                      const void* vs, const void* lengths, void* out, void* part,
                                      void* part_ml, int B, int S, int Hq, int Hkv, int D,
                                      int kv_type, int q_int8, int lpr_log2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D > MAX_D || (GROUPS << lpr_log2) > 1024) return (int)cudaErrorInvalidValue;
  switch (kv_type) {
    case KV_INT8:
      if (q_int8)
        return launch_split<int8_t, true, true>(st, q, k, v, ks, vs, lengths, out, part, part_ml,
                                                B, S, Hq, Hkv, D, lpr_log2);
      return launch_split<int8_t, true, false>(st, q, k, v, ks, vs, lengths, out, part, part_ml,
                                               B, S, Hq, Hkv, D, lpr_log2);
    case KV_F32:
      if (q_int8) break;
      return launch_split<float, false, false>(st, q, k, v, nullptr, nullptr, lengths, out, part,
                                               part_ml, B, S, Hq, Hkv, D, lpr_log2);
    case KV_BF16:
      if (q_int8) break;
      return launch_split<__nv_bfloat16, false, false>(st, q, k, v, nullptr, nullptr, lengths,
                                                       out, part, part_ml, B, S, Hq, Hkv, D,
                                                       lpr_log2);
  }
  return (int)cudaErrorInvalidValue;
}

// rows a split of the split arm
extern "C" int decode_attention_split_rows() { return R; }
