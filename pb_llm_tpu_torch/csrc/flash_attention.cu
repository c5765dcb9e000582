// flash_attention — causal or full attention over whole windows for Hopper
// (sm_90a), with an online softmax.
//
// Replaces: pb_llm_tpu/ops/flash_attention.py::_kernel (entry
// flash_attention).  For each batch b, head h and query row i of q, k, v
// [B, T|S, H, D] (equal head counts; callers repeat GQA heads first):
//
//   s_j = (q_i . k_j) * scale     allowed: j < kv_len and (causal: j <= i)
//   out_i = sum_j softmax(s)_j * v_j
//
// with the running max m, normalizer l and rescaled accumulator of the
// flash recurrence, all f32.  A masked score is NEG_INF = -1e30 and its
// weight is 0, so a row with no allowed key gives 0 (l == 0), never NaN.
// DOTS_BF16 rounds q, k, v and the weights p to bf16 before the two
// products (the sums and statistics stay f32).  RESIDUALS also writes m and
// l [B, T, H] (what a ring merge needs).
//
// What bounds it on the H100: operations.  The two products take 4*D
// multiply-adds per (row, allowed key) pair: at B=4, T=2048, H=32, D=128,
// causal, 1.4e11 f32 operations, 2 ms at 67 TFLOP/s; the q, k, v and out
// bytes (537 MB) take 0.16 ms at 3.35 TB/s.  Design, simple first: one block
// of 256 threads per (b*h, 64 query rows); k and v arrive in tiles of 64
// rows; q, k and v tiles sit in shared memory in rows padded to 132 floats,
// so the 16-byte loads of neighbouring threads fall on distinct banks.  A
// thread owns a 4x4 patch of the scores tile (rows ty+16i, keys tx+16j) and
// 4 rows by 8 columns of the output; the 16 threads of a row reduce its max
// and sum with shuffles.  Key tiles past the causal diagonal or kv_len are
// skipped.  f32 CUDA cores, no tensor cores (TF32 would cost the f32
// parity): that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAXD = 128;
constexpr int DP = MAXD + 4;  // padded row stride (floats)
constexpr int PP = BK + 1;    // padded weights row stride
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM = (size_t)(3 * BQ * DP + BQ * PP) * sizeof(float);
static_assert(BQ == BK, "one tile shape for q, k and v");

template <bool BF16>
__device__ __forceinline__ float dot_in(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// rows [r0, r0 + BQ) of one (b, h) slice of a [B, N, H, D] tensor into
// dst [BQ][DP]; rows at or past n are zero
template <bool BF16>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int n, int H, int D) {
  const int per_row = D / 4;
  for (int e = threadIdx.x; e < BQ * per_row; e += THREADS) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * H * D + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) =
        make_float4(dot_in<BF16>(v.x), dot_in<BF16>(v.y), dot_in<BF16>(v.z), dot_in<BF16>(v.w));
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int T, int S, int H,
                       int D, int kv_len, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * DP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* qb = q + ((size_t)b * T * H + h) * D;
  const float* kb = k + ((size_t)b * S * H + h) * D;
  const float* vb = v + ((size_t)b * S * H + h) * D;

  load_tile<BF16>(Qs, qb, q0, T, H, D);

  float o[4][8];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  const int kend = causal ? min(kv_len, q0 + BQ) : kv_len;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    load_tile<BF16>(Ks, kb, k0, S, H, D);
    load_tile<BF16>(Vs, vb, k0, S, H, D);
    __syncthreads();

    // scores patch: rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // online softmax, one row at a time over its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < kv_len && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_next) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = dot_in<BF16>(p);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_next;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // o += P . V over this tile: columns tx*4 .. +3 and 64 + tx*4 .. +3
    const int nk = min(BK, kend - k0);
    for (int c = 0; c < nk; ++c) {
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + c * DP + tx * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + c * DP + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + c];
        o[i][0] = fmaf(p, v0.x, o[i][0]);
        o[i][1] = fmaf(p, v0.y, o[i][1]);
        o[i][2] = fmaf(p, v0.z, o[i][2]);
        o[i][3] = fmaf(p, v0.w, o[i][3]);
        o[i][4] = fmaf(p, v1.x, o[i][4]);
        o[i][5] = fmaf(p, v1.y, o[i][5]);
        o[i][6] = fmaf(p, v1.z, o[i][6]);
        o[i][7] = fmaf(p, v1.w, o[i][7]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
    float* orow = out + ((size_t)(b * T + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + tx * 4 + (c & 3);
      if (col < D) orow[col] = o[i][c] * inv;
    }
    if (m_out != nullptr && tx == 0) {
      const size_t r = (size_t)(b * T + row) * H + h;
      m_out[r] = m_i[i];
      l_out[r] = l_i[i];
    }
  }
}

template <bool BF16>
int launch(dim3 grid, cudaStream_t st, const float* q, const float* k, const float* v,
           float* out, float* m_out, float* l_out, int T, int S, int H, int D, int kv_len,
           int causal, float scale) {
  static bool attr_set = false;  // the block needs more than the default 48 KB
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  flash_attention_kernel<BF16><<<grid, THREADS, SMEM, st>>>(q, k, v, out, m_out, l_out, T, S, H,
                                                            D, kv_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: f32 [B, T, H, D]; k, v: f32 [B, S, H, D]; out: f32 [B, T, H, D];
// m_out, l_out: f32 [B, T, H] or null.  D % 4 == 0, D <= 128, kv_len <= S.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               void* m_out, void* l_out, int B, int T, int S, int H, int D,
                               int kv_len, int causal, int dots_bf16, float scale,
                               void* stream) {
  if (D % 4 != 0 || D > MAXD || kv_len > S) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  cudaStream_t st = (cudaStream_t)stream;
  if (dots_bf16)
    return launch<true>(grid, st, (const float*)q, (const float*)k, (const float*)v, (float*)out,
                        (float*)m_out, (float*)l_out, T, S, H, D, kv_len, causal, scale);
  return launch<false>(grid, st, (const float*)q, (const float*)k, (const float*)v, (float*)out,
                       (float*)m_out, (float*)l_out, T, S, H, D, kv_len, causal, scale);
}
