// pb_prep_int8 — the int8 path's x preparation in one launch, for Hopper
// (sm_90a).
//
// Replaces the eager PyTorch sequence of prepare_int8 (ops/packed_matmul.py;
// the counterpart of the x preparation that XLA fuses inside
// pb_llm_tpu/ops/pallas_pb.py::_planar_v2_int8_call, not a Pallas kernel).
// For x f32 [m, ic] and the salient index side_idx int32 [K, n_rg]
// (K = shards * kps rows; row k reads column idx of shard k / kps, and the
// index ic / shards is the shard's appended zero column), it writes the
// five operands of pb_int8_matmul / pb_int8_matmul_stacked:
//
//   sx[r]        = max(max_i |x[r, i]|, 1e-30) / 127
//   x8[r, i]     = clamp(rint(x[r, i] / sx[r]), -127, 127)
//   rs[r]        = sum_i x[r, i]
//   xg8[g, r, k] = clamp(rint(xg / sx[r]), -127, 127),  xg = x gathered
//   rsg[g, r]    = sum_k xg
//
// Numerics: the divisions are IEEE (__fdiv_rn) and rint rounds half to
// even, so sx, x8 and xg8 equal the plain version's bit for bit (its scale
// is a true division too, see prepare_int8_plain).  The two sums accumulate
// in f64 and round once to f32, within (u + n 2^-53) sum|x| of the exact
// sum; the plain version's are f32 sums in torch.sum's order, so the two
// differ by at most packed_matmul.sum_bound, 2 n u sum|x| (u = 2^-24).
//
// What bounds it on the H100: x read once and the codes written once, some
// 5 bytes per element; at decode (8 rows of 4096) that is 160 KB, 0.05 us
// at 3.35 TB/s, so the launch itself bounds it.  Design for that: one launch
// per packed linear, grid (m, 1 + n_rg): block (r, 0) reduces row r's
// absmax and sum, then quantizes the row; block (r, 1 + g) reduces the same
// absmax (a max is exact in any order) and gathers, sums and quantizes row
// group g's salient columns.  It allocates nothing: the wrapper owns the
// outputs.
//
// For the int8 matmul's tensor-core arm (tc = 1) it writes the two code
// arrays in that arm's layout (packed_matmul.tc_x_columns): each row of x8
// in pallas_pb.py::byte_permute_x's order (within a pack block of g words,
// column (8j + b)*g + i at b*4g + 4i + j), every bit run of 4g bytes
// padded with zeros to 4*round_up(g, 8) and cut into 32-byte pieces of 8
// words, the 8 runs' pieces of one word group side by side (256 bytes a
// group: one stage of the arm, two 128-byte TMA boxes); each xg8 row
// padded with zeros to a multiple of 32 slots.  The codes are the same
// bytes, in other places; the sums add the same values in another order,
// within the same bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) v = fmaxf(v, red[w]);
  return v;
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

__global__ void __launch_bounds__(THREADS)
pb_prep_int8_kernel(const float* __restrict__ x, const int* __restrict__ side_idx,
                    int8_t* __restrict__ x8, float* __restrict__ sx, float* __restrict__ rs,
                    int8_t* __restrict__ xg8, float* __restrict__ rsg, int m, int ic, int shards,
                    int kps, int n_rg, int pack_block, int tc) {
  __shared__ float red_f[THREADS / 32];
  __shared__ double red_d[THREADS / 32];
  const int r = blockIdx.x;
  const int y = blockIdx.y;
  const float* xr = x + (size_t)r * ic;

  float amax = 0.f;
  for (int i = threadIdx.x; i < ic; i += THREADS) amax = fmaxf(amax, fabsf(xr[i]));
  const float s = __fdiv_rn(fmaxf(block_max(amax, red_f), 1e-30f), 127.f);

  double sum = 0.0;
  if (y == 0 && !tc) {
    int8_t* out = x8 + (size_t)r * ic;
    for (int i = threadIdx.x; i < ic; i += THREADS) {
      const float v = xr[i];
      sum += (double)v;
      out[i] = quantize(v, s);
    }
  } else if (y == 0) {
    // byte-permuted, padded, grouped: full blocks of gf words (g8f padded),
    // then the last; 256 bytes a word group s: run b's 32 bytes (words
    // 8s..8s+7, 4 bytes each) at 32b
    const int gf = pack_block / 32, g8f = (gf + 7) & ~7, nfull = ic / pack_block;
    const int gl = (ic - nfull * pack_block) / 32, g8l = (gl + 7) & ~7;
    const int full_bytes = nfull * 32 * g8f;
    const int icp = full_bytes + 32 * g8l;
    int8_t* out = x8 + (size_t)r * icp;
    for (int o = threadIdx.x; o < icp; o += THREADS) {
      const bool in_full = o < full_bytes;
      const int blk = in_full ? o / (32 * g8f) : nfull;
      const int g = in_full ? gf : gl;
      const int rem = o - blk * 32 * g8f;
      const int b = (rem & 255) >> 5, iw = 8 * (rem >> 8) + ((rem & 31) >> 2), j = rem & 3;
      const float v = iw < g ? xr[blk * pack_block + (8 * j + b) * g + iw] : 0.f;
      sum += (double)v;
      out[o] = quantize(v, s);
    }
  } else {
    const int g = y - 1;
    const int K = shards * kps;
    const int kst = tc ? (K + 31) & ~31 : K;
    const int ic_s = ic / shards;
    int8_t* out = xg8 + ((size_t)g * m + r) * kst;
    for (int k = threadIdx.x; k < kst; k += THREADS) {
      const int idx = k < K ? side_idx[(size_t)k * n_rg + g] : ic_s;
      const float v = idx < ic_s ? xr[(k / kps) * ic_s + idx] : 0.f;
      sum += (double)v;
      out[k] = quantize(v, s);
    }
  }
  sum = block_sum(sum, red_d);
  if (threadIdx.x == 0) {
    if (y == 0) {
      sx[r] = s;
      rs[r] = (float)sum;
    } else {
      rsg[(size_t)(y - 1) * m + r] = (float)sum;
    }
  }
}

}  // namespace

// x: f32 [m, ic]; side_idx: int32 [shards * kps, n_rg]; out: x8 int8
// [m, ic], sx, rs f32 [m], xg8 int8 [n_rg, m, shards * kps], rsg f32
// [n_rg, m]; with tc, x8 [m, icp] and xg8 [n_rg, m, round_up(shards * kps,
// 32)] in the tensor-core arm's layout (pack_block: the plane's local pack
// block, a multiple of 32).  All contiguous, on one device.
extern "C" int pb_prep_int8(const void* x, const void* side_idx, void* x8, void* sx, void* rs,
                            void* xg8, void* rsg, int m, int ic, int shards, int kps, int n_rg,
                            int pack_block, int tc, void* stream) {
  if (m <= 0 || ic <= 0 || shards <= 0 || ic % shards != 0 || kps <= 0 || n_rg <= 0 ||
      n_rg >= 65535 || pack_block <= 0 || pack_block % 32 || ic % 32)
    return (int)cudaErrorInvalidValue;
  dim3 grid(m, 1 + n_rg);
  pb_prep_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)side_idx, (int8_t*)x8, (float*)sx, (float*)rs, (int8_t*)xg8,
      (float*)rsg, m, ic, shards, kps, n_rg, pack_block, tc);
  return (int)cudaGetLastError();
}
