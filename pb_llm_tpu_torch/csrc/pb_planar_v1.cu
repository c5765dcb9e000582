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

#include <cuda_runtime.h>
#include <stdint.h>

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
