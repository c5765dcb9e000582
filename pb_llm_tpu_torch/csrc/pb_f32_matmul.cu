// pb_f32_matmul — exact f32 PBW-v2 packed matmul for Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_planar_v2_kernel (entry
// _planar_v2_call), with its sidecar helper _v2_salient_terms.  For x
// [m, ic] f32, the packed low planes B_j and the salient sidecar V:
//
//   y = rs*beta + (x . C)*alpha2 + (xg . V)*hs + rsg*gamma + bias
//
// C = sum_j 2^j * B_j is the low code ({0,1} planes; the TPU kernel's {0,2}
// planes carry a factor 2 that lives in alpha2 here, which is exact).  For
// 1-bit lows the product is a select-and-add: each set bit adds x_i, with no
// multiply.  xg [n_rg, m, k_pad] is x gathered at each row group's salient
// columns (outside the kernel); a column reads the group col / col_tile.
// 8-bit codes are bytes, 4-bit codes nibbles that pair slot row r with
// r + kps/2 per shard segment.  rs and rsg (f32 row sums of x and xg) come
// from the wrapper.  DOT_BF16 rounds x and xg to bf16 before the products
// (decode_dot "bf16"); the sums stay f32.
//
// Layout read as stored: bit b of word gi in pack block blk holds weight
// row blk_off + b*g + gi (g = rows_in_block / 32).
//
// What bounds it on the H100: at decode m (8 rows) bytes, the packed planes
// (4096x11008: 5.6 MB of sign words, 4.6 MB of codes), about 3 us at
// 3.35 TB/s; at prefill m (512) the f32 operations, 2*m*ic*oc (46 GFLOP at
// 4096x11008, 0.69 ms at 67 TFLOP/s).  Design, simple first: a block owns 32
// output columns (one a lane) and 8 rows of x; the ic loop is split over its
// 8 warps and walks chunks of 16 sign-word rows.  Each chunk's x (512 rows
// by 8) is staged in shared memory as [word][bit][row], so a lane reads the
// 8 rows of one weight row with two 16-byte broadcast loads, and each lane's
// sign words are loaded before the staging so that their latency overlaps
// it.  The sidecar product walks the code rows the same way, split over the
// warps.  The partial sums of the warps are reduced in shared memory in a
// fixed order.  No tensor cores: that is later work.
//
// The f32 epilogue uses __fmul_rn/__fadd_rn in the plain PyTorch version's
// order (pb_llm_tpu_torch/ops/packed_matmul.py::pb_f32_matmul_plain); the
// products sum in another order than the plain version's torch.matmul.
//
// pb_f32_matmul_stacked replaces pallas_pb.py::_stacked_f32_kernel (entry
// pb_matmul_pallas_v2_stacked with decode_dot f32, the scan_layers path):
// the 1-bit function on layer li of [L, ic/32, oc] sign planes,
// [L, k_pad(/2), oc] codes and an [L, 5, oc] coefficient array, li read by
// the block from a device int32 (the counterpart of scalar prefetch).  It is
// this file's kernel instantiated with STACKED, which offsets the three
// plane pointers by li and runs the flat device code unchanged.  A layer's
// slice of a stacked tensor is already a view in PyTorch, so the copy the
// TPU kernel avoids never happens here; what the entry gives is a launch
// whose arguments are the same for every layer (for a CUDA graph of the
// layer loop, later work).  No speed is claimed.
//
// pb_f32_matmul_tc and pb_f32_matmul_stacked_tc: the same functions (1-bit
// lows) on the bf16 tensor cores, x in three bf16 terms (one for dot bf16),
// from packed_matmul.F32_TC rows of x on (packed_matmul.f32_arm):
// pb_bf16_tc.cuh holds the device code and its notes.  Below F32_TC rows,
// for 2- and 4-bit lows and for layouts the tensor-core arm does not take,
// the kernel above runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_bf16_tc.cuh"
#include "pb_v2_side.cuh"

namespace {

constexpr int TM = 8;      // rows of x per block
constexpr int TN = 32;     // output columns per block (one per lane)
constexpr int WARPS = 8;   // ic split inside the block
constexpr int THREADS = TN * WARPS;
constexpr int CHW = 16;    // sign-word rows staged per chunk
constexpr int WPW = CHW / WARPS;             // word rows a warp takes per chunk
constexpr int WSTRIDE = 32 * TM + 4;         // floats per staged word row (padded)
constexpr int STAGE = CHW * 32 * TM / THREADS;  // x values a thread stages per chunk
static_assert(CHW % WARPS == 0 && TM * TN == THREADS, "tile shape");

template <bool BF16>
__device__ __forceinline__ float dot_in(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int LOW_BITS, int SIDE_BITS, bool BF16, bool STACKED>
__global__ void __launch_bounds__(THREADS)
pb_f32_matmul_kernel(const float* __restrict__ x, const float* __restrict__ xg,
                     const float* __restrict__ rs, const float* __restrict__ rsg,
                     const uint32_t* __restrict__ sign, const uint8_t* __restrict__ side,
                     const float* __restrict__ coef, float* __restrict__ out, int m, int ic,
                     int oc, int pack_block, int k_pad, int kps, int col_tile,
                     const int* __restrict__ layer) {
  if (STACKED) {  // layer li of the stacked planes (unsharded, one row group)
    const size_t li = (size_t)__ldg(layer);
    sign += li * (size_t)LOW_BITS * (ic / 32) * oc;
    side += li * (size_t)(SIDE_BITS == 4 ? k_pad / 2 : k_pad) * oc;
    coef += li * 5 * (size_t)oc;
  }
  __shared__ __align__(16) float xs[CHW * WSTRIDE];
  __shared__ float red_b[WARPS][TM][TN];
  __shared__ float red_v[WARPS][TM][TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * TN + lane;
  const int lcol = min(col, oc - 1);  // load column (a lane past oc loads and discards)
  const int m0 = blockIdx.y * TM;
  const int nwords = ic / 32;

  float acc_b[TM];
  float acc_v[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { acc_b[i] = 0.f; acc_v[i] = 0.f; }

  // ---- low-code product: sum_r x[mi, r] * C[r, col] ----
  for (int w0 = 0; w0 < nwords; w0 += CHW) {
    // this warp's sign words of the chunk (a word past the plane is 0)
    uint32_t words[WPW][LOW_BITS];
#pragma unroll
    for (int u = 0; u < WPW; ++u) {
      const int wr = w0 + warp + u * WARPS;
#pragma unroll
      for (int j = 0; j < LOW_BITS; ++j) {
        const uint32_t w = sign[((size_t)j * nwords + min(wr, nwords - 1)) * oc + lcol];
        words[u][j] = wr < nwords ? w : 0u;
      }
    }
    // stage xs[wl][b][mi] = x[m0 + mi, row of bit b of word w0 + wl]; element
    // e of the chunk: wl = e % CHW fastest, so a half warp reads 16
    // neighbouring columns of x
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int wl = e % CHW;
      const int b = (e / CHW) % 32;
      const int mi = e / (CHW * 32);
      const int wr = min(w0 + wl, nwords - 1);
      const int blk_off = (wr * 32 / pack_block) * pack_block;
      const int g = min(pack_block, ic - blk_off) / 32;
      const int r = blk_off + b * g + (wr - blk_off / 32);
      const float v = x[(size_t)min(m0 + mi, m - 1) * ic + r];
      xs[wl * WSTRIDE + b * TM + mi] = w0 + wl < nwords ? dot_in<BF16>(v) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < WPW; ++u) {
      const float* xw = xs + (warp + u * WARPS) * WSTRIDE;
#pragma unroll 4
      for (int b = 0; b < 32; ++b) {
        const float4 lo = *reinterpret_cast<const float4*>(xw + b * TM);
        const float4 hi = *reinterpret_cast<const float4*>(xw + b * TM + 4);
        const float xv[TM] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (LOW_BITS == 1) {
          const bool on = (words[u][0] >> b) & 1u;
#pragma unroll
          for (int i = 0; i < TM; ++i) acc_b[i] += on ? xv[i] : 0.f;
        } else {
          int code = 0;
#pragma unroll
          for (int j = 0; j < LOW_BITS; ++j) code |= (int)((words[u][j] >> b) & 1u) << j;
          const float c = (float)code;
#pragma unroll
          for (int i = 0; i < TM; ++i) acc_b[i] = fmaf(c, xv[i], acc_b[i]);
        }
      }
    }
    __syncthreads();
  }

  // ---- sidecar product: sum_j xg[t, mi, j] * code(j, col), t = col's row group ----
  {
    const int t = lcol / col_tile;
    const float* xgr[TM];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) xgr[mi] = xg + ((size_t)t * m + min(m0 + mi, m - 1)) * k_pad;
    for (int j = warp; j < k_pad; j += WARPS) {
      const float c = side_code<SIDE_BITS>(side, j, lcol, oc, kps);
#pragma unroll
      for (int mi = 0; mi < TM; ++mi) acc_v[mi] = fmaf(dot_in<BF16>(__ldg(xgr[mi] + j)), c, acc_v[mi]);
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
  const int ocol = blockIdx.x * TN + (threadIdx.x % TN);
  if (row >= m || ocol >= oc) return;
  float ab = 0.f, av = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    ab += red_b[w][mi][threadIdx.x % TN];
    av += red_v[w][mi][threadIdx.x % TN];
  }
  const float g_rs = rsg[(size_t)(ocol / col_tile) * m + row];
  const float alpha2 = coef[ocol];
  const float beta = coef[oc + ocol];
  const float gamma = coef[2 * oc + ocol];
  const float hs = coef[3 * oc + ocol];
  const float bias = coef[4 * oc + ocol];
  float y = __fadd_rn(__fmul_rn(rs[row], beta), __fmul_rn(ab, alpha2));
  y = __fadd_rn(y, __fmul_rn(av, hs));
  y = __fadd_rn(y, __fmul_rn(g_rs, gamma));
  y = __fadd_rn(y, bias);
  out[(size_t)row * oc + ocol] = y;
}

template <int LOW_BITS, int SIDE_BITS, bool STACKED>
void launch(dim3 grid, cudaStream_t st, bool bf16, const float* x, const float* xg,
            const float* rs, const float* rsg, const uint32_t* sign, const uint8_t* side,
            const float* coef, float* out, int m, int ic, int oc, int pack_block, int k_pad,
            int kps, int col_tile, const int* layer) {
  if (bf16) {
    pb_f32_matmul_kernel<LOW_BITS, SIDE_BITS, true, STACKED><<<grid, THREADS, 0, st>>>(
        x, xg, rs, rsg, sign, side, coef, out, m, ic, oc, pack_block, k_pad, kps, col_tile, layer);
  } else {
    pb_f32_matmul_kernel<LOW_BITS, SIDE_BITS, false, STACKED><<<grid, THREADS, 0, st>>>(
        x, xg, rs, rsg, sign, side, coef, out, m, ic, oc, pack_block, k_pad, kps, col_tile, layer);
  }
}

}  // namespace

#define PB_ARGS grid, st, bf, (const float*)x, (const float*)xg, (const float*)rs, \
    (const float*)rsg, (const uint32_t*)sign, (const uint8_t*)side, (const float*)coef, \
    (float*)out, m, ic, oc, pack_block, k_pad, kps, col_tile

// x: f32 [m, ic]; xg: f32 [n_rg, m, k_pad]; rs: f32 [m]; rsg: f32 [n_rg, m];
// sign: u32 [low_bits * ic/32, oc]; side: u8 [k_pad (/2), oc]; coef: f32
// [5, oc] (2*alpha, beta, gamma, hs, bias); out: f32 [m, oc].
extern "C" int pb_f32_matmul(const void* x, const void* xg, const void* rs, const void* rsg,
                             const void* sign, const void* side, const void* coef, void* out,
                             int m, int ic, int oc, int pack_block, int low_bits, int side_bits,
                             int k_pad, int kps, int col_tile, int dot_bf16, void* stream) {
  dim3 grid((oc + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = dot_bf16 != 0;
  if (side_bits != 8 && side_bits != 4) return (int)cudaErrorInvalidValue;
  const bool s8 = side_bits == 8;
  const int* flat = nullptr;
  if (low_bits == 1) {
    s8 ? launch<1, 8, false>(PB_ARGS, flat) : launch<1, 4, false>(PB_ARGS, flat);
  } else if (low_bits == 2) {
    s8 ? launch<2, 8, false>(PB_ARGS, flat) : launch<2, 4, false>(PB_ARGS, flat);
  } else if (low_bits == 4) {
    s8 ? launch<4, 8, false>(PB_ARGS, flat) : launch<4, 4, false>(PB_ARGS, flat);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// sign: u32 [L, ic/32, oc]; side: u8 [L, k_pad(/2), oc]; coef: f32 [L, 5, oc];
// layer: a device int32, the layer li; 1-bit lows, one row group, unsharded
// (col_tile = oc, kps = k_pad); the rest as pb_f32_matmul with dot_bf16 0.
extern "C" int pb_f32_matmul_stacked(const void* x, const void* xg, const void* rs,
                                     const void* rsg, const void* sign, const void* side,
                                     const void* coef, void* out, const void* layer, int m,
                                     int ic, int oc, int pack_block, int side_bits, int k_pad,
                                     void* stream) {
  dim3 grid((oc + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = false;
  const int kps = k_pad, col_tile = oc;
  const int* li = (const int*)layer;
  if (side_bits == 8) {
    launch<1, 8, true>(PB_ARGS, li);
  } else if (side_bits == 4) {
    launch<1, 4, true>(PB_ARGS, li);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#undef PB_ARGS

// the tensor-core arm: xp bf16 [terms, m, icp] (packed_matmul.tc_pair_columns'
// order, split_terms' planes); xgp bf16 [terms, n_rg, m, kst], kst =
// round_up(k_pad, 64) zero-padded; terms 3 (dot f32) or 1 (dot bf16); the
// rest as pb_f32_matmul with low_bits 1.  A 128-row x tile above 256 rows,
// else 64.
extern "C" int pb_f32_matmul_tc(const void* xp, const void* xgp, const void* rs, const void* rsg,
                                const void* sign, const void* side, const void* coef, void* out,
                                int m, int ic, int oc, int pack_block, int side_bits, int k_pad,
                                int kps, int col_tile, int n_rg, int terms, void* stream) {
  const bf16tc::Args A{xp, xgp, rs, rsg, sign, side, coef, out, nullptr, m, ic, oc, pack_block,
                       k_pad, kps, col_tile, n_rg, 1, 1, nullptr};
  if ((side_bits != 8 && side_bits != 4) || (terms != 1 && terms != 3) ||
      !bf16tc::layout_ok(A, side_bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PB_TC(T, S) (m <= 256 ? bf16tc::launch<T, S, false, 64>(A, st) \
                              : bf16tc::launch<T, S, false, 128>(A, st))
  if (terms == 3) return side_bits == 8 ? PB_TC(3, 8) : PB_TC(3, 4);
  return side_bits == 8 ? PB_TC(1, 8) : PB_TC(1, 4);
#undef PB_TC
}

// the stacked entry's tensor-core arm: three terms, m <= 256 (the 64-row
// tile of the flat arm, so stacked equals flat bit for bit); sign, side and
// coef as pb_f32_matmul_stacked, n_layers L; one row group, unsharded.
extern "C" int pb_f32_matmul_stacked_tc(const void* xp, const void* xgp, const void* rs,
                                        const void* rsg, const void* sign, const void* side,
                                        const void* coef, void* out, const void* layer, int m,
                                        int ic, int oc, int pack_block, int side_bits, int k_pad,
                                        int n_layers, void* stream) {
  const bf16tc::Args A{xp, xgp, rs, rsg, sign, side, coef, out, nullptr, m, ic, oc, pack_block,
                       k_pad, k_pad, oc, 1, n_layers, 1, layer};
  if ((side_bits != 8 && side_bits != 4) || m > 256 || !bf16tc::layout_ok(A, side_bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return side_bits == 8 ? bf16tc::launch<3, 8, true, 64>(A, st)
                        : bf16tc::launch<3, 4, true, 64>(A, st);
}
