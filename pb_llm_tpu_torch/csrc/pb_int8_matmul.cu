// pb_int8_matmul — PBW-v2 int8 packed matmul for Hopper (sm_90a).
//
// Replaces: pb_llm_tpu/ops/pallas_pb.py::_planar_v2_int8_kernel (entry
// _planar_v2_int8_call).  Computes, for x [m, ic] quantized per row to int8
// (scale sx), with the packed sign plane B' and the salient sidecar V:
//
//   y = rs*beta + (x8 . B') * sx * alpha2
//       + (sx * (xg8 . V'') [+ 128*rsg]) * hs + rsg*gamma + bias
//
// V'' = code - 128 for 8-bit codes (the +128*rsg correction), the 4-bit
// code itself for nibble sidecars.  Both integer dots accumulate exactly in
// int32 (|sum| <= ic*127*255 < 2^31).
//
// Layout read as stored: bit b of word gi in pack block blk holds weight
// row blk_off + b*g + gi (g = rows_in_block / 32).  Nibble sidecars pair
// slot row r with r + kps/2 per shard segment (low / high nibble).
//
// What bounds it on the H100: at decode m (8 slots) it is a stream of the
// packed planes — 1 bit per weight of sign plane plus k_pad bytes per
// output column of sidecar (4096x11008: 5.6 MB + 4.6 MB), about 3 us at
// 3.35 TB/s.  Design for that: each 32-column block reads every sign word
// of its columns exactly once per m tile, lanes on neighbouring columns so
// a warp's word loads are one 128-byte transaction, and a lane requests
// all its words of a 64-word chunk before it stages x, so their latency
// overlaps.  The x tile is staged in shared memory already packed for
// __dp4a (four bit-planes b, b+8, b+16, b+24 of a word ride one dp4a
// against four x bytes: one shift + one AND per four weights).  The
// sidecar rides __dp4a too: four slot rows' signed codes against four
// gathered x bytes, with eight steps of code loads in flight.  Every load
// is branch-free (clamped address, masked value), so a batch of them is in
// flight before the first use (with the loads under branches, an earlier
// version waited out each one in turn and took about twice as long on an
// H100 at decode m).  The ic loop is split over the block's 8 warps and
// the partial int32 sums are reduced in shared memory (exact,
// deterministic).  At prefill m the same block re-reads its plane strip
// once per 8-row m tile from L2, and the dp4a instruction rate bounds it;
// a tensor-core (wgmma) version is later work.
//
// The f32 epilogue uses __fmul_rn/__fadd_rn in the plain PyTorch version's
// order (pb_llm_tpu_torch/ops/packed_matmul.py::_epilogue), so the kernel
// and its plain version agree to the last bit on the same operands.
//
// pb_int8_matmul_stacked replaces pallas_pb.py::_stacked_int8_kernel (entry
// pb_matmul_pallas_v2_stacked, the scan_layers path): the same function on
// layer li of [L, ic/32, oc] sign planes, [L, k_pad(/2), oc] codes and an
// [L, 5, oc] coefficient array, with li read by the block from a device
// int32 (the counterpart of the TPU kernel's scalar prefetch).  It is this
// file's kernel instantiated with STACKED: the block offsets its three
// plane pointers by li and runs the flat device code unchanged.  What it
// buys on this card: a layer's slice of a stacked tensor is already a view
// in PyTorch, so the per-layer copy the TPU kernel avoids never happens
// here; what it gives is a launch whose arguments are the same for every
// layer, which a CUDA graph of the layer loop needs.  No speed is claimed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;      // rows of x per block
constexpr int TN = 32;     // output columns per block (one per lane)
constexpr int WARPS = 8;   // ic split inside the block
constexpr int THREADS = TN * WARPS;
constexpr int CHW = 64;    // sign-word rows staged per chunk
constexpr int WPW = CHW / WARPS;                 // sign words a lane loads per chunk
constexpr int STAGE = TM * CHW * 8 / THREADS;    // packed x ints a thread stages per chunk
constexpr int SU = 8;      // sidecar steps (4 codes each) a lane has in flight
static_assert(THREADS % CHW == 0 && TM * TN == THREADS, "tile shape");

// The loads below are branch-free (addresses clamped into range, values
// masked afterwards) so the compiler can start a whole batch before the
// first use: a load under a branch waits for the one before it.

// the signed byte the sidecar dot takes for slot row j: code - 128 for
// 8-bit codes (offset binary, V xor 0x80), the nibble itself for 4-bit
template <int SIDE_BITS>
__device__ __forceinline__ int side_code(const uint8_t* __restrict__ side, int j, int col, int oc,
                                         int kps) {
  if (SIDE_BITS == 8) return (int)(side[(size_t)j * oc + col] ^ 0x80u);
  const int half = kps / 2;
  const int s = j / kps;
  const int r = j - s * kps;
  const uint8_t v = side[(size_t)(s * half + (r % half)) * oc + col];
  return r < half ? (v & 15) : (v >> 4);
}

template <int SIDE_BITS, bool STACKED>
__global__ void __launch_bounds__(THREADS)
pb_int8_matmul_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                      const float* __restrict__ rs, const int8_t* __restrict__ xg8,
                      const float* __restrict__ rsg, const uint32_t* __restrict__ sign,
                      const uint8_t* __restrict__ side, const float* __restrict__ coef,
                      float* __restrict__ out, int m, int ic, int oc, int pack_block,
                      int k_pad, int kps, int col_tile, const int* __restrict__ layer) {
  if (STACKED) {  // layer li of the stacked planes (unsharded, one row group)
    const size_t li = (size_t)__ldg(layer);
    sign += li * (size_t)(ic / 32) * oc;
    side += li * (size_t)(SIDE_BITS == 4 ? k_pad / 2 : k_pad) * oc;
    coef += li * 5 * (size_t)oc;
  }
  __shared__ __align__(16) int xq[TM][CHW][8];
  __shared__ int red_b[WARPS][TM][TN];
  __shared__ int red_v[WARPS][TM][TN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * TN + lane;
  const int lcol = min(col, oc - 1);  // load column (a lane past oc loads and discards)
  const int m0 = blockIdx.y * TM;
  const int nwords = ic / 32;

  int acc_b[TM];
  int acc_v[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { acc_b[i] = 0; acc_v[i] = 0; }

  // x rows of this m tile; rows past m read row m-1 (their sums are never stored)
  const int8_t* xrow[TM];
#pragma unroll
  for (int mi = 0; mi < TM; ++mi) xrow[mi] = x8 + (size_t)min(m0 + mi, m - 1) * ic;

  // ---- bit-plane dot: sum_r x8[mi, r] * bit[r, col] ----
  // staging map: thread t stages word row wl = t % CHW of the chunk, bit
  // groups b = t / CHW + 4u (u = 0, 1), for every row mi
  const int s_wl = threadIdx.x % CHW;
  const int s_b = threadIdx.x / CHW;
  for (int w0 = 0; w0 < nwords; w0 += CHW) {
    // this chunk's sign words first, so their latency overlaps the staging
    // (a word past the plane counts as 0 and adds nothing)
    uint32_t words[WPW];
#pragma unroll
    for (int u = 0; u < WPW; ++u) {
      const int wr = w0 + warp + u * WARPS;
      const uint32_t w = sign[(size_t)min(wr, nwords - 1) * oc + lcol];
      words[u] = wr < nwords ? w : 0u;
    }
    // xq[mi][wl][b] packs the x bytes of rows blk_off + (b + 8j)*g + gi,
    // j = 0..3, into one int (neighbouring threads read neighbouring bytes)
    {
      const int wr = min(w0 + s_wl, nwords - 1);
      const int blk_off = (wr * 32 / pack_block) * pack_block;
      const int g = min(pack_block, ic - blk_off) / 32;
      const int base = blk_off + wr - blk_off / 32;  // blk_off + gi
      int packed[STAGE];
#pragma unroll
      for (int k = 0; k < STAGE; ++k) {
        const int mi = k / 2;
        const int b = s_b + 4 * (k % 2);
        const int8_t* xr = xrow[mi] + base + b * g;
        packed[k] = (int)(uint8_t)xr[0] | ((int)(uint8_t)xr[8 * g] << 8) |
                    ((int)(uint8_t)xr[16 * g] << 16) | ((int)(uint8_t)xr[24 * g] << 24);
      }
#pragma unroll
      for (int k = 0; k < STAGE; ++k) xq[k / 2][s_wl][s_b + 4 * (k % 2)] = packed[k];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < WPW; ++u) {
      const int wl = warp + u * WARPS;
      int bb[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) bb[b] = (int)((words[u] >> b) & 0x01010101u);
#pragma unroll
      for (int mi = 0; mi < TM; ++mi) {
        // the row's 8 packed x ints in two 16-byte broadcast loads
        const int4 lo = *reinterpret_cast<const int4*>(&xq[mi][wl][0]);
        const int4 hi = *reinterpret_cast<const int4*>(&xq[mi][wl][4]);
        int a = acc_b[mi];
        a = __dp4a(lo.x, bb[0], a);
        a = __dp4a(lo.y, bb[1], a);
        a = __dp4a(lo.z, bb[2], a);
        a = __dp4a(lo.w, bb[3], a);
        a = __dp4a(hi.x, bb[4], a);
        a = __dp4a(hi.y, bb[5], a);
        a = __dp4a(hi.z, bb[6], a);
        a = __dp4a(hi.w, bb[7], a);
        acc_b[mi] = a;
      }
    }
    __syncthreads();
  }

  // ---- sidecar dot: sum_j xg8[t, mi, j] * code(j, col), t = col's row group;
  // four slot rows ride one __dp4a (k_pad % 4 == 0) ----
  {
    const int t = lcol / col_tile;
    const int8_t* xg[TM];
#pragma unroll
    for (int mi = 0; mi < TM; ++mi) xg[mi] = xg8 + ((size_t)t * m + min(m0 + mi, m - 1)) * k_pad;
    for (int j0 = warp * 4; j0 < k_pad; j0 += WARPS * 4 * SU) {
      int c4[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int j = j0 + u * WARPS * 4;
        const int jl = min(j, k_pad - 4);
        int c = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          c |= (side_code<SIDE_BITS>(side, jl + q, lcol, oc, kps) & 0xFF) << (8 * q);
        c4[u] = j < k_pad ? c : 0;  // a step past k_pad adds nothing
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int jl = min(j0 + u * WARPS * 4, k_pad - 4);
#pragma unroll
        for (int mi = 0; mi < TM; ++mi)
          acc_v[mi] = __dp4a(*reinterpret_cast<const int*>(xg[mi] + jl), c4[u], acc_v[mi]);
      }
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
  int ab = 0, av = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    ab += red_b[w][mi][threadIdx.x % TN];
    av += red_v[w][mi][threadIdx.x % TN];
  }
  const int n_rg_idx = ocol / col_tile;
  const float s = sx[row];
  const float g_rs = rsg[(size_t)n_rg_idx * m + row];
  float side_f = __fmul_rn((float)av, s);
  if (SIDE_BITS == 8) side_f = __fadd_rn(side_f, __fmul_rn(128.0f, g_rs));
  const float alpha2 = coef[ocol];
  const float beta = coef[oc + ocol];
  const float gamma = coef[2 * oc + ocol];
  const float hs = coef[3 * oc + ocol];
  const float bias = coef[4 * oc + ocol];
  const float y_bin = __fmul_rn(__fmul_rn((float)ab, s), alpha2);
  float y = __fadd_rn(__fmul_rn(rs[row], beta), y_bin);
  y = __fadd_rn(y, __fmul_rn(side_f, hs));
  y = __fadd_rn(y, __fmul_rn(g_rs, gamma));
  y = __fadd_rn(y, bias);
  out[(size_t)row * oc + ocol] = y;
}

template <bool STACKED>
int launch(const void* x8, const void* sx, const void* rs, const void* xg8, const void* rsg,
           const void* sign, const void* side, const void* coef, void* out, int m, int ic,
           int oc, int pack_block, int side_bits, int k_pad, int kps, int col_tile,
           const void* layer, void* stream) {
  dim3 grid((oc + TN - 1) / TN, (m + TM - 1) / TM);
  cudaStream_t st = (cudaStream_t)stream;
#define PB_ARGS (const int8_t*)x8, (const float*)sx, (const float*)rs, (const int8_t*)xg8, \
    (const float*)rsg, (const uint32_t*)sign, (const uint8_t*)side, (const float*)coef, \
    (float*)out, m, ic, oc, pack_block, k_pad, kps, col_tile, (const int*)layer
  if (side_bits == 8) {
    pb_int8_matmul_kernel<8, STACKED><<<grid, THREADS, 0, st>>>(PB_ARGS);
  } else if (side_bits == 4) {
    pb_int8_matmul_kernel<4, STACKED><<<grid, THREADS, 0, st>>>(PB_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PB_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pb_int8_matmul(const void* x8, const void* sx, const void* rs, const void* xg8,
                              const void* rsg, const void* sign, const void* side,
                              const void* coef, void* out, int m, int ic, int oc,
                              int pack_block, int side_bits, int k_pad, int kps,
                              int col_tile, int n_rg, void* stream) {
  (void)n_rg;
  return launch<false>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc, pack_block,
                       side_bits, k_pad, kps, col_tile, nullptr, stream);
}

// sign: u32 [L, ic/32, oc]; side: u8 [L, k_pad(/2), oc]; coef: f32 [L, 5, oc];
// layer: a device int32, the layer li; the rest as pb_int8_matmul (one row
// group, unsharded: col_tile = oc, kps = k_pad).
extern "C" int pb_int8_matmul_stacked(const void* x8, const void* sx, const void* rs,
                                      const void* xg8, const void* rsg, const void* sign,
                                      const void* side, const void* coef, void* out,
                                      const void* layer, int m, int ic, int oc, int pack_block,
                                      int side_bits, int k_pad, void* stream) {
  return launch<true>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc, pack_block,
                      side_bits, k_pad, k_pad, oc, layer, stream);
}
