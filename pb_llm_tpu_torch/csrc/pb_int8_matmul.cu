// pb_int8_matmul — PBW-v2 int8 packed matmul for Hopper (sm_90a), in two
// arms: __dp4a on the CUDA cores, and wgmma int8 on the tensor cores.
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
// int32 (|sum| <= ic*127*255 < 2^31), so the two arms, which sum in other
// orders, give the same integers; the f32 epilogue uses __fmul_rn/__fadd_rn
// in the plain PyTorch version's order
// (pb_llm_tpu_torch/ops/packed_matmul.py::_epilogue), so either arm agrees
// with the plain version, and with the other arm, to the last bit.
//
// Layout read as stored: bit b of word gi in pack block blk holds weight
// row blk_off + b*g + gi (g = rows_in_block / 32).  Nibble sidecars pair
// slot row r with r + kps/2 per shard segment (low / high nibble).
// packed_matmul.int8_arm picks the arm by rows and layout (M_TC there).
//
// The dp4a arm (pb_int8_matmul_kernel, x8 in natural column order): below
// M_TC rows and for the layouts the tensor cores do not take.  What bounds
// it on the H100: at decode m (8 slots) it is a stream of the
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
// once per 8-row m tile from L2, and dp4a's instruction rate (4 MACs a
// lane) bounds it: 0.4 ms at best at m = 512 on 4096x11008, 1.09 ms
// measured on an H100 at 700 W.
//
// The tensor-core arm (tc::kernel, wgmma and TMA; x8 in the TPU kernel's
// byte order).  What bounds it: the operations, 2*m*oc*(ic + k_pad) int8
// MACs against 1979 TOP/s, at prefill rows (at 512 rows on 4096x11008 51
// GOP, 0.026 ms; bytes 0.011 ms).  The product is taken transposed:
// weights are wgmma's A operand, from registers (M = 128 output columns a
// block, 64 a warpgroup), x rows its N (64 or 128 a block), so a sign word
// never leaves its packed form.  A register of the A fragment holds 4
// consecutive k of one row, and in byte_permute_x's order (within a pack
// block of g words, column (8j + b)*g + i moves to b*4g + 4i + j) those are
// bits b, b+8, b+16, b+24 of word i: one shift and one AND with 0x01010101
// (pallas_pb.py::_bit_plane_bytes_int8).  The K loop runs over groups of 8
// words: a thread loads its 4 words of the group once and makes the A
// registers of all 8 bits from them.  pb_prep_int8.cu writes x8 in that
// order with each bit run padded from 4g to 4*round_up(g, 8) bytes (zeros)
// and the runs' 32-byte pieces of one word group side by side, so a group
// is 256 contiguous bytes of a row for any g (llama-7b's ic = 11008 packs
// in blocks of 1376, g = 43) and the words past g meet zero x.  TMA copies
// a group's x as two 128-byte boxes, 128-byte swizzled, which wgmma reads
// as K-major B; its 8 sign-word rows as one box; one thread states the
// bytes on the stage's mbarrier and asks, 4 stages ahead of the MMAs (an
// earlier version whose threads issued 16-byte cp.async copies spent most
// of each stage issuing them; 16-byte bulk copies were slower still).  The sidecar rides the same wgmma: A =
// the codes of the block's columns, a box of 128 slot rows (128-byte
// swizzled; 8 packed rows a box for nibble codes, per shard segment and
// nibble half) gathered 4 slot rows to a register (xor 0x80 for 8-bit
// codes; the nibble half for 4-bit ones), B = 128-byte boxes of xg8[t],
// padded with zeros to 32 slots.  Rows and columns past the tensors arrive
// as zeros.  The epilogue stores from the accumulator fragment (column by
// x row), each store a full 32-byte sector per 8 lanes.  A 128-column tile
// must lie in one row group (col_tile a multiple of 128, or one group), oc
// be a multiple of 16 and nibble shard segments of 16 slots; int8_arm
// sends other layouts to the dp4a arm.
//
// pb_int8_matmul_stacked replaces pallas_pb.py::_stacked_int8_kernel (entry
// pb_matmul_pallas_v2_stacked, the scan_layers path): the same function on
// layer li of [L, ic/32, oc] sign planes, [L, k_pad(/2), oc] codes and an
// [L, 5, oc] coefficient array, with li read by the block from a device
// int32 (the counterpart of the TPU kernel's scalar prefetch).  Either
// arm's kernel is instantiated with STACKED: the dp4a block offsets its
// three plane pointers by li, the tensor-core block its TMA rows (the maps
// span all L layers) and its coefficient pointer, and each runs the flat
// device code unchanged, so stacked equals flat bit for bit.  What it buys on this card: a layer's slice of
// a stacked tensor is already a view in PyTorch, so the per-layer copy the
// TPU kernel avoids never happens here; what it gives is a launch whose
// arguments are the same for every layer, which a CUDA graph of the layer
// loop needs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_sm90.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core arm (wgmma, TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace sm90;

constexpr int THREADS = 256;  // 2 warpgroups, each 64 columns x all TN rows
constexpr int STAGES = 4;     // the ring of TMA copies
constexpr int NS = 2;         // A register sets: one read by the wgmma in flight, one made
constexpr unsigned ONES = 0x01010101u;

// a block's tile: OC = 128 columns (the wgmma's M, 64 a warpgroup), TN x
// rows (its N).  A stage holds either a word group (x: two 128-byte atoms
// of its 8 bit runs for TN rows; 8 sign-word rows of OC words) or SK = 128
// sidecar slots (xg: one atom of TN rows; the code box of 128 rows x OC
// bytes).  Atoms and the code box are 128-byte swizzled (16-byte chunk ^
// row % 8), as TMA writes them and wgmma reads them.
constexpr int OC = 128;
constexpr int SK = 128;

template <int TN>
struct Cfg {
  static constexpr int main_bytes = TN * 256 + 8 * OC * 4;
  static constexpr int codes_at = up1024(TN * SK);
  static constexpr int side_bytes = codes_at + SK * OC;
  static constexpr int stage = up1024(main_bytes > side_bytes ? main_bytes : side_bytes);
  static constexpr int total = STAGES * stage + 1024 + STAGES * 8;  // + alignment, mbarriers
  static_assert(TN % 32 == 0 && TN <= 256, "tile shape");
};

// x8's byte-permuted, padded row: full pack blocks of g words (g8 =
// round_up(g, 8) padded words each), then the shorter last block, if any
struct Geo {
  int gf, g8f, nfull, gl, g8l, ngf, ng;  // x8's row: 256 bytes a word group, ng groups
};

__host__ __device__ __forceinline__ Geo geometry(int ic, int pb) {
  Geo q;
  q.gf = pb / 32;
  q.g8f = (q.gf + 7) & ~7;
  q.nfull = ic / pb;
  q.gl = (ic - q.nfull * pb) / 32;
  q.g8l = (q.gl + 7) & ~7;
  q.ngf = q.g8f / 8;
  q.ng = q.nfull * q.ngf + q.g8l / 8;
  return q;
}

template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(int* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(int* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(int* d, const unsigned* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The tensor maps (host side, `maps`): mx x8 [icp bytes, m rows]; mxg xg8
// [kst bytes, m rows, n_rg]; msg the sign words [oc, L*ic/32] (u32); mcd
// the codes [oc, L*rows] (u8).  Boxes of 128 bytes, 128-byte swizzled, but
// the sign words'.  Out-of-range rows and columns arrive as zeros.
template <int SIDE_BITS, bool STACKED, int TN>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mxg,
       const __grid_constant__ CUtensorMap msg,
       const __grid_constant__ CUtensorMap mcd, const float* __restrict__ sx,
       const float* __restrict__ rs, const float* __restrict__ rsg,
       const float* __restrict__ coef, float* __restrict__ out, int m, int ic, int oc,
       int pack_block, int k_pad, int kps, int col_tile, const int* __restrict__ layer) {
  using C = Cfg<TN>;
  constexpr int STAGE = C::stage;
  int li = 0;
  if (STACKED) {
    li = __ldg(layer);
    coef += (size_t)li * 5 * oc;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const Geo G = geometry(ic, pack_block);
  const int kst = (k_pad + 31) & ~31;  // xg8's slots, padded with zeros
  const int code_rows = SIDE_BITS == 4 ? k_pad / 2 : k_pad;
  const int oc0 = blockIdx.x * OC;
  const int m0 = blockIdx.y * TN;
  const int t = oc0 / col_tile;  // the tile's row group (one group a tile)
  const int n_main = G.ng;
  const int n_total = n_main + (kst + SK - 1) / SK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, q = lane & 3;
  // warpgroup warp/4 owns columns 64*(warp/4)..; its warp w%4 the 16 from 16*(w%4)
  const int wo = 64 * (warp >> 2) + 16 * (warp & 3);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage st's copies, issued by thread 0: it states the bytes, then asks
  auto load = [&](int st) {
    uint8_t* sb = smem + (st % STAGES) * STAGE;
    uint64_t* bar = bars + st % STAGES;
    if (st < n_main) {  // word group st: bytes 256st.. of the x rows; 8 word rows
      expect(bar, TN * 256 + 8 * OC * 4);
      tma2(sb, &mx, 256 * st, m0, bar);
      tma2(sb + TN * 128, &mx, 256 * st + 128, m0, bar);
      const bool full = st < G.nfull * G.ngf;
      const int blk = full ? st / G.ngf : G.nfull;
      const int s = st - blk * G.ngf;
      tma2(sb + TN * 256, &msg, oc0, li * (ic / 32) + blk * G.gf + 8 * s, bar);  // past g: zero x
    } else {  // sidecar slots j0..j0+127: their xg bytes; the code rows of those slots
      const int j0 = (st - n_main) * SK;
      expect(bar, TN * SK + SK * OC);
      tma3(sb, &mxg, j0, m0, t, bar);
      uint8_t* cs = sb + C::codes_at;
      if (SIDE_BITS == 8) {  // slots past k_pad meet zero xg
        tma2(cs, &mcd, oc0, li * code_rows + j0, bar);
      } else {  // 8 slots at a time: the packed rows of a shard segment's nibble half
        for (int g = 0; g < SK / 8; ++g) {
          const int j = j0 + 8 * g, sh = j / kps, r = j - sh * kps, half = kps / 2;
          tma2(cs + g * 1024, &mcd, oc0, li * code_rows + sh * half + (r % half), bar);
        }
      }
    }
  };

  int acc_b[TN / 2];
  int acc_v[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    acc_b[e] = 0;
    acc_v[e] = 0;
  }

  if (tid == 0)
    for (int st = 0; st < STAGES - 1 && st < n_total; ++st) load(st);
#pragma unroll 1
  for (int st = 0; st < n_total; ++st) {
    wait_phase(bars + st % STAGES, (st / STAGES) & 1);
    __syncthreads();  // every warpgroup is done with stage st-1: its slot is free
    if (tid == 0 && st + STAGES - 1 < n_total) load(st + STAGES - 1);
    const uint8_t* sb = smem + (st % STAGES) * STAGE;
    unsigned a[NS][4];  // NS sets: one read by the wgmma in flight, one being made
    if (st < n_main) {
      // the A register of unit u (k = 4u..4u+3) of row c holds bits b, b+8,
      // b+16, b+24 of word u: rows gid, gid+8; units q, q+4
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(sb + TN * 256);
      const int c = wo + gid;
      const uint32_t w[4] = {ws[q * OC + c], ws[q * OC + c + 8], ws[(q + 4) * OC + c],
                             ws[(q + 4) * OC + c + 8]};
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[b % NS][r] = (w[r] >> b) & ONES;
        fence();
        // run b: atom b/4, bytes 32(b%4)..
        Wgmma<TN>::run(acc_b, a[b % NS], desc(sb + (b >> 2) * TN * 128 + 32 * (b & 3)));
        commit();
        wait<NS - 1>();  // the set made next is free
      }
    } else {
      const uint8_t* cs = sb + C::codes_at;
      const int j0 = (st - n_main) * SK;
#pragma unroll
      for (int kk = 0; kk < SK / 32; ++kk) {
        int nib[2] = {0, 0};  // the nibble's shift of slots kk*32 + 4q (+16)
        if (SIDE_BITS == 4) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = j0 + kk * 32 + 16 * hh + 4 * q;
            nib[hh] = (j % kps) >= kps / 2 ? 4 : 0;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: column + 8*(r&1), slots + 16*(r>>1)
          const int col = wo + gid + 8 * (r & 1);
          const int j = kk * 32 + 16 * (r >> 1) + 4 * q;
          unsigned v = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u)  // the 128-byte swizzle: chunk ^ row % 8
            v |= (unsigned)cs[(j + u) * 128 + (((col >> 4) ^ ((j + u) & 7)) << 4) + (col & 15)]
                 << (8 * u);
          a[kk % NS][r] = SIDE_BITS == 8 ? (v ^ 0x80808080u) : ((v >> nib[r >> 1]) & 0x0F0F0F0Fu);
        }
        fence();
        Wgmma<TN>::run(acc_v, a[kk % NS], desc(sb + 32 * kk));
        commit();
        wait<NS - 1>();
      }
    }
    wait<0>();  // the stage's shared memory is read before the ring reuses it
  }

  // epilogue: accumulator element 4i + e is column wo + gid + 8(e/2), x
  // row 8i + 2q + e%2
  {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int col = oc0 + wo + gid + 8 * hr;
      if (col >= oc) continue;
      const float alpha2 = coef[col];
      const float beta = coef[oc + col];
      const float gamma = coef[2 * oc + col];
      const float hs = coef[3 * oc + col];
      const float bias = coef[4 * oc + col];
#pragma unroll
      for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * i + 2 * q + e;
          if (row >= m) continue;
          const float s = sx[row];
          const float g_rs = rsg[(size_t)t * m + row];
          const int ab = acc_b[4 * i + 2 * hr + e], av = acc_v[4 * i + 2 * hr + e];
          float side_f = __fmul_rn((float)av, s);
          if (SIDE_BITS == 8) side_f = __fadd_rn(side_f, __fmul_rn(128.0f, g_rs));
          const float y_bin = __fmul_rn(__fmul_rn((float)ab, s), alpha2);
          float y = __fadd_rn(__fmul_rn(rs[row], beta), y_bin);
          y = __fadd_rn(y, __fmul_rn(side_f, hs));
          y = __fadd_rn(y, __fmul_rn(g_rs, gamma));
          y = __fadd_rn(y, bias);
          out[(size_t)row * oc + col] = y;
        }
      }
    }
  }
}

struct Maps {
  CUtensorMap x, xg, sg, cd;
};

// x8: [m, icp] bytes; xg8: [n_rg, m, kst]; sign: [L*ic/32, oc] u32; side:
// [L*rows, oc] bytes
inline bool maps(Maps* M, int oc_tile, int tn, int side_bits, const void* x8, const void* xg8,
                 const void* sign, const void* side, int m, int ic, int oc, int pack_block,
                 int k_pad, int n_rg, int n_layers) {
  const Geo G = geometry(ic, pack_block);
  const cuuint64_t icp = 256 * (cuuint64_t)G.ng;
  const cuuint64_t kst = (k_pad + 31) & ~31;
  const int rows = side_bits == 4 ? k_pad / 2 : k_pad;
  const cuuint64_t x_dims[2] = {icp, (cuuint64_t)m}, x_strides[1] = {icp};
  const cuuint64_t xg_dims[3] = {kst, (cuuint64_t)m, (cuuint64_t)n_rg};
  const cuuint64_t xg_strides[2] = {kst, kst * m};
  const cuuint32_t x_box[3] = {128, (cuuint32_t)tn, 1};
  const cuuint64_t sg_dims[2] = {(cuuint64_t)oc, (cuuint64_t)n_layers * (ic / 32)};
  const cuuint64_t sg_strides[1] = {(cuuint64_t)oc * 4};
  const cuuint32_t sg_box[2] = {(cuuint32_t)oc_tile, 8};
  const cuuint64_t cd_dims[2] = {(cuuint64_t)oc, (cuuint64_t)n_layers * rows};
  const cuuint64_t cd_strides[1] = {(cuuint64_t)oc};
  const cuuint32_t cd_box[2] = {128, (cuuint32_t)(side_bits == 8 ? SK : 8)};
  return encode(&M->x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x8, x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&M->xg, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xg8, xg_dims, xg_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&M->sg, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, sign, sg_dims, sg_strides, sg_box,
                CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&M->cd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, side, cd_dims, cd_strides, cd_box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tc

template <int SIDE_BITS, bool STACKED, int TN>
int launch_tc_as(const void* x8, const void* sx, const void* rs, const void* xg8, const void* rsg,
                 const void* sign, const void* side, const void* coef, void* out, int m, int ic,
                 int oc, int pack_block, int k_pad, int kps, int col_tile, int n_rg,
                 int n_layers, const void* layer, cudaStream_t st) {
  using C = tc::Cfg<TN>;
  auto kern = tc::kernel<SIDE_BITS, STACKED, TN>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  tc::Maps M;
  if (!tc::maps(&M, tc::OC, TN, SIDE_BITS, x8, xg8, sign, side, m, ic, oc, pack_block, k_pad, n_rg,
                n_layers))
    return (int)cudaErrorInvalidValue;
  dim3 grid((oc + tc::OC - 1) / tc::OC, (m + TN - 1) / TN);
  kern<<<grid, tc::THREADS, C::total, st>>>(M.x, M.xg, M.sg, M.cd, (const float*)sx,
                                            (const float*)rs, (const float*)rsg,
                                            (const float*)coef, (float*)out, m, ic, oc,
                                            pack_block, k_pad, kps, col_tile, (const int*)layer);
  return (int)cudaGetLastError();
}

// the tensor-core arm's block tile: 128 columns x 64 rows up to 256 rows
// of x (more blocks), x 128 above (half the re-reads of the planes)
template <int SIDE_BITS, bool STACKED>
int launch_tc(const void* x8, const void* sx, const void* rs, const void* xg8, const void* rsg,
              const void* sign, const void* side, const void* coef, void* out, int m, int ic,
              int oc, int pack_block, int k_pad, int kps, int col_tile, int n_rg, int n_layers,
              const void* layer, cudaStream_t st) {
#define PB_TC(TN) launch_tc_as<SIDE_BITS, STACKED, TN>(x8, sx, rs, xg8, rsg, sign, side, coef, \
    out, m, ic, oc, pack_block, k_pad, kps, col_tile, n_rg, n_layers, layer, st)
  return m <= 256 ? PB_TC(64) : PB_TC(128);
#undef PB_TC
}

template <bool STACKED>
int launch(const void* x8, const void* sx, const void* rs, const void* xg8, const void* rsg,
           const void* sign, const void* side, const void* coef, void* out, int m, int ic,
           int oc, int pack_block, int side_bits, int k_pad, int kps, int col_tile, int n_rg,
           int n_layers, const void* layer, int arm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (side_bits != 8 && side_bits != 4) return (int)cudaErrorInvalidValue;
  if (arm == 1) {  // tensor cores: one row group a 128-column tile, 16-byte code rows
    if (oc % 16 || (col_tile < oc && col_tile % 128) || m <= 0 || (side_bits == 4 && kps % 16))
      return (int)cudaErrorInvalidValue;
    return side_bits == 8
               ? launch_tc<8, STACKED>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc,
                                       pack_block, k_pad, kps, col_tile, n_rg, n_layers, layer, st)
               : launch_tc<4, STACKED>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc,
                                       pack_block, k_pad, kps, col_tile, n_rg, n_layers, layer, st);
  }
  if (arm != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((oc + TN - 1) / TN, (m + TM - 1) / TM);
#define PB_ARGS (const int8_t*)x8, (const float*)sx, (const float*)rs, (const int8_t*)xg8, \
    (const float*)rsg, (const uint32_t*)sign, (const uint8_t*)side, (const float*)coef, \
    (float*)out, m, ic, oc, pack_block, k_pad, kps, col_tile, (const int*)layer
  if (side_bits == 8) {
    pb_int8_matmul_kernel<8, STACKED><<<grid, THREADS, 0, st>>>(PB_ARGS);
  } else {
    pb_int8_matmul_kernel<4, STACKED><<<grid, THREADS, 0, st>>>(PB_ARGS);
  }
#undef PB_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// arm: 0 = dp4a (x8 [m, ic] in natural order, xg8 [n_rg, m, k_pad]); 1 =
// tensor cores (x8 [icp/16, m, 16]: byte_permute_x's order with padded bit
// runs, in 16-byte chunks; xg8 [n_rg, kst/16, m, 16], kst = round_up(k_pad,
// 32), zero-padded: pb_prep_int8's layouts).
extern "C" int pb_int8_matmul(const void* x8, const void* sx, const void* rs, const void* xg8,
                              const void* rsg, const void* sign, const void* side,
                              const void* coef, void* out, int m, int ic, int oc,
                              int pack_block, int side_bits, int k_pad, int kps,
                              int col_tile, int n_rg, int arm, void* stream) {
  return launch<false>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc, pack_block,
                       side_bits, k_pad, kps, col_tile, n_rg, 1, nullptr, arm, stream);
}

// sign: u32 [L, ic/32, oc]; side: u8 [L, k_pad(/2), oc]; coef: f32 [L, 5, oc];
// layer: a device int32, the layer li; n_layers: L; the rest as
// pb_int8_matmul (one row group, unsharded: col_tile = oc, kps = k_pad).
extern "C" int pb_int8_matmul_stacked(const void* x8, const void* sx, const void* rs,
                                      const void* xg8, const void* rsg, const void* sign,
                                      const void* side, const void* coef, void* out,
                                      const void* layer, int m, int ic, int oc, int pack_block,
                                      int side_bits, int k_pad, int n_layers, int arm,
                                      void* stream) {
  return launch<true>(x8, sx, rs, xg8, rsg, sign, side, coef, out, m, ic, oc, pack_block,
                      side_bits, k_pad, k_pad, oc, 1, n_layers, layer, arm, stream);
}
