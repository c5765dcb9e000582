// pb_bf16_tc.cuh — the PBW-v2 packed matmul on the bf16 tensor cores
// (sm_90a: wgmma bf16 -> f32, TMA, mbarriers), shared by pb_pair_v2.cu (the
// pair arm: one bf16 term of x) and pb_f32_matmul.cu (the exact f32 arm:
// three bf16 terms of x; one term for decode_dot bf16).
//
// The function, for x [m, ic] f32, 1-bit lows (sign plane B), the salient
// sidecar V (8-bit bytes or 4-bit nibbles) and xg [n_rg, m, k_pad], x
// gathered at each row group's salient columns:
//
//   y = rs*beta + (x' . B)*alpha2 + (xg' . V)*hs + rsg*gamma + bias
//
// with x' = bf16(x) for TERMS = 1 (pb_pair_v2_plain, pb_f32_matmul_plain
// with dot bf16) and x' = x for TERMS = 3 (pb_f32_matmul_plain with dot
// f32); rs and rsg are the f32 row sums of the unrounded x and xg, from the
// wrapper.  The epilogue uses __fmul_rn/__fadd_rn in the plain version's
// order.
//
// Terms (packed_matmul.split_terms): an f32 x splits exactly into
// hi + mid*2^-8 + lo*2^-16 with hi, mid, lo bf16, each cut by truncation
// (hi = x with its low 16 bits cleared; mid and lo the same on the rest,
// scaled up by 2^8), which holds for every finite f32, subnormal and huge
// included.  Each plane's product runs on the tensor cores with the plane's
// scale folded into A: the sign bits as bf16 {0, 2}, {0, 2^-7}, {0, 2^-15}
// for hi, mid, lo (the factor 2 leaves with a * 0.5 in the epilogue, as in
// the TPU kernel's {0, 2} planes), the codes (<= 255) as bf16 code,
// code*2^-8, code*2^-16.  Every product is exact in f32.  A stage (one
// plane of one word group, or of 64 sidecar slots) sums its products on the
// tensor cores into a fresh f32 partial, which then adds into the row's f32
// accumulator with __fadd_rn: the planes lo first, then mid, then hi, for
// each word group in turn, then the sidecar chunks.  The sums run over k in
// that fixed order whatever m is (the row tile TN changes how many rows a
// block holds, not the order).  The tensor cores' own f32 sums truncate;
// summing the whole K there put 3.4e-4 on a y of llama-7b's 11008x4096
// layer at 512 rows on an H100, beyond the 1e-4 bound; a stage's partial
// is small, so its truncation is too.
//
// What bounds it on the H100: the operations, TERMS * 2*m*oc*(ic + k_pad)
// against 989 TFLOP/s, at prefill rows (3 terms at 512 rows on 4096x11008:
// 0.14 ms); at decode rows the bytes of the packed planes (4096x11008: 5.6
// MB of sign words, 4.6 MB of codes, 3 us at 3.35 TB/s).
//
// Design, after pb_int8_matmul.cu's tensor-core arm.  The product is taken
// transposed: the weights are wgmma's A (M = 128 output columns a block, 64
// a warpgroup), from registers, so a sign word never leaves its packed form;
// x rows are its N (TN = 16, 64 or 128 rows a block).  A register of the
// m64nNk16 A fragment holds two neighbouring k of one column; in the
// pair-permuted order of x (pallas_pb.pair_permute_x: within a pack block of
// g words, column p*2g + 2i + h holds x of weight row (p + 16h)*g + i) those
// are bits p and p+16 of word i, so the A register of bit pair p is
// ((w >> p) & 0x00010001) * scale: a k16 step covers 8 words at one p, and
// a word group of 8 words 16 steps.  The wrapper lays x out
// (packed_matmul.tc_pair_columns) with each bit pair's run of 2g values
// padded to 2*round_up(g, 8) (zeros) and the runs' 16-value pieces of one
// word group side by side, so a word group is 256 contiguous bf16 of a row
// (4 TMA boxes of 64, 128-byte swizzled, which wgmma reads as K-major B)
// for any g (llama-7b's ic = 11008 packs in blocks of 1376, g = 43), and the
// words past g meet zero x.  A stage of the ring holds one plane of one
// word group (its 4 boxes of TN rows and the group's 8 sign-word rows of the
// block's 128 columns) or one plane of 64 sidecar slots (one box of xg's
// plane, padded with zeros to 64 slots; the codes of those slots, a box of
// 64 rows of 128 bytes, 128-byte swizzled; 8 packed rows a box for nibble
// codes, per shard segment and nibble half).  One thread states the bytes
// on the stage's mbarrier and asks STAGES - 1 stages ahead; two A register
// sets alternate (one read by the wgmma in flight).  Rows and columns past
// the tensors arrive as zeros.  A 128-column tile must lie in one row group
// (col_tile a multiple of 128, or one group), oc be a multiple of 16 and
// nibble shard segments of 16 slots (packed_matmul.tc_layout_ok).
//
// K split (ksplit > 1, the pair arm at decode rows): the stages are cut into
// ksplit ranges of whole units (word groups, then 64-slot sidecar chunks),
// one a block (blockIdx.z); each block writes its raw partial sums to a
// workspace, and a second kernel adds the ranges' sums in range order and
// runs the epilogue.  The wrapper picks ksplit from the layer's shape alone,
// so the order stays fixed whatever m is; nothing is summed by atomics.
//
// The stacked entry (STACKED): layer li of [L, ic/32, oc] sign planes,
// [L, rows, oc] codes and [L, 5, oc] coefficients, li read once from a
// device int32 and added to the TMA rows (the maps span all L layers); the
// flat device code runs unchanged, so stacked equals flat bit for bit.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pb_sm90.cuh"

namespace {
namespace bf16tc {

using namespace sm90;

constexpr int THREADS = 256;  // 2 warpgroups, each 64 columns x all TN rows
constexpr int NS = 2;         // A register sets: one read by the wgmma in flight, one made
constexpr int OC = 128;       // output columns a block (wgmma M, 64 a warpgroup)
constexpr int BK = 64;        // bf16 values of a 128-byte swizzled box row
constexpr int SK = 64;        // sidecar slots a stage
constexpr int GROUP = 256;    // bf16 values of a word group in a row of x (4 boxes)

// a stage: a word group's plane (4 boxes of TN rows x 128 bytes, then 8
// sign-word rows of OC words) or a sidecar chunk's plane (one box, then the
// codes at codes_at: SK rows x 128 bytes)
template <int TN>
struct Cfg {
  static constexpr int stages = TN >= 128 ? 3 : 4;
  static constexpr int main_bytes = 4 * TN * 128 + 8 * OC * 4;
  static constexpr int codes_at = up1024(TN * 128);
  static constexpr int side_bytes = codes_at + SK * 128;
  static constexpr int stage = up1024(main_bytes > side_bytes ? main_bytes : side_bytes);
  static constexpr int total = stages * stage + 1024 + stages * 8;  // + alignment, mbarriers
  static_assert(TN % 16 == 0 && TN <= 128, "tile shape");
};

// x's permuted, padded row: full pack blocks of g words (g8 = round_up(g, 8)
// padded words each), then the shorter last block, if any; ng word groups
struct Geo {
  int gf, nfull, ngf, ng;
};

__host__ __device__ __forceinline__ Geo geometry(int ic, int pb) {
  Geo q;
  q.gf = pb / 32;
  q.nfull = ic / pb;
  q.ngf = (q.gf + 7) / 8;
  q.ng = q.nfull * q.ngf + ((ic - q.nfull * pb) / 32 + 7) / 8;
  return q;
}

// the bf16 bits of an integer code <= 255 times 2^-8*plane (exact)
__device__ __forceinline__ unsigned code_bf16(unsigned v, float scale) {
  return __float_as_uint((float)v * scale) >> 16;
}

// y from the raw sums (ab of the {0, 2}-scaled planes), the plain version's order
__device__ __forceinline__ float epilogue(float ab, float av, int row, int col, int m, int oc,
                                          int t, const float* __restrict__ rs,
                                          const float* __restrict__ rsg,
                                          const float* __restrict__ coef) {
  ab *= 0.5f;  // {0, 2} planes: the sum of the {0, 1} product, exactly
  const float g_rs = rsg[(size_t)t * m + row];
  float y = __fadd_rn(__fmul_rn(rs[row], coef[oc + col]), __fmul_rn(ab, coef[col]));
  y = __fadd_rn(y, __fmul_rn(av, coef[3 * oc + col]));
  y = __fadd_rn(y, __fmul_rn(g_rs, coef[2 * oc + col]));
  return __fadd_rn(y, coef[4 * oc + col]);
}

// The tensor maps (host side, `maps`): mx the x planes [TERMS, m, icp]
// (bf16); mxg xg's planes [TERMS * n_rg, m, kst] (bf16); msg the sign words
// [L*ic/32, oc] (u32); mcd the codes [L*rows, oc] (u8).  Boxes of 128
// bytes, 128-byte swizzled, but the sign words'.  part: the K split's
// workspace [ksplit, 2, m, oc] (f32), unused when ksplit == 1.
template <int TERMS, int SIDE_BITS, bool STACKED, int TN>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mxg,
       const __grid_constant__ CUtensorMap msg, const __grid_constant__ CUtensorMap mcd,
       const float* __restrict__ rs, const float* __restrict__ rsg,
       const float* __restrict__ coef, float* __restrict__ out, float* __restrict__ part,
       int m, int ic, int oc, int pack_block, int k_pad, int kps, int col_tile, int n_rg,
       int ksplit, const int* __restrict__ layer) {
  using C = Cfg<TN>;
  constexpr int STAGE = C::stage;
  constexpr int STAGES = C::stages;
  int li = 0;
  if (STACKED) {
    li = __ldg(layer);
    coef += (size_t)li * 5 * oc;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);  // 1024-aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  const Geo G = geometry(ic, pack_block);
  const int kst = (k_pad + SK - 1) / SK * SK;  // xg's slots, padded with zeros
  const int code_rows = SIDE_BITS == 4 ? k_pad / 2 : k_pad;
  const int oc0 = blockIdx.x * OC;
  const int m0 = blockIdx.y * TN;
  const int t = oc0 / col_tile;  // the tile's row group (one group a tile)
  const int n_units = G.ng + kst / SK;
  const int per = (n_units + ksplit - 1) / ksplit;  // this block's units: [u0, u1)
  const int u0 = min(n_units, (int)blockIdx.z * per);
  const int n_st = TERMS * (min(n_units, u0 + per) - u0);
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

  // stage i of this block: unit u0 + i / TERMS, plane TERMS - 1 - i % TERMS
  // (lo first); its copies, issued by thread 0, which states the bytes first
  auto load = [&](int i) {
    uint8_t* sb = smem + (i % STAGES) * STAGE;
    uint64_t* bar = bars + i % STAGES;
    const int u = u0 + i / TERMS, pl = TERMS - 1 - i % TERMS;
    if (u < G.ng) {  // word group u: bf16 256u.. of the x rows; 8 word rows
      expect(bar, 4 * TN * 128 + 8 * OC * 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) tma3(sb + a * TN * 128, &mx, GROUP * u + BK * a, m0, pl, bar);
      const bool full = u < G.nfull * G.ngf;
      const int blk = full ? u / G.ngf : G.nfull;
      const int s = u - blk * G.ngf;
      tma2(sb + 4 * TN * 128, &msg, oc0, li * (ic / 32) + blk * G.gf + 8 * s, bar);  // past g: zero x
    } else {  // sidecar slots j0..j0+63: their xg plane; the code rows of those slots
      const int j0 = (u - G.ng) * SK;
      expect(bar, TN * 128 + SK * 128);
      tma3(sb, &mxg, j0, m0, pl * n_rg + t, bar);
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

  // each stage's product lands in `stg` (the wgmma overwrites it at the
  // stage's first step), then adds into acc_b or acc_v on the CUDA cores:
  // the tensor cores' f32 sums round less exactly than __fadd_rn, and a
  // stage's partial sum is far smaller than the whole
  float acc_b[TN / 2];
  float acc_v[TN / 2];
  float stg[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) {
    acc_b[e] = 0.f;
    acc_v[e] = 0.f;
  }

  if (tid == 0)
    for (int i = 0; i < STAGES - 1 && i < n_st; ++i) load(i);
#pragma unroll 1
  for (int i = 0; i < n_st; ++i) {
    wait_phase(bars + i % STAGES, (i / STAGES) & 1);
    __syncthreads();  // every warpgroup is done with stage i-1: its slot is free
    if (tid == 0 && i + STAGES - 1 < n_st) load(i + STAGES - 1);
    const uint8_t* sb = smem + (i % STAGES) * STAGE;
    const int u = u0 + i / TERMS, pl = TERMS - 1 - i % TERMS;
    unsigned a[NS][4];  // NS sets: one read by the wgmma in flight, one being made
    if (u < G.ng) {
      // the A register of k pair (2j, 2j+1) of column c holds bits p and
      // p+16 of word j: columns gid, gid+8; words q, q+4
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(sb + 4 * TN * 128);
      const int c = wo + gid;
      const uint32_t w[4] = {ws[q * OC + c], ws[q * OC + c + 8], ws[(q + 4) * OC + c],
                             ws[(q + 4) * OC + c + 8]};
      const uint32_t one = pl == 0 ? 0x4000u : pl == 1 ? 0x3C00u : 0x3800u;  // 2, 2^-7, 2^-15
#pragma unroll
      for (int p = 0; p < 16; ++p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[p % NS][r] = ((w[r] >> p) & 0x00010001u) * one;
        fence();
        // bit pair p: box p/4, bytes 32(p%4)..
        Bf16Rs<TN>::run(stg, a[p % NS], desc(sb + (p >> 2) * TN * 128 + 32 * (p & 3)), p > 0);
        commit();
        wait<NS - 1>();  // the set made next is free
      }
    } else {
      const uint8_t* cs = sb + C::codes_at;
      const int j0 = (u - G.ng) * SK;
      const float scale = pl == 0 ? 1.f : pl == 1 ? 0x1p-8f : 0x1p-16f;
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // r: column + 8*(r&1), slots + 8*(r>>1)
          const int col = wo + gid + 8 * (r & 1);
          const int j = kk * 16 + 8 * (r >> 1) + 2 * q;
          // the 128-byte swizzle: 16-byte chunk ^ row % 8
          unsigned v0 = cs[j * 128 + (((col >> 4) ^ (j & 7)) << 4) + (col & 15)];
          unsigned v1 = cs[(j + 1) * 128 + (((col >> 4) ^ ((j + 1) & 7)) << 4) + (col & 15)];
          if (SIDE_BITS == 4) {  // slots j, j+1 lie in one nibble half
            const int nib = ((j0 + j) % kps) >= kps / 2 ? 4 : 0;
            v0 = (v0 >> nib) & 15u;
            v1 = (v1 >> nib) & 15u;
          }
          a[kk % NS][r] = code_bf16(v0, scale) | (code_bf16(v1, scale) << 16);
        }
        fence();
        Bf16Rs<TN>::run(stg, a[kk % NS], desc(sb + 32 * kk), kk > 0);
        commit();
        wait<NS - 1>();
      }
    }
    wait<0>();  // the stage's shared memory is read before the ring reuses it
    if (u < G.ng) {
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc_b[e] = __fadd_rn(acc_b[e], stg[e]);
    } else {
#pragma unroll
      for (int e = 0; e < TN / 2; ++e) acc_v[e] = __fadd_rn(acc_v[e], stg[e]);
    }
  }

  // accumulator element 4i + e is column wo + gid + 8(e/2), x row 8i + 2q + e%2
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int col = oc0 + wo + gid + 8 * hr;
    if (col >= oc) continue;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * i + 2 * q + e;
        if (row >= m) continue;
        const float ab = acc_b[4 * i + 2 * hr + e], av = acc_v[4 * i + 2 * hr + e];
        if (ksplit == 1) {
          out[(size_t)row * oc + col] = epilogue(ab, av, row, col, m, oc, t, rs, rsg, coef);
        } else {
          float* pz = part + (size_t)blockIdx.z * 2 * m * oc;
          pz[(size_t)row * oc + col] = ab;
          pz[(size_t)(m + row) * oc + col] = av;
        }
      }
    }
  }
}

// the K split's second pass: the ranges' raw sums in range order, then the epilogue
__global__ void __launch_bounds__(256)
reduce(const float* __restrict__ part, const float* __restrict__ rs,
       const float* __restrict__ rsg, const float* __restrict__ coef, float* __restrict__ out,
       int m, int oc, int col_tile, int ksplit, const int* __restrict__ layer) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)m * oc) return;
  if (layer) coef += (size_t)__ldg(layer) * 5 * oc;
  const int row = (int)(idx / oc), col = (int)(idx % oc);
  const size_t mo = (size_t)m * oc;
  float ab = part[idx], av = part[mo + idx];
  for (int z = 1; z < ksplit; ++z) {
    ab = __fadd_rn(ab, part[2 * z * mo + idx]);
    av = __fadd_rn(av, part[(2 * z + 1) * mo + idx]);
  }
  out[idx] = epilogue(ab, av, row, col, m, oc, col / col_tile, rs, rsg, coef);
}

struct Maps {
  CUtensorMap x, xg, sg, cd;
};

// xp: [terms, m, icp] bf16; xgp: [terms * n_rg, m, kst] bf16; sign: [L*ic/32,
// oc] u32; side: [L*rows, oc] bytes
inline bool maps(Maps* M, int tn, int terms, int side_bits, const void* xp, const void* xgp,
                 const void* sign, const void* side, int m, int ic, int oc, int pack_block,
                 int k_pad, int n_rg, int n_layers) {
  const Geo G = geometry(ic, pack_block);
  const cuuint64_t icp = (cuuint64_t)GROUP * G.ng;
  const cuuint64_t kst = (k_pad + SK - 1) / SK * SK;
  const int rows = side_bits == 4 ? k_pad / 2 : k_pad;
  const cuuint64_t x_dims[3] = {icp, (cuuint64_t)m, (cuuint64_t)terms};
  const cuuint64_t x_strides[2] = {icp * 2, icp * 2 * m};
  const cuuint64_t xg_dims[3] = {kst, (cuuint64_t)m, (cuuint64_t)(terms * n_rg)};
  const cuuint64_t xg_strides[2] = {kst * 2, kst * 2 * m};
  const cuuint32_t x_box[3] = {BK, (cuuint32_t)tn, 1};
  const cuuint64_t sg_dims[2] = {(cuuint64_t)oc, (cuuint64_t)n_layers * (ic / 32)};
  const cuuint64_t sg_strides[1] = {(cuuint64_t)oc * 4};
  const cuuint32_t sg_box[2] = {OC, 8};
  const cuuint64_t cd_dims[2] = {(cuuint64_t)oc, (cuuint64_t)n_layers * rows};
  const cuuint64_t cd_strides[1] = {(cuuint64_t)oc};
  const cuuint32_t cd_box[2] = {128, (cuuint32_t)(side_bits == 8 ? SK : 8)};
  return encode(&M->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xp, x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&M->xg, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, xgp, xg_dims, xg_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode(&M->sg, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, sign, sg_dims, sg_strides, sg_box,
                CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode(&M->cd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, side, cd_dims, cd_strides, cd_box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// the arguments of one launch
struct Args {
  const void *xp, *xgp, *rs, *rsg, *sign, *side, *coef;
  void *out, *part;
  int m, ic, oc, pack_block, k_pad, kps, col_tile, n_rg, n_layers, ksplit;
  const void* layer;
};

// the layouts the arm takes: one row group a 128-column tile, 16-byte code
// rows, nibble shard segments of 16 slots
inline bool layout_ok(const Args& A, int side_bits) {
  return A.m > 0 && A.oc % 16 == 0 && A.ic % 32 == 0 && (A.col_tile >= A.oc || A.col_tile % OC == 0) &&
         (side_bits == 8 || A.kps % 16 == 0) && A.ksplit >= 1 && (A.ksplit == 1 || A.part);
}

template <int TERMS, int SIDE_BITS, bool STACKED, int TN>
int launch(const Args& A, cudaStream_t st) {
  using C = Cfg<TN>;
  auto kern = kernel<TERMS, SIDE_BITS, STACKED, TN>;
  static bool sized = false;  // above 48 KB of dynamic shared memory: ask once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::total);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  Maps M;
  if (!maps(&M, TN, TERMS, SIDE_BITS, A.xp, A.xgp, A.sign, A.side, A.m, A.ic, A.oc, A.pack_block,
            A.k_pad, A.n_rg, A.n_layers))
    return (int)cudaErrorInvalidValue;
  dim3 grid((A.oc + OC - 1) / OC, (A.m + TN - 1) / TN, A.ksplit);
  kern<<<grid, THREADS, C::total, st>>>(M.x, M.xg, M.sg, M.cd, (const float*)A.rs,
                                        (const float*)A.rsg, (const float*)A.coef, (float*)A.out,
                                        (float*)A.part, A.m, A.ic, A.oc, A.pack_block, A.k_pad,
                                        A.kps, A.col_tile, A.n_rg, A.ksplit, (const int*)A.layer);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || A.ksplit == 1) return (int)e;
  const size_t n = (size_t)A.m * A.oc;
  reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)A.part, (const float*)A.rs, (const float*)A.rsg, (const float*)A.coef,
      (float*)A.out, A.m, A.oc, A.col_tile, A.ksplit, STACKED ? (const int*)A.layer : nullptr);
  return (int)cudaGetLastError();
}

}  // namespace bf16tc
}  // namespace
