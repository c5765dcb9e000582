// pbpack — native host-side PBW plane builder.
//
// Converting a multi-billion-parameter checkpoint into PBW planes is a
// host-side, memory-bandwidth-bound job (threshold + sign + bit packing over
// every weight).  The numpy path materializes several full-size temporaries
// per layer; this C++ kernel streams each (block, oc-chunk) tile once,
// multithreaded, and writes the packed planes directly.
//
// Layout contract == pb_llm_tpu/core/packing.py (block-local bit-plane-major):
//   rows grouped into pack blocks of `pack_block` rows (last may be short);
//   within a block of r rows (g = r/32 words), bit b of words[gi, :] holds
//   block-row b*g + gi.
//
// Exposed C ABI (ctypes; no pybind11 in this image):
//   pbpack_pack_bits(bits_u8[ic*oc], ic, oc, pack_block, out_u32[(ic/32)*oc])
//   pbpack_build_planes(...) — fused sign/mask/sidecar construction from
//     w_q, mask, per-oc mean/high params (see python wrapper for semantics).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Pack a {0,1} byte matrix [ic, oc] (row-major) into uint32 words [ic/32, oc].
void pbpack_pack_bits(const uint8_t* bits, int64_t ic, int64_t oc,
                      int64_t pack_block, uint32_t* out, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  // enumerate blocks
  struct Blk { int64_t row0, rows, word0; };
  std::vector<Blk> blocks;
  int64_t r0 = 0, w0 = 0;
  while (r0 < ic) {
    int64_t rows = std::min(pack_block, ic - r0);
    blocks.push_back({r0, rows, w0});
    r0 += rows;
    w0 += rows / 32;
  }
  auto work = [&](int tid) {
    for (size_t bi = tid; bi < blocks.size(); bi += n_threads) {
      const Blk& b = blocks[bi];
      int64_t g = b.rows / 32;
      for (int64_t gi = 0; gi < g; ++gi) {
        uint32_t* dst = out + (b.word0 + gi) * oc;
        std::memset(dst, 0, sizeof(uint32_t) * oc);
        for (int bit = 0; bit < 32; ++bit) {
          const uint8_t* src = bits + (b.row0 + (int64_t)bit * g + gi) * oc;
          uint32_t m = 1u << bit;
          for (int64_t c = 0; c < oc; ++c)
            if (src[c]) dst[c] |= m;
        }
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
}

// Fused PBW plane construction from the solver's outputs.
//   w_q    [oc, ic] f32  — fake-quant weights (reference orientation)
//   mask   [oc, ic] u8   — 1 ⇔ binarized (GPTQ convention)
//   mean   [oc] f32      — binary-side mean (single whole-row group)
//   hscale [oc], hzero [oc] f32 — 8-bit side params
// Outputs (transposed to [ic, oc] plane orientation):
//   sign_packed [ic/32, oc] u32 — B' plane: (w_q >= mean) & ~salient
//   mask_packed [ic/32, oc] u32 — salient bits (~mask)
//   sidecar     [ic, oc] u8     — codes at salient, 0 elsewhere
void pbpack_build_planes(const float* w_q, const uint8_t* mask,
                         const float* mean, const float* hscale, const float* hzero,
                         int64_t oc, int64_t ic, int64_t pack_block,
                         uint32_t* sign_packed, uint32_t* mask_packed,
                         uint8_t* sidecar, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  std::vector<uint8_t> sbits((size_t)ic * oc), mbits((size_t)ic * oc);
  auto work = [&](int tid) {
    for (int64_t r = tid; r < oc; r += n_threads) {  // r = output channel
      const float* wrow = w_q + r * ic;
      const uint8_t* mrow = mask + r * ic;
      float mu = mean[r], hs = hscale[r], hz = hzero[r];
      for (int64_t i = 0; i < ic; ++i) {
        bool salient = !mrow[i];
        mbits[(size_t)i * oc + r] = salient;
        sbits[(size_t)i * oc + r] = (!salient) && (wrow[i] - mu >= 0.f);
        if (salient) {
          float code = std::nearbyint(wrow[i] / hs + hz);
          code = std::min(255.f, std::max(0.f, code));
          sidecar[(size_t)i * oc + r] = (uint8_t)code;
        } else {
          sidecar[(size_t)i * oc + r] = 0;
        }
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
  pbpack_pack_bits(sbits.data(), ic, oc, pack_block, sign_packed, n_threads);
  pbpack_pack_bits(mbits.data(), ic, oc, pack_block, mask_packed, n_threads);
}

}  // extern "C"
