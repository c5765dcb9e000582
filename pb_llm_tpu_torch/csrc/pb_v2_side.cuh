// pb_v2_side.cuh — the PBW-v2 sidecar code read shared by the f32-sum
// kernels (pb_f32_matmul.cu, pb_pair_v2.cu).
#pragma once

#include <stdint.h>

// The value of slot row j's code in column col, as f32: a byte for 8-bit
// codes; for 4-bit codes a nibble, packed row r of a shard segment of kps
// slot rows holding slot rows r (low nibble) and r + kps/2 (high nibble).
template <int SIDE_BITS>
__device__ __forceinline__ float side_code(const uint8_t* __restrict__ side, int j, int col,
                                           int oc, int kps) {
  if (SIDE_BITS == 8) return (float)side[(size_t)j * oc + col];
  const int half = kps / 2;
  const int s = j / kps;
  const int r = j - s * kps;
  const uint8_t v = side[(size_t)(s * half + (r % half)) * oc + col];
  return (float)(r < half ? (v & 15) : (v >> 4));
}
