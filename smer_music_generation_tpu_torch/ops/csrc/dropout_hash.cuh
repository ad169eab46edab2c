// The counter-hash keep mask of the training attention's weight dropout,
// shared by train_attention.cu (head_dim 64 and 128) and attention_wide.cu
// (every wider head_dim), so both draw the bits of JAX's `_hash_keep`
// (smer_music_generation_tpu/ops/train_attention.py:87) and of
// `dropout_mask_reference`: uint32 wraparound arithmetic over (seed,
// b * H + h, absolute row, col), b and h global.
#pragma once

#include <stdint.h>

namespace dropout_hash {

struct Drop {
  uint32_t s0, s1, thr;
  int on;   // rate > 0
  float c;  // bf16(1 - rate) as a float
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kRowMul = 0x9E3779B1u, kColMul = 0x85EBCA77u, kBhMul = 0xC2B2AE3Du;

// _hash_keep of the TPU kernel from its three terms: row_term = s0 + row *
// kRowMul, col_term = col * kColMul, bh_term = bh * kBhMul
__device__ __forceinline__ bool keep_terms(const Drop& dr, uint32_t row_term,
                                           uint32_t col_term, uint32_t bh_term) {
  uint32_t h = (row_term ^ col_term) + bh_term;
  h = fmix32(h ^ dr.s1);
  h = fmix32(h + dr.s0);
  return h < dr.thr;
}

// _hash_keep of the TPU kernel, one element: bh = b * H + h, row absolute
__device__ __forceinline__ bool keep_at(const Drop& dr, uint32_t bh, uint32_t row,
                                        uint32_t col) {
  return keep_terms(dr, dr.s0 + row * kRowMul, col * kColMul, bh * kBhMul);
}

// the hash's (b, h) term reads the GLOBAL batch row and head: a launch on
// a shard of B rows from b0 and H heads from h0, out of Hg heads in all,
// draws the slice of the unsharded mask; b0 = h0 = 0, Hg = H unsharded
__device__ __forceinline__ uint32_t global_bh(int b, int h, int b0, int h0, int Hg) {
  return (uint32_t)(b0 + b) * (uint32_t)Hg + (uint32_t)(h0 + h);
}

__device__ __forceinline__ Drop make_drop(const int* seeds, uint32_t thr, int on,
                                          float c) {
  Drop dr;
  dr.s0 = (uint32_t)seeds[0] ^ (uint32_t)seeds[2];
  dr.s1 = (uint32_t)seeds[1] ^ (uint32_t)seeds[3];
  dr.thr = thr;
  dr.on = on;
  dr.c = c;
  return dr;
}

// a / b rounded to nearest, given rb = 1 / b (itself rounded to nearest):
// one FMA residual step, the fast path of IEEE division without its range
// check (a and b here are finite, b >= 1e-30 or a bf16 constant near 1)
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

}  // namespace dropout_hash
