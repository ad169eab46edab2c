// Flash-attention forward over (B, T, H, HD) bf16 tensors, HD 64 or 128,
// with a per-batch key length and an optional causal mask, for Hopper
// (sm_90a).  f32 inputs take the kernel of attention_f32.cu.
//
// Replaces the TPU kernel `fused_attention` of
// smer_music_generation_tpu/ops/attention.py:115 (body `_attn_kernel` :55),
// which the encoder's self-attention takes when `flash_encoder` is set
// (models/transformer.py:349-358, 433-434).  Same function: scores
// q . k / sqrt(HD) in f32, keys at or past kv_valid_len[b] masked with
// -1e30, and keys past the query row too when causal; an f32 online
// softmax; the output divided by max(l, 1e-30) and written in q's dtype.
//
// What bounds it on an NVIDIA H100 80GB HBM3 (989 TFLOP/s dense bf16,
// 3.35 TB/s at 700 W): at the served encoder shape (B=3, T=S=1536, H=8,
// HD=64) the function reads and writes 18.9 MB (6 us) and does
// 4 * B * H * T * S * HD = 14.5 GFLOP (15 us at the bf16 peak), so the
// table's bound is operations.  The products are not what limits this
// design, though: a 64 x 64 tile of QK^T plus PV is 1 MFLOP, 300-400 cycles
// of mma.sync on an SM, while its 4,096 exp take 256 cycles of the SFU (16
// a cycle) and the scaling, max, sum and the bf16 split of P as many again
// on the FMA pipes; each block also re-reads its head's K and V from L2.
// The per-element work sets the floor, so this version keeps mma.sync and
// leaves wgmma with TMA for later, if the products come out on top.
// Measured at that shape on an NVIDIA H100 80GB HBM3, 700.00 W
// (scripts/torch_kernel_ab.py, chip_smoke.py phase 2f; PERF.md): 0.083 ms
// a call, beside 0.76 ms for the first version of this kernel (one thread a
// query row on the f32 FMA pipes) and 0.08-0.11 ms for torch's
// scaled_dot_product_attention.
//
// Design (FlashAttention-2, helpers in attn_tiles.cuh): a block of 4 warps
// owns 64 query rows of one (b, h), 16 a warp, their Q fragments loaded
// once into registers.  64-key tiles of K and V stream through a two-stage
// cp.async ring.  Per tile a warp takes S = Q K^T by mma into f32, masks it
// (on the tiles that need it: one branch a tile, selects per element) and
// updates its rows' running max m (of s * scale * log2 e), sum l and 16 x 64
// f32 accumulator, p = 2^(s * scale * log2 e - m) by one FFMA and one
// MUFU.EX2 (quad shuffles for the row max).  P stays f32 in the TPU kernel
// and in the twin, and one bf16 rounding of P is not accurate enough for a
// peaked softmax (tests/test_torch_attention_tiles.py), so P is split as
// P_hi = bf16(P) plus P_lo = bf16(P - P_hi) and both go through the PV
// product into the same f32 accumulator (each V fragment loaded once for
// the two).  A masked key takes -inf, so its weight is exactly 0 whatever
// the running max; the TPU kernel's -1e30 gives the same result, since key
// 0, valid for every row, lies in the first tile.  The block stops at the
// last key any of its rows may attend (min(len, t0 + 64) when causal).  A
// batch element with no valid key (kv_valid_len 0) has every score at -1e30
// in the TPU kernel's reference and weighs all S keys alike; here every
// score is 0, which does the same.  Causal blocks run in reverse row order
// so the longest start first.  168 registers a thread and 45 KB of shared
// memory: three blocks an SM (the launch bounds ask so; at four ptxas
// spilled).  At head_dim 128 the Q fragments and the accumulator double
// (32 + 64 registers) and the tiles take 87 KB of dynamic shared memory:
// two blocks an SM.  The epilogue divides by max(l, 1e-30) and writes bf16
// through the Q tile in 16-byte stores.
//
// The launcher has a plain C interface and returns cudaGetLastError().

#include <math.h>

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// o += P V over one 64-key tile, P given as f32 C fragments and applied as
// bf16 hi + lo halves; each V fragment is loaded once for both.
template <int HD>
__device__ __forceinline__ void pv_tile_split(float o[kONB<HD>][4], const float p[kNB][4],
                                              const __nv_bfloat16* vs, int lane) {
#pragma unroll
  for (int kc = 0; kc < kKTile / 16; ++kc) {
    uint32_t ah[4], al[4];  // A fragments of bf16(P) and bf16(P - bf16(P))
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* pp = &p[2 * kc + (u >> 1)][2 * (u & 1)];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pp[0], pp[1]);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(pp[0] - hf.x, pp[1] - hf.y);
      ah[u] = *reinterpret_cast<const uint32_t*>(&hi);
      al[u] = *reinterpret_cast<const uint32_t*>(&lo);
    }
#pragma unroll
    for (int jp = 0; jp < HD / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (16 * kc + (lane & 15)) * kLd<HD> + 16 * jp + 8 * (lane >> 4));
      mma_bf16(o[2 * jp], ah, b[0], b[1]);
      mma_bf16(o[2 * jp + 1], ah, b[2], b[3]);
      mma_bf16(o[2 * jp], al, b[0], b[1]);
      mma_bf16(o[2 * jp + 1], al, b[2], b[3]);
    }
  }
}

// Q (then the output), the K ring and the V ring, 2 stages each: dynamic
// shared memory at head_dim 128 (87 KB), static at 64
template <int HD>
constexpr size_t kFwdSmem = HD == 64 ? 0 : 5 * kTileElems<HD> * sizeof(__nv_bfloat16);

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int causal, float scale) {
  constexpr int kHD = HD, kTE = kTileElems<HD>;
  __nv_bfloat16* qs;  // Q, then the output; then the K ring and the V ring, [2][kTE] each
  if constexpr (HD == 64) {  // 45 KB: static, as before head_dim 128
    __shared__ __align__(16) __nv_bfloat16 tiles[5 * kTE];
    qs = tiles;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    qs = reinterpret_cast<__nv_bfloat16*>(smem);
  }
  __nv_bfloat16* ks = qs + kTE;
  __nv_bfloat16* vs = ks + 2 * kTE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tile_q = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int t0 = tile_q * kQTile;
  const size_t ld = (size_t)H * kHD;  // elements between two positions
  const __nv_bfloat16* qb = q + (size_t)b * T * ld + h * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * ld + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * ld + h * kHD;

  const int n_valid = min(lens != nullptr ? lens[b] : S, S);
  const bool uniform = n_valid <= 0;  // every key masked: all weigh alike
  const bool clip = causal && !uniform;
  const int block_keys = clip ? min(n_valid, t0 + kQTile) : (uniform ? S : n_valid);
  const int n_tiles = (block_keys + kKTile - 1) / kKTile;  // >= 1
  const int row0 = t0 + 16 * warp + g, row1 = row0 + 8;
  const float sl2 = scale * kLog2e;

  load_tile<HD>(qs, qb, ld, t0, T);
  load_tile<HD>(ks, kb, ld, 0, S);
  load_tile<HD>(vs, vb, ld, 0, S);
  cp_async_commit();

  RegA<HD> qa;
  float o[kONB<HD>][4];
#pragma unroll
  for (int j = 0; j < kONB<HD>; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // running max in the log2 domain (m = max s * sl2) and sum, rows g, g + 8
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKTile;
    if (it + 1 < n_tiles) {
      load_tile<HD>(ks + ((it + 1) & 1) * kTE, kb, ld, k0 + kKTile, S);
      load_tile<HD>(vs + ((it + 1) & 1) * kTE, vb, ld, k0 + kKTile, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    if (it == 0) qa.load(qs, warp, lane);

    float s[kNB][4];
    qk_blocks<HD, kNB>(s, qa, ks + (it & 1) * kTE, 0, lane);
    // masking only on a tile some key of which is out of range for some row
    // of this warp: one branch a tile, selects per element.  A masked key
    // takes -inf, so its weight is exactly 0 whatever m is (the TPU kernel's
    // -1e30 gives the same once key 0, valid for every row, has been seen);
    // with no valid key every score is -1e30 there, which weighs all keys
    // alike, as a score of 0 does here; keys past S weigh nothing.
    if (k0 + kKTile > n_valid || (clip && k0 + kKTile - 1 > t0 + 16 * warp)) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool masked = col >= n_valid || (clip && col > (e < 2 ? row0 : row1));
          s[j][e] = col >= S || (masked && !uniform) ? -INFINITY : (uniform ? 0.f : s[j][e]);
        }
    }
    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3):
    // p = 2^(s sl2 - m) by one FFMA and one MUFU.EX2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kNB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx) * sl2);
      const float alpha = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        s[j][2 * r] = exp2_ftz(fmaf(s[j][2 * r], sl2, -m_new));
        s[j][2 * r + 1] = exp2_ftz(fmaf(s[j][2 * r + 1], sl2, -m_new));
        sum += s[j][2 * r] + s[j][2 * r + 1];
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
#pragma unroll
      for (int j = kNB; j < kONB<HD>; ++j) {  // head_dim 128: the accumulator's other half
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
      l[r] = l[r] * alpha + sum;
    }
    pv_tile_split<HD>(o, s, vs + (it & 1) * kTE, lane);
    __syncthreads();  // this stage is read; the next iteration refills it
  }
  cp_async_wait<0>();

  const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
  stage_out<HD>(qs, o, inv0, inv1, warp, lane);
  __syncthreads();
  store_out<HD>(out + (size_t)b * T * ld + h * kHD, qs, ld, t0, T);
}

template <int HD>
int launch_flash_fwd(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v,
                     const void* lens, void* out, int T, int S, int H, int causal, float scale) {
  if (kFwdSmem<HD> > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem<HD>);
    if (e != cudaSuccess) return (int)e;
  }
  flash_fwd_kernel<HD><<<grid, kThreads, kFwdSmem<HD>, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), T, S, H, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H, HD), all bf16,
// contiguous and 16-byte aligned, HD = head_dim 64 or 128; lens (B,) int32
// or null (every key valid).
int smer_flash_attention(int head_dim, int B, int T, int S, int H,
                         const void* q, const void* k, const void* v,
                         const void* lens, int causal, float scale, void* out,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || S < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((T + kQTile - 1) / kQTile, B * H);
  switch (head_dim) {
    case 64:
      return launch_flash_fwd<64>(grid, st, q, k, v, lens, out, T, S, H, causal, scale);
    case 128:
      return launch_flash_fwd<128>(grid, st, q, k, v, lens, out, T, S, H, causal, scale);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
