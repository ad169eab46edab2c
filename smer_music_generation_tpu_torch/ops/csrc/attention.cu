// Flash-attention forward over (B, T, H, HD) bf16 tensors with a per-batch
// key length and an optional causal mask, for Hopper (sm_90a).
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
// 3.35 TB/s at 700 W): operations.  At the served encoder shape (B=3,
// T=S=1536, H=8, HD=64) the function reads and writes 18.9 MB (6 us) and
// does 4 * B * H * T * S * HD = 14.5 GFLOP (15 us at the bf16 peak).  This
// first version is simple and right, not fast: it runs on the f32 FMA
// pipes, not the tensor cores (wgmma and TMA are later work).  Measured on
// an NVIDIA H100 80GB HBM3, 700.00 W at that shape (PERF.md,
// chip_smoke.py): 0.76 ms a call, 0.46-0.61 ms of it device time.
//
// Design: one block per (query tile of 128 rows, b * H + h), one thread per
// query row.  The thread keeps its q row and its output accumulator in
// registers; the block stages 64 key rows of K and V at a time in shared
// memory as f32 (each element read from device memory once a block), and
// every thread walks them in order with its own running max, sum and
// accumulator, reading the staged rows as broadcasts.  The ragged edges
// are masked in the kernel: query rows past T do no work, key rows past S
// are never read, a row stops at its own last valid key (the causal bound
// included), and a block stops at the last key any of its rows attends.
// Skipping the masked keys is exact: their -1e30 score contributes
// exp(-1e30 - m) = 0 once any valid key has been seen.  A batch element
// with no valid key (kv_valid_len 0) has every score at -1e30 and, as in
// the TPU kernel's reference, weighs all S keys alike.
//
// The launcher has a plain C interface and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQRows = 128;  // query rows a block, one a thread
constexpr int kKRows = 64;   // key rows a shared-memory tile
constexpr float kMasked = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kQRows) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ out, int T, int S, int H, int causal,
    float scale) {
  __shared__ float ks[kKRows][HD];
  __shared__ float vs[kKRows][HD];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * kQRows;
  const int t = t0 + threadIdx.x;
  const size_t ld = (size_t)H * HD;  // elements between two positions
  const __nv_bfloat16* qb = q + (size_t)b * T * ld + h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * ld + h * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * ld + h * HD;

  const int n_valid = min(lens != nullptr ? lens[b] : S, S);
  const bool uniform = n_valid <= 0;  // every key masked: all weigh alike
  const int n_keys = uniform ? S : n_valid;
  const bool clip = causal && !uniform;
  const int block_keys = clip ? min(n_keys, t0 + kQRows) : n_keys;
  const int my_keys = clip ? min(n_keys, t + 1) : n_keys;

  float qv[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  if (t < T) {
#pragma unroll
    for (int d = 0; d < HD; d += 2) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)t * ld + d));
      qv[d] = p.x;
      qv[d + 1] = p.y;
    }
  }
  float m = kMasked, l = 0.f;

  for (int k0 = 0; k0 < block_keys; k0 += kKRows) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kKRows * HD / 2; i += kQRows) {
      const int r = i / (HD / 2);
      const int c = 2 * (i % (HD / 2));
      const int s = k0 + r;
      float2 kk = make_float2(0.f, 0.f), vv = make_float2(0.f, 0.f);
      if (s < block_keys) {
        kk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kb + (size_t)s * ld + c));
        vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)s * ld + c));
      }
      ks[r][c] = kk.x;
      ks[r][c + 1] = kk.y;
      vs[r][c] = vv.x;
      vs[r][c + 1] = vv.y;
    }
    __syncthreads();
    if (t < T) {
      const int n = min(kKRows, my_keys - k0);
      for (int r = 0; r < n; ++r) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(qv[d], ks[r][d], s);
        s = uniform ? kMasked : s * scale;
        if (s > m) {  // a new running max: rescale what was summed
          const float alpha = expf(m - s);
          l *= alpha;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] *= alpha;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[r][d], acc[d]);
      }
    }
  }

  if (t < T) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* ob = out + (size_t)b * T * ld + h * HD + (size_t)t * ld;
#pragma unroll
    for (int d = 0; d < HD; d += 2)
      *reinterpret_cast<__nv_bfloat162*>(ob + d) =
          __floats2bfloat162_rn(acc[d] * inv, acc[d + 1] * inv);
  }
}

}  // namespace

extern "C" {

// q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H, HD), all bf16 and
// contiguous; lens (B,) int32 or null (every key valid).
int smer_flash_attention(int head_dim, int B, int T, int S, int H,
                         const void* q, const void* k, const void* v,
                         const void* lens, int causal, float scale, void* out,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || S < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kQRows - 1) / kQRows, B * H);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const int* lp = static_cast<const int*>(lens);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  switch (head_dim) {
    case 64:
      flash_fwd_kernel<64><<<grid, kQRows, 0, st>>>(qb, kb, vb, lp, ob, T, S,
                                                    H, causal, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
