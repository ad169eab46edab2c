// Attention in f32 for Hopper (sm_90a), on the FMA pipes: the forward of
// `fused_attention` and the forward and recomputing backward of flash
// training attention, over (B, T|S, H, HD) f32 tensors, HD = 64 or 128.
//
// Replaces, for f32 inputs, the same TPU kernels as attention.cu and
// flash_train.cu: `fused_attention` (smer_music_generation_tpu/ops/
// attention.py:115, body `_attn_kernel` :55) and the library flash kernel
// behind `attend_flash_vjp` (models/transformer.py:360; jax/experimental/
// pallas/ops/tpu/flash_attention.py, pallas_call :758 forward, :1121 dkv,
// :1456 dq).  Both run in the inputs' dtype in JAX, so in f32 every product
// and sum is f32 and nothing is rounded to bf16 (the library casts p and ds
// to the inputs' dtype: here no rounding).  The two forwards share one body,
// a template of the mask semantics:
//   MODE 0 (`fused_attention`): scores q . k scale, keys at or past
//     kv_valid_len[b] (and past the row when causal) at -inf, so their
//     weight is 0; a batch row with no valid key weighs all S keys alike;
//     out = o / max(l, 1e-30);
//   MODE 1 (flash training): scores q . k scale plus -0.7 * f32 max where
//     the key is invalid or, when causal, past the row (added, so a row
//     with no attendable key weighs its keys alike); a causal row of
//     128-block qb visits the key blocks kb <= qb only; out = o / l, each
//     row's m and l written for the backward.
// The backward is the library's two kernels (FlashAttention-2's
// deterministic pair: no atomics, so a recompute gives the same bits):
// p = exp(s - m) / l, di = sum_d out g, dv = p^T g, ds = (g v^T - di) p
// scale, dq = ds k, dk = ds^T q, all in f32.
//
// What bounds it on an NVIDIA H100 (67 TFLOP/s of f32 FMA, 3.35 TB/s at
// 700 W): at B=8, H=8, T=S=640, head_dim 64 the forward does 4 B H T S HD =
// 6.7 GFLOP (0.10 ms at the FMA peak) and moves 42 MB (0.013 ms): operations.
// JAX's f32 bound (atol 2e-5, rtol 1e-4 on outputs) rules out single-pass
// TF32 on the tensor cores; this first version is a simple tiled kernel on
// the FMA pipes.  Design: a block of 256 threads owns 64 rows of one
// (b, h) (query rows in the forward and dq kernels, keys in the dk/dv
// kernel) and walks 64-row tiles of the other operands through shared
// memory (f32, rows padded by 4 floats so that 16 rows read as float4 fall
// on distinct banks); thread (ty, tx) = (tid / 16, tid % 16) computes a 4 x
// 4 tile of a 64 x 64 product (rows 4 ty + i, columns tx + 16 j, sums over
// head_dim in order) and holds a 4 x HD / 16 slice of each output
// accumulator (rows 4 ty + i, columns tx + 16 j).  A row's reductions (max,
// sum) are 16-lane shuffles.  P (and ds) go through shared memory as a 64 x
// 64 tile into the next product.  exp is exp2f((s - m) log2(e)), the
// difference taken first, as the bf16 kernels and the twins take it.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // rows a block owns, rows a tile
constexpr int kF32Threads = 256;
constexpr int kPLd = kRows + 4;  // padded row of a 64 x 64 P or ds tile
constexpr int kBlk = 128;        // the library's block (MODE 1)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

template <int HD>
constexpr int kLdF = HD + 4;  // padded row of a 64 x HD f32 tile
template <int HD>
constexpr int kTileF = kRows * kLdF<HD>;

// rows p0 .. p0 + 63 of one head of a (B, L, H, HD) f32 tensor (base at
// (b, 0, h, 0), `stride` floats between positions) into a shared tile, rows
// at or past `limit` zero-filled; every thread takes part, float4 loads
template <int HD>
__device__ __forceinline__ void load_f32(float* dst, const float* base, size_t stride, int p0,
                                         int limit) {
  constexpr int kVec = HD / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kF32Threads) {
    const int r = i / kVec, c = 4 * (i % kVec);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < limit) v = *reinterpret_cast<const float4*>(base + (size_t)(p0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * kLdF<HD> + c) = v;
  }
}

// acc[i][j] = sum_d X[4 ty + i][d] Y[tx + 16 j][d], d in order
template <int HD>
__device__ __forceinline__ void xyt(float (&acc)[4][4], const float* X, const float* Y, int tx,
                                    int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(X + (4 * ty + i) * kLdF<HD> + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(Y + (tx + 16 * j) * kLdF<HD> + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[i][j];
        a = fmaf(x[i].x, y[j].x, a);
        a = fmaf(x[i].y, y[j].y, a);
        a = fmaf(x[i].z, y[j].z, a);
        acc[i][j] = fmaf(x[i].w, y[j].w, a);
      }
  }
}

// acc[i][j] += sum_c P[4 ty + i][c] Y[c][tx + 16 j], c < 64 in order
template <int HD>
__device__ __forceinline__ void pv(float (&acc)[4][HD / 16], const float* P, const float* Y,
                                   int tx, int ty) {
#pragma unroll 2
  for (int c = 0; c < kRows; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kPLd + c);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const float y0 = Y[c * kLdF<HD> + tx + 16 * j], y1 = Y[(c + 1) * kLdF<HD> + tx + 16 * j];
      const float y2 = Y[(c + 2) * kLdF<HD> + tx + 16 * j], y3 = Y[(c + 3) * kLdF<HD> + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][j];
        a = fmaf(p[i].x, y0, a);
        a = fmaf(p[i].y, y1, a);
        a = fmaf(p[i].z, y2, a);
        acc[i][j] = fmaf(p[i].w, y3, a);
      }
    }
  }
}

// over the 16 lanes that share ty (tx is the lane's low four bits)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a 4 x HD / 16 accumulator slice (rows 4 ty + i of the block, times
// scl[i]) to rows p0 + 4 ty + i of one head of a (B, L, H, HD) f32 tensor
template <int HD>
__device__ __forceinline__ void store_f32(float* base, size_t stride, const float (&acc)[4][HD / 16],
                                          const float (&scl)[4], int p0, int limit, int tx,
                                          int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = p0 + 4 * ty + i;
    if (r >= limit) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) base[(size_t)r * stride + tx + 16 * j] = acc[i][j] * scl[i];
  }
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h)
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kFwdSmemF = (3 * kTileF<HD> + kRows * kPLd) * sizeof(float) + kRows * sizeof(int);

template <int HD, int MODE>
__global__ void __launch_bounds__(kF32Threads)
    attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ keys, int causal,
                        float scale, float* __restrict__ out, float* __restrict__ stats, int T,
                        int S, int H) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ks = qs + kTileF<HD>;
  float* vs = ks + kTileF<HD>;
  float* ps = vs + kTileF<HD>;                                  // [64][kPLd]
  int* kok = reinterpret_cast<int*>(ps + kRows * kPLd);         // MODE 1: the tile's validity
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const size_t stride = (size_t)H * HD;
  const float* kb = k + (size_t)b * S * stride + h * HD;
  const float* vb = v + (size_t)b * S * stride + h * HD;

  // the keys the block visits, and (MODE 0) how the row's keys are masked
  int n_keys, n_valid = S;
  bool uniform = false, clip = false;
  if (MODE == 0) {
    n_valid = min(keys != nullptr ? keys[b] : S, S);
    uniform = n_valid <= 0;  // every key masked: all weigh alike
    clip = causal && !uniform;
    n_keys = clip ? min(n_valid, t0 + kRows) : (uniform ? S : n_valid);
  } else {
    n_keys = causal ? min((t0 / kBlk + 1) * kBlk, S) : S;
  }
  load_f32<HD>(qs, q + (size_t)b * T * stride + h * HD, stride, t0, T);

  float o[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) o[i][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MODE == 0 ? kMasked : -INFINITY;
    l[i] = 0.f;  // this lane's partial sum over its columns
  }

  for (int k0 = 0; k0 < n_keys; k0 += kRows) {
    load_f32<HD>(ks, kb, stride, k0, S);
    load_f32<HD>(vs, vb, stride, k0, S);
    if (MODE == 1 && threadIdx.x < kRows) kok[threadIdx.x] = keys[(size_t)b * S + k0 + threadIdx.x];
    __syncthreads();
    float s[4][4];
    xyt<HD>(s, qs, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (MODE == 0) {
          const bool masked = col >= n_valid || (clip && col > row);
          s[i][j] = col >= S || (masked && !uniform) ? -INFINITY : (uniform ? 0.f : s[i][j] * scale);
        } else {
          const bool ok = kok[tx + 16 * j] != 0 && !(causal && col > row);
          s[i][j] = fmaf(s[i][j], scale, ok ? 0.f : kMaskValue);
        }
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f((s[i][j] - m_new) * kLog2e);
        ps[(4 * ty + i) * kPLd + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = fmaf(alpha, l[i], sum);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    pv<HD>(o, ps, vs, tx, ty);
    __syncthreads();  // this tile is read; the next one overwrites it
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = sum16(l[i]);
    inv[i] = 1.f / (MODE == 0 ? fmaxf(l[i], 1e-30f) : l[i]);
  }
  store_f32<HD>(out + (size_t)b * T * stride + h * HD, stride, o, inv, t0, T, tx, ty);
  if (MODE == 1 && tx == 0) {
    const size_t BHT = (size_t)gridDim.y * T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = (size_t)bh * T + t0 + 4 * ty + i;
      stats[at] = m[i];
      stats[BHT + at] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq: a block per (64 query rows, b * H + h); writes di for dk/dv
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kDqSmemF = (4 * kTileF<HD> + kRows * kPLd) * sizeof(float) + kRows * sizeof(int);

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_train_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ valid,
                              const float* __restrict__ out, const float* __restrict__ stats,
                              const float* __restrict__ g, int causal, float scale,
                              float* __restrict__ di_out, float* __restrict__ dq, int T, int S,
                              int H) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* gs = qs + kTileF<HD>;
  float* ks = gs + kTileF<HD>;  // the output rows first, for di
  float* vs = ks + kTileF<HD>;
  float* ds = vs + kTileF<HD>;  // [64][kPLd]
  int* kok = reinterpret_cast<int*>(ds + kRows * kPLd);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const size_t stride = (size_t)H * HD;
  const size_t qofs = (size_t)b * T * stride + h * HD;
  const float* kb = k + (size_t)b * S * stride + h * HD;
  const float* vb = v + (size_t)b * S * stride + h * HD;
  const int n_keys = causal ? min((t0 / kBlk + 1) * kBlk, S) : S;
  const size_t BHT = (size_t)gridDim.y * T;

  load_f32<HD>(qs, q + qofs, stride, t0, T);
  load_f32<HD>(gs, g + qofs, stride, t0, T);
  load_f32<HD>(ks, out + qofs, stride, t0, T);
  __syncthreads();
  float m[4], rl[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      acc = fmaf(ks[r * kLdF<HD> + tx + 16 * j], gs[r * kLdF<HD> + tx + 16 * j], acc);
    di[i] = sum16(acc);
    const size_t at = (size_t)bh * T + t0 + r;
    if (tx == 0) di_out[at] = di[i];
    m[i] = stats[at];
    rl[i] = 1.f / stats[BHT + at];
  }
  __syncthreads();  // the output rows are read; the key tiles overwrite them

  float dqa[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dqa[i][j] = 0.f;
  for (int k0 = 0; k0 < n_keys; k0 += kRows) {
    load_f32<HD>(ks, kb, stride, k0, S);
    load_f32<HD>(vs, vb, stride, k0, S);
    if (threadIdx.x < kRows) kok[threadIdx.x] = valid[(size_t)b * S + k0 + threadIdx.x];
    __syncthreads();
    float s[4][4], dp[4][4];
    xyt<HD>(s, qs, ks, tx, ty);
    xyt<HD>(dp, gs, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = kok[tx + 16 * j] != 0 && !(causal && col > row);
        const float sv = fmaf(s[i][j], scale, ok ? 0.f : kMaskValue);
        const float p = exp2f((sv - m[i]) * kLog2e) * rl[i];
        ds[(4 * ty + i) * kPLd + tx + 16 * j] = (dp[i][j] - di[i]) * p * scale;
      }
    }
    __syncthreads();
    pv<HD>(dqa, ds, ks, tx, ty);
    __syncthreads();
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_f32<HD>(dq + qofs, stride, dqa, one, t0, T, tx, ty);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (64 keys, b * H + h)
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kDkvSmemF = (4 * kTileF<HD> + 2 * kRows * kPLd + 3 * kRows) * sizeof(float);

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_train_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const int* __restrict__ valid,
                               const float* __restrict__ stats, const float* __restrict__ di_in,
                               const float* __restrict__ g, int causal, float scale,
                               float* __restrict__ dk, float* __restrict__ dv, int T, int S,
                               int H) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + kTileF<HD>;
  float* qs = vs + kTileF<HD>;
  float* gs = qs + kTileF<HD>;
  float* ps = gs + kTileF<HD>;  // [64 keys][kPLd rows]: p^T
  float* dss = ps + kRows * kPLd;  // ds^T
  float* rst = dss + kRows * kPLd;  // [3][64]: m, 1 / l, di of the tile's rows
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.x * kRows;
  const size_t stride = (size_t)H * HD;
  const size_t kofs = (size_t)b * S * stride + h * HD;
  const float* qb = q + (size_t)b * T * stride + h * HD;
  const float* gb = g + (size_t)b * T * stride + h * HD;
  // query rows: all, or those of the 128-blocks at or below the keys'
  const int first = causal ? (c0 / kBlk) * kBlk : 0;
  const size_t BHT = (size_t)gridDim.y * T;

  load_f32<HD>(ks, k + kofs, stride, c0, S);
  load_f32<HD>(vs, v + kofs, stride, c0, S);
  float madd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) madd[i] = valid[(size_t)b * S + c0 + 4 * ty + i] != 0 ? 0.f : kMaskValue;

  float dka[4][HD / 16], dva[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dka[i][j] = dva[i][j] = 0.f;
  for (int r0 = first; r0 < T; r0 += kRows) {
    load_f32<HD>(qs, qb, stride, r0, T);
    load_f32<HD>(gs, gb, stride, r0, T);
    if (threadIdx.x < kRows) {
      const size_t at = (size_t)bh * T + r0 + threadIdx.x;
      rst[threadIdx.x] = stats[at];
      rst[kRows + threadIdx.x] = 1.f / stats[BHT + at];
      rst[2 * kRows + threadIdx.x] = di_in[at];
    }
    __syncthreads();
    float sT[4][4], dT[4][4];  // row = this thread's key, column = a query row
    xyt<HD>(sT, ks, qs, tx, ty);
    xyt<HD>(dT, vs, gs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = c0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = tx + 16 * j, row = r0 + rr;
        const float mk = causal && key > row ? kMaskValue : madd[i];
        const float sv = fmaf(sT[i][j], scale, mk);
        const float p = exp2f((sv - rst[rr]) * kLog2e) * rst[kRows + rr];
        ps[(4 * ty + i) * kPLd + rr] = p;
        dss[(4 * ty + i) * kPLd + rr] = (dT[i][j] - rst[2 * kRows + rr]) * p * scale;
      }
    }
    __syncthreads();
    pv<HD>(dva, ps, gs, tx, ty);
    pv<HD>(dka, dss, qs, tx, ty);
    __syncthreads();
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_f32<HD>(dk + kofs, stride, dka, one, c0, S, tx, ty);
  store_f32<HD>(dv + kofs, stride, dva, one, c0, S, tx, ty);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int HD>
int launch_fwd_f32(int mode, int B, int T, int S, int H, const void* q, const void* k,
                   const void* v, const void* keys, int causal, float scale, void* out,
                   void* stats, cudaStream_t st) {
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const int* kk = static_cast<const int*>(keys);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(stats);
  cudaError_t e;
  if (mode == 0) {
    e = cudaFuncSetAttribute(attn_f32_fwd_kernel<HD, 0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmemF<HD>);
    if (e != cudaSuccess) return (int)e;
    attn_f32_fwd_kernel<HD, 0><<<grid, kF32Threads, kFwdSmemF<HD>, st>>>(
        qf, kf, vf, kk, causal, scale, of, sf, T, S, H);
  } else {
    e = cudaFuncSetAttribute(attn_f32_fwd_kernel<HD, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmemF<HD>);
    if (e != cudaSuccess) return (int)e;
    attn_f32_fwd_kernel<HD, 1><<<grid, kF32Threads, kFwdSmemF<HD>, st>>>(
        qf, kf, vf, kk, causal, scale, of, sf, T, S, H);
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_f32(int B, int T, int S, int H, const void* q, const void* k, const void* v,
                   const void* valid, const void* out, const void* stats, const void* g,
                   int causal, float scale, void* di, void* dq, void* dk, void* dv,
                   cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  const int* vl = static_cast<const int*>(valid);
  const auto* sf = static_cast<const float*>(stats);
  float* dib = static_cast<float*>(di);
  cudaError_t e = cudaFuncSetAttribute(flash_train_f32_dq_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kDqSmemF<HD>);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_train_f32_dkv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmemF<HD>);
  if (e != cudaSuccess) return (int)e;
  flash_train_f32_dq_kernel<HD><<<dim3(T / kRows, B * H), kF32Threads, kDqSmemF<HD>, st>>>(
      qf, kf, vf, vl, static_cast<const float*>(out), sf, gf, causal, scale, dib,
      static_cast<float*>(dq), T, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_train_f32_dkv_kernel<HD><<<dim3(S / kRows, B * H), kF32Threads, kDkvSmemF<HD>, st>>>(
      qf, kf, vf, vl, sf, dib, gf, causal, scale, static_cast<float*>(dk), static_cast<float*>(dv),
      T, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The f32 forward: q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H,
// HD), f32, contiguous and 16-byte aligned, HD = head_dim 64 or 128.  mode 0
// (`fused_attention`): keys = kv_valid_len (B,) int32 or null; any T, S.
// mode 1 (flash training): keys = the validity (B, S) int32, T and S
// multiples of 128, stats (2, B*H, T) f32 receives each row's m and l.
int smer_attention_f32_fwd(int mode, int head_dim, int B, int T, int S, int H, const void* q,
                           const void* k, const void* v, const void* keys, int causal, float scale,
                           void* out, void* stats, void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || B * H > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (keys == nullptr || stats == nullptr || T % kBlk || S % kBlk))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd_f32<64>(mode, B, T, S, H, q, k, v, keys, causal, scale, out, stats, st);
    case 128:
      return launch_fwd_f32<128>(mode, B, T, S, H, q, k, v, keys, causal, scale, out, stats, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 backward of mode 1: out and stats as the forward wrote them, g
// (B, T, H, HD) f32; di a (B*H, T) f32 scratch buffer; dq, dk, dv f32 in the
// layouts of q, k, v.
int smer_flash_train_bwd_f32(int head_dim, int B, int T, int S, int H, const void* q,
                             const void* k, const void* v, const void* valid, const void* out,
                             const void* stats, const void* g, int causal, float scale, void* di,
                             void* dq, void* dk, void* dv, void* stream) {
  if (B < 1 || H < 1 || T < kBlk || S < kBlk || T % kBlk || S % kBlk || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(g))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_bwd_f32<64>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq,
                                dk, dv, st);
    case 128:
      return launch_bwd_f32<128>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq,
                                 dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
