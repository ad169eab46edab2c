// One decoder step of the infill model (all decoder layers, the final
// LayerNorm and the f32 logits) as a short sequence of hand-written kernels
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_decode_step` (v2) of
// smer_music_generation_tpu/ops/decode_step.py:456 (body `_kernel` :416,
// `_layer_body` :296, `_flash_attend` :201).  It computes the same function:
// per layer a fused QKV projection, self-attention by online softmax over the
// interleaved K|V cache up to `index` plus the current row, cross-attention
// over the cross K|V masked by `cross_len`, the two out projections, post-LN
// (eps 1e-6) and the ReLU FFN; then the final LN and the f32 logits.
//
// What bounds it on an NVIDIA H100 80GB HBM3 (3.35 TB/s at 700 W): bytes.
// At B=1 a step streams 4 x (512*3072 + 2*512*2048) bf16 decoder weights
// (29.4 MB) plus the 512 x 384 f32 output projection (0.8 MB), and per
// layer and batch element `index` rows of self cache and `cross_len` rows
// of cross cache at 2 KB each.  The operations (2 flops per weight byte
// pair per row of B <= 8) are far below the card's ridge point.  So the
// design keeps every weight read coalesced and shared by all B rows, and
// reads each cache row once:
//
//   * `rowvec_kernel`: y[b, n] = act(sum_k x[b, k] W[k, n] + bias[n]) for
//     B <= 8 rows.  W stays in the (K, N) layout of the packed flax weights;
//     each lane owns two adjacent output columns, so a warp reads 128
//     contiguous bytes of a W row, and the block's 8 warps split K.  x and
//     the sums are f32; a bf16 W sees x rounded to bf16 first, as the TPU
//     kernel's `x.astype(dt)` does.  The QKV launch also writes the new K|V
//     row in the cache dtype.
//   * `attend_kernel`: grid (B, H); each warp walks a strided share of the
//     valid cache rows with an f32 online softmax, the block merges its
//     warps, and the current token's K/V row (self-attention) is folded in.
//   * `add_layernorm_kernel`: out = LN(x + y) in f32 with eps 1e-6.
//
// There is no grid-wide synchronisation, no cooperative launch, no spin-wait
// and no hand-off between blocks: each launch is independent and stream
// order carries the data from one to the next, 11 launches per layer plus
// 2 (46 for the 4-layer model).  This first version is right but slow.
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W, B=4, S=1536, index=512
// (PERF.md, chip_smoke.py): 1.98 ms a step against a 27.7 us bytes bound,
// the device busy 97% of it;
// rowvec_kernel takes 70% (the N = 512 projections run on 8 blocks, each
// warp walking K serially) and attend_kernel 28% (only B x H blocks).
//
// int8 weights (the TPU kernel's `scale=` path of `_layer_body`, packed by
// `quantize_columns` :50): the same rowvec_kernel reads W as int8 (two lanes
// a load, converted exactly to float) with x rounded to bf16, and scales each
// output column by its f32 scale before the bias: y = (x . q) * s + b, the
// order of the TPU kernel's `rescale(dot) + b`.  It halves the decoder's
// weight bytes (29.4 MB -> 14.7 MB plus a 90 KB scale strip a step; fc_w
// stays f32).
//
// The kernel-looped token chunk (v4, `fused_decode_tokens` :1028) gives
// attend_kernel a second source of self-attention rows: rows r < n_rows come
// from the cache, rows n_rows <= r < n_rows + n_chunk from the chunk's own
// K|V rows (the v4 `new_kv` output, (T, B, 2D) a layer).  The rows keep the
// warp assignment of a cache that holds them all (row r on warp r % 8), so a
// v4 token sums exactly what a v3 token sums over the spliced cache.
//
// The teacher-forced verify of speculative decode (`fused_verify_window`
// :1368, body `_kernel_verify` :1284, `_flash_attend_multi` :1182) runs the
// same launches on the W <= 16 window rows at B=1: rowvec_kernel takes the W
// rows as its batch, so each weight is read once for all of them; the cache
// and the cross K|V are shared by every row (batch stride 0); and
// attend_kernel's third row source gives row j the `index` cache rows, then
// window rows 0..j-1 of the `new_kv` output (written by the QKV launch of
// the same layer), then its own row, again in the row-to-warp order of a
// cache that holds them all.  Each row sums what one v2 step over the
// spliced cache sums, in the same order.  Bound by bytes as the step is: at
// W=9, index 512 and 1440 cross rows a call moves 46.4 MB (13.8 us); it took
// 1.63 ms on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, chip_smoke.py),
// 1.18x a v3 token of 3 rows, and is bit-equal to W sequential v2 steps.
//
// Every launcher has a plain C interface and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;  // output columns per rowvec block: two per lane
// rows a rowvec launch takes: 8 for the batched decode, 16 for a verify
// window (red[kWarps][16][kCols] is 32 KB of static shared memory)
constexpr int kMaxRows = 16;

template <typename WT>
struct PairLoad;

template <>
struct PairLoad<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// two int8 lanes; |q| <= 127 converts to float exactly
template <>
struct PairLoad<int8_t> {
  static __device__ __forceinline__ float2 load(const int8_t* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
};

template <>
struct PairLoad<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename WT, int NB, bool ROUND_X, bool RELU>
__global__ void __launch_bounds__(kThreads) rowvec_kernel(
    const float* __restrict__ x, int ldx, const WT* __restrict__ w, int ldw,
    const float* __restrict__ colscale, const float* __restrict__ bias,
    float* __restrict__ y, int ldy, __nv_bfloat16* __restrict__ kv_out,
    int ldkv, int kv_col0, int K, int N) {
  // int8 weights carry column scales; a bf16 or f32 instantiation is the
  // kernel without them
  constexpr bool kScaled = std::is_same<WT, int8_t>::value;
  __shared__ float red[kWarps][NB][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + 2 * lane;

  float acc[NB][2];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b][0] = acc[b][1] = 0.f;

  if (n < N) {
    const WT* wp = w + n;
#pragma unroll 4
    for (int k = warp; k < K; k += kWarps) {
      const float2 wv = PairLoad<WT>::load(wp + (size_t)k * ldw);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float xv = __ldg(x + (size_t)b * ldx + k);
        if (ROUND_X) xv = __bfloat162float(__float2bfloat16(xv));
        acc[b][0] = fmaf(xv, wv.x, acc[b][0]);
        acc[b][1] = fmaf(xv, wv.y, acc[b][1]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    red[warp][b][2 * lane] = acc[b][0];
    red[warp][b][2 * lane + 1] = acc[b][1];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < NB * kCols; i += kThreads) {
    const int b = i / kCols;
    const int col = blockIdx.x * kCols + i % kCols;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][b][i % kCols];
    // int8: the column scale, rounded, then the bias (no contraction)
    if (kScaled) s = __fmul_rn(s, colscale[col]);
    s += bias[col];
    if (RELU) s = fmaxf(s, 0.f);
    y[(size_t)b * ldy + col] = s;
    if (kv_out != nullptr && col >= kv_col0)
      kv_out[(size_t)b * ldkv + (col - kv_col0)] = __float2bfloat16(s);
  }
}

// One K|V row into a warp's f32 online softmax (m, l, acc).
template <int EPL>
__device__ __forceinline__ void attend_row(const __nv_bfloat16* row, int d0,
                                           int D, const float* qv,
                                           float scale, float& m, float& l,
                                           float* acc) {
  float kf[EPL], vf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; e += 2) {
    const float2 kk = PairLoad<__nv_bfloat16>::load(row + d0 + e);
    const float2 vv = PairLoad<__nv_bfloat16>::load(row + D + d0 + e);
    kf[e] = kk.x;
    kf[e + 1] = kk.y;
    vf[e] = vv.x;
    vf[e + 1] = vv.y;
  }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) s = fmaf(qv[e], kf[e], s);
  s = warp_sum(s) * scale;
  const float m_new = fmaxf(m, s);
  const float alpha = expf(m - m_new);  // exp(-inf) = 0 on the first row
  const float p = expf(s - m_new);
  l = l * alpha + p;
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = fmaf(acc[e], alpha, p * vf[e]);
  m = m_new;
}

// Where self-attention rows past the cache's come from.
enum RowSource {
  kCacheOnly = 0,  // v2, v3 and cross-attention
  kChunk = 1,      // v4: n_chunk rows of the chunk, (n_chunk, B, 2D) a layer
  kWindow = 2,     // verify: row b reads window rows 0..b-1, (W, 2D) a layer
};

// head_dim = 32 * EPL; each lane owns EPL adjacent lanes of the head.
template <int EPL, int SRC>
__global__ void __launch_bounds__(kThreads) attend_kernel(
    const float* __restrict__ q, int ldq, const __nv_bfloat16* __restrict__ kv,
    long long kv_bstride, int D, int n_rows, const int* __restrict__ lens,
    int max_rows, const __nv_bfloat16* __restrict__ chunk,
    long long chunk_tstride, int n_chunk, const float* __restrict__ extra,
    int ld_extra, float* __restrict__ out, int ldo, float scale) {
  constexpr int HD = 32 * EPL;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][HD];
  __shared__ float sm_extra;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n_cache = lens != nullptr ? lens[b] : n_rows;
  n_cache = max(0, min(n_cache, max_rows));
  const int n_extra = SRC == kChunk ? n_chunk : (SRC == kWindow ? b : 0);
  const int n = n_cache + n_extra;

  const int d0 = h * HD + lane * EPL;
  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = q[(size_t)b * ldq + d0 + e];

  const __nv_bfloat16* base = kv + (size_t)b * kv_bstride;
  float m = -INFINITY, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  // row t on warp t % kWarps, in order: the cache rows, then the chunk rows
  int t = warp;
#pragma unroll 4
  for (; t < n_cache; t += kWarps)
    attend_row<EPL>(base + (size_t)t * 2 * D, d0, D, qv, scale, m, l, acc);
  if (SRC != kCacheOnly) {
    // a v4 chunk holds B rows a token; the verify window is one row a slot
    const __nv_bfloat16* cbase = chunk + (SRC == kChunk ? (size_t)b * 2 * D : 0);
    for (; t < n; t += kWarps)
      attend_row<EPL>(cbase + (size_t)(t - n_cache) * chunk_tstride, d0, D, qv,
                      scale, m, l, acc);
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[e];
  if (extra != nullptr && warp == 0) {
    // the current token's key: it is not in the cache yet
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      s = fmaf(qv[e], extra[(size_t)b * ld_extra + d0 + e], s);
    s = warp_sum(s) * scale;
    if (lane == 0) sm_extra = s;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float M = -INFINITY;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) M = fmaxf(M, sm_m[wi]);
    if (extra != nullptr) M = fmaxf(M, sm_extra);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float c = expf(sm_m[wi] - M);
      L = fmaf(sm_l[wi], c, L);
      A = fmaf(sm_acc[wi][d], c, A);
    }
    if (extra != nullptr) {
      const float c = expf(sm_extra - M);
      L += c;
      A = fmaf(c, extra[(size_t)b * ld_extra + D + h * HD + d], A);
    }
    out[(size_t)b * ldo + h * HD + d] = A / L;
  }
}

__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += scratch[i];
  __syncthreads();  // scratch is reused by the next call
  return t;
}

// out = LN(x + y) over rows of D; y may be null.  out may alias x or y:
// every element is read into shared memory before any is written.
__global__ void __launch_bounds__(kThreads) add_layernorm_kernel(
    const float* x, const float* y, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* out, int D, float eps) {
  extern __shared__ float v[];
  __shared__ float scratch[kWarps];
  const size_t off = (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float t = x[off + i] + (y != nullptr ? y[off + i] : 0.f);
    v[i] = t;
    s += t;
  }
  const float mean = block_sum(s, scratch) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = v[i] - mean;
    s2 = fmaf(d, d, s2);
  }
  const float r = rsqrtf(block_sum(s2, scratch) / D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[off + i] = (v[i] - mean) * r * gamma[i] + beta[i];
}

template <typename WT, bool ROUND_X, bool RELU>
int launch_rowvec(int nb, const float* x, int ldx, const WT* w, int ldw,
                  const float* colscale, const float* bias, float* y, int ldy,
                  __nv_bfloat16* kv_out, int ldkv, int kv_col0, int K, int N,
                  cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols);
#define SMER_ROWVEC_CASE(NB)                                              \
  case NB:                                                                \
    rowvec_kernel<WT, NB, ROUND_X, RELU><<<grid, kThreads, 0, st>>>(      \
        x, ldx, w, ldw, colscale, bias, y, ldy, kv_out, ldkv, kv_col0, K, \
        N);                                                               \
    break;
  switch (nb) {
    SMER_ROWVEC_CASE(1)
    SMER_ROWVEC_CASE(2)
    SMER_ROWVEC_CASE(3)
    SMER_ROWVEC_CASE(4)
    SMER_ROWVEC_CASE(5)
    SMER_ROWVEC_CASE(6)
    SMER_ROWVEC_CASE(7)
    SMER_ROWVEC_CASE(8)
    default:
      // 9..16 rows: the verify window, which never streams int8 weights
      if constexpr (!std::is_same<WT, int8_t>::value) {
        static_assert(kMaxRows == 16, "instantiate every row count");
        switch (nb) {
          SMER_ROWVEC_CASE(9)
          SMER_ROWVEC_CASE(10)
          SMER_ROWVEC_CASE(11)
          SMER_ROWVEC_CASE(12)
          SMER_ROWVEC_CASE(13)
          SMER_ROWVEC_CASE(14)
          SMER_ROWVEC_CASE(15)
          SMER_ROWVEC_CASE(16)
          default:
            return (int)cudaErrorInvalidValue;
        }
      } else {
        return (int)cudaErrorInvalidValue;
      }
  }
#undef SMER_ROWVEC_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w_kind 0: W is bf16; 1: W is f32; 2: W is int8 with f32 column scales
// `colscale` (null otherwise).  A bf16 or int8 W sees x rounded to bf16.
int smer_rowvec(int w_kind, int relu, int nb, const void* x, int ldx,
                const void* w, int ldw, const void* colscale, const void* bias,
                void* y, int ldy, void* kv_out, int ldkv, int kv_col0, int K,
                int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cs = static_cast<const float*>(colscale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  __nv_bfloat16* kvo = static_cast<__nv_bfloat16*>(kv_out);
  if ((w_kind == 2) != (cs != nullptr)) return (int)cudaErrorInvalidValue;
  if (w_kind == 1) {
    if (relu) return (int)cudaErrorInvalidValue;
    return launch_rowvec<float, false, false>(
        nb, xf, ldx, static_cast<const float*>(w), ldw, cs, bf, yf, ldy, kvo,
        ldkv, kv_col0, K, N, st);
  }
  if (w_kind == 2) {
    const int8_t* wq = static_cast<const int8_t*>(w);
    if (relu)
      return launch_rowvec<int8_t, true, true>(nb, xf, ldx, wq, ldw, cs, bf, yf,
                                               ldy, kvo, ldkv, kv_col0, K, N, st);
    return launch_rowvec<int8_t, true, false>(nb, xf, ldx, wq, ldw, cs, bf, yf,
                                              ldy, kvo, ldkv, kv_col0, K, N, st);
  }
  if (w_kind != 0) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  if (relu)
    return launch_rowvec<__nv_bfloat16, true, true>(
        nb, xf, ldx, wb, ldw, cs, bf, yf, ldy, kvo, ldkv, kv_col0, K, N, st);
  return launch_rowvec<__nv_bfloat16, true, false>(
      nb, xf, ldx, wb, ldw, cs, bf, yf, ldy, kvo, ldkv, kv_col0, K, N, st);
}

// row_source (RowSource): 0 no rows past the cache's (chunk, n_chunk and
// chunk_tstride unused); 1 a v4 chunk of n_chunk rows; 2 a verify window,
// row b reading b rows of it (n_chunk unused)
int smer_attend(int head_dim, int B, int H, const void* q, int ldq,
                const void* kv, long long kv_bstride, int D, int n_rows,
                const void* lens, int max_rows, int row_source,
                const void* chunk, long long chunk_tstride, int n_chunk,
                const void* extra, int ld_extra, void* out, int ldo,
                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, H);
  const float* qf = static_cast<const float*>(q);
  const __nv_bfloat16* kvb = static_cast<const __nv_bfloat16*>(kv);
  const int* lp = static_cast<const int*>(lens);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(chunk);
  const float* ef = static_cast<const float*>(extra);
  float* of = static_cast<float*>(out);
  if ((row_source == kCacheOnly) != (cb == nullptr))
    return (int)cudaErrorInvalidValue;
#define SMER_ATTEND(EPL, SRC)                                                \
  attend_kernel<EPL, SRC><<<grid, kThreads, 0, st>>>(                        \
      qf, ldq, kvb, kv_bstride, D, n_rows, lp, max_rows, cb, chunk_tstride,  \
      n_chunk, ef, ld_extra, of, ldo, scale)
#define SMER_ATTEND_SOURCES(EPL)          \
  switch (row_source) {                   \
    case kCacheOnly:                      \
      SMER_ATTEND(EPL, kCacheOnly);       \
      break;                              \
    case kChunk:                          \
      SMER_ATTEND(EPL, kChunk);           \
      break;                              \
    case kWindow:                         \
      SMER_ATTEND(EPL, kWindow);          \
      break;                              \
    default:                              \
      return (int)cudaErrorInvalidValue;  \
  }
  switch (head_dim) {
    case 64:
      SMER_ATTEND_SOURCES(2)
      break;
    case 128:
      SMER_ATTEND_SOURCES(4)
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SMER_ATTEND_SOURCES
#undef SMER_ATTEND
  return (int)cudaGetLastError();
}

int smer_add_layernorm(int B, int D, const void* x, const void* y,
                       const void* gamma, const void* beta, void* out,
                       float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  add_layernorm_kernel<<<B, kThreads, D * sizeof(float), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), D, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
