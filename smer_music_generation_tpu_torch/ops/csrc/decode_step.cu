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
// The model's compute dtype is bf16 or f32, as JAX's kernels take any
// (the weights, the caches and the embedding are in it; x, the sums, the
// softmax, the LayerNorms and the logits are f32 in both).  What bounds it
// on an NVIDIA H100 80GB HBM3 (3.35 TB/s at 700 W): bytes.  At B=1 a step
// streams 4 x (512*3072 + 2*512*2048) decoder weights, 29.4 MB in bf16
// (58.7 MB in f32), plus the 512 x 384 f32 output projection (0.8 MB), and
// per layer and batch element `index` rows of self cache and `cross_len`
// rows of cross cache at 2 KB each (4 KB in f32).  The operations (2 flops
// per weight per row of B <= 16) are far below the card's ridge point.  Each launch moves
// 0.4-12 MB, a few microseconds of HBM time, so what sets a launch's time
// is how many bytes are in flight at once across the 132 SMs: the design
// puts a whole matrix (or a whole cache slice) in flight in one wave of
// 16-byte loads, and combines the partial results in a fixed order:
//
//   * `rowvec_kernel`: y[b, n] = act((sum_k c(x[b, k]) W[k, n]) *
//     colscale[n] + bias[n]) for up to 16 rows, c the rounding to the
//     compute dtype (none in f32).  W stays in the (K, N)
//     layout of the packed flax weights.  A block owns a tile of 64 output
//     columns and one K-slice of 16 * P rows, P = 1..4 passes chosen by the
//     wrapper from (K, N) so that a projection runs on about 256 blocks
//     (192-264 for the flagship's: 32 slices of 16 rows for the 512 x 512
//     and the logits, 11 of 48 for QKV, 8 of 64 for FFN up, 32 of 64 for
//     FFN down), two an SM, all resident at once.  A thread reads one
//     16-byte piece of each of its P W rows (8 bf16, 16 int8 or 4 f32
//     columns: blocks of 128, 64 or 256 threads), all P loads issued before
//     any product; the block's x slice is staged once in shared memory,
//     already rounded to the compute dtype.  The rows of x are taken four
//     at a time against the W registers, the 16 K rows of a pass are summed by warp
//     shuffles and shared memory in a fixed tree, and each block writes its
//     (rows, 64) partial to a workspace.  The last block of a column tile
//     to finish (a __threadfence and an atomic ticket on the tile's
//     counter, which it resets) sums the partials in slice order (32 of
//     them loaded before any is added), then
//     applies the column scale (int8), the bias, the ReLU and the K|V
//     write (in the compute dtype).  No block waits on another and no
//     atomic touches the data.
//     A projection whose output o feeds a post-LN, x = LN(x + o) (the two
//     out projections and FFN down), carries the LayerNorm as a tail: each
//     tile's last block, once its columns of o are written, takes one more
//     ticket on a counter of the launch; the last of them, which then sees
//     every column, runs the LN over the launch's rows, a warp a row (at
//     most 4 warps), in
//     add_layernorm_kernel's order of sums (so with that kernel's bits),
//     and writes x in place; the final LN may follow in the same tail.
//   * `attend_kernel` (flash-decoding): grid (B, H, splits); a block owns
//     64 rows of the spliced sequence (cache rows, then v4 chunk or verify
//     window rows).  8 lanes take a row, each reading head_dim / 8 dims of
//     K and of V (16 bytes at head_dim 64 in bf16; two or four 16-byte
//     loads of f32 rows), so a warp scores 4 rows at once with 3 shuffles;
//     the block takes the max of its 64 scores, exp(s - m) once a row, and sums p V and p
//     in a fixed tree.  Its (m, l, acc[head_dim]) go to the workspace; the
//     last block of the (b, h) (the same ticket) merges the splits in
//     split order, then the current token's own K/V row.
//   * `add_layernorm_kernel`: out = LN(x + y) in f32 with eps 1e-6, a block
//     a row.  No path launches it since rowvec_kernel carries the LN; it
//     stays as the bit reference of that tail (chip_smoke.py phase 2h).
//
// The workspace and the tickets belong to the stream the launches run on
// (ops/decode_step.py): launches on one stream run one after another, and
// each leaves every ticket it took at zero.  There is no grid-wide
// synchronisation, no cooperative launch and no spin-wait: stream order
// carries the data from one launch to the next, 8 launches per layer plus
// the logits (33 for the 4-layer model).
//
// Row-independence.  A row's result is a function of its own inputs only:
// the order of every sum is fixed by (K, N, the tiling) for rowvec_kernel
// and by the row's index in the spliced sequence for attend_kernel (which
// split, which place in it), never by the number of rows in the launch, the
// other rows' values or where the cache ends and the chunk or window rows
// begin.  So a v4 token sums exactly what a v3 token sums over the spliced
// cache, a verify row exactly what a v2 step at index + j sums, and a
// launch of more than 16 rows may be cut into chunks of 16 (the wrapper
// does) without changing a bit.
//
// int8 weights (the TPU kernel's `scale=` path of `_layer_body`, packed by
// `quantize_columns` :50): the same rowvec_kernel reads W as int8 (16
// columns a 16-byte load, converted exactly to float) with x rounded to the
// compute dtype (bf16; an f32 model's x unrounded, as JAX casts x and the
// int8 block to f32), and scales each output column by its f32 scale
// before the bias:
// y = (x . q) * s + b, the order of the TPU kernel's `rescale(dot) + b`.
//
// The kernel-looped token chunk (v4, `fused_decode_tokens` :1028) gives
// attend_kernel a second source of self-attention rows: rows r < n_rows come
// from the cache, rows n_rows <= r < n_rows + n_chunk from the chunk's own
// K|V rows (the v4 `new_kv` output, (T, B, 2D) a layer).  The teacher-forced
// verify of speculative decode (`fused_verify_window` :1368, body
// `_kernel_verify` :1284, `_flash_attend_multi` :1182) runs the same
// launches on the W window rows at B=1: rowvec_kernel takes the W rows as
// its batch (16 a launch), the cache and the cross K|V are shared by every
// row (batch stride 0), and attend_kernel's third row source gives row j
// the `index` cache rows, then window rows 0..j-1 of the `new_kv` output
// (written by the QKV launch of the same layer), then its own row.  The
// cache length may come from the device (`lens`, its first entry for every
// window row), so that speculative decode's iteration is replayed as one
// CUDA graph at every position (ops/decode_graph.py SpecGraph).
//
// Measured on an NVIDIA H100 80GB HBM3, 700.00 W (scripts/torch_kernel_ab.py,
// chip_smoke.py phase 2h; PERF.md): at the served case (B=3, S=1536, index
// 512) a v3 token's 25 rowvec launches take 122-155 us of device time and
// its 8 attend launches 52-66 us, against 751 and 532 us for the first
// design (N/64 blocks a projection with each warp walking K serially;
// B x H blocks of attention with a row a warp step).  A launch takes
// 4.6-6.2 us at 1-3 rows against a bytes bound of 0.16-0.64 us: the launch,
// one wave of loads and the ticketed combine set it, and the time a launch
// rises by ~1 us for each 4 rows past 8.  A whole token takes 0.21-0.27 ms
// of device time against 1.33 ms, and the host's launches set its pace
// unless the token is replayed as one CUDA graph (ops/decode_graph.py, the
// self-attention then reading the position through `lens`).  Before the LN
// tail a token also ran 13 add_layernorm_kernel launches of 2.66 us each.
//
// Every launcher has a plain C interface and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // add_layernorm_kernel, and the LN tail's order

// rowvec_kernel's tiling: a block owns kCols output columns and a K-slice
// of kPassRows * passes rows (passes <= kMaxPasses, chosen by the wrapper
// from K and N); it takes kGroup rows of x at a time, at most kMaxRows a
// launch
constexpr int kCols = 64;
constexpr int kPassRows = 16;
constexpr int kMaxPasses = 4;
constexpr int kGroup = 4;
constexpr int kMaxRows = 16;
constexpr int kStage = 32;  // partials of an output the combine loads at once

// attend_kernel: a block owns kSplitRows rows of the spliced sequence, 8
// lanes a row, 4 warps
constexpr int kSplitRows = 64;
constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kLanesPerRow = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of W as floats: 8 bf16, 16 int8 (|q| <= 127, exact) or 4 f32
template <typename WT>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(WT);
};

__device__ __forceinline__ void to_floats(const uint4& r, float (&f)[8]) {
  // a bf16 is the top half of the f32 of the same value
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_floats(const uint4& r, float (&f)[16]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int>(u[i] << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ void to_floats(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// Publish a block's partial (written before the call) and take a ticket on
// `counter`: true in the one block of `arrivals` that comes last, after
// which it may read every partial; that block resets the counter.
__device__ __forceinline__ bool last_arrival(unsigned* counter, unsigned arrivals) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == arrivals - 1;
    if (last) *counter = 0u;  // no other block of this launch touches it again
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The post-LN a projection carries (rowvec_kernel's LN tail): x = LN(x + o)
// over the launch's rows, in place in the residual x (row stride ldx), then
// the final LN (gamma2, beta2) where it is given.
struct LnTail {
  float* x;
  int ldx;
  const float* gamma;
  const float* beta;
  const float* gamma2;  // null: no final LN
  const float* beta2;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A row's sum as add_layernorm_kernel's kThreads threads take it, done by
// one warp: lane l stands for thread w * 32 + l of each warp w, whose sum
// s[w] went over elements w * 32 + l, + kThreads, ... from 0; then each
// warp's xor tree (warp_sum), and the warps' totals added in order from 0.
__device__ __forceinline__ float block_order_sum(const float (&s)[kWarps]) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_sum(s[w]);
  return t;
}

// LN of the warp's row v (D floats in shared memory) in place, with
// add_layernorm_kernel's arithmetic in its order, so with its bits.
__device__ __forceinline__ void layernorm_row(float* v, int D, const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float eps) {
  const int lane = threadIdx.x & 31;
  float s[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s[w] = 0.f;
  for (int i0 = 0; i0 < D; i0 += kThreads)
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (i0 + w * 32 + lane < D) s[w] += v[i0 + w * 32 + lane];
  const float mean = block_order_sum(s) / D;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s[w] = 0.f;
  for (int i0 = 0; i0 < D; i0 += kThreads)
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (i0 + w * 32 + lane < D) {
        const float d = v[i0 + w * 32 + lane] - mean;
        s[w] = fmaf(d, d, s[w]);
      }
  const float r = rsqrtf(block_order_sum(s) / D + eps);
  for (int i = lane; i < D; i += 32) v[i] = (v[i] - mean) * r * gamma[i] + beta[i];
}

// The warps of a block that run its LN tail: every warp of a bf16 (4) or
// int8 (2) block, 4 of an f32 block's 8, so that a tail's rows take no more
// shared memory than a bf16 block's.  Which warp takes a row changes none
// of its bits.
__host__ __device__ constexpr int tail_warps(int block_warps) {
  return block_warps < 4 ? block_warps : 4;
}

// The LN tail over nb rows of D, in the block that took the launch's last
// ticket: warp w < kWarpsUsed takes rows w, w + kWarpsUsed, ...; x + o into
// the warp's row of `buf` (kWarpsUsed rows of D floats; x and o read
// through L2, o written by other blocks of the launch), the LN there, the
// final LN after it where given, and x written in place.
template <int kWarpsUsed>
__device__ void layernorm_tail(const float* o, int ldo, int nb, int D, const LnTail& ln,
                               float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= kWarpsUsed) return;  // no barrier follows
  float* v = buf + (size_t)warp * D;
  for (int b = warp; b < nb; b += kWarpsUsed) {
    float* xr = ln.x + (size_t)b * ln.ldx;
    const float* orow = o + (size_t)b * ldo;
    for (int i = lane; i < D; i += 32) v[i] = __ldcg(xr + i) + __ldcg(orow + i);
    layernorm_row(v, D, ln.gamma, ln.beta, ln.eps);
    if (ln.gamma2 != nullptr) {
      // the final LN reads its input as add_layernorm_kernel with no y does
      for (int i = lane; i < D; i += 32) v[i] = v[i] + 0.f;
      layernorm_row(v, D, ln.gamma2, ln.beta2, ln.eps);
    }
    for (int i = lane; i < D; i += 32) xr[i] = v[i];
  }
}

// A K|V value as the cache holds it: bf16 (rounded to nearest) or f32
__device__ __forceinline__ void store_kv(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_kv(float* p, float v) { *p = v; }

// BF16: the model computes in bf16, so x is rounded to bf16 as the kernel
// reads it and the K|V rows are written as bf16; otherwise (an f32 model,
// and the f32 logits of either) x is read as it is and K|V written as f32.
// LN_TAIL: the launch ends with x = LN(x + y) over its rows (N == D), by
// the last of the tiles' last blocks, on a ticket past the tiles' own
template <typename WT, bool BF16, bool RELU, bool LN_TAIL>
__global__ void __launch_bounds__(kPassRows * kCols / Vec16<WT>::kN) rowvec_kernel(
    const float* __restrict__ x, int ldx, int nb, const WT* __restrict__ w, int ldw,
    const float* __restrict__ colscale, const float* __restrict__ bias, float* __restrict__ y,
    int ldy, void* __restrict__ kv_out, int ldkv, int kv_col0, int K, int N,
    int k_split, LnTail ln, float* __restrict__ ws, unsigned* __restrict__ tickets) {
  // the launch after this one may begin now: a token's sampler, launched
  // as a programmatic dependent launch behind the logits, runs the loads
  // that do not read this launch's output meanwhile (decode_token.cu);
  // for any other launch after it this changes nothing
  asm volatile("griddepcontrol.launch_dependents;");
  // int8 weights carry column scales; a bf16 or f32 instantiation is the
  // kernel without them
  constexpr bool kScaled = std::is_same<WT, int8_t>::value;
  using KT = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int kVec = Vec16<WT>::kN;        // columns a thread
  constexpr int kTpr = kCols / kVec;         // threads a W row of the tile
  constexpr int kBlock = kPassRows * kTpr;   // 128 bf16, 64 int8, 256 f32
  constexpr int kBlockWarps = kBlock / 32;
  extern __shared__ float smem[];
  float* xs = smem;                 // [nb][k_split], x rounded as the kernel reads it
  float* red = smem + nb * k_split; // [kBlockWarps][nb][kCols]
  const int tile = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int krow = tid / kTpr, cg = tid % kTpr;
  const int k0 = slice * k_split;
  const int passes = k_split / kPassRows;
  const int n = tile * kCols + cg * kVec;

  // every W load of the thread first: passes 16-byte pieces
  uint4 wr[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int k = k0 + p * kPassRows + krow;
    wr[p] = make_uint4(0u, 0u, 0u, 0u);
    if (p < passes && k < K && n < N) wr[p] = ldg16(w + (size_t)k * ldw + n);
  }
  for (int i = tid; i < nb * k_split; i += kBlock) {
    const int b = i / k_split, k = k0 + i % k_split;
    float v = 0.f;
    if (k < K) {
      v = x[(size_t)b * ldx + k];
      if (BF16) v = bf16_round(v);
    }
    xs[i] = v;
  }
  __syncthreads();

  for (int g0 = 0; g0 < nb; g0 += kGroup) {
    float acc[kGroup][kVec];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < passes) {
        float wf[kVec];
        to_floats(wr[p], wf);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float xv = g0 + r < nb ? xs[(g0 + r) * k_split + p * kPassRows + krow] : 0.f;
#pragma unroll
          for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
        }
      }
    }
    // the warp's K rows (lanes cg, cg + kTpr, ...) by a shuffle tree
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
#pragma unroll
        for (int o = kTpr; o < 32; o <<= 1) acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], o);
    if (lane < kTpr) {
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (g0 + r < nb) {
#pragma unroll
          for (int c = 0; c < kVec; ++c)
            red[(warp * nb + g0 + r) * kCols + cg * kVec + c] = acc[r][c];
        }
      }
    }
  }
  __syncthreads();

  // the block's partial, its warps summed in order
  const int tile_vals = nb * kCols;
  float* part = ws + (size_t)tile * slices * tile_vals;
  for (int i = tid; i < tile_vals; i += kBlock) {
    float s = red[i];
#pragma unroll
    for (int wi = 1; wi < kBlockWarps; ++wi) s += red[wi * tile_vals + i];
    part[(size_t)slice * tile_vals + i] = s;
  }
  if (!last_arrival(tickets + tile, (unsigned)slices)) return;

  // each output sums its slices' partials in slice order; up to kStage of
  // them are loaded before any is added, so a round's loads are in flight
  // together
  for (int i = tid; i < tile_vals; i += kBlock) {
    const int b = i / kCols;
    const int col = tile * kCols + i % kCols;
    if (col >= N) continue;
    float s = 0.f;
    for (int s0 = 0; s0 < slices; s0 += kStage) {
      float v[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j)
        v[j] = s0 + j < slices ? __ldcg(part + (size_t)(s0 + j) * tile_vals + i) : 0.f;
#pragma unroll
      for (int j = 0; j < kStage; ++j)
        if (s0 + j < slices) s = s0 + j == 0 ? v[j] : s + v[j];
    }
    // int8: the column scale, rounded, then the bias (no contraction)
    if (kScaled) s = __fmul_rn(s, colscale[col]);
    s += bias[col];
    if (RELU) s = fmaxf(s, 0.f);
    y[(size_t)b * ldy + col] = s;
    if (kv_out != nullptr && col >= kv_col0)
      store_kv(static_cast<KT*>(kv_out) + (size_t)b * ldkv + (col - kv_col0), s);
  }
  if constexpr (LN_TAIL) {
    // the tile's columns of y are written: the launch's last tile to get
    // here sees every column.  No block of the launch reads ln.x (the
    // projection's input is another buffer), so the tail writes it in place.
    if (last_arrival(tickets + gridDim.x, gridDim.x))
      layernorm_tail<tail_warps(kBlockWarps)>(y, ldy, nb, N, ln, smem);
  }
}

// Where self-attention rows past the cache's come from.
enum RowSource {
  kCacheOnly = 0,  // v2, v3 and cross-attention
  kChunk = 1,      // v4: n_chunk rows of the chunk, (n_chunk, B, 2D) a layer
  kWindow = 2,     // verify: row b reads window rows 0..b-1, (W, 2D) a layer
};

// q . k of one row over the 8 lanes that hold it (kDpl dims each), times
// scale; every lane of the 8 ends with the same bits
template <int kDpl>
__device__ __forceinline__ float row_score(const float (&qv)[kDpl], const float (&kf)[kDpl],
                                           float scale) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kDpl; ++e) s = fmaf(qv[e], kf[e], s);
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  return s * scale;
}

// head_dim HD (64 or 128): each of a row's 8 lanes owns HD / 8 adjacent dims.
// The rows (cache, chunk, window) are T: bf16, or f32 for an f32 model,
// whose row takes twice the 16-byte loads a lane (2 at head_dim 64, 4 at
// 128) and no other change: a lane's dims, its sums and their order are
// those of the bf16 rows.  Partials in `ws`: [b * H + h][split][2 + HD] =
// (m, l, acc).
template <typename T, int HD, int SRC>
__global__ void __launch_bounds__(kAttnThreads) attend_kernel(
    const float* __restrict__ q, int ldq, const T* __restrict__ kv,
    long long kv_bstride, int D, int n_rows, const int* __restrict__ lens, int max_rows,
    const T* __restrict__ chunk, long long chunk_tstride, int n_chunk,
    const float* __restrict__ extra, int ld_extra, float* __restrict__ out, int ldo, float scale,
    float* __restrict__ ws, unsigned* __restrict__ tickets) {
  constexpr int kDpl = HD / kLanesPerRow;
  constexpr int kPer = Vec16<T>::kN;                           // elements a 16-byte load
  constexpr int kPieces = kDpl / kPer;                         // 16-byte loads a row, of K and of V
  constexpr int kRowsAtOnce = kAttnThreads / kLanesPerRow;     // 16
  constexpr int kSteps = kSplitRows / kRowsAtOnce;             // 4
  // a split's scores; in the merge, a chunk of splits' exp(m - M) (or m)
  // and l
  __shared__ float sc[kAttnThreads];
  __shared__ float sl[kAttnThreads];
  __shared__ float red[kAttnWarps][HD + 1];
  __shared__ float sx;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int H = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % kLanesPerRow;  // which dims of the row
  const int rl = lane / kLanesPerRow;   // which row of the warp's 4
  // the verify window's rows share one sequence's cache length
  int n_cache = lens != nullptr ? lens[SRC == kWindow ? 0 : b] : n_rows;
  n_cache = max(0, min(n_cache, max_rows));
  const int n = n_cache + (SRC == kChunk ? n_chunk : (SRC == kWindow ? b : 0));
  const int r0 = split * kSplitRows;
  const int d0 = h * HD + sub * kDpl;
  float* part = ws + ((size_t)(b * H + h) * splits + split) * (2 + HD);

  float qv[kDpl];
#pragma unroll
  for (int e = 0; e < kDpl; e += 4) {
    const float4 t = *reinterpret_cast<const float4*>(q + (size_t)b * ldq + d0 + e);
    qv[e] = t.x;
    qv[e + 1] = t.y;
    qv[e + 2] = t.z;
    qv[e + 3] = t.w;
  }

  if (r0 < n) {
    const T* base = kv + (size_t)b * kv_bstride;
    // a v4 chunk holds B rows a token; the verify window is one row a slot
    const T* cbase = chunk + (SRC == kChunk ? (size_t)b * 2 * D : 0);
    uint4 kr[kSteps][kPieces], vr[kSteps][kPieces];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int r = r0 + st * kRowsAtOnce + warp * 4 + rl;
      const T* row = nullptr;
      if (r < n_cache)
        row = base + (size_t)r * 2 * D;
      else if (SRC != kCacheOnly && r < n)
        row = cbase + (size_t)(r - n_cache) * chunk_tstride;
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        kr[st][pc] = make_uint4(0u, 0u, 0u, 0u);
        vr[st][pc] = make_uint4(0u, 0u, 0u, 0u);
        if (row != nullptr) {
          kr[st][pc] = ldg16(row + d0 + kPer * pc);
          vr[st][pc] = ldg16(row + D + d0 + kPer * pc);
        }
      }
    }
    float s[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float kf[kDpl];
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        float f[kPer];
        to_floats(kr[st][pc], f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) kf[kPer * pc + e] = f[e];
      }
      s[st] = row_score<kDpl>(qv, kf, scale);
      if (r0 + st * kRowsAtOnce + warp * 4 + rl >= n) s[st] = -INFINITY;
      if (sub == 0) sc[st * kRowsAtOnce + warp * 4 + rl] = s[st];
    }
    __syncthreads();
    float m = -INFINITY;
#pragma unroll 8
    for (int i = 0; i < kSplitRows; ++i) m = fmaxf(m, sc[i]);
    // p = exp(s - m) once a row; the row's 8 lanes hold the same p
    float l = 0.f;
    float acc[kDpl];
#pragma unroll
    for (int e = 0; e < kDpl; ++e) acc[e] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const float p = expf(s[st] - m);  // 0 on a row past n
      l += p;
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        float f[kPer];
        to_floats(vr[st][pc], f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[kPer * pc + e] = fmaf(p, f[e], acc[kPer * pc + e]);
      }
    }
    // the warp's 4 rows (lanes sub, sub + 8, ...), then the 4 warps in order
#pragma unroll
    for (int o = kLanesPerRow; o < 32; o <<= 1) {
      l += __shfl_xor_sync(kFull, l, o);
#pragma unroll
      for (int e = 0; e < kDpl; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], o);
    }
    if (rl == 0) {
#pragma unroll
      for (int e = 0; e < kDpl; ++e) red[warp][sub * kDpl + e] = acc[e];
      if (sub == 0) red[warp][HD] = l;
    }
    __syncthreads();
    for (int i = tid; i <= HD; i += kAttnThreads) {
      float t = red[0][i];
#pragma unroll
      for (int wi = 1; wi < kAttnWarps; ++wi) t += red[wi][i];
      part[i == HD ? 1 : 2 + i] = t;
    }
    if (tid == 0) part[0] = m;
  }
  if (!last_arrival(tickets + b * H + h, (unsigned)splits)) return;

  const bool has_extra = extra != nullptr;
  if (has_extra && warp == 0) {
    // the current token's key: it is not in the cache yet; lanes 0-7 as a row
    float kf[kDpl];
#pragma unroll
    for (int e = 0; e < kDpl; ++e) kf[e] = extra[(size_t)b * ld_extra + d0 + e];
    const float t = row_score<kDpl>(qv, kf, scale);
    if (lane == 0) sx = t;
  }
  __syncthreads();
  // the splits holding a row (by n alone) in split order: their m and
  // exp(m - M) staged in shared memory a chunk of 128 splits at a time, a
  // dim's partials loaded kStage at a time before any is added
  const int used = (n + kSplitRows - 1) / kSplitRows;
  const float* p0 = ws + (size_t)(b * H + h) * splits * (2 + HD);
  float M = has_extra ? sx : -INFINITY;
  for (int c0 = 0; c0 < used; c0 += kAttnThreads) {
    __syncthreads();
    if (c0 + tid < used) sc[tid] = __ldcg(p0 + (size_t)(c0 + tid) * (2 + HD));
    __syncthreads();
    for (int j = 0; j < min(kAttnThreads, used - c0); ++j) M = fmaxf(M, sc[j]);
  }
  float L = 0.f, A = 0.f;
  for (int c0 = 0; c0 < used; c0 += kAttnThreads) {
    const int nc = min(kAttnThreads, used - c0);
    __syncthreads();
    if (tid < nc) {
      const float* ps = p0 + (size_t)(c0 + tid) * (2 + HD);
      sc[tid] = expf(__ldcg(ps) - M);
      sl[tid] = __ldcg(ps + 1);
    }
    __syncthreads();
    if (tid < HD) {
      for (int j0 = 0; j0 < nc; j0 += kStage) {
        float v[kStage];
#pragma unroll
        for (int j = 0; j < kStage; ++j)
          v[j] = j0 + j < nc ? __ldcg(p0 + (size_t)(c0 + j0 + j) * (2 + HD) + 2 + tid) : 0.f;
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
          if (j0 + j < nc) {
            L = fmaf(sl[j0 + j], sc[j0 + j], L);
            A = fmaf(v[j], sc[j0 + j], A);
          }
        }
      }
    }
  }
  if (tid < HD) {
    if (has_extra) {
      const float c = expf(sx - M);
      L += c;
      A = fmaf(c, extra[(size_t)b * ld_extra + D + h * HD + tid], A);
    }
    out[(size_t)b * ldo + h * HD + tid] = A / L;
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
// every element is read into shared memory before any is written.  On no
// path: rowvec_kernel's LN tail computes its bits inside the projection's
// launch, and this kernel is the tail's reference.
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

template <typename WT, bool BF16, bool RELU, bool LN_TAIL>
int launch_rowvec(int nb, const float* x, int ldx, const WT* w, int ldw, const float* colscale,
                  const float* bias, float* y, int ldy, void* kv_out, int ldkv,
                  int kv_col0, int K, int N, int k_split, const LnTail& ln, float* ws,
                  unsigned* tickets, cudaStream_t st) {
  constexpr int kVec = Vec16<WT>::kN;
  constexpr int kBlock = kPassRows * kCols / kVec;
  if (nb < 1 || nb > kMaxRows || K < 1 || N < 1 || N % kVec || ldw % kVec ||
      k_split < kPassRows || k_split > kPassRows * kMaxPasses || k_split % kPassRows ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, (K + k_split - 1) / k_split);
  size_t smem = sizeof(float) * (size_t)nb * (k_split + kBlock / 32 * kCols);
  if (LN_TAIL)  // a row a tail warp
    smem = std::max(smem, sizeof(float) * (size_t)tail_warps(kBlock / 32) * N);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  rowvec_kernel<WT, BF16, RELU, LN_TAIL><<<grid, kBlock, smem, st>>>(
      x, ldx, nb, w, ldw, colscale, bias, y, ldy, kv_out, ldkv, kv_col0, K, N, k_split, ln, ws,
      tickets);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w_kind, the weights and the compute dtype: 0, W bf16 (a bf16 model);
// 1, W f32 (an f32 model, and the f32 logits of either); 2, W int8 with
// f32 column scales `colscale` (null otherwise) in a bf16 model; 3, the
// same in an f32 model.  In a bf16 model (kinds 0 and 2) x is rounded to
// bf16 as W reads it and the K|V rows `kv_out` are written as bf16; in an
// f32 model (kinds 1 and 3) x is read as it is and K|V written as f32, as
// JAX casts the int8 blocks and x to the compute dtype (:306-319).
// 1 <= nb <= 16 rows; K is cut into slices of k_split rows (a multiple of
// 16, at most 64), one block each per 64-column tile; `ws` holds the
// tiles' partials (ceil(N / 64) * 64 * slices * nb floats) and `tickets`
// one zeroed counter a tile, which the launch leaves at zero.
// `res` non-null (no ReLU): the LN tail, res = LN(res + y) over the nb rows
// of N (row stride ldr, in place) with gamma and beta, then LN(res) with
// gamma2 and beta2 where they are given; `tickets` then holds one more
// counter, past the tiles'.
int smer_rowvec(int w_kind, int relu, int nb, const void* x, int ldx, const void* w, int ldw,
                const void* colscale, const void* bias, void* y, int ldy, void* kv_out, int ldkv,
                int kv_col0, int K, int N, int k_split, void* res, int ldr, const void* gamma,
                const void* beta, const void* gamma2, const void* beta2, float eps, void* ws,
                void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cs = static_cast<const float*>(colscale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  float* wsf = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const LnTail ln{static_cast<float*>(res), ldr, static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), static_cast<const float*>(gamma2),
                  static_cast<const float*>(beta2), eps};
  const bool tail = ln.x != nullptr;
  if ((w_kind >= 2) != (cs != nullptr)) return (int)cudaErrorInvalidValue;
  if (tail && (relu || ln.gamma == nullptr || ln.beta == nullptr ||
               (ln.gamma2 == nullptr) != (ln.beta2 == nullptr)))
    return (int)cudaErrorInvalidValue;
#define SMER_ROWVEC(WT, BF16, RELU, TAIL)                                                      \
  launch_rowvec<WT, BF16, RELU, TAIL>(nb, xf, ldx, static_cast<const WT*>(w), ldw, cs, bf, yf, \
                                      ldy, kv_out, ldkv, kv_col0, K, N, k_split, ln, wsf, tk, st)
#define SMER_ROWVEC_USES(WT, BF16)                                                   \
  (relu ? SMER_ROWVEC(WT, BF16, true, false)                                          \
        : tail ? SMER_ROWVEC(WT, BF16, false, true) : SMER_ROWVEC(WT, BF16, false, false))
  switch (w_kind) {
    case 0:
      return SMER_ROWVEC_USES(__nv_bfloat16, true);
    case 1:
      return SMER_ROWVEC_USES(float, false);
    case 2:
      return SMER_ROWVEC_USES(int8_t, true);
    case 3:
      return SMER_ROWVEC_USES(int8_t, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SMER_ROWVEC_USES
#undef SMER_ROWVEC
}

// kv_f32: the K|V rows (kv, chunk) are f32 (an f32 model), else bf16.
// row_source (RowSource): 0 no rows past the cache's (chunk, n_chunk and
// chunk_tstride unused); 1 a v4 chunk of n_chunk rows; 2 a verify window,
// row b reading b rows of it (n_chunk unused), every row reading the cache
// length lens[0] when lens is given.  The grid is (B, H,
// n_splits): n_splits * 64 must cover every row a (b, h) attends before
// its `extra` row; `ws` holds B * H * n_splits * (2 + head_dim) floats and
// `tickets` B * H zeroed counters, which the launch leaves at zero.
int smer_attend(int head_dim, int kv_f32, int B, int H, const void* q, int ldq, const void* kv,
                long long kv_bstride, int D, int n_rows, const void* lens, int max_rows,
                int row_source, const void* chunk, long long chunk_tstride, int n_chunk,
                const void* extra, int ld_extra, void* out, int ldo, float scale, int n_splits,
                void* ws, void* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, H, n_splits);
  const float* qf = static_cast<const float*>(q);
  const int* lp = static_cast<const int*>(lens);
  const float* ef = static_cast<const float*>(extra);
  float* of = static_cast<float*>(out);
  float* wsf = static_cast<float*>(ws);
  unsigned* tk = static_cast<unsigned*>(tickets);
  if ((row_source == kCacheOnly) != (chunk == nullptr) || n_splits < 1 || D % 8 || ldq % 4 ||
      reinterpret_cast<uintptr_t>(kv) % 16 || reinterpret_cast<uintptr_t>(chunk) % 16 ||
      chunk_tstride % 8 || kv_bstride % 8)
    return (int)cudaErrorInvalidValue;
#define SMER_ATTEND(T, HD, SRC)                                                               \
  attend_kernel<T, HD, SRC><<<grid, kAttnThreads, 0, st>>>(                                  \
      qf, ldq, static_cast<const T*>(kv), kv_bstride, D, n_rows, lp, max_rows,               \
      static_cast<const T*>(chunk), chunk_tstride, n_chunk, ef, ld_extra, of, ldo, scale, wsf, \
      tk)
#define SMER_ATTEND_SOURCES(T, HD)        \
  switch (row_source) {                   \
    case kCacheOnly:                      \
      SMER_ATTEND(T, HD, kCacheOnly);     \
      break;                              \
    case kChunk:                          \
      SMER_ATTEND(T, HD, kChunk);         \
      break;                              \
    case kWindow:                         \
      SMER_ATTEND(T, HD, kWindow);        \
      break;                              \
    default:                              \
      return (int)cudaErrorInvalidValue;  \
  }
#define SMER_ATTEND_HEADS(T)              \
  switch (head_dim) {                     \
    case 64:                              \
      SMER_ATTEND_SOURCES(T, 64)          \
      break;                              \
    case 128:                             \
      SMER_ATTEND_SOURCES(T, 128)         \
      break;                              \
    default:                              \
      return (int)cudaErrorInvalidValue;  \
  }
  if (kv_f32) {
    SMER_ATTEND_HEADS(float)
  } else {
    SMER_ATTEND_HEADS(__nv_bfloat16)
  }
#undef SMER_ATTEND_HEADS
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
