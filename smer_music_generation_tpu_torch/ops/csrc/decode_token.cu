// The two ends of one whole decode token (v3) for Hopper (sm_90a): the
// embedding + positional row in front of the decoder layers, and the
// grammar-masked sampling + state advance after the logits.  The decoder
// layers and the logits in between are the v2 launches of decode_step.cu.
//
// Replaces the TPU kernel `fused_decode_token` (v3) of
// smer_music_generation_tpu/ops/decode_step.py:796 (body `_kernel_v3` :725,
// `_sample_and_advance_b` :617, `_pe_row` :604) and, run T_chunk times, the
// kernel-looped chunk `fused_decode_tokens` (v4) of the same file, :1028
// (body `_kernel_v4` :916).  It computes the same function, not the TPU
// kernel's shape: the embedding is a gather, not a one-hot matmul; the
// nucleus rule reads the probabilities from shared memory, not through an
// identity-matmul transpose; there are no DMA semaphores.
//
// The position lives on the device.  On the TPU a whole token is one
// `pallas_call` inside a device-side `lax.while_loop`, the position a loop
// carry.  Here a replayed token is 34 launches in stream order (4 layers x
// 8 and the logits of decode_step.cu, then sample_advance_kernel), captured
// once as a CUDA graph and replayed once a token (v3) or once a chunk of
// T_chunk tokens (v4; ops/decode_graph.py).  The token's input row x is
// written by the sampler of the token before it; embed_pe_kernel writes it
// only for the first token of an eager call and when a graph is built or
// loaded.
// A graph replays its launches with the arguments they were captured
// with, so no launch may take the position as a value: it is an int32
// vector `pos` (B,), one equal entry a batch row, read by every kernel that
// needs it (the self-attention reads it as attend_kernel's per-row `lens`)
// and advanced by the last kernel of the token.  A launch's arguments are
// then the same at every position.
//
//   * `embed_pe_kernel` (grid B): reads the token of each row from the
//     (6, B) state and its position pos[b] + t (t, the token's place in a
//     v4 chunk, is fixed at capture), gathers the token's embedding row
//     (bf16 -> f32), scales it by sqrt(D) and adds the analytic sinusoidal
//     row of that position (even lanes sin, odd lanes cos of the (l - 1)
//     frequency), in f32; x is not rounded before the first layer, as the
//     TPU kernel keeps it in f32;
//   * `sample_advance_kernel` (grid B, one thread per padded vocab lane):
//     grammar-row selection from the state bits, span start and span type;
//     masked (-1e9) logits over the temperature; an f32 log-softmax; the
//     sort-free nucleus rule (a lane is kept iff the probability mass
//     strictly above its own is < p); the Gumbel row `noise[p, b]` of the
//     token's position p = pos[b] + t (greedy reads none); an argmax that
//     takes the lowest index on ties, as jnp.argmax does; the class flags
//     of the sampled token; the bits, span end (eos, the span cap counting
//     the introducing m_0, a control span's one token), done, next token
//     and length (p + 2) exactly as the TPU kernel advances them.  A row
//     that is done writes padding.  It writes the next state over the
//     state it read (block b owns column b, and every thread reads the
//     column before thread 0 writes it, past the block's barriers), the
//     next token into the decoder's (B, L) output at column p + 1 when it
//     is given one, and advances pos[b] by `advance` (1 for a v3 token,
//     T_chunk at a chunk's last token, 0 before it).  Each block advances
//     its own row's entry of `pos` after its own reads, and every other
//     reader of the position is an earlier launch in stream order, so no
//     ticket and no extra launch is needed; this is why the position is a
//     (B,) vector and not one word.  Given `x`, it then writes the next
//     token's input row, embed_pe_kernel's row of the next token at
//     position p + 1 (the same device functions, so the same bits).
//
// What bounds them on an NVIDIA H100 80GB HBM3 (3.35 TB/s at 700 W): bytes,
// a few KB a token: embed_pe_kernel reads B embedding rows (1 KB each at
// d512) and writes B f32 rows; sample_advance_kernel reads B logit rows,
// grammar mask rows and (nucleus) noise rows of vpad f32 (1.5 KB each),
// writes 7 words and (folded) an x row a batch row, and does at most
// vpad x vpad compare-adds a row for the nucleus rule.  Under 0.01 us of
// HBM time each.  What sets their time is a chain of dependent steps: the
// launch, global loads that wait on one another, barriers.  So the sampler
// keeps the chain short:
//   - at entry it issues every load that depends on nothing it computes:
//     the state column, pos, aux, the row's span types (a lane holds every
//     32nd, the lane of the current span hands it over by a shuffle), the
//     16 sid_tbl entries (one a lane, handed over by a shuffle), the lane's
//     8 class flags packed into a byte, then the noise lane at the
//     position; the mask row is its one dependent global load before the
//     logits; each thread computes the PE of its x lanes meanwhile;
//   - it is launched as a programmatic dependent launch
//     (cudaLaunchAttributeProgrammaticStreamSerialization) behind the
//     logits' rowvec_kernel, which triggers its dependents at its start:
//     all of the above reads buffers that no launch of the token writes
//     and runs while the logits are computed; `griddepcontrol.wait` gates
//     the logit load and every write;
//   - the nucleus rule sums only the nonzero probabilities (each warp
//     compacts its own by a ballot, in lane order): a masked lane's
//     probability is exactly 0 and adds nothing, so `above` keeps the bits
//     of the sum over every lane in index order while the loop runs over
//     the grammar's allowed lanes alone;
//   - the argmax carries each lane's flag byte beside its index, and every
//     warp finishes the cross-warp argmax itself by shuffles: no load and
//     no barrier after it.  Three barriers a launch, four with the nucleus
//     rule; the reductions keep the order of the kernel they replace (the
//     warp xor tree, then the warps in index order), so the
//     log-probabilities keep their bits.
// The whole token is bound by the bytes of the v2 step (the decoder
// weights, the valid cache rows).
//
// In a v4 chunk the QKV launch of token t writes its K|V row into the
// chunk output `new_kv` (nl, T_chunk, B, 2D), the self-attention reads the
// cache rows below pos (which stays at the chunk's base until the chunk's
// last token) and the chunk rows before t (decode_step.cu).  It is bound
// by bytes as v3 is, the weights read once a token.
//
// There is no grid-wide synchronisation, no cooperative launch and no
// spin-wait.  Every launcher has a plain C interface and returns the
// launch's error or cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// state rows (ops/decode_step.py ST_*), aux rows (AUX_*), class columns
constexpr int kToken = 0, kBits = 1, kSteps = 2, kSpan = 3, kDone = 4, kLen = 5;
constexpr int kNSpans = 0, kNoWhole = 1;
constexpr int kClPitch = 0, kClDur = 1, kClSep = 2, kClRest = 3, kClStep = 4,
              kClCont = 6, kNClasses = 8;
constexpr float kNeg = -1e9f;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
// span types a lane loads at entry: every 32nd of the first 256; a span
// index past them is read when it is known
constexpr int kSpanRegs = 8;
// the argmax's key: the lane's index in the low 16 bits, its class flags
// above them
constexpr int kIndexBits = 0xffff;

// The input row's lane l at position p: the sinusoidal value (even lanes
// sin, odd lanes cos of the (l - 1) frequency), then the embedding value
// e scaled by sqrt(D) plus it, as two rounded steps as the reference
// computes them.  embed_pe_kernel and the sampler's fold both call these,
// so they write the same bits.
__device__ __forceinline__ float pe_lane(int l, float p, float neg_log_over_d) {
  const float freq = expf(__fmul_rn((float)(l - (l & 1)), neg_log_over_d));
  const float angle = __fmul_rn(p, freq);
  return (l & 1) ? cosf(angle) : sinf(angle);
}

__device__ __forceinline__ float embed_lane(const __nv_bfloat16* __restrict__ emb, int tok,
                                            int vpad, int D, int l, float emb_scale, float pe) {
  const bool valid = tok >= 0 && tok < vpad;
  const float e = valid ? __bfloat162float(emb[(size_t)tok * D + l]) : 0.f;
  return __fadd_rn(__fmul_rn(e, emb_scale), pe);
}

__global__ void __launch_bounds__(256) embed_pe_kernel(
    const int* __restrict__ tokens, const __nv_bfloat16* __restrict__ emb,
    int vpad, int D, float emb_scale, const int* __restrict__ pos, int pos_offset,
    float neg_log_over_d, float* __restrict__ x) {
  const int b = blockIdx.x;
  const int tok = tokens[b];
  const float p = (float)(pos[b] + pos_offset);
  for (int l = threadIdx.x; l < D; l += blockDim.x)
    x[(size_t)b * D + l] = embed_lane(emb, tok, vpad, D, l, emb_scale,
                                      pe_lane(l, p, neg_log_over_d));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// (a, key a) before (b, key b): the larger score, the lower index on ties
__device__ __forceinline__ bool better(float a, int ka, float b, int kb) {
  return a > b || (a == b && (ka & kIndexBits) < (kb & kIndexBits));
}

// One block per batch row, one thread per padded vocab lane (blockDim.x ==
// vpad, a multiple of 32 and at most 1024).  `state` is read and written in
// place, and `pos` too: neither is __restrict__.  The logits are written
// by the launch this one may overlap (a programmatic dependent launch):
// they are read after griddepcontrol.wait, through L2 (ld.global.cg).
__global__ void __launch_bounds__(1024) sample_advance_kernel(
    const float* logits, int* state,
    const int* __restrict__ aux, const int* __restrict__ span_types,
    const int* __restrict__ sid_tbl, const float* __restrict__ masks,
    const float* __restrict__ class_mat, const float* __restrict__ noise,
    int* pos, int pos_offset, int advance, int* __restrict__ out, int ld_out, int B,
    int vpad, int mode, int max_spans, int span_cap, int eos_index, int mask_index,
    int use_nucleus, float nucleus_p, float temperature, int n_sid,
    int span_body, const __nv_bfloat16* __restrict__ emb, int D, float emb_scale,
    float neg_log_over_d, float* __restrict__ x) {
  extern __shared__ float smem[];
  float* seg = smem;          // (vpad,): each warp's nonzero probabilities, lane order
  float* pe_s = smem + vpad;  // (D,) with x: the next position's PE, a thread's own lanes
  __shared__ float red_max[kMaxWarps];
  __shared__ float red_sum[kMaxWarps];
  __shared__ int seg_n[kMaxWarps];
  __shared__ float arg_v[kMaxWarps];
  __shared__ int arg_k[kMaxWarps];

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;
  const int n_warps = blockDim.x >> 5;

  // every load that depends on nothing this kernel computes, issued at once
  const int row_pos = pos[b];
  const int bits = state[kBits * B + b];
  const int steps = state[kSteps * B + b];
  const int span_idx = state[kSpan * B + b];
  const int done = state[kDone * B + b];
  const int length = state[kLen * B + b];
  const int n_spans = aux[kNSpans * B + b];
  const int nw = aux[kNoWhole * B + b];
  const int sid_l = lane < 16 ? sid_tbl[lane] : 0;
  const int* types = span_types + (size_t)b * max_spans;
  int type_r[kSpanRegs];
#pragma unroll
  for (int j = 0; j < kSpanRegs; ++j) {
    const int k = lane + 32 * j;
    type_r[j] = k < max_spans ? types[k] : 0;
  }
  const float4 c0 = __ldg(reinterpret_cast<const float4*>(class_mat + (size_t)v * kNClasses));
  const float4 c1 = __ldg(reinterpret_cast<const float4*>(class_mat + (size_t)v * kNClasses) + 1);

  const int index = row_pos + pos_offset;  // this token's position
  const float g = noise != nullptr ? noise[((size_t)index * B + b) * vpad + v] : 0.f;

  // the grammar row: the current span's type from the lane that holds it,
  // the flag row from sid_tbl by shuffle
  const int si = min(span_idx, max_spans - 1);
  int type_l = 0;
#pragma unroll
  for (int j = 0; j < kSpanRegs; ++j)
    if (lane + 32 * j == si) type_l = type_r[j];
  int cur_type = __shfl_sync(kFull, type_l, si & 31);
  if (si >= 32 * kSpanRegs) cur_type = types[si];
  const bool is_start = steps == 1;
  const int flag_sid = __shfl_sync(kFull, sid_l, bits & 15);
  const int start_sid = 5 + cur_type;
  int sid;
  if (mode == 1)
    sid = is_start ? start_sid : flag_sid;
  else
    sid = bits > 0 ? flag_sid : (is_start ? start_sid : 0);
  const int row = nw * n_sid + sid;
  const float allowed = masks[(size_t)row * vpad + v];

  const int flags = (c0.x > 0.f) | (c0.y > 0.f) << 1 | (c0.z > 0.f) << 2 | (c0.w > 0.f) << 3 |
                    (c1.x > 0.f) << 4 | (c1.y > 0.f) << 5 | (c1.z > 0.f) << 6 |
                    (c1.w > 0.f) << 7;
  if (x != nullptr) {  // the next token's position is this one's + 1
    const float p_next = (float)(index + 1);
    for (int l = v; l < D; l += blockDim.x) pe_s[l] = pe_lane(l, p_next, neg_log_over_d);
  }

  // the launch before this one (the logits) has finished and its writes
  // are visible past here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float logit = __ldcg(logits + (size_t)b * vpad + v);
  const float masked = (allowed > 0.f ? logit : kNeg) / temperature;

  // log_softmax as jax.nn.log_softmax computes it: shift by the max, then
  // subtract the log of the sum of exponentials; the warps' partials are
  // combined in warp order by every thread alike
  float t = warp_max(masked);
  if (lane == 0) red_max[warp] = t;
  __syncthreads();
  t = red_max[0];
  for (int i = 1; i < n_warps; ++i) t = fmaxf(t, red_max[i]);
  const float shifted = masked - t;
  float s = warp_sum(expf(shifted));
  if (lane == 0) red_sum[warp] = s;
  __syncthreads();
  s = red_sum[0];
  for (int i = 1; i < n_warps; ++i) s += red_sum[i];
  float logp = shifted - logf(s);
  float score = logp;
  if (noise != nullptr) {
    if (use_nucleus) {
      // the probability mass strictly above this lane's, summed in index
      // order over the nonzero probabilities (a zero adds nothing)
      const float p = expf(logp);
      const unsigned nz = __ballot_sync(kFull, p > 0.f);
      if (p > 0.f) seg[warp * 32 + __popc(nz & ((1u << lane) - 1u))] = p;
      if (lane == 0) seg_n[warp] = __popc(nz);
      __syncthreads();
      float above = 0.f;
      for (int w = 0; w < n_warps; ++w) {
        const float* q = seg + w * 32;
        const int n = seg_n[w];
#pragma unroll 4
        for (int j = 0; j < n; ++j) above += q[j] > p ? q[j] : 0.f;
      }
      if (!(above < nucleus_p)) logp = kNeg;
    }
    score = logp + g;
  }

  // argmax, the lowest index on ties; the key carries the lane's flags
  float best = score;
  int key = v | flags << 16;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, best, o);
    const int ok = __shfl_down_sync(kFull, key, o);
    if (better(ov, ok, best, key)) {
      best = ov;
      key = ok;
    }
  }
  if (lane == 0) {
    arg_v[warp] = best;
    arg_k[warp] = key;
  }
  __syncthreads();
  // every warp finishes the argmax over the warps' winners itself
  best = lane < n_warps ? arg_v[lane] : -INFINITY;
  key = lane < n_warps ? arg_k[lane] : kIndexBits;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int ok = __shfl_xor_sync(kFull, key, o);
    if (better(ov, ok, best, key)) {
      best = ov;
      key = ok;
    }
  }
  const int sampled = key & kIndexBits;
  const int fl = key >> 16;

  const bool is_pitch = fl >> kClPitch & 1, is_dur = fl >> kClDur & 1;
  const bool is_sep = fl >> kClSep & 1, is_rest = fl >> kClRest & 1;
  const bool is_step = fl >> kClStep & 1, is_cont = fl >> kClCont & 1;
  const bool b_sep = bits & 8, b_cont = bits & 4, b_pitch = bits & 2, b_rest = bits & 1;
  bool n_sep, n_cont, n_pitch, n_rest;
  if (mode == 1) {
    n_sep = false;
    n_rest = false;
    n_cont = is_step ? true : ((is_pitch || is_dur) ? false : b_cont);
    n_pitch = is_pitch ? true : ((is_step || is_dur) ? false : b_pitch);
  } else {
    n_sep = is_sep ? true : ((is_cont || is_pitch) ? false : b_sep);
    n_cont = is_cont ? true : (is_pitch ? false : b_cont);
    n_pitch = is_pitch ? true : (is_dur ? false : b_pitch);
    n_rest = is_rest ? true : (is_dur ? false : b_rest);
  }
  int new_bits = n_sep * 8 + n_cont * 4 + n_pitch * 2 + n_rest;

  const bool control_done = cur_type != span_body && steps >= 2;
  // the cap counts the introducing m_0 (reference generation.py:542)
  const bool end_span = sampled == eos_index || steps >= span_cap || control_done;
  const int new_span_idx = end_span ? span_idx + 1 : span_idx;
  const bool now_done = done > 0 || new_span_idx >= n_spans;
  int next_tok = end_span ? mask_index : sampled;
  if (now_done) next_tok = 0;  // now_done covers done
  if (end_span || done > 0) new_bits = 0;

  if (v == 0) {
    // every thread of the block read the state column and pos[b] above,
    // before the barriers: thread 0 may overwrite them
    state[kToken * B + b] = next_tok;
    state[kBits * B + b] = new_bits;
    state[kSteps * B + b] = end_span ? 1 : steps + 1;
    state[kSpan * B + b] = new_span_idx;
    state[kDone * B + b] = now_done ? 1 : 0;
    state[kLen * B + b] = next_tok != 0 ? index + 2 : length;
    if (out != nullptr) out[(size_t)b * ld_out + index + 1] = next_tok;
    if (advance != 0) pos[b] = row_pos + advance;
  }
  if (x != nullptr)  // the next token's input row, embed_pe_kernel's at p + 1
    for (int l = v; l < D; l += blockDim.x)
      x[(size_t)b * D + l] = embed_lane(emb, next_tok, vpad, D, l, emb_scale, pe_s[l]);
}

}  // namespace

extern "C" {

// x (B, D) f32 <- emb[state[ST_TOKEN, b]] * emb_scale + PE(pos[b] + pos_offset)
int smer_embed_pe(int B, int D, const void* tokens, const void* emb, int vpad,
                  float emb_scale, const void* pos, int pos_offset, float neg_log_over_d,
                  void* x, void* stream) {
  embed_pe_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const __nv_bfloat16*>(emb),
      vpad, D, emb_scale, static_cast<const int*>(pos), pos_offset, neg_log_over_d,
      static_cast<float*>(x));
  return (int)cudaGetLastError();
}

// noise null = greedy; use_nucleus 0 = no nucleus rule; the state (6, B) is
// advanced in place; the token's position is pos[b] + pos_offset, and
// pos[b] grows by `advance` at the end; out null = no output row, else the
// next token goes to out[b * ld_out + position + 1]; x null = no input row,
// else x (B, D) f32 <- the next token's row at position + 1 (emb (vpad, D)
// bf16, as smer_embed_pe).  A programmatic dependent launch: it may begin
// while the launch before it on the stream runs, and only its
// griddepcontrol.wait makes that launch's writes visible.  So the caller
// keeps one rule: the launch just before it writes none of what the
// prologue reads (state, pos, aux, span_types, sid_tbl, masks, class_mat,
// noise, emb); the logits, read after the wait, it may write.
int smer_sample_advance(int B, int vpad, const void* logits, void* state,
                        const void* aux, const void* span_types,
                        const void* sid_tbl, const void* masks,
                        const void* class_mat, const void* noise, void* pos,
                        int pos_offset, int advance, void* out, int ld_out, int mode,
                        int max_spans, int span_cap, int eos_index, int mask_index,
                        int use_nucleus, float nucleus_p, float temperature,
                        int n_sid, int span_body, const void* emb, int D, float emb_scale,
                        float neg_log_over_d, void* x, void* stream) {
  if (vpad % 32 != 0 || vpad > 1024 || vpad < 32 || max_spans < 1)
    return (int)cudaErrorInvalidValue;
  if (x != nullptr && (emb == nullptr || D < 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = (vpad + (x != nullptr ? D : 0)) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(vpad);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, sample_advance_kernel, static_cast<const float*>(logits), static_cast<int*>(state),
      static_cast<const int*>(aux), static_cast<const int*>(span_types),
      static_cast<const int*>(sid_tbl), static_cast<const float*>(masks),
      static_cast<const float*>(class_mat), static_cast<const float*>(noise),
      static_cast<int*>(pos), pos_offset, advance, static_cast<int*>(out), ld_out, B,
      vpad, mode, max_spans, span_cap, eos_index, mask_index, use_nucleus, nucleus_p,
      temperature, n_sid, span_body, static_cast<const __nv_bfloat16*>(emb), D, emb_scale,
      neg_log_over_d, static_cast<float*>(x));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
