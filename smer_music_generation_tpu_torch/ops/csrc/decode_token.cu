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
// carry.  Here a token is 48 launches in stream order (embed_pe_kernel,
// 4 layers x 11 and the final LN and logits of decode_step.cu,
// sample_advance_kernel), captured once as a CUDA graph and replayed once
// a token (v3) or once a chunk of T_chunk tokens (v4; ops/decode_graph.py).
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
//     strictly above its own is < p: vpad x vpad multiply-adds over shared
//     memory); the Gumbel row `noise[p, b]` of the token's position p =
//     pos[b] + t (greedy reads none); an argmax that takes the lowest index
//     on ties, as jnp.argmax does; the class flags of the sampled token;
//     the bits, span end (eos, the span cap counting the introducing m_0, a
//     control span's one token), done, next token and length (p + 2) exactly
//     as the TPU kernel advances them.  A row that is done writes padding.
//     It writes the next state over the state it read (block b owns column
//     b, and every thread reads the column before thread 0 writes it, past
//     the block's barriers), the next token into the decoder's (B, L)
//     output at column p + 1 when it is given one, and advances pos[b] by
//     `advance` (1 for a v3 token, T_chunk at a chunk's last token, 0
//     before it).  Each block advances its own row's entry of `pos` after
//     its own reads, and every other reader of the position is an earlier
//     launch in stream order, so no ticket and no extra launch is needed;
//     this is why the position is a (B,) vector and not one word.
//
// What bounds them on an NVIDIA H100 80GB HBM3 (3.35 TB/s at 700 W): bytes,
// a few KB a token: embed_pe_kernel reads B embedding rows (1 KB each at
// d512) and writes B f32 rows; sample_advance_kernel reads B logit rows,
// grammar mask rows and (nucleus) noise rows of vpad f32 (1.5 KB each) and
// writes 7 words a row.  Under 0.01 us of HBM time each: the launch (a few
// us) sets their time, and so what this design does about it is to make
// them, and the 46 launches between them, replayable as one graph.  The
// whole token is bound by the bytes of the v2 step (the decoder weights,
// the valid cache rows).
//
// In a v4 chunk the QKV launch of token t writes its K|V row into the
// chunk output `new_kv` (nl, T_chunk, B, 2D), the self-attention reads the
// cache rows below pos (which stays at the chunk's base until the chunk's
// last token) and the chunk rows before t (decode_step.cu).  It is bound
// by bytes as v3 is, the weights read once a token.
//
// There is no grid-wide synchronisation, no cooperative launch and no
// spin-wait.  Every launcher has a plain C interface and returns
// cudaGetLastError().

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

__global__ void __launch_bounds__(256) embed_pe_kernel(
    const int* __restrict__ tokens, const __nv_bfloat16* __restrict__ emb,
    int vpad, int D, float emb_scale, const int* __restrict__ pos, int pos_offset,
    float neg_log_over_d, float* __restrict__ x) {
  const int b = blockIdx.x;
  const int tok = tokens[b];
  const bool valid = tok >= 0 && tok < vpad;
  const float p = (float)(pos[b] + pos_offset);
  for (int l = threadIdx.x; l < D; l += blockDim.x) {
    const float e = valid ? __bfloat162float(emb[(size_t)tok * D + l]) : 0.f;
    const float freq = expf(__fmul_rn((float)(l - (l & 1)), neg_log_over_d));
    const float angle = __fmul_rn(p, freq);
    const float pe = (l & 1) ? cosf(angle) : sinf(angle);
    // rows * sqrt(D) + pe as two rounded steps, as the reference computes it
    x[(size_t)b * D + l] = __fadd_rn(__fmul_rn(e, emb_scale), pe);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max or sum; every thread gets the result.  The warps' partial
// results are combined in warp order by every thread alike.
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = scratch[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
    t = MAX ? fmaxf(t, scratch[i]) : t + scratch[i];
  __syncthreads();  // scratch is reused by the next call
  return t;
}

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// One block per batch row, one thread per padded vocab lane (blockDim.x ==
// vpad, a multiple of 32 and at most 1024).  `state` is read and written in
// place, and `pos` too: neither is __restrict__.
__global__ void sample_advance_kernel(
    const float* __restrict__ logits, int* state,
    const int* __restrict__ aux, const int* __restrict__ span_types,
    const int* __restrict__ sid_tbl, const float* __restrict__ masks,
    const float* __restrict__ class_mat, const float* __restrict__ noise,
    int* pos, int pos_offset, int advance, int* __restrict__ out, int ld_out, int B,
    int vpad, int mode, int max_spans, int span_cap, int eos_index, int mask_index,
    int use_nucleus, float nucleus_p, float temperature, int n_sid,
    int span_body) {
  extern __shared__ float probs[];  // (vpad,)
  __shared__ float scratch[kMaxWarps];
  __shared__ float arg_v[kMaxWarps];
  __shared__ int arg_i[kMaxWarps];

  const int b = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;

  const int row_pos = pos[b];
  const int index = row_pos + pos_offset;  // this token's position
  const int bits = state[kBits * B + b];
  const int steps = state[kSteps * B + b];
  const int span_idx = state[kSpan * B + b];
  const int done = state[kDone * B + b];
  const int length = state[kLen * B + b];
  const int n_spans = aux[kNSpans * B + b];
  const int nw = aux[kNoWhole * B + b];

  const int cur_type = span_types[(size_t)b * max_spans + min(span_idx, max_spans - 1)];
  const bool is_start = steps == 1;
  const int flag_sid = sid_tbl[bits & 15];
  const int start_sid = 5 + cur_type;
  int sid;
  if (mode == 1)
    sid = is_start ? start_sid : flag_sid;
  else
    sid = bits > 0 ? flag_sid : (is_start ? start_sid : 0);
  const int row = nw * n_sid + sid;

  const float allowed = masks[(size_t)row * vpad + v];
  const float masked = (allowed > 0.f ? logits[(size_t)b * vpad + v] : kNeg) / temperature;
  // log_softmax as jax.nn.log_softmax computes it: shift by the max, then
  // subtract the log of the sum of exponentials
  const float shifted = masked - block_reduce<true>(masked, scratch);
  float logp = shifted - logf(block_reduce<false>(expf(shifted), scratch));
  float score = logp;
  if (noise != nullptr) {
    if (use_nucleus) {
      const float p = expf(logp);
      probs[v] = p;
      __syncthreads();
      float above = 0.f;  // probability mass strictly above this lane's
      for (int u = 0; u < vpad; ++u) {
        const float q = probs[u];
        above += q > p ? q : 0.f;
      }
      if (!(above < nucleus_p)) logp = kNeg;
    }
    score = logp + noise[((size_t)index * B + b) * vpad + v];
  }

  // argmax, the lowest index on ties
  float best = score;
  int best_i = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, o);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    arg_v[warp] = best;
    arg_i[warp] = best_i;
  }
  __syncthreads();
  if (v != 0) return;
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
    if (better(arg_v[i], arg_i[i], best, best_i)) {
      best = arg_v[i];
      best_i = arg_i[i];
    }
  const int sampled = best_i;

  const float* fl = class_mat + (size_t)sampled * kNClasses;
  const bool is_pitch = fl[kClPitch] > 0.f, is_dur = fl[kClDur] > 0.f;
  const bool is_sep = fl[kClSep] > 0.f, is_rest = fl[kClRest] > 0.f;
  const bool is_step = fl[kClStep] > 0.f, is_cont = fl[kClCont] > 0.f;
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

  // every thread of the block read the state column and pos[b] above,
  // before the barriers of the reductions: thread 0 may overwrite them
  state[kToken * B + b] = next_tok;
  state[kBits * B + b] = new_bits;
  state[kSteps * B + b] = end_span ? 1 : steps + 1;
  state[kSpan * B + b] = new_span_idx;
  state[kDone * B + b] = now_done ? 1 : 0;
  state[kLen * B + b] = next_tok != 0 ? index + 2 : length;
  if (out != nullptr) out[(size_t)b * ld_out + index + 1] = next_tok;
  if (advance != 0) pos[b] = row_pos + advance;
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
// next token goes to out[b * ld_out + position + 1]
int smer_sample_advance(int B, int vpad, const void* logits, void* state,
                        const void* aux, const void* span_types,
                        const void* sid_tbl, const void* masks,
                        const void* class_mat, const void* noise, void* pos,
                        int pos_offset, int advance, void* out, int ld_out, int mode,
                        int max_spans, int span_cap, int eos_index, int mask_index,
                        int use_nucleus, float nucleus_p, float temperature,
                        int n_sid, int span_body, void* stream) {
  if (vpad % 32 != 0 || vpad > 1024 || vpad < 32) return (int)cudaErrorInvalidValue;
  sample_advance_kernel<<<B, vpad, vpad * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(state),
      static_cast<const int*>(aux), static_cast<const int*>(span_types),
      static_cast<const int*>(sid_tbl), static_cast<const float*>(masks),
      static_cast<const float*>(class_mat), static_cast<const float*>(noise),
      static_cast<int*>(pos), pos_offset, advance, static_cast<int*>(out), ld_out, B,
      vpad, mode, max_spans, span_cap, eos_index, mask_index, use_nucleus, nucleus_p,
      temperature, n_sid, span_body);
  return (int)cudaGetLastError();
}

}  // extern "C"
