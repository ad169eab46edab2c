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
//     (in the model's compute dtype, bf16 or f32; a template of it, as the
//     sampler is), scales it by sqrt(D) and adds the analytic sinusoidal
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

// The embedding is in the model's compute dtype: bf16 or f32
__device__ __forceinline__ float emb_value(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float emb_value(const float* p) { return *p; }

template <typename T>
__device__ __forceinline__ float embed_lane(const T* __restrict__ emb, int tok,
                                            int vpad, int D, int l, float emb_scale, float pe) {
  const bool valid = tok >= 0 && tok < vpad;
  const float e = valid ? emb_value(emb + (size_t)tok * D + l) : 0.f;
  return __fadd_rn(__fmul_rn(e, emb_scale), pe);
}

template <typename T>
__global__ void __launch_bounds__(256) embed_pe_kernel(
    const int* __restrict__ tokens, const T* __restrict__ emb,
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

// The grammar row's state id (JAX `allowed_mask_fast`): with
// `start_overrides` (REMI, mode 1) a span's first step takes the span
// type's start row; otherwise the flag row wins whenever a flag is set
__device__ __forceinline__ int grammar_sid(int mode, int bits, bool is_start, int cur_type,
                                           int flag_sid) {
  const int start_sid = 5 + cur_type;
  if (mode == 1) return is_start ? start_sid : flag_sid;
  return bits > 0 ? flag_sid : (is_start ? start_sid : 0);
}

// The nucleus rule's compaction: chunk c's (32 lanes') nonzero
// probabilities into seg[32 c ...] in lane order, by a ballot, and their
// count into seg_n[c].  A zero probability (a masked lane) adds nothing to
// any lane's mass above, so it is left out.
__device__ __forceinline__ unsigned compact_nonzero(float p, int c, int lane, float* seg,
                                                    int* seg_n) {
  const unsigned nz = __ballot_sync(kFull, p > 0.f);
  if (p > 0.f) seg[32 * c + __popc(nz & ((1u << lane) - 1u))] = p;
  if (lane == 0) seg_n[c] = __popc(nz);
  return nz;
}

// The probability mass strictly above each of N probabilities p[i]: the
// compacted nonzero probabilities summed in chunk order, and in lane order
// within a chunk, one pass over them for all N at once; each p[i] sums the
// same sequence in the same order, so its bits do not depend on N
template <int N>
__device__ __forceinline__ void above_mass(const float* seg, const int* seg_n, int n_chunks,
                                           const float (&p)[N], float (&above)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) above[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float* q = seg + 32 * c;
    const int n = seg_n[c];
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float t = q[j];
#pragma unroll
      for (int i = 0; i < N; ++i) above[i] += t > p[i] ? t : 0.f;
    }
  }
}

// (a, key a) before (b, key b): the larger score, the lower index on ties
__device__ __forceinline__ bool better(float a, int ka, float b, int kb) {
  return a > b || (a == b && (ka & kIndexBits) < (kb & kIndexBits));
}

// One block per batch row, one thread per padded vocab lane (blockDim.x ==
// vpad, a multiple of 32 and at most 1024); T, the embedding's dtype.
// `state` is read and written in place, and `pos` too: neither is
// __restrict__.  The logits are written
// by the launch this one may overlap (a programmatic dependent launch):
// they are read after griddepcontrol.wait, through L2 (ld.global.cg).
template <typename T>
__global__ void __launch_bounds__(1024) sample_advance_kernel(
    const float* logits, int* state,
    const int* __restrict__ aux, const int* __restrict__ span_types,
    const int* __restrict__ sid_tbl, const float* __restrict__ masks,
    const float* __restrict__ class_mat, const float* __restrict__ noise,
    int* pos, int pos_offset, int advance, int* __restrict__ out, int ld_out, int B,
    int vpad, int mode, int max_spans, int span_cap, int eos_index, int mask_index,
    int use_nucleus, float nucleus_p, float temperature, int n_sid,
    int span_body, const T* __restrict__ emb, int D, float emb_scale,
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
  const int flag_sid = __shfl_sync(kFull, sid_l, bits & 15);
  const int row = nw * n_sid + grammar_sid(mode, bits, steps == 1, cur_type, flag_sid);
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
      const float p[1] = {expf(logp)};
      compact_nonzero(p[0], warp, lane, seg, seg_n);
      __syncthreads();
      float above[1];
      above_mass<1>(seg, seg_n, n_warps, p, above);
      if (!(above[0] < nucleus_p)) logp = kNeg;
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

// ---------------------------------------------------------------------------
// spec_advance_kernel: everything speculative decode does after its verify,
// for one sequence, in one block.
//
// Replaces the body of JAX's `_decode_v5` after the verify
// (smer_music_generation_tpu/infer/decode.py:539-651; the single-token tail
// :660-698 is the same kernel at W = 1 with no draft) and the draft lookup
// `build_draft` (:509-534), which on the TPU run as XLA ops inside one
// device-side `lax.while_loop`.  Here an iteration is one CUDA-graph replay
// (ops/decode_graph.py SpecGraph): the W-row verify's launches
// (decode_step.cu, the position read from the carry as `lens`), this
// kernel, and the verify's K|V rows copied into the cache at `kv_rows`.
//
// One block of kSpecThreads threads.  From the carry (pos, done, grammar
// bits, steps in span, span index, length) and the window the iteration
// verified ([out[pos], draft]), with K = W - 1:
//   * the assumed-emission chain: slot i samples under the state reached
//     if slots < i emitted their window tokens (an emitted m_0 ends a
//     span), by the next_bits table; each warp walks it to its own slot
//     over the 16 x (W - 1) transitions the window can take (next_bits[s]
//     [window[j]] for every state s, loaded in parallel into shared memory
//     as bytes), so no barrier stands between the chain and the slots;
//   * a warp a slot (slots past kSpecWarps loop): the slot's grammar row
//     (`grammar_sid`, sample_advance_kernel's own), greedy argmax of the
//     masked logits, or the masked log-softmax over the temperature (the
//     warp's chunks of 32 lanes summed in sample_advance_kernel's order:
//     a chunk's xor tree, then the chunks in lane order), the nucleus rule
//     (`compact_nonzero` and `above_mass`, sample_advance_kernel's own
//     functions, so a lane's mass above sums the same sequence in the same
//     order), then, in a slot with a draft, the delta-draft acceptance
//     u < P(draft) over the kept support and else the argmax of the
//     residual plus the Gumbel row (JAX `spec_accept_resample`); slot K
//     (no draft) the argmax of log-probabilities plus the Gumbel row;
//   * each slot's span end, done flag and next token; then warp 0 alone:
//     the emitted prefix by a ballot (slot i emits iff every slot before
//     it emitted its window token and did not finish the session), its
//     W-slot write into `out`, the length, and the carry of the last
//     emitted slot;
//   * the next draft (JAX `build_draft`: the continuation of the latest
//     match of the bigram (out[P - 1], out[P]) in the emitted stream,
//     ending at 1..P-1, else in the source, never at a padding id, else
//     zeros) as an O(1) lookup in two device tables of "the latest j at
//     which each bigram ends", `draft_tbl` (2, vpad, vpad) int32, -1 where
//     none: [1] the source's, built once a decode by `prime`; [0] the
//     emitted stream's, which `prime` fills up to pos - 1 and every
//     sampling iteration extends by the bigrams ending at pos .. P - 1
//     (atomicMax: the latest wins), so it never holds the bigram ending at
//     P itself.  The lookup reads the entry before this iteration's inserts
//     and takes the max with the inserts of the same bigram, warp-reduced,
//     so it needs no ordering of the atomics inside the launch.  The next
//     window and its W input rows x = emb[tok] * sqrt(D) + pos_table[pos +
//     j] in f32, rounded to bf16 when the model computes in bf16 and left
//     in f32 for an f32 model (`round_bf16` 0; the PE
//     table's rows, as JAX's verify reads them, not the analytic row of
//     embed_pe_kernel).
// An iteration whose carry is done, or whose window no longer fits
// (pos + W >= L), samples nothing and changes nothing: it writes the same
// window, x and kv_rows again and inserts nothing, so a host that reads the
// carry back only now and then may replay past the end.  `prime` (the first
// window of a decode, after the host has set the tables to -1) builds the
// tables and changes nothing else.
//
// What bounds it on an NVIDIA H100 80GB HBM3 (3.35 TB/s at 700 W): bytes,
// about 50 KB at the flagship's served case (W x vpad logits, mask and
// noise rows, the transitions, two table entries, W embedding and PE rows
// read; W x D x rows written), ~0.015 us of HBM time; its time is a chain
// of dependent steps.  So the chain is kept short and mostly hidden: it is
// a programmatic dependent launch behind the logits' rowvec_kernel, and
// before `griddepcontrol.wait` it loads what no launch of the iteration
// writes (carry, window, transitions, span types, tables), walks each
// slot's chain and issues each first-round slot's mask and noise loads;
// after the wait a warp reads its slot's logits through L2 and no block
// barrier stands between a slot's loads and its token.  Three block
// barriers in all: the staged transitions, the slots' tokens, the next
// window.  No sampling iteration's work grows with L + S (only the
// prime's, once a decode).
//
// carry rows (ops/decode_step.py SPEC_*)
constexpr int kSPos = 0, kSDone = 1, kSBits = 2, kSSteps = 3, kSSpan = 4, kSLen = 5;
constexpr int kSpecThreads = 512;
constexpr int kSpecWarps = kSpecThreads / 32;
constexpr int kSlotArrays = 7;  // the W-long int arrays in shared memory

struct SpecArgs {
  const float* logits;    // (W, vpad): the verify's, written by the launch before this one
  int* carry;             // (8,)
  int* out;               // (L,)
  int* window;            // (W,): read, then the next window written
  float* x;               // (W, D): the next window's input rows
  long long* kv_rows;     // (W,): the cache rows of this iteration's verify, pos + j
  const int* aux;         // (2,): n_spans, no_whole
  const int* span_types;  // (max_spans,)
  const int* sid_tbl;     // (16,)
  const float* masks;     // (2 n_sid, vpad), 1 = allowed
  const int* next_bits;   // (16, vpad)
  const float* noise;     // (L, vpad) Gumbel rows, or null (greedy)
  const float* uniforms;  // (L,) acceptance draws, or null (greedy)
  const int* src;         // (S,)
  const float* emb;       // (V, D) f32
  const float* pos_table; // (max_len, D) f32
  int* draft_tbl;         // (2, vpad, vpad): the latest j each bigram ends at, -1 if none
  int W, L, S, V, D, vpad, max_len, max_spans, n_sid, mode, span_cap, eos_index, mask_index;
  int span_body, greedy, use_nucleus, round_bf16, prime;
  float nucleus_p, temperature, emb_scale;
};

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the warp's argmax over (score, index) pairs, the lowest index on ties
__device__ __forceinline__ int warp_argmax(float best, int idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > best || (ov == best && oi < idx)) {
      best = ov;
      idx = oi;
    }
  }
  return idx;
}

// One slot's token, by its warp: lane l holds vocab lanes l + 32 i.
template <int VPL>
__device__ __forceinline__ int spec_slot_token(const SpecArgs& a, int j, int K, unsigned allow,
                               const float (&g)[VPL], float u, int draft, float* seg, int lane) {
  const float* lrow = a.logits + (size_t)j * a.vpad;
  float lg[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) lg[i] = __ldcg(lrow + lane + 32 * i);
  float best = -INFINITY;
  int bi = 0x7fffffff;
  if (a.greedy) {  // JAX greedy_sample: argmax of where(allowed, logits, -1e9)
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float s = (allow >> i & 1u) ? lg[i] : kNeg;
      if (s > best) {
        best = s;
        bi = lane + 32 * i;
      }
    }
    return warp_argmax(best, bi);
  }
  float logp[VPL];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    logp[i] = ((allow >> i & 1u) ? lg[i] : kNeg) / a.temperature;
    mx = fmaxf(mx, logp[i]);
  }
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    logp[i] -= mx;
    s += warp_sum(expf(logp[i]));
  }
  const float ls = logf(s);
#pragma unroll
  for (int i = 0; i < VPL; ++i) logp[i] -= ls;
  if (a.use_nucleus) {
    // The mass above is needed for the nonzero probabilities only (~a
    // quarter of the lanes): they are compacted into one list, chunk after
    // chunk of 32 lanes and in lane order within a chunk (the sequence and
    // order above_mass sums), then spread over the lanes as items f of the
    // list, four a lane a pass, each lane summing the whole list once for
    // its items, and the mass above 0 (what a zero probability's lane gets)
    // beside them.  A lane's bits are those of a pass over every lane's own
    // value; the flat list spares the per-chunk loops.
    float p[VPL];
    unsigned nz[VPL];
    int off[VPL];
    int n = 0;
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      p[i] = expf(logp[i]);
      nz[i] = __ballot_sync(kFull, p[i] > 0.f);
      off[i] = n;
      if (p[i] > 0.f) seg[n + __popc(nz[i] & lt)] = p[i];
      n += __popc(nz[i]);
    }
    __syncwarp();
    float* abv = seg + a.vpad;  // each item's mass above
    float total = 0.f;
    for (int f0 = 0; f0 < n; f0 += 4 * 32) {
      float q[4], ab[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = f0 + 32 * k + lane;
        q[k] = f < n ? seg[f] : INFINITY;  // nothing is above +inf
      }
      total = 0.f;
#pragma unroll 4
      for (int f = 0; f < n; ++f) {
        const float t = seg[f];
#pragma unroll
        for (int k = 0; k < 4; ++k) ab[k] += t > q[k] ? t : 0.f;
        total += t;  // above_mass's t > 0 ? t : 0 on a nonzero t
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (f0 + 32 * k + lane < n) abv[f0 + 32 * k + lane] = ab[k];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float above = p[i] > 0.f ? abv[off[i] + __popc(nz[i] & lt)] : total;
      if (!(above < a.nucleus_p)) logp[i] = kNeg;
    }
    __syncwarp();  // the warp's next slot reuses seg
  }
  int excl = -1;  // the lane the residual leaves out: the draft's
  if (j < K) {
    // delta-draft speculative sampling: accept the draft with its
    // probability under the kept support, renormalised
    const int d = max(draft, 0);
    float norm = 0.f, mine = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      norm += logp[i] > kNeg / 2 ? expf(logp[i]) : 0.f;
      if (i == (d >> 5)) mine = logp[i];
    }
    norm = warp_sum(norm);
    const float p_draft = expf(__shfl_sync(kFull, mine, d & 31)) / fmaxf(norm, 1e-38f);
    if (u < p_draft) return d;
    excl = d;
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    const float sc = (v == excl ? kNeg : logp[i]) + g[i];
    if (sc > best) {
      best = sc;
      bi = v;
    }
  }
  return warp_argmax(best, bi);
}

// the emitted stream's token at position i, once this iteration's W-slot
// write is decided: the slots' tokens in (pos, pos + W] (0 past the prefix),
// else the stream as the launch found it (positions it does not write)
__device__ __forceinline__ int stream_at(const SpecArgs& a, const int* nt_s, bool active, int pos,
                                         int m, int i) {
  if (active && i > pos && i <= pos + a.W) return i - pos - 1 < m ? nt_s[i - pos - 1] : 0;
  return a.out[i];
}

// the table entry of bigram (x, y), or -1 when either token is outside the table
__device__ __forceinline__ int bigram_at(int vpad, int x, int y) {
  return (unsigned)x < (unsigned)vpad && (unsigned)y < (unsigned)vpad ? x * vpad + y : -1;
}

template <int VPL>
__global__ void __launch_bounds__(kSpecThreads) spec_advance_kernel(const SpecArgs a) {
  extern __shared__ int sm[];
  const int W = a.W, K = W - 1;
  int* win_s = sm;                  // the window verified
  int* nt_s = sm + W;               // each slot's next token
  int* nd_s = sm + 2 * W;           // now done
  int* bpost_s = sm + 3 * W;        // bits after the slot
  int* spost_s = sm + 4 * W;        // steps after the slot
  int* npost_s = sm + 5 * W;        // span after the slot
  int* wn_s = sm + 6 * W;           // the next window
  unsigned char* tr_s = reinterpret_cast<unsigned char*>(sm + kSlotArrays * W);  // (W, 16)
  float* seg_all = reinterpret_cast<float*>(sm + kSlotArrays * W + 4 * W);  // a warp's 2 vpad
  __shared__ int sid_s[16];
  __shared__ int p_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* tbl_out = a.draft_tbl;
  const int* tbl_src = a.draft_tbl + (size_t)a.vpad * a.vpad;
  // every load that depends on nothing this iteration's other launches write
  const int pos = a.carry[kSPos];
  const int done = a.carry[kSDone];
  const bool active = !a.prime && done == 0 && pos + W < a.L;
  for (int i = tid; i < W; i += kSpecThreads) win_s[i] = a.window[i];
  if (active) {
    // transitions[j][s] = next_bits[s][window[j]], the chain's every step from every state
    for (int i = tid; i < 16 * W; i += kSpecThreads) {
      const int j = i >> 4, st = i & 15;
      tr_s[i] = j > 0 ? static_cast<unsigned char>(a.next_bits[st * a.vpad + a.window[j]]) : 0;
    }
    if (tid < 16) sid_s[tid] = a.sid_tbl[tid];
  }
  if (a.prime) {
    // the tables of a new decode (the host set them to -1): the source's
    // bigrams ending at 1..S-1 (never at a padding id) and the stream's
    // ending at 1..pos-1
    int* tsrc = a.draft_tbl + (size_t)a.vpad * a.vpad;
    for (int j = 1 + tid; j < a.S; j += kSpecThreads) {
      const int e = bigram_at(a.vpad, a.src[j - 1], a.src[j]);
      if (a.src[j] != 0 && e >= 0) atomicMax(tsrc + e, j);
    }
    for (int j = 1 + tid; j <= pos - 1; j += kSpecThreads) {
      const int e = bigram_at(a.vpad, a.out[j - 1], a.out[j]);
      if (e >= 0) atomicMax(tbl_out + e, j);
    }
    __threadfence();
  }
  __syncthreads();

  float* seg = seg_all + 2 * warp * a.vpad;
  unsigned allow = 0;
  float g[VPL];
  float u = 0.f;
  int st = 0, stp = 0, sn = 0, type = 0;
  // slot j's chain (lane 0 walks it from the carry over the staged
  // transitions, then the warp shares it), grammar row, noise and uniform
  auto load_slot = [&](int j) {
    if (lane == 0) {
      st = a.carry[kSBits];
      stp = a.carry[kSSteps];
      sn = a.carry[kSSpan];
      for (int i = 1; i <= j; ++i) {
        const bool ended = win_s[i] == a.mask_index;
        st = ended ? 0 : tr_s[16 * i + st];
        stp = ended ? 1 : stp + 1;
        sn += ended;
      }
    }
    st = __shfl_sync(kFull, st, 0);
    stp = __shfl_sync(kFull, stp, 0);
    sn = __shfl_sync(kFull, sn, 0);
    type = a.span_types[min(sn, a.max_spans - 1)];
    const int sid = grammar_sid(a.mode, st, stp == 1, type, sid_s[st & 15]);
    const float* mrow = a.masks + (size_t)(a.aux[1] * a.n_sid + sid) * a.vpad;
    allow = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) allow |= (mrow[lane + 32 * i] > 0.f ? 1u : 0u) << i;
    if (a.noise != nullptr) {
      const float* grow = a.noise + (size_t)(pos + j) * a.vpad;
#pragma unroll
      for (int i = 0; i < VPL; ++i) g[i] = grow[lane + 32 * i];
      u = a.uniforms[pos + j];
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) g[i] = 0.f;
    }
  };
  if (active && warp < W) load_slot(warp);

  // the logits' launch has finished and its writes are visible past here;
  // nothing is written to global memory before it (that launch reads x)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (active) {
    for (int j = warp; j < W; j += kSpecWarps) {
      if (j != warp) load_slot(j);
      const int tok = spec_slot_token<VPL>(a, j, K, allow, g, u, j < K ? win_s[j + 1] : 0, seg,
                                           lane);
      if (lane == 0) {  // the plain loop's bookkeeping for the slot
        const bool control_done = type != a.span_body && stp >= 2;
        // the cap counts the introducing m_0 (reference generation.py:542)
        const bool end_span = tok == a.eos_index || stp >= a.span_cap || control_done;
        const int new_span = end_span ? sn + 1 : sn;
        const bool now_done = new_span >= a.aux[0];
        nt_s[j] = now_done ? 0 : (end_span ? a.mask_index : tok);
        nd_s[j] = now_done;
        bpost_s[j] = end_span ? 0 : a.next_bits[st * a.vpad + tok];
        spost_s[j] = end_span ? 1 : stp + 1;
        npost_s[j] = new_span;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the emitted prefix: slots 0 .. m - 1, m - 1 the first slot whose
    // token is not its window token or that finished the session
    int m = 0;
    if (active) {
      m = W;
      for (int base = 0; base < K; base += 32) {
        const int j = base + lane;
        const unsigned ok = __ballot_sync(kFull, j < K && nt_s[j] == win_s[j + 1] && !nd_s[j]);
        if (ok != kFull) {
          m = base + __ffs(~ok);
          break;
        }
      }
      int len = a.carry[kSLen];
      for (int j = lane; j < m; j += 32)
        if (nt_s[j] != 0) len = max(len, pos + j + 2);
      len = warp_max_int(len);
      for (int j = lane; j < W; j += 32) a.out[pos + 1 + j] = j < m ? nt_s[j] : 0;
      if (lane == 0) {
        const int last = m - 1;
        a.carry[kSPos] = pos + m;
        a.carry[kSDone] = nd_s[last];
        a.carry[kSBits] = bpost_s[last];
        a.carry[kSSteps] = spost_s[last];
        a.carry[kSSpan] = npost_s[last];
        a.carry[kSLen] = len;
      }
    }
    for (int j = lane; j < W; j += 32) a.kv_rows[j] = pos + j;
    const int P = pos + m;  // the next window's position
    auto at = [&](int i) { return stream_at(a, nt_s, active, pos, m, i); };
    if (K > 0) {
      // the latest match of the bigram ending at P: the table's entry from
      // before this iteration, or one of the bigrams ending at pos .. P - 1
      // that this iteration inserts (all later than any entry before it)
      const int e = bigram_at(a.vpad, at(max(P - 1, 0)), at(P));
      int jo = -1;
      for (int j = pos + lane; j < P; j += 32) {
        if (j < 1) continue;
        const int ej = bigram_at(a.vpad, at(j - 1), at(j));
        if (ej >= 0 && ej == e) jo = max(jo, j);
      }
      jo = warp_max_int(max(jo, e >= 0 ? __ldcg(tbl_out + e) : -1));
      const int js = e >= 0 ? __ldcg(tbl_src + e) : -1;
      for (int i = lane; i < K; i += 32) {
        int t = 0;
        if (jo >= 0)
          t = at(max(min(jo + 1, a.L - K), 0) + i);
        else if (js >= 0)
          t = a.src[max(min(js + 1, a.S - K), 0) + i];
        wn_s[1 + i] = t;
      }
    }
    // the bigrams ending at pos .. P - 1 join the stream's table (after
    // every lane has read the entry above)
    __syncwarp();
    for (int j = pos + lane; j < P; j += 32) {
      if (j < 1) continue;
      const int ej = bigram_at(a.vpad, at(j - 1), at(j));
      if (ej >= 0) atomicMax(tbl_out + ej, j);
    }
    if (lane == 0) {
      wn_s[0] = at(P);
      p_s = P;
    }
  }
  __syncthreads();
  const int P = p_s;
  for (int j = tid; j < W; j += kSpecThreads) a.window[j] = wn_s[j];
  // the next window's input rows, four lanes of a row at a time
  const int D4 = a.D / 4;
  for (int e = tid; e < W * D4; e += kSpecThreads) {
    const int j = e / D4, l = 4 * (e - j * D4);
    const int tok = wn_s[j];
    const int p = min(P + j, a.max_len - 1);  // past the table only where no window fits
    const float4 ev = tok >= 0 && tok < a.V ? *reinterpret_cast<const float4*>(a.emb + (size_t)tok * a.D + l)
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 pe = *reinterpret_cast<const float4*>(a.pos_table + (size_t)p * a.D + l);
    float4 v = make_float4(__fadd_rn(__fmul_rn(ev.x, a.emb_scale), pe.x),
                           __fadd_rn(__fmul_rn(ev.y, a.emb_scale), pe.y),
                           __fadd_rn(__fmul_rn(ev.z, a.emb_scale), pe.z),
                           __fadd_rn(__fmul_rn(ev.w, a.emb_scale), pe.w));
    if (a.round_bf16) {
      v.x = __bfloat162float(__float2bfloat16_rn(v.x));
      v.y = __bfloat162float(__float2bfloat16_rn(v.y));
      v.z = __bfloat162float(__float2bfloat16_rn(v.z));
      v.w = __bfloat162float(__float2bfloat16_rn(v.w));
    }
    *reinterpret_cast<float4*>(a.x + (size_t)j * a.D + l) = v;
  }
}

// dynamic shared memory of spec_advance_kernel: the W-long arrays, the
// transitions (16 bytes a slot) and each warp's nucleus scratch
__host__ __forceinline__ size_t spec_smem(int W, int vpad) {
  return sizeof(int) * ((size_t)kSlotArrays * W + 4 * (size_t)W + 2 * (size_t)kSpecWarps * vpad);
}

template <int VPL>
int launch_spec_advance(const SpecArgs& a, int pdl, cudaStream_t st) {
  const size_t smem = spec_smem(a.W, a.vpad);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // set on every launch: the attribute is per device, and decoders may run on several
  const cudaError_t e = cudaFuncSetAttribute(
      spec_advance_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kSpecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, spec_advance_kernel<VPL>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D) f32 <- emb[state[ST_TOKEN, b]] * emb_scale + PE(pos[b] + pos_offset);
// emb (vpad, D) f32 when emb_f32 (an f32 model), else bf16
int smer_embed_pe(int B, int D, const void* tokens, const void* emb, int emb_f32, int vpad,
                  float emb_scale, const void* pos, int pos_offset, float neg_log_over_d,
                  void* x, void* stream) {
#define SMER_EMBED_PE(T)                                                                  \
  embed_pe_kernel<T><<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(                   \
      static_cast<const int*>(tokens), static_cast<const T*>(emb), vpad, D, emb_scale,     \
      static_cast<const int*>(pos), pos_offset, neg_log_over_d, static_cast<float*>(x))
  if (emb_f32)
    SMER_EMBED_PE(float);
  else
    SMER_EMBED_PE(__nv_bfloat16);
#undef SMER_EMBED_PE
  return (int)cudaGetLastError();
}

// noise null = greedy; use_nucleus 0 = no nucleus rule; the state (6, B) is
// advanced in place; the token's position is pos[b] + pos_offset, and
// pos[b] grows by `advance` at the end; out null = no output row, else the
// next token goes to out[b * ld_out + position + 1]; x null = no input row,
// else x (B, D) f32 <- the next token's row at position + 1 (emb (vpad, D)
// f32 when emb_f32, else bf16, as smer_embed_pe).  A programmatic
// dependent launch: it may begin while the launch before it on the stream
// runs, and only its
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
                        int n_sid, int span_body, const void* emb, int emb_f32, int D,
                        float emb_scale, float neg_log_over_d, void* x, void* stream) {
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
#define SMER_SAMPLE_ADVANCE(T)                                                                    \
  cudaLaunchKernelEx(                                                                              \
      &cfg, sample_advance_kernel<T>, static_cast<const float*>(logits), static_cast<int*>(state), \
      static_cast<const int*>(aux), static_cast<const int*>(span_types),                          \
      static_cast<const int*>(sid_tbl), static_cast<const float*>(masks),                         \
      static_cast<const float*>(class_mat), static_cast<const float*>(noise),                     \
      static_cast<int*>(pos), pos_offset, advance, static_cast<int*>(out), ld_out, B, vpad, mode,  \
      max_spans, span_cap, eos_index, mask_index, use_nucleus, nucleus_p, temperature, n_sid,     \
      span_body, static_cast<const T*>(emb), D, emb_scale, neg_log_over_d, static_cast<float*>(x))
  const cudaError_t err =
      emb_f32 ? SMER_SAMPLE_ADVANCE(float) : SMER_SAMPLE_ADVANCE(__nv_bfloat16);
#undef SMER_SAMPLE_ADVANCE
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Speculative decode's iteration after its verify (spec_advance_kernel),
// one block.  logits (W, vpad) f32 (null with prime); carry (8,) int32,
// out (L,) int32 and window (W,) int32 updated in place; x (W, D) f32 and
// kv_rows (W,) int64 written; aux (2,), span_types (max_spans,), sid_tbl
// (16,), next_bits (16, vpad) int32, masks (2 n_sid, vpad) f32, src (S,)
// int32, emb (V, D) f32, pos_table (max_len, D) f32, D a multiple of 4;
// draft_tbl (2, vpad, vpad) int32, the draft's bigram tables (set to -1 by
// the host before a decode's prime, kept by the kernel after it); noise
// (L, vpad) and uniforms (L,) f32, both null when greedy.  Token ids lie in
// [0, vpad).  vpad a multiple of 128 up to 512.  pdl 1: a programmatic
// dependent launch behind the logits' launch, which then may write the
// logits and nothing else the kernel reads (the rule of smer_sample_advance).
int smer_spec_advance(const void* logits, void* carry, void* out, void* window, void* x,
                      void* kv_rows, const void* aux, const void* span_types,
                      const void* sid_tbl, const void* masks, const void* next_bits,
                      const void* noise, const void* uniforms, const void* src, const void* emb,
                      const void* pos_table, void* draft_tbl, int W, int L, int S, int V, int D,
                      int vpad,
                      int max_len, int max_spans, int n_sid, int mode, int span_cap,
                      int eos_index, int mask_index, int span_body, int greedy, int use_nucleus,
                      float nucleus_p, float temperature, float emb_scale, int round_bf16,
                      int prime, int pdl, void* stream) {
  if (W < 1 || L < 1 || S < W - 1 || V < 1 || V > vpad || D < 4 || D % 4 || max_len < 1 ||
      draft_tbl == nullptr ||
      max_spans < 1 || (logits == nullptr) != (prime != 0) || (noise == nullptr) != (greedy != 0) ||
      (uniforms == nullptr) != (greedy != 0))
    return (int)cudaErrorInvalidValue;
  SpecArgs a;
  a.logits = static_cast<const float*>(logits);
  a.carry = static_cast<int*>(carry);
  a.out = static_cast<int*>(out);
  a.window = static_cast<int*>(window);
  a.x = static_cast<float*>(x);
  a.kv_rows = static_cast<long long*>(kv_rows);
  a.aux = static_cast<const int*>(aux);
  a.span_types = static_cast<const int*>(span_types);
  a.sid_tbl = static_cast<const int*>(sid_tbl);
  a.masks = static_cast<const float*>(masks);
  a.next_bits = static_cast<const int*>(next_bits);
  a.noise = static_cast<const float*>(noise);
  a.uniforms = static_cast<const float*>(uniforms);
  a.src = static_cast<const int*>(src);
  a.emb = static_cast<const float*>(emb);
  a.pos_table = static_cast<const float*>(pos_table);
  a.draft_tbl = static_cast<int*>(draft_tbl);
  a.W = W;
  a.L = L;
  a.S = S;
  a.V = V;
  a.D = D;
  a.vpad = vpad;
  a.max_len = max_len;
  a.max_spans = max_spans;
  a.n_sid = n_sid;
  a.mode = mode;
  a.span_cap = span_cap;
  a.eos_index = eos_index;
  a.mask_index = mask_index;
  a.span_body = span_body;
  a.greedy = greedy;
  a.use_nucleus = use_nucleus;
  a.round_bf16 = round_bf16;
  a.prime = prime;
  a.nucleus_p = nucleus_p;
  a.temperature = temperature;
  a.emb_scale = emb_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vpad) {
    case 128:
      return launch_spec_advance<4>(a, pdl, st);
    case 256:
      return launch_spec_advance<8>(a, pdl, st);
    case 384:
      return launch_spec_advance<12>(a, pdl, st);
    case 512:
      return launch_spec_advance<16>(a, pdl, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
