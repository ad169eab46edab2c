// The keys kernel split by warps, a design variant of
// scripts/wide_variants.py (not built into the port's library): the text of
// this file takes the place of fetch_keys and wide_keys_kernel in a copy of
// ops/csrc/attention_wide.cu, and launch_keys_split the place of the keys
// kernel's launch.  A block of 8 warps owns 64 keys and one 128-column chunk
// of both dk and dv: warps 0-3 take S^T = K Q^T and dv, warps 4-7 (the same
// 16 keys a warp, so the same C-fragment layout) (g V^T)^T and dk; w or p
// passes from a warp of the first group to its twin in the second through
// the stash.  S^T is taken once a chunk, so 6 full-size products a block at
// head_dim 256 where the shipped kernel's dk and dv blocks take 8.  A score
// step stages chunks of K and Q (the first group's threads) and of V and g
// (the second's), the last with the tile's m, l and delta or di; an output
// step stages g rows (dv) and Q rows (dk).  KEYS_SPLIT_BLOCKS caps the
// registers: 2 blocks an SM (128 a thread) or 1 (255).

#ifndef KEYS_SPLIT_BLOCKS
#define KEYS_SPLIT_BLOCKS 2
#endif

constexpr int kSplitThreads = 256;
constexpr int kSplitB = 2 * kChunkBytes;             // the second group's part of a stage
constexpr int kSplitStats = 4 * kChunkBytes;         // m, l, then delta or di
constexpr int kSplitStage = kSplitStats + 3 * kRows * 4;
constexpr int kSplitStashOff = kStages * kSplitStage;
constexpr size_t kSplitSmem = (size_t)kSplitStashOff + 4 * kNJ * kTcThreads * sizeof(float);
static_assert(kSplitStage % 16 == 0, "stages stay 16-byte aligned");

// stage_rows with the thread's index in its group of 128
template <class T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_rows_g(int tid, T* dst, const T* base, int ld, int r0, int limit,
                                             int c0, int ncols) {
  constexpr int kPer = 16 / sizeof(T), kCpr = COLS / kPer, kN = ROWS * kCpr;
  const int c = kPer * (tid % kCpr), r = tid / kCpr;
#pragma unroll
  for (int u = 0; u < kN / kTcThreads; ++u) {
    const int ru = r + u * (kTcThreads / kCpr);
    const bool ok = r0 + ru < limit && c < ncols;
    tiles::cp_async16(dst + ru * LD + c, ok ? base + ((uint32_t)(r0 + ru) * (uint32_t)ld + c0 + c) : base,
                      ok);
  }
}

template <class Fetch>
struct SplitRing {
  unsigned char* smem;
  Fetch fetch;
  int step;
  __device__ __forceinline__ SplitRing(unsigned char* s, Fetch f) : smem(s), fetch(f), step(0) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) fetch(i, stage(i));
  }
  __device__ __forceinline__ unsigned char* stage(int i) const { return smem + (i % kStages) * kSplitStage; }
  __device__ __forceinline__ const unsigned char* next() {
    tiles::cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(step + kStages - 1, stage(step + kStages - 1));
    return stage(step++);
  }
  __device__ __forceinline__ const float* stats() const {
    return reinterpret_cast<const float*>(stage(step - 1) + kSplitStats);
  }
};

template <class T>
__device__ __forceinline__ void fetch_split(const WideArgs& a, const Plan& p, int i, unsigned char* st) {
  using E = Elem<T>;
  const int grp = threadIdx.x >= kTcThreads, tid = threadIdx.x % kTcThreads;
  if (i < p.total) {
    const int nsc = p.nsc, j = i % p.per, q0 = p.t0 + (i / p.per) * kRows;
    unsigned char* mine = st + grp * kSplitB;
    if (j < nsc) {  // K and Q (first group), V and g (second)
      stage_rows_g<T, kKeys, E::kChunk, E::kLdC>(tid, reinterpret_cast<T*>(mine),
                                                 static_cast<const T*>(p.x[grp]), p.ld, p.s0, a.S,
                                                 j * E::kChunk, E::kChunk);
      stage_rows_g<T, kRows, E::kChunk, E::kLdC>(tid, reinterpret_cast<T*>(mine + kChunkBytes),
                                                 static_cast<const T*>(p.y[grp]), p.ld, q0, a.T,
                                                 j * E::kChunk, E::kChunk);
      if (j == nsc - 1 && (grp == 0 || tid < kRows)) {
        const float* src = grp ? p.st[2] : p.st[tid / kRows];
        const int q = tid % kRows;
        const bool ok = q0 + q < a.T;
        tiles::cp_async4(reinterpret_cast<float*>(st + kSplitStats) + grp * 2 * kRows + tid,
                         ok ? src + q0 + q : src, ok);
      }
    } else {  // g rows (dv), Q rows (dk)
      stage_rows_g<T, E::kOutKeys, kOC, E::kLdO>(tid, reinterpret_cast<T*>(mine),
                                                 static_cast<const T*>(p.y[1 - grp]), p.ld,
                                                 q0 + (j - nsc) * E::kOutKeys, a.T, p.c0, p.ncols);
    }
  }
  tiles::cp_async_commit();
}

template <class T, int MODE>
__global__ void __launch_bounds__(kSplitThreads, KEYS_SPLIT_BLOCKS) wide_keys_kernel(const WideArgs a) {
  using E = Elem<T>;
  constexpr int kOut = kRows / E::kOutKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool dk_group = threadIdx.x >= kTcThreads;
  const int tid = threadIdx.x % kTcThreads;
  float* stash = reinterpret_cast<float*>(smem + kSplitStashOff) + tid;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int s0 = blockIdx.x * kKeys, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int c0 = blockIdx.z * kOC, nnb = min(kOC, a.D - c0) / 8;
  const int key0 = s0 + 16 * warp + (lane >> 2);
  const int q_begin = !a.causal ? 0 : MODE == kModeFlash ? (s0 / kBlk) * kBlk : s0;
  const int nt = q_begin < a.T ? (a.T - q_begin + kRows - 1) / kRows : 0, nsc = a.D / E::kChunk;
  __shared__ Plan plan;
  if (threadIdx.x == 0) {
    const size_t n = (size_t)a.B * a.H * a.T;
    plan.x[0] = head<T>(a.k, b, a.S, a.H, h, a.D);
    plan.x[1] = head<T>(a.v, b, a.S, a.H, h, a.D);
    plan.y[0] = head<T>(a.q, b, a.T, a.H, h, a.D);
    plan.y[1] = head<T>(a.g, b, a.T, a.H, h, a.D);
    plan.st[0] = a.stats + (size_t)bh * a.T;
    plan.st[1] = plan.st[0] + n;
    plan.st[2] = MODE == kModeFlash ? a.di + (size_t)bh * a.T : plan.st[0] + 2 * n;
    plan.dr = drop_of<MODE>(a);
    if (!plan.dr.on) plan.dr.c = 1.f;
    plan.bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
    plan.rc = 1.f / plan.dr.c;
    plan.ld = a.H * a.D;
    plan.t0 = q_begin;
    plan.s0 = s0;
    plan.nsc = nsc;
    plan.per = nsc + kOut;
    plan.total = nt * plan.per;
    plan.c0 = c0;
    plan.ncols = 8 * nnb;
  }
  bool kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kv[r] = key < a.S && a.valid[(size_t)b * a.S + key] != 0;
  }
  __syncthreads();
  auto fetch = [&](int i, unsigned char* st) { fetch_split<T>(a, plan, i, st); };
  SplitRing<decltype(fetch)> ring(smem, fetch);
  const int part = dk_group ? kSplitB : 0;

  float acc[kOC / 8][4], s[kNJ][4];
#pragma unroll
  for (int nb = 0; nb < kOC / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  const float c = plan.dr.c, rc = plan.rc;
  for (int it = 0; it < nt; ++it) {
    const int q0 = q_begin + it * kRows;
    const uint32_t keep = MODE == kModeDrop ? keep_bits_t(plan, key0, q0, t) : 0u;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int cc = 0; cc < nsc; ++cc) score_step<true>(s, reinterpret_cast<const T*>(ring.next() + part), warp, lane);
    const float* sts = ring.stats();
    if (!dk_group) {  // S^T: w or p into the stash, wd or cast(p) for dv
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cl = 8 * j + 2 * t + u, query = q0 + cl;
          const float m = sts[cl];
          const float l = MODE == kModeDrop ? fmaxf(sts[kRows + cl], 1e-30f) : sts[kRows + cl];
          const float rl = 1.f / l;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + u;
            const bool ok = kv[r] && (!a.causal || key0 + 8 * r <= query);
            float w = 0.f;
            if (query < a.T) {
              if (MODE == kModeDrop) {
                if (ok) w = div_rn(ex2_ftz(bf16r(s[j][e]) * a.scale - m), l, rl);
              } else {
                w = ex2_ftz(s[j][e] * a.scale + (ok ? 0.f : kMaskValue) - m) * rl;
              }
            }
            stash[(4 * j + e) * kTcThreads] = w;
            if (MODE == kModeDrop)
              s[j][e] = keep >> (4 * j + e) & 1u ? bf16r(div_rn(bf16r(w), c, rc)) : 0.f;
            else
              s[j][e] = cast<T>(w);
          }
        }
    } else {  // (g V^T)^T: dw - delta or s - di, before the stage is refilled
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dl = sts[2 * kRows + 8 * j + 2 * t + (e & 1)];
          if (MODE == kModeDrop) {
            const float dw = keep >> (4 * j + e) & 1u ? div_rn(s[j][e], c, rc) : 0.f;
            s[j][e] = dw - dl;
          } else {
            s[j][e] = s[j][e] - dl;
          }
        }
    }
    auto weights = [&s](int j, int e) { return s[j][e]; };
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const T* ys = reinterpret_cast<const T*>(ring.next() + part);
      if (u == 0 && dk_group) {  // ds, from the first group's w or p (past the barrier)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = stash[(4 * j + e) * kTcThreads];
            float ds = 0.f;
            if (q0 + 8 * j + 2 * t + (e & 1) < a.T)
              ds = MODE == kModeDrop ? bf16r(w * s[j][e] * a.scale) : cast<T>(s[j][e] * w * a.scale);
            s[j][e] = ds;
          }
      }
      out_step<false>(acc, weights, u, ys, lane, plan.ncols >> 3);
    }
  }
  tiles::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  T* out = static_cast<T*>(dk_group ? a.dk : a.dv) + ((size_t)b * a.S * a.H + h) * a.D + c0;
  store_rows<T>(out, plan.ld, key0, a.S, plan.ncols >> 3, acc, one, t);
}

template <class Kernel>
cudaError_t launch_keys_split(Kernel kernel, const WideArgs& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSplitSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kKeys - 1) / kKeys, a.B * a.H, (a.D + kOC - 1) / kOC);
  kernel<<<grid, kSplitThreads, kSplitSmem, st>>>(a);
  return cudaGetLastError();
}

