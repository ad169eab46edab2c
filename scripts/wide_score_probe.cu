// The scores q . k of the wide attention kernels, summed in each of their two
// orders, for scripts/wide_score_probe.py: wide_rows_kernel's (and
// wide_fwd_kernel's) s = Q K^T, and wide_keys_kernel's S^T = K Q^T (split
// TF32's cross passes swapped), both through attention_wide.cu's own staging
// and score_step, chunk after chunk of head_dim.  Built with -I on ops/csrc.

#include "attention_wide.cu"

namespace {

// a block per (64 query rows, b * H + h, 64 keys): s as the rows kernel sums
// it, or (KEYS) as the keys kernel does, its 64 keys the fragments' rows;
// out[bh][row][key] either way
template <class T, bool KEYS>
__global__ void __launch_bounds__(kTcThreads) probe_tc(const T* q, const T* k, int n_rows, int S,
                                                       int H, int D, float* out) {
  using E = Elem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, t0 = blockIdx.x * kRows, k0 = blockIdx.z * kKeys;
  const int ld = H * D;
  const T* qb = q + ((size_t)b * n_rows * H + h) * D;
  const T* kb = k + ((size_t)b * S * H + h) * D;
  float s[kNJ][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int c = 0; c < D / E::kChunk; ++c) {
    stage_rows<T, kRows, E::kChunk, E::kLdC>(reinterpret_cast<T*>(smem + (KEYS ? kChunkBytes : 0)), qb,
                                             ld, t0, n_rows, c * E::kChunk, E::kChunk);
    stage_rows<T, kKeys, E::kChunk, E::kLdC>(reinterpret_cast<T*>(smem + (KEYS ? 0 : kChunkBytes)), kb,
                                             ld, k0, S, c * E::kChunk, E::kChunk);
    tiles::cp_async_commit();
    tiles::cp_async_wait<0>();
    __syncthreads();
    score_step<KEYS>(s, reinterpret_cast<const T*>(smem), warp, lane);
    __syncthreads();
  }
  const int x0 = (KEYS ? k0 : t0) + 16 * warp + (lane >> 2), y0 = KEYS ? t0 : k0;
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = x0 + 8 * (e >> 1), y = y0 + 8 * j + 2 * t + (e & 1);
      const int row = KEYS ? y : x, col = KEYS ? x : y;
      if (row < n_rows && col < S) out[((size_t)bh * n_rows + row) * S + col] = s[j][e];
    }
}

template <class T>
int run(int B, int n_rows, int S, int H, int D, const void* q, const void* k, void* rows, void* keys,
        cudaStream_t st) {
  const size_t smem = 2 * kChunkBytes;
  const dim3 grid((n_rows + kRows - 1) / kRows, B * H, (S + kKeys - 1) / kKeys);
  probe_tc<T, false><<<grid, kTcThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                      n_rows, S, H, D, static_cast<float*>(rows));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  probe_tc<T, true><<<grid, kTcThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                     n_rows, S, H, D, static_cast<float*>(keys));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wide_score_probe(int bf16_, int B, int T, int S, int H, int D, const void* q,
                                const void* k, void* rows, void* keys, void* stream) {
  if (D % kDC || B < 1 || T < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_ ? run<bf16>(B, T, S, H, D, q, k, rows, keys, st)
               : run<float>(B, T, S, H, D, q, k, rows, keys, st);
}
