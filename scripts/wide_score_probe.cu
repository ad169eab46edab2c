// The scores q . k of the wide attention kernels, summed in each of their two
// orders, for scripts/wide_score_probe.py: wide_rows_kernel's (and
// wide_fwd_kernel's) on the tensor cores, chunk after chunk of head_dim
// through attention_wide.cu's own staging and score_step, and
// wide_keys_kernel's on the FMA pipes, one fmaf(k_d, q_d, acc) a head_dim in
// order (score_tile's sum for one element).  Built with -I on ops/csrc.

#include "attention_wide.cu"

namespace {

// a block per (64 query rows, b * H + h, 64 keys): s as the rows kernel sums it
template <class T>
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
    stage_rows<T, kRows, E::kChunk, E::kLdC>(reinterpret_cast<T*>(smem), qb, ld, t0, n_rows,
                                             c * E::kChunk, E::kChunk);
    stage_rows<T, kKeys, E::kChunk, E::kLdC>(reinterpret_cast<T*>(smem + kChunkBytes), kb, ld, k0, S,
                                             c * E::kChunk, E::kChunk);
    tiles::cp_async_commit();
    tiles::cp_async_wait<0>();
    __syncthreads();
    score_step(s, reinterpret_cast<const T*>(smem), warp, lane);
    __syncthreads();
  }
  const int row0 = t0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), col = k0 + 8 * j + 2 * t + (e & 1);
      if (row < n_rows && col < S) out[((size_t)bh * n_rows + row) * S + col] = s[j][e];
    }
}

// a thread per (b * H + h, row, key): s as the keys kernel sums it
template <class T>
__global__ void probe_fma(const T* q, const T* k, int B, int n_rows, int S, int H, int D, float* out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * n_rows * S) return;
  const int col = i % S, row = (i / S) % n_rows, bh = i / ((size_t)S * n_rows), b = bh / H, h = bh % H;
  const T* qr = q + (((size_t)b * n_rows + row) * H + h) * D;
  const T* kr = k + (((size_t)b * S + col) * H + h) * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(to_f(kr[d]), to_f(qr[d]), acc);
  out[i] = acc;
}

template <class T>
int run(int B, int n_rows, int S, int H, int D, const void* q, const void* k, void* tc, void* fma,
        cudaStream_t st) {
  const size_t smem = 2 * kChunkBytes;
  const dim3 grid((n_rows + kRows - 1) / kRows, B * H, (S + kKeys - 1) / kKeys);
  probe_tc<T><<<grid, kTcThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                               n_rows, S, H, D, static_cast<float*>(tc));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * H * n_rows * S;
  probe_fma<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), B, n_rows, S, H, D, static_cast<float*>(fma));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wide_score_probe(int bf16_, int B, int T, int S, int H, int D, const void* q,
                                const void* k, void* tc, void* fma, void* stream) {
  if (D % kDC || B < 1 || T < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_ ? run<bf16>(B, T, S, H, D, q, k, tc, fma, st) : run<float>(B, T, S, H, D, q, k, tc, fma, st);
}
