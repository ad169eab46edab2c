// Split-TF32 products on Hopper's tensor cores, for scripts/f32_tc_probe.py:
// C[b][m][n] = sum_k A[b][m][k] Bt[b][n][k] over f32 operands, one warp a
// 16 x 8 output tile, every product by
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with fragments read
// straight from device memory (speed is not the point).
//
// Each operand x is split as hi = cvt.rna.tf32.f32(x) and lo = x - hi, lo
// either rounded by cvt.rna as well (LO_RNA) or handed over as it is, so
// that the tensor cores read its top 19 bits (LO_RAW); a k8 step adds
// lo_a hi_b, hi_a lo_b, hi_a hi_b into the accumulator in that order (lo_a
// lo_b dropped).  The schemes of accumulation:
//   CHAIN: one accumulator over the whole reduction;
//   TILE64: a zeroed accumulator for each 64 of k, added to the running sum
//     by FADD (round to nearest) when the 64 are done;
//   ONE_PASS: hi_a hi_b alone, one chain (plain TF32, for contrast).
// rna_sweep holds the kernels' integer rounding to TF32 against cvt.rna on
// every finite f32 value.
//
// The launcher has a plain C interface and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { LO_RNA = 0, LO_RAW = 1 };
enum { CHAIN = 0, TILE64 = 1, ONE_PASS = 2 };

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int LO>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  const float rest = x - __uint_as_float(hi);
  lo = LO == LO_RNA ? tf32_rna(rest) : __float_as_uint(rest);
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int LO, int SCHEME>
__global__ void __launch_bounds__(32)
    split_tf32_product(const float* __restrict__ A, const float* __restrict__ Bt,
                       float* __restrict__ C, int M, int N, int K) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int n0 = 8 * blockIdx.x, m0 = 16 * blockIdx.y;
  const float* a = A + (size_t)blockIdx.z * M * K;
  const float* b = Bt + (size_t)blockIdx.z * N * K;
  float run[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a[(size_t)(m0 + g) * K + k0 + t], a[(size_t)(m0 + g + 8) * K + k0 + t],
                         a[(size_t)(m0 + g) * K + k0 + t + 4],
                         a[(size_t)(m0 + g + 8) * K + k0 + t + 4]};
    const float bv[2] = {b[(size_t)(n0 + g) * K + k0 + t], b[(size_t)(n0 + g) * K + k0 + t + 4]};
    uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split<LO>(av[i], ah[i], al[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) split<LO>(bv[i], bh[i], bl[i]);
    if (SCHEME != ONE_PASS) {
      mma_tf32(acc, al, bh);
      mma_tf32(acc, ah, bl);
    }
    mma_tf32(acc, ah, bh);
    if (SCHEME == TILE64 && ((k0 + 8) % 64 == 0 || k0 + 8 == K)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
  if (SCHEME != TILE64) {
#pragma unroll
    for (int i = 0; i < 4; ++i) run[i] = acc[i];
  }
  float* c = C + (size_t)blockIdx.z * M * N;
  c[(size_t)(m0 + g) * N + n0 + 2 * t] = run[0];
  c[(size_t)(m0 + g) * N + n0 + 2 * t + 1] = run[1];
  c[(size_t)(m0 + g + 8) * N + n0 + 2 * t] = run[2];
  c[(size_t)(m0 + g + 8) * N + n0 + 2 * t + 1] = run[3];
}

// Every finite f32 bit pattern (inf and NaN left out): cvt.rna.tf32.f32
// against the integer rounding the flash-train f32 backward kernels use,
// (bits + 0x1000) & 0xffffe000; counts the patterns where they differ and
// where cvt.rna's low 13 bits are not zero, and keeps the least differing
// pattern.
__global__ void rna_sweep(unsigned long long* differ, unsigned long long* low_bits,
                          unsigned int* first) {
  unsigned long long n_differ = 0, n_low = 0;
  const uint64_t step = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32); i += step) {
    const uint32_t bits = (uint32_t)i;
    if ((bits & 0x7fffffffu) >= 0x7f800000u) continue;
    const uint32_t rna = tf32_rna(__uint_as_float(bits));
    const uint32_t mine = (bits + 0x1000u) & 0xffffe000u;
    n_low += (rna & 0x1fffu) != 0;
    if ((rna & 0xffffe000u) != mine) {
      ++n_differ;
      atomicMin(first, bits);
    }
  }
  if (n_differ) atomicAdd(differ, n_differ);
  if (n_low) atomicAdd(low_bits, n_low);
}

template <int LO, int SCHEME>
void launch(int batch, int M, int N, int K, const float* A, const float* Bt, float* C,
            cudaStream_t st) {
  split_tf32_product<LO, SCHEME><<<dim3(N / 8, M / 16, batch), 32, 0, st>>>(A, Bt, C, M, N, K);
}

}  // namespace

extern "C" {

// lo_mode 0 (lo rounded by cvt.rna) or 1 (lo as it is); scheme 0 (one
// chain), 1 (a zeroed accumulator each 64 of k, added by FADD) or 2 (one
// TF32 pass); A (batch, M, K), Bt (batch, N, K), C (batch, M, N) f32,
// contiguous; M a multiple of 16, N and K of 8.
int f32_tc_probe_launch(int lo_mode, int scheme, int batch, int M, int N, int K, const void* A,
                        const void* Bt, void* C, void* stream) {
  if (batch < 1 || batch > 65535 || M % 16 || N % 8 || K % 8 || M < 16 || N < 8 || K < 8 ||
      lo_mode < 0 || lo_mode > 1 || scheme < 0 || scheme > 2)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(A);
  const auto* b = static_cast<const float*>(Bt);
  auto* c = static_cast<float*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scheme == ONE_PASS) {
    launch<LO_RNA, ONE_PASS>(batch, M, N, K, a, b, c, st);
  } else if (lo_mode == LO_RNA) {
    if (scheme == CHAIN) launch<LO_RNA, CHAIN>(batch, M, N, K, a, b, c, st);
    else launch<LO_RNA, TILE64>(batch, M, N, K, a, b, c, st);
  } else {
    if (scheme == CHAIN) launch<LO_RAW, CHAIN>(batch, M, N, K, a, b, c, st);
    else launch<LO_RAW, TILE64>(batch, M, N, K, a, b, c, st);
  }
  return (int)cudaGetLastError();
}

// counts[0]: patterns where the two roundings differ, counts[1]: where
// cvt.rna left low bits; first: the least differing pattern (set to
// 0xffffffff before the call)
int f32_tc_rna_sweep(void* counts, void* first, void* stream) {
  auto* c = static_cast<unsigned long long*>(counts);
  rna_sweep<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(c, c + 1,
                                                                      static_cast<unsigned int*>(first));
  return (int)cudaGetLastError();
}

}  // extern "C"
