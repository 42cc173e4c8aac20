// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_k vals[k * n + i] * x[i + offsets[k]]      (0 <= i < n)
//
// Replaces the Pallas TPU kernel amgx_tpu/ops/pallas_dia.py::_dia_kernel.
// That kernel staged one x window per 64K-row block in VMEM and applied
// the per-diagonal shifts as lane rotations, because XLA's shifted
// slices materialised an intermediate per diagonal on the TPU.
//
// What bounds it on an H100: bytes.  Each call must read the nd value
// planes once, x once and write y once: 4 * n * (nd + 2) bytes in f32
// (75.5 MB for the 2,097,152-row, 7-diagonal Poisson level, 22.5 us at
// the H100 SXM's 3.35 TB/s).  It does 2 * nd flops per row, far below
// the card's flop rate.
//
// Design:
//   * one thread per row (grid-stride), so for each diagonal a warp's
//     32 threads read 32 neighbouring values of that plane: every
//     plane load is coalesced;
//   * x[i + off] is read through the read-only path (__ldg); the nd
//     shifted reads of neighbouring rows hit the same lines, so L1/L2
//     serve all but the first and x costs about one pass from memory;
//     the window staging the TPU kernel did by hand is what the caches
//     do here;
//   * out-of-range columns are masked with an explicit bounds check
//     instead of padding x (no copy of x);
//   * the sum starts from +0.0 and runs in offset order, as the plain
//     version (ops/dia.py:dia_spmv_plain) does, with one explicit fma
//     per diagonal, so it agrees bit for bit with the stencil kernel
//     (stencil_spmv.cu) on a matrix both formats hold;
//   * k * n + i is computed in 64-bit.
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// grid-stride beyond this many blocks (64 per SM on 132 SMs)
constexpr long long kMaxBlocks = 132LL * 64;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ offsets,
                int nd, const T* __restrict__ x, T* __restrict__ y,
                int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + static_cast<int64_t>(__ldg(offsets + k));
      const T xj = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
      acc = fma_rn(__ldg(vals + static_cast<int64_t>(k) * n + i), xj, acc);
    }
    y[i] = acc;
  }
}

template <typename T>
int launch(const void* vals, const void* offsets, int nd, const void* x,
           void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(offsets), nd,
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dia_spmv_f32(const void* vals, const void* offsets, int nd,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<float>(vals, offsets, nd, x, y, n, stream);
}

extern "C" int dia_spmv_f64(const void* vals, const void* offsets, int nd,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<double>(vals, offsets, nd, x, y, n, stream);
}
