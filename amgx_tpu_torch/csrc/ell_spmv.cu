// ELL sparse matrix-vector product for Hopper (sm_90a), slot-major:
//
//     y[i] = sum_s vals[s * n + i] * x[cols[s * n + i]]     (0 <= i < n)
//
// for a square or rectangular matrix of n rows stored as w slots of n
// entries each (padding slots hold column 0 and value 0).
//
// Replaces the Pallas TPU kernel amgx_tpu/ops/pallas_well.py::_well_kernel.
// That kernel cut rows into 1024-row tiles, interleaved the slots across
// the (8, 128) lanes and gathered from one x window per tile, only to
// bound the cost of a TPU lane gather.  A GPU gathers per thread, so
// none of that is carried over.
//
// What bounds it on an H100: bytes.  A call must read the w slots of
// column ids and values once, x once and write y once:
// n * w * 8 + 4 * n + 4 * n_cols bytes in f32 (about 26 MB for each of
// the prolongation P, w = 1, and restriction R, w = 8, of the
// 2,097,152-row Poisson level, 7.8 us at 3.35 TB/s).  It does 2 * w
// flops per row.
//
// Design:
//   * one thread per row (grid-stride); with the slot-major layout a
//     warp's loads of cols and vals for one slot are coalesced;
//   * x[cols[...]] is a gather through the read-only path (__ldg); the
//     aggregation transfers number coarse unknowns lexicographically,
//     so neighbouring rows gather from neighbouring columns and the
//     gathered lines are mostly reused from L1/L2;
//   * the sum starts from +0.0 and runs in slot order, as the plain
//     version (ops/ell.py:ell_spmv_plain) does;
//   * s * n + i is computed in 64-bit.
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                int w, const T* __restrict__ x, T* __restrict__ y,
                int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    T acc = T(0);
    for (int s = 0; s < w; ++s) {
      const int64_t e = static_cast<int64_t>(s) * n + i;
      acc += __ldg(vals + e) * __ldg(x + __ldg(cols + e));
    }
    y[i] = acc;
  }
}

template <typename T>
int launch(const void* cols, const void* vals, int w, const void* x,
           void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ell_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals), w,
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols, const void* vals, int w,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<float>(cols, vals, w, x, y, n, stream);
}

extern "C" int ell_spmv_f64(const void* cols, const void* vals, int w,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<double>(cols, vals, w, x, y, n, stream);
}
