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
//   * k * n + i is computed in 64-bit;
//   * bf16 (dtypes.cuh): the planes and x in bf16, y in bf16, each
//     product and each sum rounded to bf16 in offset order, as the plain
//     version's torch operations and the Pallas kernel's bf16
//     accumulator round, so the kernel returns the plain version's bits
//     (and the stencil kernel's on a matrix both formats hold).  The
//     bytes are half those of f32: 2 * n * (nd + 2) (37.7 MB for the
//     2,097,152-row level).  Only (bf16, bf16) is instantiated: every DIA
//     operator the cycle reaches multiplies a vector of its own dtype.
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

using namespace spmv_types;

constexpr int kThreads = 256;
// grid-stride beyond this many blocks (64 per SM on 132 SMs)
constexpr long long kMaxBlocks = 132LL * 64;

// V: plane values, X: x, Y: y, K: how a term rounds (dtypes.cuh)
template <typename V, typename X, typename Y, int K>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const V* __restrict__ vals, const int* __restrict__ offsets,
                int nd, const X* __restrict__ x, Y* __restrict__ y,
                int64_t n) {
  using C = typename Compute<Y>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    C acc = C(0);
    for (int k = 0; k < nd; ++k) {
      const int64_t j = i + static_cast<int64_t>(__ldg(offsets + k));
      const C xj = (j >= 0 && j < n) ? C(ldg_c(x + j)) : C(0);
      acc = Term<K>::f(acc, C(ldg_c(vals + static_cast<int64_t>(k) * n + i)),
                       xj);
    }
    store_y(y + i, acc);
  }
}

template <typename V, typename X, typename Y, int K>
int launch(const void* vals, const void* offsets, int nd, const void* x,
           void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dia_spmv_kernel<V, X, Y, K><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), static_cast<const int*>(offsets), nd,
      static_cast<const X*>(x), static_cast<Y*>(y),
      static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dia_spmv_f32(const void* vals, const void* offsets, int nd,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<float, float, float, 0>(vals, offsets, nd, x, y, n, stream);
}

extern "C" int dia_spmv_f64(const void* vals, const void* offsets, int nd,
                            const void* x, void* y, long long n,
                            void* stream) {
  return launch<double, double, double, 0>(vals, offsets, nd, x, y, n, stream);
}

extern "C" int dia_spmv_bf16(const void* vals, const void* offsets, int nd,
                             const void* x, void* y, long long n,
                             void* stream) {
  return launch<bf16, bf16, bf16, 2>(vals, offsets, nd, x, y, n, stream);
}
