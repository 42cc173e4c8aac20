// Constant-stencil (MATRIX_FREE) sparse matrix-vector product for
// Hopper (sm_90a), on an nx x ny x nz grid with flat row index
// i = ix + nx * (iy + ny * iz):
//
//     y[i] = sum_k c[k] * [neighbour (ix+dx_k, iy+dy_k, iz+dz_k) in grid]
//                       * x[i + dx_k + nx * dy_k + nx * ny * dz_k]
//
// Replaces the Pallas TPU kernel
// amgx_tpu/ops/pallas_stencil.py::_stencil_kernel.  That kernel staged
// one x window per 64K-row block in VMEM, shifted it by lane rotations
// and regenerated the Dirichlet masks from the block's row indices; the
// nd coefficients rode in SMEM.
//
// What bounds it on an H100: bytes.  The matrix is nd scalars, so a
// call must read x once and write y once: 2 * sizeof(T) * n bytes
// (16.8 MB in f32 for the 2,097,152-row Poisson level, 5.0 us at the
// H100 SXM's 3.35 TB/s), against 4 * n * (nd + 2) for the DIA kernel.
// It does 2 * nd flops per row, far below the card's flop rate.
//
// Design:
//   * one thread per row (grid-stride, 64-bit row index), so a warp's
//     32 threads read 32 neighbouring x values for each diagonal and
//     write 32 neighbouring y values: every access is coalesced;
//   * the nd coefficients and (dx, dy, dz) steps (nd <= 27) are staged
//     in shared memory once per block and broadcast to its threads;
//   * (ix, iy, iz) come from i by two divisions (32-bit below 4G rows);
//     per diagonal the neighbour is kept when it lies inside the grid
//     on every axis (the flat index wraps at the seams of grid rows and
//     planes, so a flat bounds check alone would be wrong);
//   * x[i + off] is read through the read-only path (__ldg); the nd
//     shifted reads of neighbouring rows hit lines that L1/L2 already
//     hold (level-0 x is 8 MB in f32, inside the 50 MB L2), so x costs
//     about one pass from memory;
//   * the sum starts from +0.0 and runs in offsets order with one fma
//     per diagonal, as the DIA kernel (dia_spmv.cu) does, so on a
//     verified stencil the two agree bit for bit: where a DIA plane
//     holds 0 for a masked neighbour, fma(0, x, acc) == acc ==
//     fma(c, 0, acc).
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiags = 27;
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
stencil_spmv_kernel(const T* __restrict__ coefs,
                    const int* __restrict__ steps, int nd,
                    const T* __restrict__ x, T* __restrict__ y, int nx,
                    int ny, int nz) {
  __shared__ T s_c[kMaxDiags];
  __shared__ int s_dx[kMaxDiags], s_dy[kMaxDiags], s_dz[kMaxDiags];
  __shared__ int64_t s_off[kMaxDiags];
  const int64_t nxy = static_cast<int64_t>(nx) * ny;
  const int64_t n = nxy * nz;
  for (int k = threadIdx.x; k < nd; k += blockDim.x) {
    const int dx = steps[3 * k], dy = steps[3 * k + 1],
              dz = steps[3 * k + 2];
    s_c[k] = coefs[k];
    s_dx[k] = dx;
    s_dy[k] = dy;
    s_dz[k] = dz;
    s_off[k] = dx + static_cast<int64_t>(nx) * dy + nxy * dz;
  }
  __syncthreads();

  const bool narrow = n <= 0xffffffffLL;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int64_t iz;
    int iy, ix;
    if (narrow) {  // uniform branch: 32-bit division is far cheaper
      const unsigned u = static_cast<unsigned>(i);
      const unsigned uz = u / static_cast<unsigned>(nxy);
      const unsigned ur = u - uz * static_cast<unsigned>(nxy);
      iz = uz;
      iy = static_cast<int>(ur / static_cast<unsigned>(nx));
      ix = static_cast<int>(ur - static_cast<unsigned>(iy) * nx);
    } else {
      iz = i / nxy;
      const int64_t rem = i - iz * nxy;
      iy = static_cast<int>(rem / nx);
      ix = static_cast<int>(rem - static_cast<int64_t>(iy) * nx);
    }
    T acc = T(0);
    for (int k = 0; k < nd; ++k) {
      const int jx = ix + s_dx[k];
      const int jy = iy + s_dy[k];
      const int64_t jz = iz + s_dz[k];
      const bool inside = jx >= 0 && jx < nx && jy >= 0 && jy < ny &&
                          jz >= 0 && jz < nz;
      const T xj = inside ? __ldg(x + i + s_off[k]) : T(0);
      acc = fma_rn(s_c[k], xj, acc);
    }
    y[i] = acc;
  }
}

template <typename T>
int launch(const void* coefs, const void* steps, int nd, const void* x,
           void* y, int nx, int ny, int nz, void* stream) {
  if (nd > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nx) * ny * nz;
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  stencil_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coefs), static_cast<const int*>(steps), nd,
      static_cast<const T*>(x), static_cast<T*>(y), nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_spmv_f32(const void* coefs, const void* steps, int nd,
                                const void* x, void* y, int nx, int ny,
                                int nz, void* stream) {
  return launch<float>(coefs, steps, nd, x, y, nx, ny, nz, stream);
}

extern "C" int stencil_spmv_f64(const void* coefs, const void* steps, int nd,
                                const void* x, void* y, int nx, int ny,
                                int nz, void* stream) {
  return launch<double>(coefs, steps, nd, x, y, nx, ny, nz, stream);
}
