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
// What bounds it on an H100: bytes, once the instructions per row are
// few.  The matrix is nd scalars, so a call must read x once and write
// y once: 2 * sizeof(T) * n bytes (16.8 MB in f32 for the 2,097,152-row
// Poisson level, 5.0 us at the H100 SXM's 3.35 TB/s).  It does 2 * nd
// flops per row.  The first design (one thread per flat row) spent
// about 180 instructions a row on two integer divisions for (ix, iy,
// iz), per-diagonal 64-bit coordinates, six compares and five
// shared-memory loads, and took as long in f64 as in f32: it was bound
// by its instruction stream.  Without divisions, a thread walking z
// with one __ldg per neighbour still issues about a dozen instructions
// per term and has only its +z neighbour's 4 bytes in flight (the rest
// hit L1), which leaves it several times over the bound (PERF.md).
//
// Design, shared by both kernels below:
//   * a 2D block over (ix, iy) whose threads each walk zchunk
//     consecutive planes: ix and iy come from blockIdx/threadIdx, iz
//     from the loop, and the row index advances by nx * ny per plane,
//     so nothing is divided.  Neighbouring threads hold neighbouring x,
//     so every global load and store is coalesced.  The launch geometry
//     (blocks, threads, zchunk, kernel, points per thread) is computed
//     on the host (ops/stencil.py:stencil_launch_plan) and checked here;
//   * masks hoisted per axis: each thread computes the x and y part of
//     "neighbour inside" for every diagonal once, as a <= 27-bit mask;
//     the z part changes only on the first and last plane of the grid;
//   * the bitwise contract of ops/stencil.py: per row the sum starts
//     from +0.0 and runs in offsets order with one fma per diagonal,
//     the masked ones included (fma(c, 0, acc) == acc), as the DIA
//     kernel (dia_spmv.cu) does, so on a verified stencil the two agree
//     bit for bit.
//
// stencil_tile_kernel<T, ND, VEC>, for stencils with a z step whose
// steps all lie within one point on every axis, in offsets order, i.e.
// (dz, dy, dx) lexicographic: the 7-point star (ND = 7, the bench
// operator, steps fixed at compile time) and any other subset of the
// 3x3x3 box (ND = 27: the box itself, the 19-point stencil), whose
// diagonals present are a runtime mask.  A diagonal the stencil lacks
// adds fma(0, 0, acc), which leaves the sum as it is (unless the sum is
// -0.0, which takes an underflow; the masked terms of this kernel and
// of the DIA kernel share that caveat).  A 2.5D blocking: each thread
// owns VEC consecutive x points (for the star one 16-byte vector, 4 in
// f32 and 2 in f64, when nx is a multiple; else 1, and 1 for the box,
// whose 27 terms per point would take more registers than vectors
// save), so a block of 32 x 8 threads owns a 32 VEC x 8 tile of every
// plane of its z chunk.  The tile and its one-point halo are copied to
// shared memory once per plane with cp.async (16-byte copies for the
// vectors), into a ring of kRing plane slots that keeps kAhead planes
// in flight ahead of the three (iz - 1, iz, iz + 1) a step reads; the
// copies hold no registers.  Each thread then reads its rows of the
// three planes as vectors plus the halo points it needs, and with the
// steps fixed each term is an FMA on registers: about a quarter of the
// instructions per row of one point per thread.
//
// stencil_spmv_kernel<T>, any other stencil of at most 27 diagonals:
// 2D stencils (the plan walks a one-plane grid's y axis as z, so each
// thread walks rows), steps wider than one point, an offsets order that
// is not the box's (as on some grids only two points wide).  One point
// per thread, the steps by value in the constant bank, the diagonal
// loop unrolled to 27 under a runtime count, each neighbour a
// predicated __ldg of x.
//
// bf16 (dtypes.cuh): coefficients, x and y in bf16, the arithmetic in
// f32 registers with each product and each sum rounded to bf16 in
// offsets order, as the plain version's torch operations (and the DIA
// kernel's bf16 instantiation) round, so the kernel keeps the bitwise
// contract in bf16 too.  A 16-byte vector holds 8 bf16 points (the plan
// takes VEC 8); cp.async copies 4, 8 or 16 bytes, so a lone bf16 point
// (a tile's halo, or a point of a VEC 1 plan) is copied with a load and
// a shared-memory store, which the barrier of the step that reads it
// orders as it does the asynchronous copies.  Its bound is 2 * 2 * n
// bytes (8.4 MB at 2,097,152 rows).
//
// Mixed pairs and complex: the coefficients' type V and the x and y type
// T are apart (f32 with f64 x, bf16 with f32 x, c64 with c128 x), the
// coefficients converted to T's compute type once, exactly; the tile
// kernel stages T.  The complex instantiations (c64, c128, c64 under
// c128) compute each term with dtypes.cuh's complex rule; a 16-byte
// vector holds two c64 points or one c128, so the star takes vec 2 in
// c64 and 1 in c128.
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

using namespace spmv_types;

constexpr int kMaxThreads = 256;
constexpr int kMaxDiags = 27;
constexpr int kMaxGridYZ = 65535;
// tile kernel: blocks of at most kTileX x kTileY threads, each thread
// computing VEC consecutive x points; kRing plane slots (a power of
// two), kAhead planes in flight
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kRing = 8;
constexpr int kAhead = kRing - 3;
// a slot row holds the tile's kTileX * VEC points at [VEC, VEC +
// kTileX * VEC), the halo point before them at VEC - 1 and the one
// after at VEC + kTileX * VEC, so each thread's VEC points start on a
// 16-byte boundary
template <int VEC>
constexpr int kSlotW = (kTileX + 2) * VEC;
constexpr int kSlotH = kTileY + 2;

// per-diagonal steps, passed by value (kernel parameters live in the
// constant bank)
struct Steps {
  int off[kMaxDiags];  // dx + nx * dy + nx * ny * dz, |off| < 2^31
  int dx[kMaxDiags];
  int dy[kMaxDiags];
  int dz[kMaxDiags];
};

// steps of the tile kernel's stencils, in offsets order
__host__ __device__ constexpr int step_x(int nd, int k) {
  return nd == 27 ? k % 3 - 1 : (k == 2 ? -1 : k == 4 ? 1 : 0);
}
__host__ __device__ constexpr int step_y(int nd, int k) {
  return nd == 27 ? (k / 3) % 3 - 1 : (k == 1 ? -1 : k == 5 ? 1 : 0);
}
__host__ __device__ constexpr int step_z(int nd, int k) {
  return nd == 27 ? k / 9 - 1 : (k == 0 ? -1 : k == 6 ? 1 : 0);
}
// bits of the diagonals whose z step is dz
__host__ __device__ constexpr unsigned z_bits(int nd, int dz) {
  unsigned m = 0;
  for (int k = 0; k < nd; ++k) {
    if (step_z(nd, k) == dz) m |= 1u << k;
  }
  return m;
}
// bit 9 * (dz + 1) + 3 * (dy + 1) + (side + 1): a diagonal steps by
// (dy, dz) and, with side != 0, by dx of that sign; which slot rows a
// thread reads, and which of their halo points
__host__ __device__ constexpr unsigned row_bits(int nd) {
  unsigned m = 0;
  for (int k = 0; k < nd; ++k) {
    const int dx = step_x(nd, k), row = 9 * (step_z(nd, k) + 1) +
                                        3 * (step_y(nd, k) + 1);
    m |= 1u << (row + 1);
    if (dx != 0) m |= 1u << (row + dx + 1);
  }
  return m;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC values from shared memory at a 16-byte boundary (VEC > 1), in the
// compute type
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = p[0];
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const double* p, double* v) {
  if constexpr (VEC == 2) {
    const double2 u = *reinterpret_cast<const double2*>(p);
    v[0] = u.x, v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const c64* p, c64* v) {
  if constexpr (VEC == 2) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = c64(u.x, u.y), v[1] = c64(u.z, u.w);
  } else {
    v[0] = p[0];
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const c128* p, c128* v) {
  static_assert(VEC == 1, "a c128 point is a 16-byte vector");
  v[0] = p[0];
}
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(double* p, const double* v) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(c64* p, const c64* v) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0].re, v[0].im, v[1].re, v[1].im);
  } else {
    p[0] = v[0];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(c128* p, const c128* v) {
  static_assert(VEC == 1, "a c128 point is a 16-byte vector");
  p[0] = v[0];
}

// BYTES bytes from global to shared memory: cp.async for 4, 8 or 16; a
// load and a store for a lone bf16 point (2 bytes)
template <int BYTES, typename T>
__device__ __forceinline__ void copy_to_shared(T* dst, const T* src) {
  if constexpr (BYTES >= 4) {
    cp_async<BYTES>(dst, src);
  } else {
    *dst = __ldg(src);
  }
}

// copies plane z of the points `copies` names (see stencil_tile_kernel)
// into its slot, (z - z0 + 1) % kRing; planes z0 - 1 .. z1 are read.
// Every thread commits one group per plane, copies or not, so the group
// counts stay uniform.
template <int VEC, typename T>
__device__ __forceinline__ void copy_plane(T (*slots)[kSlotH][kSlotW<VEC>],
                                           const T* xy, int64_t nxy, int nx,
                                           int nz, int z, int z0, int z1,
                                           int tx, int ty, unsigned copies) {
  constexpr int kW = kSlotW<VEC>;
  if (z >= 0 && z < nz && z <= z1) {
    T* dst = &slots[(z - z0 + 1) & (kRing - 1)][ty + 1][VEC * (tx + 1)];
    const T* src = xy + nxy * z;
#pragma unroll
    for (int sy = -1; sy <= 1; ++sy) {
      if ((copies >> (3 * (sy + 1))) & 1u) {  // the point before
        copy_to_shared<sizeof(T)>(dst + sy * kW - 1, src + sy * nx - 1);
      }
      if ((copies >> (3 * (sy + 1) + 1)) & 1u) {  // the VEC points
        copy_to_shared<VEC * sizeof(T)>(dst + sy * kW, src + sy * nx);
      }
      if ((copies >> (3 * (sy + 1) + 2)) & 1u) {  // the point after
        copy_to_shared<sizeof(T)>(dst + sy * kW + VEC, src + sy * nx + VEC);
      }
    }
  }
  cp_async_commit();
}

// present: bit k set when the stencil has the box's diagonal k (ND =
// 27); the star has all of its 7.  A diagonal the stencil lacks gets
// coefficient 0 and a mask bit that is never set, so its term is
// fma(0, 0, acc) == acc: the sum of the diagonals present, in order.
// V: coefficients, T: x and y; K: how a term rounds (dtypes.cuh)
template <typename V, typename T, int ND, int VEC, int K>
__global__ void __launch_bounds__(kMaxThreads)
stencil_tile_kernel(const V* __restrict__ coefs, const T* __restrict__ x,
                    T* __restrict__ y, int nx, int ny, int nz, int zchunk,
                    unsigned present) {
  using C = typename Compute<T>::type;
  constexpr int kW = kSlotW<VEC>;
  __shared__ __align__(16) T slots[kRing][kSlotH][kW];
  constexpr unsigned kAll = (1u << ND) - 1u;
  constexpr unsigned kLo = z_bits(ND, -1), kHi = z_bits(ND, 1);
  constexpr unsigned kRows = row_bits(ND);
  const unsigned pm = ND == 27 ? present : kAll;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // the first of this thread's VEC points; nx % VEC == 0, so all VEC
  // lie inside the grid or none does
  const int ix = (blockIdx.x * blockDim.x + tx) * VEC;
  const int iy = blockIdx.y * blockDim.y + ty;
  const bool active = ix < nx && iy < ny;

  // the box's coefficients, those of the diagonals present in order
  // and 0 elsewhere, staged once per block so that each is read at a
  // fixed address, as the star reads coefs[k]
  __shared__ C box_coefs[ND == 27 ? ND : 1];
  if constexpr (ND == 27) {
    for (int k = ty * blockDim.x + tx; k < ND; k += blockDim.x * blockDim.y) {
      box_coefs[k] =
          (pm >> k) & 1u ? C(ldg_c(coefs + __popc(pm & ((1u << k) - 1u))))
                         : C(0);
    }
    __syncthreads();
  }
  C c[ND];
  unsigned mxy[VEC];  // bit k: point j's neighbour k inside on x and y
#pragma unroll
  for (int j = 0; j < VEC; ++j) mxy[j] = 0;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const bool has = (pm >> k) & 1u;
    c[k] = ND == 27 ? box_coefs[k] : C(ldg_c(coefs + k));
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const bool in = has &&
                      static_cast<unsigned>(ix + j + step_x(ND, k)) <
                          static_cast<unsigned>(nx) &&
                      static_cast<unsigned>(iy + step_y(ND, k)) <
                          static_cast<unsigned>(ny);
      mxy[j] |= static_cast<unsigned>(in) << k;
    }
  }
  // bit 3 * (sy + 1) + (sx + 1): this thread copies, of row iy + sy of
  // each plane, its own VEC points (sx = 0) and, on the tile's edges,
  // the halo point before (sx = -1) or after (sx = 1) them; rows beside
  // its own only on the tile's edges, corners only for the box.  Points
  // outside the grid are never read, so never copied.
  unsigned copies = 0;
#pragma unroll
  for (int sy = -1; sy <= 1; ++sy) {
#pragma unroll
    for (int sx = -1; sx <= 1; ++sx) {
      const bool edge =
          (sx == 0 || tx == (sx < 0 ? 0 : static_cast<int>(blockDim.x) - 1)) &&
          (sy == 0 || ty == (sy < 0 ? 0 : static_cast<int>(blockDim.y) - 1));
      const int px = sx < 0 ? ix - 1 : sx > 0 ? ix + VEC : ix;
      const bool in =
          static_cast<unsigned>(px) < static_cast<unsigned>(nx) &&
          static_cast<unsigned>(iy + sy) < static_cast<unsigned>(ny);
      if (edge && in && (ND == 27 || sx == 0 || sy == 0)) {
        copies |= 1u << (3 * (sy + 1) + (sx + 1));
      }
    }
  }

  const int64_t nxy = static_cast<int64_t>(nx) * ny;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(z0 + zchunk, nz);
  const int64_t ixy = ix + static_cast<int64_t>(nx) * iy;
  const T* xy = x + ixy;

  for (int z = z0 - 1; z <= z0 + kAhead; ++z) {
    copy_plane<VEC>(slots, xy, nxy, nx, nz, z, z0, z1, tx, ty, copies);
  }
  for (int iz = z0; iz < z1; ++iz) {
    cp_async_wait<kAhead - 1>();  // this thread's copies up to iz + 1
    __syncthreads();  // everyone's; and plane iz - 2 is read no more
    // into plane iz - 2's slot
    copy_plane<VEC>(slots, xy, nxy, nx, nz, iz + kAhead + 1, z0, z1, tx, ty,
                    copies);
    if (!active) continue;
    unsigned zm = kAll;
    if (iz == 0) zm &= ~kLo;
    if (iz == nz - 1) zm &= ~kHi;
    // the slot rows (iz + dz, iy + dy) this thread reads: the point
    // before its VEC points, the VEC points, the point after
    C r[3][3][VEC + 2];
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const unsigned use = kRows >> (9 * (dz + 1) + 3 * (dy + 1));
        if (!(use & 2u)) continue;
        const T* row = &slots[(iz - z0 + 1 + dz) & (kRing - 1)][ty + 1 + dy]
                             [VEC * (tx + 1)];
        load_vec<VEC>(row, &r[dz + 1][dy + 1][1]);
        if (use & 1u) r[dz + 1][dy + 1][0] = to_c(row[-1]);
        if (use & 4u) r[dz + 1][dy + 1][VEC + 1] = to_c(row[VEC]);
      }
    }
    bool all = true;
#pragma unroll
    for (int j = 0; j < VEC; ++j) all = all && (mxy[j] & zm) == kAll;
    C out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const unsigned m = mxy[j] & zm;
      C acc = C(0);
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const C v = r[step_z(ND, k) + 1][step_y(ND, k) + 1]
                     [j + 1 + step_x(ND, k)];
        acc = Term<K>::f(acc, c[k], all || ((m >> k) & 1u) ? v : C(0));
      }
      out[j] = acc;
    }
    store_vec<VEC>(y + ixy + nxy * iz, out);
  }
  cp_async_wait<0>();
}

// nd (<= 27) diagonals with any steps; planes outside [zlo, zhi) have
// a z neighbour outside the grid
template <typename V, typename T, int K>
__global__ void __launch_bounds__(kMaxThreads)
stencil_spmv_kernel(const V* __restrict__ coefs, const Steps st, int nd,
                    const T* __restrict__ x, T* __restrict__ y, int nx,
                    int ny, int nz, int zchunk, int zlo, int zhi) {
  using C = typename Compute<T>::type;
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= nx || iy >= ny) return;

  C c[kMaxDiags];
  unsigned mxy = 0;  // bit k: neighbour k inside the grid on x and y
#pragma unroll
  for (int k = 0; k < kMaxDiags; ++k) {
    c[k] = C(0);
    if (k < nd) {
      c[k] = C(ldg_c(coefs + k));
      const bool in = static_cast<unsigned>(ix + st.dx[k]) <
                          static_cast<unsigned>(nx) &&
                      static_cast<unsigned>(iy + st.dy[k]) <
                          static_cast<unsigned>(ny);
      mxy |= static_cast<unsigned>(in) << k;
    }
  }

  const int64_t nxy = static_cast<int64_t>(nx) * ny;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = min(z0 + zchunk, nz);
  const int64_t i0 = ix + static_cast<int64_t>(nx) * iy + nxy * z0;
  const T* xi = x + i0;
  T* yi = y + i0;
  for (int iz = z0; iz < z1; ++iz, xi += nxy, yi += nxy) {
    unsigned m = mxy;
    if (iz < zlo || iz >= zhi) {  // uniform over the block
#pragma unroll
      for (int k = 0; k < kMaxDiags; ++k) {
        if (k < nd && static_cast<unsigned>(iz + st.dz[k]) >=
                          static_cast<unsigned>(nz)) {
          m &= ~(1u << k);
        }
      }
    }
    C acc = C(0);
#pragma unroll
    for (int k = 0; k < kMaxDiags; ++k) {
      if (k < nd) {
        const C xj = (m >> k) & 1u ? ldg_c(xi + st.off[k]) : C(0);
        acc = Term<K>::f(acc, c[k], xj);
      }
    }
    store_y(yi, acc);
  }
}

template <typename V, typename T>
using TileKernel = void (*)(const V*, const T*, T*, int, int, int, int,
                            unsigned);

// the tile kernel for the star (nd_inst 7, vec 1 or 16 / sizeof(T)
// points per thread) or a subset of the box (27, vec 1), or null
template <typename V, typename T, int K>
TileKernel<V, T> tile_kernel(int nd_inst, int vec) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (nd_inst == 7 && vec == 1) return stencil_tile_kernel<V, T, 7, 1, K>;
  if (nd_inst == 7 && vec == kV) return stencil_tile_kernel<V, T, 7, kV, K>;
  if (nd_inst == 27 && vec == 1) return stencil_tile_kernel<V, T, 27, 1, K>;
  return nullptr;
}

// a: nd, nx, ny, nz, gx, gy, gz, bx, by, zchunk, nd_inst, vec, then
// (dx, dy, dz) per diagonal (see stencil_spmv_f32)
template <typename V, typename T, int K>
int launch(const void* coefs, const void* x, void* y, const int* a,
           void* stream) {
  const int nd = a[0], nx = a[1], ny = a[2], nz = a[3], gx = a[4],
            gy = a[5], gz = a[6], bx = a[7], by = a[8], zchunk = a[9],
            nd_inst = a[10], vec = a[11];
  const int* steps = a + 12;
  bool ok =
      nd >= 1 && nd <= kMaxDiags &&
      (nd_inst == 0 || nd_inst == 27 || nd_inst == nd) &&
      nx > 0 && ny > 0 && nz > 0 && bx > 0 && by > 0 &&
      bx * by <= kMaxThreads && zchunk > 0 && gx > 0 && gy > 0 && gz > 0 &&
      gy <= kMaxGridYZ && gz <= kMaxGridYZ && vec > 0 && nx % vec == 0 &&
      static_cast<long long>(gx) * bx * vec >= nx &&
      static_cast<long long>(gy) * by >= ny &&
      static_cast<long long>(gz) * zchunk >= nz;
  const TileKernel<V, T> tile = tile_kernel<V, T, K>(nd_inst, vec);
  unsigned present = 0;
  if (nd_inst == 0) {
    ok = ok && vec == 1;
  } else {  // the tile kernel's block, alignment and steps
    ok = ok && tile != nullptr && bx <= kTileX && by <= kTileY &&
         (vec == 1 || (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0));
    // the star's steps exactly; or diagonals of the box in its order
    int last = -1;
    for (int k = 0; ok && k < nd; ++k) {
      const int dx = steps[3 * k], dy = steps[3 * k + 1],
                dz = steps[3 * k + 2];
      if (nd_inst == 7) {
        ok = dx == step_x(7, k) && dy == step_y(7, k) && dz == step_z(7, k);
        present |= 1u << k;
        continue;
      }
      const int b = 9 * (dz + 1) + 3 * (dy + 1) + (dx + 1);
      ok = dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1 && dz >= -1 &&
           dz <= 1 && b > last;
      if (ok) present |= 1u << b;
      last = b;
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gx, gy, gz), block(bx, by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* c = static_cast<const V*>(coefs);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (nd_inst != 0) {
    tile<<<grid, block, 0, s>>>(c, xx, yy, nx, ny, nz, zchunk, present);
    return static_cast<int>(cudaGetLastError());
  }
  Steps st{};
  const long long nxy = static_cast<long long>(nx) * ny;
  int zlo = 0, zhi = nz;
  for (int k = 0; k < nd; ++k) {
    const int dx = steps[3 * k], dy = steps[3 * k + 1], dz = steps[3 * k + 2];
    const long long off = dx + static_cast<long long>(nx) * dy + nxy * dz;
    if (off > INT_MAX || off < INT_MIN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    st.off[k] = static_cast<int>(off);
    st.dx[k] = dx;
    st.dy[k] = dy;
    st.dz[k] = dz;
    if (-dz > zlo) zlo = -dz;
    if (nz - dz < zhi) zhi = nz - dz;
  }
  stencil_spmv_kernel<V, T, K><<<grid, block, 0, s>>>(
      c, st, nd, xx, yy, nx, ny, nz, zchunk, zlo, zhi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coefs: nd device scalars; args: 12 + 3 * nd host ints, one array
// built once per stencil: nd, the grid (nx, ny, nz), then from
// ops/stencil.py:stencil_launch_plan the blocks (gx, gy, gz), threads
// (bx, by), zchunk, nd_inst (7: the star, 27: a subset of the box, both
// on the tile kernel; 0: any stencil) and vec (x points per thread),
// then (dx, dy, dz) per diagonal in offsets order
extern "C" int stencil_spmv_f32(const void* coefs, const void* x, void* y,
                                const int* args, void* stream) {
  return launch<float, float, 0>(coefs, x, y, args, stream);
}

extern "C" int stencil_spmv_f64(const void* coefs, const void* x, void* y,
                                const int* args, void* stream) {
  return launch<double, double, 0>(coefs, x, y, args, stream);
}

extern "C" int stencil_spmv_bf16(const void* coefs, const void* x, void* y,
                                 const int* args, void* stream) {
  return launch<bf16, bf16, 2>(coefs, x, y, args, stream);
}

// the C API's mixed modes under MATRIX_FREE: f32 coefficients with f64 x
// and y (dDFI / dIFI), bf16 coefficients with f32 x and y (dFBI); each
// product, then each sum, rounded in the wider type (dtypes.cuh Term<1>),
// so that each returns the bits of its plain version and of
// dia_spmv_f32_f64 / dia_spmv_bf16_f32 on the same matrix
extern "C" int stencil_spmv_f32_f64(const void* coefs, const void* x,
                                    void* y, const int* args,
                                    void* stream) {
  return launch<float, double, 1>(coefs, x, y, args, stream);
}

extern "C" int stencil_spmv_bf16_f32(const void* coefs, const void* x,
                                     void* y, const int* args,
                                     void* stream) {
  return launch<bf16, float, 1>(coefs, x, y, args, stream);
}

// the complex modes: dZZI (c128), dCCI (c64), dZCI (c64 coefficients,
// c128 x and y); each term the complex rule of dtypes.cuh in offsets
// order from +0, as dia_spmv_c64 / _c128 / _c64_c128 sum, so the two
// agree bit for bit.  A 16-byte vector holds two c64 points or one c128
extern "C" int stencil_spmv_c64(const void* coefs, const void* x, void* y,
                                const int* args, void* stream) {
  return launch<c64, c64, 0>(coefs, x, y, args, stream);
}

extern "C" int stencil_spmv_c128(const void* coefs, const void* x, void* y,
                                 const int* args, void* stream) {
  return launch<c128, c128, 0>(coefs, x, y, args, stream);
}

extern "C" int stencil_spmv_c64_c128(const void* coefs, const void* x,
                                     void* y, const int* args,
                                     void* stream) {
  return launch<c64, c128, 1>(coefs, x, y, args, stream);
}
