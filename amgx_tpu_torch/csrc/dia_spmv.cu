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
// planes once, x once and write y once: sizeof(T) * n * (nd + 2) bytes
// (75.5 MB in f32 for the 2,097,152-row, 7-diagonal Poisson level, 22.5
// us at the H100 SXM's 3.35 TB/s; half that in bf16).  It does 2 * nd
// flops per row, far below the card's flop rate.
//
// The first design (one thread a row; per term a dependent __ldg of the
// offset, a bounds-checked scalar x load and a scalar plane load; nd a
// runtime count) was bound by its instruction stream and load latency:
// in bf16, half the bytes of f32 bought 18 % of the time (PERF.md).
// This design, for every instantiation:
//   * a host launch plan (ops/dia.py:dia_launch_plan), checked here:
//     vec rows a thread (one plane vector of 8 bytes: 4 rows in bf16, 2
//     in f32, 1 in f64, where n and the pointers' alignment allow; fewer
//     where that would leave SMs without a block; the kernel takes up to
//     16 bytes, which measured slower: 96 registers a thread in bf16,
//     two blocks an SM), the instantiation (nd_inst 7: the diagonal
//     count compiled in, the 7-point operators of every DIA level of the
//     repo's hierarchies; 0: a runtime count up to 48, its diagonals
//     taken in chunks of kChunk) and an exact grid of one thread per vec
//     rows;
//   * the offsets by value, in a 48-int kernel parameter struct (the
//     constant bank): no device load per term;
//   * loads in flight: each thread issues its plane vectors (ld.global.cs:
//     read once, evicted first) and its x windows before the arithmetic,
//     then writes y as one vector;
//   * the x window x[i + off, i + off + vec) is unaligned for most
//     offsets.  In bf16 its two aligned vectors are loaded through L1
//     (the neighbouring threads' windows share their lines) and shifted
//     into place by off mod vec elements: whole 32-bit words by selects,
//     the half word by __byte_perm.  The shift is the same for every
//     thread (i is a multiple of vec), so nothing diverges: this is the
//     counterpart of the Pallas kernel's lane rotation
//     (pallas_dia.py:94-103).  In f32 and f64 each row's x is one scalar
//     load through L1 (load_x_window says why);
//   * out-of-range columns read zeros without padding x;
//   * the bitwise contracts stay: per row the sum starts from +0.0 and
//     runs in offset order with one fma per diagonal in f32 and f64, the
//     masked terms included (fma(v, 0, acc) == acc), so MATRIX_FREE
//     (stencil_spmv.cu) agrees with DIA bit for bit; in bf16 each
//     product and each sum is rounded to bf16 in offset order, in f32
//     registers (dtypes.cuh Term<2>), as the plain version
//     (ops/dia.py:dia_spmv_plain) and the Pallas kernel's bf16
//     accumulator round, so the kernel returns the plain version's bits.
//     Packed bf16x2 arithmetic would round a product once where torch
//     rounds it to f32 first, which differs in the f32 subnormal range,
//     so the f32 emulation stays.
//   * the mixed pairs of the C API's mixed modes (dia_spmv_f32_f64 for
//     dDFI / dIFI, dia_spmv_bf16_f32 for dFBI) take the same kernel with
//     the plane type V and the x and y type X apart: plane vectors of VEC
//     values of V, x one scalar load of X a row, y a vector of VEC values
//     of X, each term rounded in X (Term<1>), so that they too return the
//     plain version's bits.
//
// The complex entry points (c64, c128, and c64 planes under c128 x for
// dZCI) take one row a thread: a complex element is already an 8- or
// 16-byte vector.  Each term is dtypes.cuh's complex rule.  Bound: bytes,
// 8 or 16 a value.
//
// Batched entry points (dia_spmv_batched_f32 / _f64 / _c64 / _c128, for
// the serve layer's groups of same-pattern systems, amgx_tpu_torch/serve): B
// instances of one structure, planes (B, nd, n) (or one (nd, n) set
// shared by every instance: a batch stride of 0), x and y (B, n).  The
// batch is the grid's y axis; each instance runs the unbatched kernel's
// code on its own slices with the same launch plan, so each instance's y
// is the unbatched entry point's bit for bit.  This is the TPU package's
// _dia_kernel under jax.vmap (amgx_tpu/serve/batched.py), whose batch
// Pallas adds as an outer grid axis.  Bound: bytes, B times the
// unbatched call's planes, x and y (the planes once when shared).
//
// Plain C interface, loaded with ctypes (amgx_tpu_torch/ops/kernels.py).
// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it does not
// take) so the caller can raise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

using namespace spmv_types;

constexpr int kThreads = 256;
constexpr int kMaxDiags = 48;
// diagonals a thread keeps in flight at once under a runtime count
constexpr int kChunk = 8;

// the offsets by value (kernel parameters live in the constant bank)
struct DiaOffsets {
  int off[kMaxDiags];
};

// 32-bit words of a vector of W words: loaded streaming (plane values)
// or through the read-only path (x), and stored
template <int W, bool STREAM>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (W == 4) {
    const uint4* q = static_cast<const uint4*>(p);
    uint4 u;
    if constexpr (STREAM) u = __ldcs(q); else u = __ldg(q);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (W == 2) {
    const uint2* q = static_cast<const uint2*>(p);
    uint2 u;
    if constexpr (STREAM) u = __ldcs(q); else u = __ldg(q);
    w[0] = u.x, w[1] = u.y;
  } else {
    const unsigned int* q = static_cast<const unsigned int*>(p);
    if constexpr (STREAM) w[0] = __ldcs(q); else w[0] = __ldg(q);
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  if constexpr (W == 4) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (W == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *static_cast<unsigned int*>(p) = w[0];
  }
}

// the unsigned integer of T's size
template <typename T> struct Bits;
template <> struct Bits<bf16> { using type = unsigned short; };
template <> struct Bits<float> { using type = unsigned int; };
template <> struct Bits<double> { using type = unsigned long long; };

// element e of the elements of T packed in words w, in the compute type
template <typename T>
__device__ __forceinline__ typename Compute<T>::type elem(const uint32_t* w,
                                                          int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = w[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    return __hiloint2double(static_cast<int>(w[2 * e + 1]),
                            static_cast<int>(w[2 * e]));
  }
}

// VEC compute values rounded to T and packed into words
template <typename T, int VEC>
__device__ __forceinline__ void pack(const typename Compute<T>::type* v,
                                     uint32_t* w) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w[2 * j] = static_cast<uint32_t>(__double2loint(v[j]));
      w[2 * j + 1] = static_cast<uint32_t>(__double2hiint(v[j]));
    }
  }
}

// How a thread reads its x window x[i0 + off, i0 + off + VEC), zeros
// outside [0, n) (measured both ways on the H100, PERF.md): bf16, two
// elements a 32-bit word, as the two aligned VEC-element vectors at a =
// i0 + off - r and a + VEC, r = off mod VEC, shifted down by r elements
// (a scalar 2-byte load a row issues an instruction for every 64 bytes
// a warp moves); f32 and f64 as one scalar load a row through L1, which
// ties with the realigned vectors on the 7-point operators and beats
// them at runtime counts, where the shifts' selects cost registers.
// Building with -DDIA_X_WAY=1 (scalar loads for every type) or 2
// (realigned vectors for every type) gives the other way, for
// ci/torch_dia_compare.py --sweep only.
#ifndef DIA_X_WAY
#define DIA_X_WAY 0
#endif
template <typename T>
__host__ __device__ constexpr bool scalar_x() {
  return DIA_X_WAY == 1 || (DIA_X_WAY == 0 && sizeof(T) > 2);
}

// The window as the first W of the words w (2 W of them).  r is the same
// for every thread, so the realigned way's branches are uniform.
template <typename T, int VEC>
__device__ __forceinline__ void load_x_window(const T* __restrict__ x,
                                              int64_t n, int64_t i0,
                                              int off, uint32_t* w) {
  constexpr int W = VEC * static_cast<int>(sizeof(T)) / 4;
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) w[j] = 0u;
  if constexpr (scalar_x<T>()) {
    using U = typename Bits<T>::type;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int64_t j = i0 + off + e;
      const unsigned long long u =
          (j >= 0 && j < n) ? __ldg(reinterpret_cast<const U*>(x) + j) : 0u;
      if constexpr (sizeof(T) == 2) {
        w[e >> 1] |= static_cast<uint32_t>(u) << (16 * (e & 1));
      } else if constexpr (sizeof(T) == 4) {
        w[e] = static_cast<uint32_t>(u);
      } else {
        w[2 * e] = static_cast<uint32_t>(u);
        w[2 * e + 1] = static_cast<uint32_t>(u >> 32);
      }
    }
  } else {
    // n is a multiple of VEC, so an aligned vector lies wholly inside
    // [0, n) or wholly outside it, and one outside is not loaded
    const int r = off & (VEC - 1);
    const int64_t a = i0 + off - r;
    if (a >= 0 && a < n) load_words<W, false>(x + a, w);
    if (r != 0 && a + VEC >= 0 && a + VEC < n) {
      load_words<W, false>(x + a + VEC, w + W);
    }
  }
}

// the realigned way's shift: whole words by selects, then half a word
template <typename T, int VEC>
__device__ __forceinline__ void shift_window(uint32_t* w, int off) {
  if constexpr (!scalar_x<T>()) {
    constexpr int W = VEC * static_cast<int>(sizeof(T)) / 4;
    const int b = (off & (VEC - 1)) * static_cast<int>(sizeof(T));  // bytes
    const int q = b >> 2;                                           // words
    if constexpr (W >= 4) {
      if (q & 2) {
#pragma unroll
        for (int j = 0; j + 2 < 2 * W; ++j) w[j] = w[j + 2];
      }
    }
    if constexpr (W >= 2) {
      if (q & 1) {
#pragma unroll
        for (int j = 0; j + 1 < 2 * W; ++j) w[j] = w[j + 1];
      }
    }
    if constexpr (sizeof(T) == 2) {
      if (b & 2) {  // bytes 2..5 of the pair (w[j], w[j + 1])
#pragma unroll
        for (int j = 0; j < W; ++j) {
          w[j] = __byte_perm(w[j], w[j + 1], 0x5432);
        }
      }
    }
  }
}

// acc[e] += the terms of diagonals o[0..cnt) for rows i0 + e, e < VEC,
// in offset order; v points at row i0 of the first of those planes.  All
// the chunk's loads are issued before its arithmetic.  A plane vector
// holds VEC values of V, an x window VEC values of X (the two differ in
// width for the mixed pairs); both convert to X's compute type.
template <typename V, typename X, int K, int VEC, int CH>
__device__ __forceinline__ void add_diagonals(
    const V* __restrict__ v, int64_t n, const X* __restrict__ x, int64_t i0,
    const int (&o)[CH], int cnt, typename Compute<X>::type (&acc)[VEC]) {
  using C = typename Compute<X>::type;
  if constexpr (VEC == 1) {
    C pv[CH], xv[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < cnt) {
        pv[c] = C(ldcs_c(v + c * n));
        const int64_t j = i0 + o[c];
        xv[c] = (j >= 0 && j < n) ? C(ldg_c(x + j)) : C(0);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < cnt) acc[0] = Term<K>::f(acc[0], pv[c], xv[c]);
    }
  } else {
    constexpr int WV = VEC * static_cast<int>(sizeof(V)) / 4;
    constexpr int WX = VEC * static_cast<int>(sizeof(X)) / 4;
    uint32_t pw[CH][WV], xw[CH][2 * WX];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < cnt) {
        load_words<WV, true>(v + c * n, pw[c]);
        load_x_window<X, VEC>(x, n, i0, o[c], xw[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c < cnt) {
        shift_window<X, VEC>(xw[c], o[c]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[e] = Term<K>::f(acc[e], C(elem<V>(pw[c], e)),
                              C(elem<X>(xw[c], e)));
        }
      }
    }
  }
}

// V: values; X: x and y (the promoted type: X itself for every pair
// built); K: how a term rounds (dtypes.cuh); VEC: rows a thread; ND:
// the diagonal count (7), or 0 for the runtime count nd
template <typename V, typename X, int K, int VEC, int ND>
__global__ void __launch_bounds__(kThreads, 2)
dia_spmv_kernel(const V* __restrict__ vals, const X* __restrict__ x,
                X* __restrict__ y, int64_t n, int nd, const DiaOffsets offs,
                int64_t vstride) {
  using C = typename Compute<X>::type;
  // instance blockIdx.y of a batch (0 unbatched): its planes start
  // vstride values in (0: shared), its x and y n values in
  vals += static_cast<int64_t>(blockIdx.y) * vstride;
  x += static_cast<int64_t>(blockIdx.y) * n;
  y += static_cast<int64_t>(blockIdx.y) * n;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (i0 >= n) return;
  C acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = C(0);
  if constexpr (ND > 0) {
    int o[ND];
#pragma unroll
    for (int c = 0; c < ND; ++c) o[c] = offs.off[c];
    add_diagonals<V, X, K, VEC, ND>(vals + i0, n, x, i0, o, ND, acc);
  } else {
    for (int k0 = 0; k0 < nd; k0 += kChunk) {
      int o[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        o[c] = k0 + c < nd ? offs.off[k0 + c] : 0;
      }
      add_diagonals<V, X, K, VEC, kChunk>(vals + k0 * n + i0, n, x, i0, o,
                                          nd - k0, acc);
    }
  }
  if constexpr (VEC == 1) {
    store_y(y + i0, acc[0]);
  } else {
    constexpr int W = VEC * static_cast<int>(sizeof(X)) / 4;
    uint32_t w[W];
    pack<X, VEC>(acc, w);
    store_words<W>(y + i0, w);
  }
}

template <typename V, typename X, int K, int VEC>
void launch_vec(int nd_inst, dim3 grid, cudaStream_t s, const V* vals,
                const X* x, X* y, int64_t n, int nd, const DiaOffsets& o,
                int64_t vstride) {
  if (nd_inst == 7) {
    dia_spmv_kernel<V, X, K, VEC, 7><<<grid, kThreads, 0, s>>>(
        vals, x, y, n, nd, o, vstride);
  } else {
    dia_spmv_kernel<V, X, K, VEC, 0><<<grid, kThreads, 0, s>>>(
        vals, x, y, n, nd, o, vstride);
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// a: nd, nd_inst, vec, threads, blocks, then the nd offsets (see
// dia_spmv_f32).  A vector of the wider of V and X is at most 16 bytes.
// batch instances (the grid's y axis, at most 65535), their planes
// shared when `shared` is set
template <typename V, typename X, int K>
int launch(const void* vals, const void* x, void* y, long long n,
           const int* a, void* stream, long long batch = 1,
           int shared = 0) {
  constexpr int kWide = static_cast<int>(sizeof(V) > sizeof(X) ? sizeof(V)
                                                               : sizeof(X));
  // a complex element is one vector load already: one row a thread
  constexpr int kMaxVec =
      IsComplex<V>::value || IsComplex<X>::value ? 1 : 16 / kWide;
  const int nd = a[0], nd_inst = a[1], vec = a[2], threads = a[3],
            blocks = a[4];
  const int* offsets = a + 5;
  const long long rows_per_block = static_cast<long long>(threads) * vec;
  bool ok = n > 0 && nd >= 1 && nd <= kMaxDiags &&
            (nd_inst == 0 || (nd_inst == 7 && nd == 7)) &&
            (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
            vec <= kMaxVec && n % vec == 0 && threads == kThreads &&
            blocks > 0 && blocks * rows_per_block >= n &&
            (blocks - 1) * rows_per_block < n;
  const long long vbytes = static_cast<long long>(vec) * sizeof(V);
  const long long xbytes = static_cast<long long>(vec) * sizeof(X);
  ok = ok && aligned(vals, vbytes) && aligned(x, xbytes) &&
       aligned(y, xbytes) && batch >= 1 && batch <= 65535;
  DiaOffsets o{};
  for (int k = 0; ok && k < nd; ++k) {
    ok = offsets[k] > -n && offsets[k] < n;
    o.off[k] = offsets[k];
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(vals);
  const X* xx = static_cast<const X*>(x);
  X* yy = static_cast<X*>(y);
  const dim3 g(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  const int64_t vs = shared ? 0 : static_cast<int64_t>(nd) * n;
  if (vec == 1) {
    launch_vec<V, X, K, 1>(nd_inst, g, s, v, xx, yy, n, nd, o, vs);
  } else if constexpr (kMaxVec >= 2) {
    if (vec == 2) {
      launch_vec<V, X, K, 2>(nd_inst, g, s, v, xx, yy, n, nd, o, vs);
    } else if constexpr (kMaxVec >= 4) {
      if (vec == 4) {
        launch_vec<V, X, K, 4>(nd_inst, g, s, v, xx, yy, n, nd, o, vs);
      } else if constexpr (kMaxVec >= 8) {
        launch_vec<V, X, K, 8>(nd_inst, g, s, v, xx, yy, n, nd, o, vs);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals: nd planes of n values; x, y: n values; plan: 5 + nd host ints,
// one array built once per (n, offsets, dtype, alignment) by
// ops/dia.py:dia_launch_plan: nd, nd_inst (7 or 0), vec (rows a thread),
// threads (a block), blocks, then the nd offsets in order
extern "C" int dia_spmv_f32(const void* vals, const void* x, void* y,
                            long long n, const int* plan, void* stream) {
  return launch<float, float, 0>(vals, x, y, n, plan, stream);
}

extern "C" int dia_spmv_f64(const void* vals, const void* x, void* y,
                            long long n, const int* plan, void* stream) {
  return launch<double, double, 0>(vals, x, y, n, plan, stream);
}

extern "C" int dia_spmv_bf16(const void* vals, const void* x, void* y,
                             long long n, const int* plan, void* stream) {
  return launch<bf16, bf16, 2>(vals, x, y, n, plan, stream);
}

// the mixed pairs of dDFI / dIFI (f32 planes, f64 x and y) and dFBI
// (bf16 planes, f32 x and y): each product, then each sum, rounded in
// the wider type (dtypes.cuh Term<1>), in offset order from +0.0, as the
// plain version's torch promotion does, so the kernel returns its bits.
// x is the wider of the two, one scalar load a row (load_x_window); the
// plan (dia_launch_plan with x_dtype) sizes vec by the planes and keeps
// a vector of y within 16 bytes
extern "C" int dia_spmv_f32_f64(const void* vals, const void* x, void* y,
                                long long n, const int* plan, void* stream) {
  return launch<float, double, 1>(vals, x, y, n, plan, stream);
}

extern "C" int dia_spmv_bf16_f32(const void* vals, const void* x, void* y,
                                 long long n, const int* plan, void* stream) {
  return launch<bf16, float, 1>(vals, x, y, n, plan, stream);
}

// the complex modes: dZZI (c128), dCCI (c64) and dZCI (c64 planes, c128
// x and y), one row a thread (the plan's vec is 1 for a complex type),
// each term the complex rule of dtypes.cuh in offset order from +0, so
// that the stencil kernel's complex entry points return the same bits
extern "C" int dia_spmv_c64(const void* vals, const void* x, void* y,
                            long long n, const int* plan, void* stream) {
  return launch<c64, c64, 0>(vals, x, y, n, plan, stream);
}

extern "C" int dia_spmv_c128(const void* vals, const void* x, void* y,
                             long long n, const int* plan, void* stream) {
  return launch<c128, c128, 0>(vals, x, y, n, plan, stream);
}

extern "C" int dia_spmv_c64_c128(const void* vals, const void* x, void* y,
                                 long long n, const int* plan,
                                 void* stream) {
  return launch<c64, c128, 1>(vals, x, y, n, plan, stream);
}

// batch instances of one structure: planes (batch, nd, n), or one (nd,
// n) set shared by all (shared != 0); x and y (batch, n); the plan is
// the unbatched one for n rows (each instance's rows start at a multiple
// of n, so the plan's vectors stay aligned)
extern "C" int dia_spmv_batched_f32(const void* vals, const void* x, void* y,
                                    long long n, long long batch, int shared,
                                    const int* plan, void* stream) {
  return launch<float, float, 0>(vals, x, y, n, plan, stream, batch, shared);
}

extern "C" int dia_spmv_batched_f64(const void* vals, const void* x, void* y,
                                    long long n, long long batch, int shared,
                                    const int* plan, void* stream) {
  return launch<double, double, 0>(vals, x, y, n, plan, stream, batch,
                                   shared);
}

extern "C" int dia_spmv_batched_c64(const void* vals, const void* x, void* y,
                                    long long n, long long batch, int shared,
                                    const int* plan, void* stream) {
  return launch<c64, c64, 0>(vals, x, y, n, plan, stream, batch, shared);
}

extern "C" int dia_spmv_batched_c128(const void* vals, const void* x,
                                     void* y, long long n, long long batch,
                                     int shared, const int* plan,
                                     void* stream) {
  return launch<c128, c128, 0>(vals, x, y, n, plan, stream, batch, shared);
}
