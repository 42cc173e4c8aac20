// Value and vector types of the SpMV kernels (dia_spmv.cu, ell_spmv.cu,
// stencil_spmv.cu): loads into the compute type, the rounding of one
// term y += v * x, and the store of y.
//
// A kernel is instantiated for a pair (V, X) of value and vector types;
// y has JAX's promoted type (jnp.result_type(vals, x)), the wider of the
// two, and the arithmetic runs in it, as the JAX package's kernels and
// its XLA path do.  bf16 arithmetic runs in f32 registers, each result
// rounded to bf16 at once.  How a term rounds (Term<K>):
//
//   K = 0  one FMA in f32 or f64: values and vectors of one type f32 or
//          f64 (held to their plain versions within a tolerance);
//   K = 1  the product, then the sum, each rounded in the compute type
//          (f32 or f64): mixed pairs (bf16 values with f32 x, f32
//          values with f64 x), which the plain versions compute with
//          torch's promotion, one rounding per operation;
//   K = 2  the product, then the sum, each rounded to bf16: bf16 values
//          with bf16 x, as torch's bf16 operations and the Pallas TPU
//          kernels (accumulator in the output dtype) round.  A product
//          of two bf16 values is exact in f32, and an f32 sum of two
//          bf16 values rounded to bf16 is the correctly rounded bf16
//          sum (24 >= 2 * 8 + 2 bits), so each step equals the plain
//          version's bf16 operation.
//
// With K = 1 and 2 a kernel that sums in the plain version's order
// therefore returns its bits exactly.  The explicit __f*_rn / __d*_rn
// intrinsics keep nvcc from contracting a multiply and an add into an
// FMA there.
//
// Complex values (the C API's dZZI, dCCI and dZCI modes): c64 and c128,
// torch's complex64 and complex128, an (re, im) pair of f32 or f64
// aligned as float2 / double2 (8 and 16 bytes), so that each element is
// one vector load or store.  They compute in pairs of their own real
// type; the mixed pair (c64 values, c128 x) converts the values to c128,
// which is exact.  A term, for K = 0 and K = 1 alike:
//
//   re += vr * xr - vi * xi,   im += vr * xi + vi * xr,
//
// each real product, the difference, the sum and the accumulation
// rounded on its own (__f*_rn / __d*_rn), in that one order.  The DIA,
// ELL and stencil kernels share it, so the DIA and stencil kernels
// agree bit for bit on one complex matrix (the MATRIX_FREE contract): a
// masked term adds a +-0 pair, which leaves a sum started at +0 as it
// is.  torch's complex product may contract to an FMA, so the plain
// versions are held to the kernels within a tolerance, not bit for bit.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spmv_types {

using bf16 = __nv_bfloat16;

// a complex value: torch's layout, one 8- or 16-byte vector
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
  cplx() = default;
  __host__ __device__ constexpr cplx(R r, R i = R(0)) : re(r), im(i) {}
  // c64 -> c128 (exact)
  template <typename S>
  __host__ __device__ explicit constexpr cplx(cplx<S> o)
      : re(R(o.re)), im(R(o.im)) {}
};
using c64 = cplx<float>;
using c128 = cplx<double>;

template <typename T> struct IsComplex {
  static constexpr bool value = false;
};
template <typename R> struct IsComplex<cplx<R>> {
  static constexpr bool value = true;
};

// the type a stored value computes in
template <typename T> struct Compute { using type = T; };
template <> struct Compute<bf16> { using type = float; };

__device__ __forceinline__ float to_c(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }
__device__ __forceinline__ c64 to_c(c64 v) { return v; }
__device__ __forceinline__ c128 to_c(c128 v) { return v; }

// read-only-path and evict-first loads of one element (a complex one as
// one vector)
template <typename T>
__device__ __forceinline__ T ld_ro(const T* p) { return __ldg(p); }
__device__ __forceinline__ c64 ld_ro(const c64* p) {
  const float2 u = __ldg(reinterpret_cast<const float2*>(p));
  return c64(u.x, u.y);
}
__device__ __forceinline__ c128 ld_ro(const c128* p) {
  const double2 u = __ldg(reinterpret_cast<const double2*>(p));
  return c128(u.x, u.y);
}
template <typename T>
__device__ __forceinline__ T ld_cs(const T* p) { return __ldcs(p); }
__device__ __forceinline__ c64 ld_cs(const c64* p) {
  const float2 u = __ldcs(reinterpret_cast<const float2*>(p));
  return c64(u.x, u.y);
}
__device__ __forceinline__ c128 ld_cs(const c128* p) {
  const double2 u = __ldcs(reinterpret_cast<const double2*>(p));
  return c128(u.x, u.y);
}

// an evict-first store of one element
template <typename T>
__device__ __forceinline__ void st_cs(T* p, T v) { __stcs(p, v); }
__device__ __forceinline__ void st_cs(c64* p, c64 v) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v.re, v.im));
}
__device__ __forceinline__ void st_cs(c128* p, c128 v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v.re, v.im));
}

// read-only-path and evict-first loads, converted to the compute type
template <typename T>
__device__ __forceinline__ typename Compute<T>::type ldg_c(const T* p) {
  return to_c(ld_ro(p));
}
template <typename T>
__device__ __forceinline__ typename Compute<T>::type ldcs_c(const T* p) {
  return to_c(ld_cs(p));
}

// a compute value rounded to T and stored
__device__ __forceinline__ void store_y(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_y(c64* p, c64 v) { *p = v; }
__device__ __forceinline__ void store_y(c128* p, c128 v) { *p = v; }

// a warp's xor shuffle of a compute value (a complex one part by part)
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(cplx<R> v, int o) {
  return cplx<R>(shfl_xor(v.re, o), shfl_xor(v.im, o));
}

// the complex term and sum of the header comment, every real operation
// rounded on its own
__device__ __forceinline__ c64 cterm(c64 acc, c64 v, c64 x) {
  const float rr = __fmul_rn(v.re, x.re), ii = __fmul_rn(v.im, x.im);
  const float ri = __fmul_rn(v.re, x.im), ir = __fmul_rn(v.im, x.re);
  return c64(__fadd_rn(acc.re, __fsub_rn(rr, ii)),
             __fadd_rn(acc.im, __fadd_rn(ri, ir)));
}
__device__ __forceinline__ c128 cterm(c128 acc, c128 v, c128 x) {
  const double rr = __dmul_rn(v.re, x.re), ii = __dmul_rn(v.im, x.im);
  const double ri = __dmul_rn(v.re, x.im), ir = __dmul_rn(v.im, x.re);
  return c128(__dadd_rn(acc.re, __dsub_rn(rr, ii)),
              __dadd_rn(acc.im, __dadd_rn(ri, ir)));
}
__device__ __forceinline__ c64 cadd(c64 a, c64 b) {
  return c64(__fadd_rn(a.re, b.re), __fadd_rn(a.im, b.im));
}
__device__ __forceinline__ c128 cadd(c128 a, c128 b) {
  return c128(__dadd_rn(a.re, b.re), __dadd_rn(a.im, b.im));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int K> struct Term;
template <> struct Term<0> {
  static __device__ __forceinline__ float f(float acc, float v, float x) {
    return __fmaf_rn(v, x, acc);
  }
  static __device__ __forceinline__ double f(double acc, double v,
                                             double x) {
    return __fma_rn(v, x, acc);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return a + b;
  }
  template <typename R>
  static __device__ __forceinline__ cplx<R> f(cplx<R> acc, cplx<R> v,
                                              cplx<R> x) {
    return cterm(acc, v, x);
  }
  template <typename R>
  static __device__ __forceinline__ cplx<R> add(cplx<R> a, cplx<R> b) {
    return cadd(a, b);
  }
};
template <> struct Term<1> {
  static __device__ __forceinline__ float f(float acc, float v, float x) {
    return __fadd_rn(acc, __fmul_rn(v, x));
  }
  static __device__ __forceinline__ double f(double acc, double v,
                                             double x) {
    return __dadd_rn(acc, __dmul_rn(v, x));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  template <typename R>
  static __device__ __forceinline__ cplx<R> f(cplx<R> acc, cplx<R> v,
                                              cplx<R> x) {
    return cterm(acc, v, x);
  }
  template <typename R>
  static __device__ __forceinline__ cplx<R> add(cplx<R> a, cplx<R> b) {
    return cadd(a, b);
  }
};
template <> struct Term<2> {
  static __device__ __forceinline__ float f(float acc, float v, float x) {
    return round_bf16(__fadd_rn(acc, round_bf16(__fmul_rn(v, x))));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return round_bf16(__fadd_rn(a, b));
  }
};

}  // namespace spmv_types
