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

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spmv_types {

using bf16 = __nv_bfloat16;

// the type a stored value computes in
template <typename T> struct Compute { using type = T; };
template <> struct Compute<bf16> { using type = float; };

__device__ __forceinline__ float to_c(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

// read-only-path and evict-first loads, converted to the compute type
template <typename T>
__device__ __forceinline__ typename Compute<T>::type ldg_c(const T* p) {
  return to_c(__ldg(p));
}
template <typename T>
__device__ __forceinline__ typename Compute<T>::type ldcs_c(const T* p) {
  return to_c(__ldcs(p));
}

// a compute value rounded to T and stored
__device__ __forceinline__ void store_y(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(double* p, double v) { *p = v; }

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
