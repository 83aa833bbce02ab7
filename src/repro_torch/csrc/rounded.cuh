// Explicitly rounded arithmetic for the kernels that must equal their
// plain versions bit for bit (sturm_count.cu) or follow them operation by
// operation (sterf.cu): each operation is an intrinsic rounded on its own,
// so nvcc cannot contract a product and a sum into an FMA, which eager
// PyTorch and Python on the CPU never do.
#pragma once

#include <cuda_runtime.h>

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};
