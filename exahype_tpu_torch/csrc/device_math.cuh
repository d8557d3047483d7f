// Overloads of the elementary functions for float and double, so that code
// templated on the value type (the port's kernels, the generated spec
// kernels) calls one name for both.  IEEE division and square root: the
// port compiles without fast math.
#pragma once

__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float dmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double dmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float dpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dpow(double a, double b) { return pow(a, b); }
