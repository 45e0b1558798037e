// layer_norm_common.cuh: the row chunks that layer_norm_fwd.cu and
// layer_norm_bwd.cu share, for NVIDIA Hopper (sm_90a).
//
// A row of T (f32 or bf16) is taken as 16-byte chunks (4 f32 or 8 bf16),
// held in registers as uint4; each element is read and written by its
// bits.  Where a row is not 16-byte aligned, or F is no multiple of the
// chunk's width, the same chunks are loaded and stored element by element
// (VEC = false), zero past F.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Chunk { static constexpr int N = 16 / (int)sizeof(T); };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the bits of element e of a 16-byte chunk of T, and the element widened
template <typename T> __device__ __forceinline__ uint32_t elem_bits(const uint4& u, int e);
template <> __device__ __forceinline__ uint32_t elem_bits<float>(const uint4& u, int e) {
  return e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
}
template <> __device__ __forceinline__ uint32_t elem_bits<__nv_bfloat16>(const uint4& u, int e) {
  const int i = e >> 1;
  const uint32_t w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  return (e & 1) ? w >> 16 : w & 0xffffu;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int e) {
  const uint32_t b = elem_bits<T>(u, e);
  return __uint_as_float(sizeof(T) == 4 ? b : b << 16);
}

// the bits of f32 v rounded to T
template <typename T> __device__ __forceinline__ uint32_t round_bits(float v);
template <> __device__ __forceinline__ uint32_t round_bits<float>(float v) {
  return __float_as_uint(v);
}
template <> __device__ __forceinline__ uint32_t round_bits<__nv_bfloat16>(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// set element e of a chunk from its bits (the other bits of its word kept)
template <typename T> __device__ __forceinline__ void set_elem(uint4& u, int e, uint32_t b);
template <> __device__ __forceinline__ void set_elem<float>(uint4& u, int e, uint32_t b) {
  if (e == 0) u.x = b; else if (e == 1) u.y = b; else if (e == 2) u.z = b; else u.w = b;
}
template <> __device__ __forceinline__ void set_elem<__nv_bfloat16>(uint4& u, int e, uint32_t b) {
  const int i = e >> 1;
  uint32_t& w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  w = (e & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
}

// one element of T by its bits
__device__ __forceinline__ uint32_t load_bits(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ uint32_t load_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
__device__ __forceinline__ void store_bits(float* p, uint32_t b) { *reinterpret_cast<uint32_t*>(p) = b; }
__device__ __forceinline__ void store_bits(__nv_bfloat16* p, uint32_t b) {
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)b;
}

// chunk of T at column col of row r: a 16-byte load, or (VEC = false) the
// elements below F one by one, zero past F
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* r, int col, int F) {
  constexpr int VW = Chunk<T>::N;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    if (col < F) u = __ldg(reinterpret_cast<const uint4*>(r + col));
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      if (col + e < F) set_elem<T>(u, e, load_bits(r + col + e));
  }
  return u;
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* r, int col, int F, const uint4& u) {
  constexpr int VW = Chunk<T>::N;
  if (VEC) {
    if (col < F) *reinterpret_cast<uint4*>(r + col) = u;
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      if (col + e < F) store_bits(r + col + e, elem_bits<T>(u, e));
  }
}

// on the host: may a 16-byte load or store start at p
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
