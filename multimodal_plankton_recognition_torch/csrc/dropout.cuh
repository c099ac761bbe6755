// Counter-based dropout bits shared by attention_fwd.cu and attention_bwd.cu.
//
// The TPU kernels seed the TPU PRNG per sample; a CUDA kernel has no such
// stream, so each probability (sample b, head h, query row r, key j) gets
// 32 bits from a hash of its coordinates instead:
//   key  = fmix32(seed ^ fmix32(b * H + h + 1))
//   bits = fmix32(key ^ fmix32(r * L + j + 1))
// fmix32 is MurmurHash3's finaliser. The forward and the backward
// regenerate the same mask with nothing stored, and ops/attention.py
// (dropout_bits) computes the same bits with int64 tensor ops. A
// probability is kept when bits >= thr, thr = round(p * 2^32).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// per (sample, head): bh = b * H + h
__device__ __forceinline__ uint32_t dropout_key(uint32_t seed, uint32_t bh) {
  return fmix32(seed ^ fmix32(bh + 1u));
}

// per probability: idx = r * L + j
__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, uint32_t idx) {
  return fmix32(key ^ fmix32(idx + 1u));
}
