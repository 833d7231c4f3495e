// Tensor-core tile of a dilated conv1d for Hopper (sm_90a), shared by the
// bf16 paths of csrc/resblock.cu and csrc/stage.cu.
//
// One conv over a tile of positions is an implicit GEMM, a sum over taps j
// of A_j . W_j with
//
//   A_j[p, ci] = act[p + j*dil, ci]   (bf16, activations in shared memory)
//   W_j[ci, co]                       (bf16, the tap's weight slice)
//
// M is positions, K is C_in and N is C_out, as in the JAX kernel's
// `shifted[:tile] @ w_ref[j]` (mimic3_tpu/ops/resblock.py).  The sums are
// float32.
//
// Layout.  Activations sit in shared memory as [rows][ld] bf16, channels
// contiguous, with ld = C_in (padded to a multiple of 16) + 8: a row is a
// whole number of 16-byte units and eight consecutive rows start in eight
// different 4-bank groups, so ldmatrix reads them without bank conflicts.
// A tap's shift j*dil is then a whole-row offset, which ldmatrix takes at
// any row.  A fragments come from ldmatrix.x4 at the shifted row; the MMA
// is mma.sync.m16n8k16 (HMMA in SASS).
//
// Weights.  The host packs each conv once (ops/mma.py) in the order the
// B operand's registers want them: for tap j, 16-deep K chunk kc and pair
// of 8-wide N tiles np, lane l holds one uint4 with the two B registers
// of N tile 2np then those of 2np + 1.  A warp reads them as 512
// contiguous bytes, from device memory through the read-only cache or,
// where the caller has staged the conv's fragments there, from shared
// memory (conflict-free: each lane reads its own 16 bytes).
//
// A warp item is (16*MW rows) x (8*NW output channels): per tap and K
// chunk it issues MW ldmatrix.x4, NW/2 weight loads and MW*NW MMAs.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace conv_tile {

constexpr float kSlope = 0.1f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b for one 16x8x16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * kSlope;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// lrelu of two packed bf16 values, computed in f32 and rounded back, as
// torch's bf16 leaky_relu does
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  const float2 f = unpack_bf16x2(v);
  return pack_bf16x2(lrelu(f.x), lrelu(f.y));
}

// acc[mi][ni] += sum_{tap < k} sum_{ci} A(row0 + 16 mi + r + tap*dil, ci)
//                                       * W_tap(ci, 8 (2 np0 + ni) + c)
// over this warp's item; A = lrelu(act) when kLrelu.  act has rows of ld
// bf16; kcs = C_in / 16 (padded); wf is the conv's packed weights with
// nps pairs of N tiles per K chunk, in device memory (read through the
// read-only cache) or, with kSharedB, in shared memory.
template <int MW, int NW, bool kLrelu, bool kSharedB = false>
__device__ __forceinline__ void conv_mma(float (&acc)[MW][NW][4],
                                         const __nv_bfloat16* act, int ld,
                                         int row0, int k, int dil, int kcs,
                                         const uint4* __restrict__ wf,
                                         int nps, int np0) {
  static_assert(NW % 2 == 0, "N tiles come in pairs");
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 0-15 give rows 0-15 of the K chunk's first 8
  // channels, lanes 16-31 the same rows' next 8
  const uint32_t base =
      smem_addr(act + (row0 + (lane & 15)) * ld + ((lane >> 4) << 3));
  const uint4* wl = wf + np0 * 32 + lane;
  for (int tap = 0; tap < k; ++tap) {
    const uint32_t tap_base = base + tap * dil * ld * 2;
    const uint4* wt = wl + (size_t)tap * kcs * nps * 32;
#pragma unroll 2
    for (int kc = 0; kc < kcs; ++kc) {
      uint4 b[NW / 2];
#pragma unroll
      for (int q = 0; q < NW / 2; ++q) {
        const uint4* wq = wt + (kc * nps + q) * 32;
        b[q] = kSharedB ? *wq : __ldg(wq);
      }
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        ldmatrix_x4(a[mi], tap_base + (mi * 16 * ld + kc * 16) * 2);
        if (kLrelu) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[mi][r] = lrelu_bf16x2(a[mi][r]);
        }
      }
#pragma unroll
      for (int q = 0; q < NW / 2; ++q) {
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(acc[mi][2 * q], a[mi], b[q].x, b[q].y);
          mma_bf16(acc[mi][2 * q + 1], a[mi], b[q].z, b[q].w);
        }
      }
    }
  }
}

// The accumulator element acc[mi][ni][e] of this lane sits at row
// 16 mi + (lane / 4) + 8 (e / 2) of the item and column
// 8 ni + 2 (lane % 4) + (e % 2).
__device__ __forceinline__ int acc_row(int mi, int e) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (e & 1);
}

template <int MW, int NW>
__device__ __forceinline__ void zero(float (&acc)[MW][NW][4]) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

}  // namespace conv_tile
