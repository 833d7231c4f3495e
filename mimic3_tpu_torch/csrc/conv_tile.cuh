// Tensor-core tile of a dilated conv1d for Hopper (sm_90a), shared by
// csrc/resblock.cu and csrc/stage.cu (which replace the Pallas TPU
// kernels mimic3_tpu/ops/resblock.py::fused_resblock_subblock and
// mimic3_tpu/ops/stage.py::hifigan_stage_fused).  The bf16 stage runs on
// the warpgroup MMA (stage.cu) and takes from here only the fragment
// loads (ldmatrix_x4, lrelu_bf16x2) and the accumulator layout.
//
// One conv over a tile of positions is an implicit GEMM, a sum over taps j
// of A_j . W_j with
//
//   A_j[p, ci] = act[p + j*dil, ci]   (activations in shared memory)
//   W_j[ci, co]                       (the tap's weight slice)
//
// M is positions, K is C_in and N is C_out, as in the JAX kernel's
// `shifted[:tile] @ w_ref[j]` (mimic3_tpu/ops/resblock.py).  The sums are
// float32.  Two operand types:
//
// - bf16 (conv_mma): mma.sync.m16n8k16, HMMA.16816.F32.BF16 in SASS.
// - float32 (tap_tf32, conv_tf32): three TF32 passes of
//   mma.sync.m16n8k8 (HMMA.1688.F32.TF32).  One TF32 pass keeps about 10
//   mantissa bits and misses the port's f32 bar (2e-4 + 1e-3 |ref|) by
//   more than tenfold over one MRF stage (tests/test_torch_port_tf32.py);
//   so each operand is split once into x = hi + lo, both rounded to TF32
//   (cvt.rna), and the tile sums a_lo.w_hi + a_hi.w_lo + a_hi.w_hi in
//   f32, dropping only a_lo.w_lo (below 2^-22 of the product), each K
//   chunk into a fresh accumulator (add_into says why).  That is
//   f32-accurate by construction and explicit in these instructions:
//   torch's TF32 switches (torch.backends.cudnn.allow_tf32 and the like)
//   govern cuDNN, not this tile.  Three passes at 495 TFLOP/s give an
//   f32-equivalent ceiling of about 165 TFLOP/s, against 67 for FFMA.
//
// Layout.  Activations sit in shared memory as [rows][ld], channels
// contiguous: bf16 with ld = C_in (padded to a multiple of 16) + 8, f32
// with ld = C_in (padded likewise) + 4.  Either way a row is a whole
// number of 16-byte units and eight consecutive rows start in eight
// different 4-bank groups, so ldmatrix reads them without bank conflicts.
// A tap's shift j*dil is then a whole-row offset, which ldmatrix takes at
// any row.  A fragments come from ldmatrix.x4 at the shifted row: an 8x8
// b16 matrix is 8 rows x 16 bytes, i.e. 8 bf16 or 4 f32 channels, and
// lane l receives row l/4, 32-bit word l%4 of each, which is the
// m16n8k16 bf16 A layout and equally the m16n8k8 TF32 one (as CUTLASS
// loads TF32).  The f32 tile applies lrelu to the loaded words, then
// splits each once and reuses the split over the item's N tiles.
//
// Weights.  The host packs each conv once (ops/mma.py) in the order the
// B operand's registers want them, one uint4 per lane:
// - bf16: for tap j, 16-deep K chunk kc and pair of 8-wide N tiles np,
//   the two B registers of N tile 2np then those of 2np + 1;
// - TF32: for tap j, 8-deep K chunk kc and 8-wide N tile nt, the two B
//   registers of w_hi then those of w_lo.
// A warp reads 512 contiguous bytes per uint4, from device memory through
// the read-only cache.
//
// A warp item is MW 16-row M tiles x (8*NW output channels): per tap and
// K chunk it issues MW ldmatrix.x4, NW/2 (bf16) or NW (TF32) weight loads
// and MW*NW (bf16) or 3*MW*NW (TF32) MMAs.  The TF32 tile spends four
// times the weight bytes and six times the MMAs of the bf16 one per FLOP.
// What bounds the f32 kernels: the latency of these mma.sync chains; the
// loop is 80-87% of the f32 stage, and fewer warps holding more M tiles
// each (fewer loads per MMA) ran slower (scripts/ablate_stage.py,
// PERF.md).

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

template <int MW, int NW>
__device__ __forceinline__ void zero(float (&acc)[MW][NW][4]) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
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
// read-only cache).
template <int MW, int NW, bool kLrelu>
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
        b[q] = __ldg(wq);
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

// ---------------------------------------------------------------------------
// float32 on tensor cores: three TF32 passes
// ---------------------------------------------------------------------------

// v rounded to TF32 (to nearest, ties away from zero), as a b32 register
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a . b for one 16x8x8 tile (TF32 in, f32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How the f32 sums leave the tensor cores.  An MMA adds its products to
// its accumulator input after aligning them to the largest exponent among
// them, without rounding to nearest, so a running accumulator that grows
// to the conv's full sum loses up to an ulp of that sum at every MMA (264
// MMAs per output at C = 64, K = 11), and in one direction.  So each K
// chunk's three passes go to a fresh accumulator, added into the sum with
// FADD (rounded to nearest).  One accumulator per conv missed the f32 bar
// at C = 64; one per tap was faster but further from a float64 reference
// (scripts/ablate_stage.py builds both; PERF.md).
template <int MW, int NW>
__device__ __forceinline__ void add_into(float (&acc)[MW][NW][4],
                                         const float (&part)[MW][NW][4]) {
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
}

// One tap: acc[mi][ni] += sum_{ci} A(row0 + mi*mstride + r, ci)
//                                  * W(ci, 8 (nt0 + ni) + c)
// for the M tiles mi < mvalid of this warp; A = lrelu(act) when kLrelu.
// act has rows of ld floats; kcs = C_in / 8 (padded); wt is the tap's
// TF32 hi/lo fragments with nts N tiles per K chunk, in device memory,
// read through the read-only cache.
template <int MW, int NW, bool kLrelu>
__device__ __forceinline__ void tap_tf32(float (&acc)[MW][NW][4],
                                         const float* act, int ld, int row0,
                                         int mstride, int mvalid, int kcs,
                                         const uint4* __restrict__ wt,
                                         int nts, int nt0) {
  if (mvalid <= 0) return;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 0-15 give rows 0-15 of the K chunk's first 4
  // channels, lanes 16-31 the same rows' next 4
  const uint32_t base =
      smem_addr(act + (row0 + (lane & 15)) * ld + ((lane >> 4) << 2));
  const uint4* wl = wt + nt0 * 32 + lane;
#pragma unroll 2
  for (int kc = 0; kc < kcs; ++kc) {
    uint32_t hi[MW][4], lo[MW][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      if (mi >= mvalid) continue;
      uint32_t r[4];
      ldmatrix_x4(r, base + (mi * mstride * ld + kc * 8) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = __uint_as_float(r[e]);
        if (kLrelu) v = lrelu(v);
        hi[mi][e] = to_tf32(v);
        lo[mi][e] = to_tf32(v - __uint_as_float(hi[mi][e]));
      }
    }
    float part[MW][NW][4];  // this K chunk's three passes
    zero(part);
#pragma unroll
    for (int ni = 0; ni < NW; ++ni) {
      const uint4 b = __ldg(wl + (kc * nts + ni) * 32);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        if (mi >= mvalid) continue;
        // the small products first, then hi . hi
        mma_tf32(part[mi][ni], lo[mi], b.x, b.y);
        mma_tf32(part[mi][ni], hi[mi], b.z, b.w);
        mma_tf32(part[mi][ni], hi[mi], b.x, b.y);
      }
    }
    add_into(acc, part);
  }
}

// A whole conv of k taps at dilation dil over MW consecutive 16-row M
// tiles from row0; wf is the conv's fragments [k][kcs][nts][32] uint4.
template <int MW, int NW, bool kLrelu>
__device__ __forceinline__ void conv_tf32(float (&acc)[MW][NW][4],
                                          const float* act, int ld, int row0,
                                          int k, int dil, int kcs,
                                          const uint4* __restrict__ wf,
                                          int nts, int nt0) {
  for (int tap = 0; tap < k; ++tap)
    tap_tf32<MW, NW, kLrelu>(acc, act, ld, row0 + tap * dil, 16, MW, kcs,
                             wf + (size_t)tap * kcs * nts * 32, nts, nt0);
}

// The accumulator element acc[mi][ni][e] of this lane (the same for
// both MMA shapes) sits at row
// 16 mi + (lane / 4) + 8 (e / 2) of the item and column
// 8 ni + 2 (lane % 4) + (e % 2).
__device__ __forceinline__ int acc_row(int mi, int e) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int ni, int e) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (e & 1);
}

}  // namespace conv_tile
