// Fused HiFi-GAN ResBlock1 dilation step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mimic3_tpu/ops/resblock.py::
// fused_resblock_subblock (body _subblock_kernel).  For x [B, C, T] and
// conv weights packed as [Cin][K][Cout]:
//
//   h   = lrelu(conv_{K,d}(lrelu(x)) + b1), zero outside [0, T)
//   out = x + conv_K(h) + b2
//
// with torch Conv1d zero padding: lrelu(x) is zero outside [0, T), and so
// is h before the second conv.  Only x is read from device memory (once
// for the haloed tile, once for the residual) and only out is written;
// lrelu(x) and h stay in shared memory.
//
// What bounds it on this card: the step does 4*C*C*K FLOPs per sample
// against 2*C activations read and C written (at C = 128, K = 3 in bf16,
// 384 FLOPs per byte), so it is bound by operations, not by memory.
//
// Three paths, by dtype and C (ops/resblock.py says which reaches which):
//
// - C >= 16, bf16 or f32: tensor cores (subblock_mma_kernel<NW, T>).
//   Each conv is the implicit GEMM of csrc/conv_tile.cuh: lrelu(x) and the
//   intermediate h sit in shared memory as [positions][C] in x's dtype
//   (transposed once on the global load), A fragments come from ldmatrix
//   at the tap's row offset, the weights from fragments packed on the
//   host.  bf16: mma.sync.m16n8k16, h rounded to bf16 as on the TPU.
//   f32: three TF32 passes of mma.sync.m16n8k8 (explicit in the kernel's
//   instructions, f32-accurate by the hi/lo split; torch's TF32 switches
//   govern cuDNN only), h kept in f32 and rounded nowhere.  Sums are f32
//   either way.  The first conv's epilogue adds the bias, applies lrelu
//   and zeroes rows outside [0, T) (torch's zero padding); the second
//   conv's adds the bias into an f32 tile in shared memory, transposed
//   back so that the residual add and the store are coalesced.  A block
//   is (time tile, batch row, output-channel group): every group
//   recomputes all of h for its tile, which is cheap next to idle SMs
//   when T is short (C = 256, T = 2048).  The wrapper (ops/resblock.py)
//   picks the rows per block and the number of groups from a model of
//   waves and warp items, so that the grid fills the card.  The first
//   conv's rows are a multiple of 32 and the tile is those rows less the
//   second halo, so only the second conv rounds up.
//   What bounds it: issue of ldmatrix, weight loads and MMAs from one or
//   two 8-warp blocks per SM (mma.sync, not wgmma), and the recompute of
//   h.  In f32 each FLOP costs six times the MMA issue and four times the
//   weight bytes of bf16, and the buffers twice the shared memory, so
//   rows per block halve; each K chunk's three passes go to a fresh
//   accumulator added with FADD, which keeps the sums f32-accurate.
// - C = 8 (under the MMA depth), either dtype: FFMA (subblock_kernel).
//   f32 FMAs plus the shared-memory activation reads and L1 weight reads
//   that feed them bound it.

// FFMA design (C = 8; simple and correct first):
// - one block per (batch row, time tile).  The tile plus the exact halos
//   (d*(K-1)/2 for the first conv, (K-1)/2 for the second) of lrelu(x) is
//   loaded into shared memory as f32, then the first conv writes the
//   masked intermediate over the tile plus the second halo, then the
//   second conv adds the residual and writes the tile.  No halo rounding
//   and no tiling constraint on T: the last tile is masked;
// - the wrapper picks the time tile from C and the halo so that two
//   blocks fit in an SM's shared memory where a tile of 64 allows, else
//   one;
// - a warp computes 8 output channels at 128 positions (4 per lane), so
//   its weight reads are warp-uniform float4 broadcasts (two loads feed
//   32 FMAs) and its activation reads are conflict-free.  The 8 warps of
//   a block walk over the (channel group, position chunk) items;
// - weights arrive rounded to x's dtype and widened to f32; bf16
//   activations are loaded and stored as bf16; all math is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "conv_tile.cuh"

namespace {

constexpr float kSlope = 0.1f;
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kCoT = 8;              // output channels per warp item
constexpr int kPos = 4;              // positions per lane
constexpr int kSpan = kWarp * kPos;  // positions per warp item
constexpr int kMaxChannels = 256;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : v * kSlope;
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[p][j] += sum_{ci, tap} w[ci][tap][co0 + j] * in[ci][i_p + tap*dil]
// for this lane's positions i_p = base + lane + 32p.  in has rows of
// l_in floats and the caller guarantees i + (k-1)*dil < l_in for every
// i < n; positions i >= n read row index 0 and are not stored.
__device__ __forceinline__ void conv_item(const float* __restrict__ in,
                                          int l_in,
                                          const float* __restrict__ w, int c,
                                          int k, int dil, int co0, int base,
                                          int n, float (&acc)[kPos][kCoT]) {
  const int lane = threadIdx.x % kWarp;
  int off[kPos];
#pragma unroll
  for (int p = 0; p < kPos; ++p) {
    const int i = base + lane + p * kWarp;
    off[p] = i < n ? i : 0;
  }
  for (int tap = 0; tap < k; ++tap) {
    const float* in_tap = in + tap * dil;
    const float4* w_tap = reinterpret_cast<const float4*>(w + tap * c + co0);
#pragma unroll 4
    for (int ci = 0; ci < c; ++ci) {
      const float* row = in_tap + ci * l_in;
      float v[kPos];
#pragma unroll
      for (int p = 0; p < kPos; ++p) v[p] = row[off[p]];
      const float4* wc = w_tap + ci * k * (c / 4);
      const float4 wa = __ldg(wc);
      const float4 wb = __ldg(wc + 1);
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        acc[p][0] = fmaf(wa.x, v[p], acc[p][0]);
        acc[p][1] = fmaf(wa.y, v[p], acc[p][1]);
        acc[p][2] = fmaf(wa.z, v[p], acc[p][2]);
        acc[p][3] = fmaf(wa.w, v[p], acc[p][3]);
        acc[p][4] = fmaf(wb.x, v[p], acc[p][4]);
        acc[p][5] = fmaf(wb.y, v[p], acc[p][5]);
        acc[p][6] = fmaf(wb.z, v[p], acc[p][6]);
        acc[p][7] = fmaf(wb.w, v[p], acc[p][7]);
      }
    }
  }
}

__device__ __forceinline__ void init_bias(const float* __restrict__ b,
                                          int co0,
                                          float (&acc)[kPos][kCoT]) {
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const float bv = __ldg(b + co0 + j);
#pragma unroll
    for (int p = 0; p < kPos; ++p) acc[p][j] = bv;
  }
}

template <typename T_io>
__global__ void __launch_bounds__(kThreads)
    subblock_kernel(const T_io* __restrict__ x, T_io* __restrict__ out,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, int c, int T, int k,
                    int dil, int tile) {
  extern __shared__ float smem[];
  const int h1 = dil * (k - 1) / 2;
  const int h2 = (k - 1) / 2;
  const int l2 = tile + 2 * h2;  // intermediate positions per row
  const int l1 = l2 + 2 * h1;    // input positions per row
  float* a = smem;               // lrelu(x)          [c][l1]
  float* h = smem + c * l1;      // masked lrelu(y1)  [c][l2]
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int pos_h = t0 - h2;      // sequence position of h[.][0]
  const int pos_a = pos_h - h1;   // sequence position of a[.][0]
  const T_io* xb = x + (size_t)row * c * T;
  T_io* ob = out + (size_t)row * c * T;

  for (int idx = threadIdx.x; idx < c * l1; idx += kThreads) {
    const int ci = idx / l1;
    const int t = pos_a + (idx - ci * l1);
    a[idx] = (t >= 0 && t < T) ? lrelu(load_f(xb + (size_t)ci * T + t)) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int groups = c / kCoT;

  // first conv over the tile and the second conv's halo
  const int chunks1 = (l2 + kSpan - 1) / kSpan;
  for (int item = warp; item < groups * chunks1; item += kWarps) {
    const int co0 = (item / chunks1) * kCoT;
    const int base = (item % chunks1) * kSpan;
    float acc[kPos][kCoT];
    init_bias(b1, co0, acc);
    conv_item(a, l1, w1, c, k, dil, co0, base, l2, acc);
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const int i = base + lane + p * kWarp;
      if (i >= l2) continue;
      const int t = pos_h + i;
      const bool inside = t >= 0 && t < T;
#pragma unroll
      for (int j = 0; j < kCoT; ++j)
        h[(co0 + j) * l2 + i] = inside ? lrelu(acc[p][j]) : 0.f;
    }
  }
  __syncthreads();

  // second conv + residual over the tile's valid positions
  const int n = min(tile, T - t0);
  const int chunks2 = (n + kSpan - 1) / kSpan;
  for (int item = warp; item < groups * chunks2; item += kWarps) {
    const int co0 = (item / chunks2) * kCoT;
    const int base = (item % chunks2) * kSpan;
    float acc[kPos][kCoT];
    init_bias(b2, co0, acc);
    conv_item(h, l2, w2, c, k, 1, co0, base, n, acc);
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const int i = base + lane + p * kWarp;
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        const size_t g = (size_t)(co0 + j) * T + t0 + i;
        store_f(ob + g, load_f(xb + g) + acc[p][j]);
      }
    }
  }
}

template <typename T_io>
cudaError_t launch(const void* x, void* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, int batch, int c, int T,
                   int k, int dil, int tile, cudaStream_t stream) {
  auto kernel = subblock_kernel<T_io>;
  const int h1 = dil * (k - 1) / 2;
  const int h2 = (k - 1) / 2;
  const int smem =
      c * ((tile + 2 * h2 + 2 * h1) + (tile + 2 * h2)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tile - 1) / tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T_io*>(x), static_cast<T_io*>(out), w1, b1, w2, b2, c,
      T, k, dil, tile);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Tensor cores: bf16 (m16n8k16) and f32 (three TF32 passes of m16n8k8)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / kWarp;
constexpr int kMW = 2;  // 16-row MMA tiles per warp item: 32 rows
constexpr int kRows = 16 * kMW;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory plan of one block (bytes), shared by kernel and launcher:
// h [rh][ld] T, then a region that holds lrelu(x) [ra][ld] T during the
// first conv and the second conv's f32 branch [cg][m2 + 4] after it.  T
// is bf16 (elt 2, ld = cp + 8) or f32 (elt 4, ld = cp + 4): rows 16 bytes
// past a multiple of 32, so ldmatrix's eight rows hit eight bank groups.
struct MmaPlan {
  int cp, ld, h1, h2, tile, m2, rh, ra, cg, ldo;
  size_t h_bytes, smem;
  __host__ __device__ MmaPlan(int c, int k, int dil, int m1, int groups,
                              int elt) {
    cp = round_up(c, 16);
    ld = cp + 16 / elt;
    h1 = dil * (k - 1) / 2;
    h2 = (k - 1) / 2;
    tile = m1 - 2 * h2;
    m2 = round_up(tile, kRows);
    rh = m2 + 2 * h2;  // >= m1: rows past m1 feed only rows past the tile
    ra = m1 + 2 * h1;
    cg = cp / groups;
    ldo = m2 + 4;  // 2 * ldo % 32 == 8: the transposed writes spread banks
    h_bytes = (size_t)rh * ld * elt;
    const size_t a_bytes = (size_t)ra * ld * elt;
    const size_t o_bytes = (size_t)cg * ldo * 4;
    smem = h_bytes + (a_bytes > o_bytes ? a_bytes : o_bytes);
  }
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = conv_tile::pack_bf16x2(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// acc += one conv over a warp item, on the operand type's tile: bf16
// fragments (ops/mma.py pack_conv_fragments, kcs = cp / 16, N-tile pairs)
// or TF32 hi/lo fragments (pack_conv_fragments_tf32, kcs = cp / 8, N
// tiles).  n0 is the item's first output channel.
template <int NW>
__device__ __forceinline__ void item_conv(float (&acc)[kMW][NW][4],
                                          const __nv_bfloat16* act, int ld,
                                          int r0, int k, int dil, int cp,
                                          const uint4* __restrict__ w,
                                          int n0) {
  conv_tile::conv_mma<kMW, NW, false>(acc, act, ld, r0, k, dil, cp / 16, w,
                                      cp / 16, n0 / 16);
}
template <int NW>
__device__ __forceinline__ void item_conv(float (&acc)[kMW][NW][4],
                                          const float* act, int ld, int r0,
                                          int k, int dil, int cp,
                                          const uint4* __restrict__ w,
                                          int n0) {
  conv_tile::conv_tf32<kMW, NW, false>(acc, act, ld, r0, k, dil, cp / 8, w,
                                       cp / 8, n0 / 8);
}

template <int NW, typename T>
__global__ void __launch_bounds__(kMmaThreads, 2)
    subblock_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const uint4* __restrict__ w1,
                        const float* __restrict__ b1,
                        const uint4* __restrict__ w2,
                        const float* __restrict__ b2, int c, int T_len, int k,
                        int dil, int m1, int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaPlan p(c, k, dil, m1, groups, sizeof(T));
  T* h = reinterpret_cast<T*>(smem_raw);
  T* a = reinterpret_cast<T*>(smem_raw + p.h_bytes);
  float* o = reinterpret_cast<float*>(smem_raw + p.h_bytes);
  const int row = blockIdx.y;
  const int group = blockIdx.z;
  const int t0 = blockIdx.x * p.tile;
  const int pos_h = t0 - p.h2;     // sequence position of h row 0
  const int pos_a = pos_h - p.h1;  // sequence position of a row 0
  const T* xb = x + (size_t)row * c * T_len;
  T* ob = out + (size_t)row * c * T_len;

  // lrelu(x) -> a, transposed to [position][channel]; a thread takes two
  // channels of one position, neighbouring threads neighbouring positions
  const int pairs = p.cp / 2;
  for (int idx = threadIdx.x; idx < p.ra * pairs; idx += kMmaThreads) {
    const int cpair = idx / p.ra;
    const int r = idx - cpair * p.ra;
    const int t = pos_a + r;
    const int ci = 2 * cpair;
    float v0 = 0.f, v1 = 0.f;
    if (t >= 0 && t < T_len) {
      if (ci < c) v0 = lrelu(load_f(xb + (size_t)ci * T_len + t));
      if (ci + 1 < c) v1 = lrelu(load_f(xb + (size_t)(ci + 1) * T_len + t));
    }
    store2(a + r * p.ld + ci, v0, v1);
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  // first conv: all channels of h over the tile and the second halo
  const int ngrp1 = p.cp / (8 * NW);
  for (int item = warp; item < (m1 / kRows) * ngrp1; item += kMmaWarps) {
    const int r0 = item / ngrp1 * kRows;
    const int n0 = item % ngrp1 * 8 * NW;
    // this lane's biases, loaded before the MMAs so they arrive meanwhile
    float bias[NW][2];
#pragma unroll
    for (int ni = 0; ni < NW; ++ni) {
      bias[ni][0] = __ldg(b1 + n0 + conv_tile::acc_col(ni, 0));
      bias[ni][1] = __ldg(b1 + n0 + conv_tile::acc_col(ni, 1));
    }
    float acc[kMW][NW][4];
    conv_tile::zero(acc);
    item_conv<NW>(acc, a, p.ld, r0, k, dil, p.cp, w1, n0);
#pragma unroll
    for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = r0 + conv_tile::acc_row(mi, e);
          const int co = n0 + conv_tile::acc_col(ni, e);
          const int t = pos_h + r;
          const bool inside = t >= 0 && t < T_len;
          const float v0 = inside ? lrelu(acc[mi][ni][e] + bias[ni][0]) : 0.f;
          const float v1 =
              inside ? lrelu(acc[mi][ni][e + 1] + bias[ni][1]) : 0.f;
          store2(h + r * p.ld + co, v0, v1);  // bf16: rounded, f32: exact
        }
  }
  __syncthreads();  // h complete; a is dead, o takes its place

  // second conv: this block's output-channel group over the tile
  const int cg0 = group * p.cg;
  const int ngrp2 = p.cg / (8 * NW);
  for (int item = warp; item < (p.m2 / kRows) * ngrp2; item += kMmaWarps) {
    const int r0 = item / ngrp2 * kRows;
    const int n0 = item % ngrp2 * 8 * NW;  // within the group
    float bias[NW][2];
#pragma unroll
    for (int ni = 0; ni < NW; ++ni) {
      bias[ni][0] = __ldg(b2 + cg0 + n0 + conv_tile::acc_col(ni, 0));
      bias[ni][1] = __ldg(b2 + cg0 + n0 + conv_tile::acc_col(ni, 1));
    }
    float acc[kMW][NW][4];
    conv_tile::zero(acc);
    item_conv<NW>(acc, h, p.ld, r0, k, 1, p.cp, w2, cg0 + n0);
#pragma unroll
    for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = n0 + conv_tile::acc_col(ni, e);
          o[co * p.ldo + r0 + conv_tile::acc_row(mi, e)] =
              acc[mi][ni][e] + bias[ni][e & 1];
        }
  }
  __syncthreads();

  // residual add and store, coalesced along time
  const int n = min(p.tile, T_len - t0);
  const int cg = min(p.cg, c - cg0);
  for (int idx = threadIdx.x; idx < cg * n; idx += kMmaThreads) {
    const int co = idx / n;
    const int i = idx - co * n;
    const size_t g = (size_t)(cg0 + co) * T_len + t0 + i;
    store_f(ob + g, load_f(xb + g) + o[co * p.ldo + i]);
  }
}

template <int NW, typename T>
cudaError_t launch_mma(const void* x, void* out, const void* w1,
                       const float* b1, const void* w2, const float* b2,
                       int batch, int c, int T_len, int k, int dil, int m1,
                       int groups, cudaStream_t stream) {
  auto kernel = subblock_mma_kernel<NW, T>;
  const MmaPlan p(c, k, dil, m1, groups, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + p.tile - 1) / p.tile, batch, groups);
  kernel<<<grid, kMmaThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const uint4*>(w1), b1, static_cast<const uint4*>(w2), b2, c,
      T_len, k, dil, m1, groups);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns a cudaError_t
// value: 0 when the launch was accepted.
//
// FFMA, C = 8 (under the MMA depth of both tensor-core paths), f32 or
// bf16 (is_bf16); from 16 channels resblock_subblock_mma_launch.
extern "C" int resblock_subblock_launch(const void* x, void* out,
                                        const void* w1, const void* b1,
                                        const void* w2, const void* b2,
                                        int batch, int c, int T, int k,
                                        int dil, int tile, int is_bf16,
                                        void* stream) {
  if (c != kCoT || T <= 0 || k <= 0 || k % 2 == 0 || dil <= 0 || tile <= 0 ||
      batch <= 0)
    return (int)cudaErrorInvalidValue;
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, out, w1f, b1f, w2f, b2f, batch, c,
                                      T, k, dil, tile, st);
  return (int)launch<float>(x, out, w1f, b1f, w2f, b2f, batch, c, T, k, dil,
                            tile, st);
}

// Tensor cores, C from 16: bf16 (is_bf16 = 1; w1, w2 packed by ops/mma.py
// pack_conv_fragments) or f32 (is_bf16 = 0; three TF32 passes, w1, w2
// packed by pack_conv_fragments_tf32), both for C padded to a multiple of
// 16; b1, b2: f32, padded likewise.  m1: rows of the first conv per block
// (a multiple of 32 above 2 * ((K - 1) / 2)); groups: output-channel
// groups per tile.
extern "C" int resblock_subblock_mma_launch(const void* x, void* out,
                                            const void* w1, const void* b1,
                                            const void* w2, const void* b2,
                                            int batch, int c, int T, int k,
                                            int dil, int m1, int groups,
                                            int is_bf16, void* stream) {
  const int cp = round_up(c, 16);
  if (c < 16 || c > kMaxChannels || T <= 0 || k <= 0 || k % 2 == 0 ||
      dil <= 0 || batch <= 0 || m1 <= 0 || m1 % kRows != 0 ||
      m1 <= k - 1 || groups <= 0 || cp % groups != 0 ||
      (cp / groups) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nw4 = (cp / groups) % 32 == 0;
  if (is_bf16)
    return (int)(nw4 ? launch_mma<4, __nv_bfloat16>(x, out, w1, b1f, w2, b2f,
                                                    batch, c, T, k, dil, m1,
                                                    groups, st)
                     : launch_mma<2, __nv_bfloat16>(x, out, w1, b1f, w2, b2f,
                                                    batch, c, T, k, dil, m1,
                                                    groups, st));
  return (int)(nw4 ? launch_mma<4, float>(x, out, w1, b1f, w2, b2f, batch, c,
                                          T, k, dil, m1, groups, st)
                   : launch_mma<2, float>(x, out, w1, b1f, w2, b2f, batch, c,
                                          T, k, dil, m1, groups, st));
}
