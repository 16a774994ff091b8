// Causal / sliding-window flash-attention backward for Hopper (sm_90a):
// one kernel for dQ and one for dK/dV in each dtype.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// k8s_vgpu_scheduler_tpu/ops/flash_attention.py (both launched by
// `_flash_bwd_impl`).  Same recomputation form, over (B, T, H, d) tensors:
//   P  = exp(scale * Q K^T - lse)          (masked entries are 0)
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O)  (computed outside)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// with lse and delta as contiguous (B, H, T) f32 rows.
//
// What bounds it on an H100: at llama_7b widths (B=1, T=2048, H=32, d=128,
// causal) dQ does 6*d flops per visible (query, key) pair (51.6 GFLOP) on
// ~84 MB, dK/dV 8*d (68.7 GFLOP) on ~101 MB: both far above the card's
// ~295 FLOP/byte ridge, so bound by operations (52 us and 70 us on the bf16
// tensor cores).
//
// Both dtypes keep the TPU's split: dQ is parallel over query tiles, dK/dV
// over key tiles, so every output element is written by one warp (one
// thread in f32) and there is no atomicAdd: gradients are bitwise
// reproducible.  Tiles are skipped as in the TPU kernels: dQ walks keys
// from the window's first tile to the query tile's diagonal; dK/dV walks
// queries from the key tile's diagonal to the window's end.  (B, T, H, d)
// is read and written through strides; a ragged T is masked here, not
// padded.  The kernel is chosen by dtype inside each C entry point
// (dispatch by type, not a fallback: a bf16 call the tensor-core kernel
// cannot take fails, it never runs the scalar one).
//
// bf16 -> flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel, on the
// tensor cores with mma.sync m16n8k16 bf16 -> f32 (tensor_core.cuh):
// - one block of 4 warps per (64-row tile, head, batch), 16 rows a warp.
//   The tiles with the most causal work launch first: the last query
//   tiles for dQ, the first key tiles for dK/dV;
// - the block's own rows (Q and dO for dQ; K and V for dK/dV) are copied
//   once into padded dynamic shared memory with 16-byte cp.async; the
//   streamed tiles (K/V; Q/dO with their lse and delta rows) go through a
//   two-stage cp.async ring, tile j+1's copy in flight while tile j is
//   computed;
// - dK/dV keeps keys as rows, so P^T and dS^T never leave registers:
//   S^T = K Q^T and dP^T = V dO^T (K, V the A operands; Q, dO as stored
//   are the col-major B operands), P^T = exp2(S^T scale log2e - lse log2e)
//   with lse indexed by the fragment's column, dS^T = P^T (dP^T - delta),
//   then dV += P^T dO and dK += dS^T Q, whose A operands are the C
//   fragments of two adjacent 8-query n-tiles packed to bf16 and whose B
//   operands come in with ldmatrix.trans;
// - dQ: S = Q K^T, dP = dO V^T (K, V as stored are the col-major B
//   operands), P and dS with the row's lse and delta, dQ += dS K with K
//   through ldmatrix.trans;
// - the A fragments of the block's own rows are read from shared memory
//   for every tile rather than held in registers: the f32 accumulators
//   (dK and dV: 2 * d/2 a lane; dQ: d/2) and the S and dP fragments of a
//   tile take the registers;
// - sm_scale multiplies dQ and dK once, in the epilogue (Q is not
//   rounded to bf16 after scaling);
// - masks are evaluated only on tiles that cross the diagonal, the
//   window's edge or T; a warp skips a tile wholly masked for its rows.
// P (before P^T dO) and dS (before dS K and dS^T Q) are rounded to bf16:
// the numerical change against the TPU kernels, which multiply in f32.
// PERF.md derives its size, and chip_smoke.py holds each output to it.
// Needs 16-byte aligned q/k/v/dO with batch/token/head strides that are
// multiples of 8 elements (cp.async moves 16 bytes), and outputs with even
// strides (written in bf16 pairs).  The wrapper checks the operands
// (ops/flash_attention.py `_check`) and allocates the outputs contiguous;
// this file does not check again.
//
// f32 -> flash_bwd_dq_kernel and flash_bwd_dkv_kernel, exact scalar
// kernels: every product is an f32 FMA on f32 tiles (no TF32), as the TPU
// kernels do.  NSUB adjacent lanes share one row, each owning every
// NSUB-th float4 chunk of d; a row's dot products are reduced with xor
// shuffles; the streamed operand (K/V for dQ, scaled Q/dO and their
// lse/delta for dK/dV) is staged in shared memory, TILE rows at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr float LOG2E = 1.4426950408889634f;

constexpr int THREADS = 256;
constexpr int TILE = 32;  // streamed rows per shared-memory tile

struct Strides {
  int64_t b, t, h;  // elements; the head dimension is contiguous
};

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// Sum over the NSUB adjacent lanes that share a row; every lane gets it.
template <int NSUB>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < NSUB; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The forward's mask, plus the ragged tail: query qpos sees key kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int seq_len,
                                        int causal, int window) {
  bool keep = qpos < seq_len && kpos < seq_len;
  if (causal) keep = keep && qpos >= kpos;
  if (window > 0) keep = keep && qpos - kpos < window;
  return keep;
}

template <int D, int NSUB>
__device__ __forceinline__ void store_row(float* row, const float4* x,
                                          int sub, float s) {
#pragma unroll
  for (int c = 0; c < D / 4 / NSUB; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    row[d0 + 0] = x[c].x * s;
    row[d0 + 1] = x[c].y * s;
    row[d0 + 2] = x[c].z * s;
    row[d0 + 3] = x[c].w * s;
  }
}

// f32 dQ: one block per (query tile of ROWS rows, head, batch).
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq,
                        int seq_len, int heads, Strides qs, Strides kst,
                        Strides vst, Strides ds, Strides dqs, float sm_scale,
                        int causal, int window) {
  constexpr int NSUB = 4;
  constexpr int ROWS = THREADS / NSUB;  // 64
  constexpr int C = D / 4;
  constexpr int CPT = C / NSUB;
  static_assert(D % (4 * NSUB) == 0, "head_dim must be a multiple of 16");
  __shared__ float4 k_tile[TILE][C];
  __shared__ float4 v_tile[TILE][C];

  const int tid = threadIdx.x;
  const int row = tid / NSUB;
  const int sub = tid % NSUB;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = q0 + row;
  const bool row_ok = qpos < seq_len;

  float4 qr[CPT], dor[CPT], acc[CPT];
  const float* qrow = q + b * qs.b + (int64_t)qpos * qs.t + h * qs.h;
  const float* drow = dout + b * ds.b + (int64_t)qpos * ds.t + h * ds.h;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    qr[c] = row_ok ? scale4(load4(qrow + d0), sm_scale) : zero;
    dor[c] = row_ok ? load4(drow + d0) : zero;
    acc[c] = zero;
  }
  float row_lse = 0.f, row_delta = 0.f;
  if (row_ok) {
    const int64_t r = ((int64_t)b * heads + h) * seq_len + qpos;
    row_lse = lse[r];
    row_delta = delta[r];
  }

  // Tiles above the query tile's diagonal and left of its window are
  // skipped, as in `_dq_kernel`.
  const int k_end = causal ? min(seq_len, q0 + ROWS) : seq_len;
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    k_begin = first > 0 ? (first / TILE) * TILE : 0;
  }

  const float* kbase = k + b * kst.b + h * kst.h;
  const float* vbase = v + b * vst.b + h * vst.h;
  for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < TILE * C; idx += THREADS) {
      const int r = idx / C;
      const int ch = idx % C;
      const int kp = k0 + r;
      float4 kx = zero, vx = zero;
      if (kp < seq_len) {
        kx = load4(kbase + (int64_t)kp * kst.t + ch * 4);
        vx = load4(vbase + (int64_t)kp * vst.t + ch * 4);
      }
      k_tile[r][ch] = kx;
      v_tile[r][ch] = vx;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s = dot4(qr[c], k_tile[j][c * NSUB + sub], s);
        dp = dot4(dor[c], v_tile[j][c * NSUB + sub], dp);
      }
      s = row_sum<NSUB>(s);
      dp = row_sum<NSUB>(dp);
      const float p = visible(qpos, k0 + j, seq_len, causal, window)
                          ? expf(s - row_lse)
                          : 0.f;
      const float dsv = p * (dp - row_delta);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        axpy4(dsv, k_tile[j][c * NSUB + sub], acc[c]);
      }
    }
  }

  if (!row_ok) return;
  store_row<D, NSUB>(dq + b * dqs.b + (int64_t)qpos * dqs.t + h * dqs.h, acc,
                     sub, sm_scale);
}

// f32 dK/dV: one block per (key tile of ROWS rows, head, batch).  Eight lanes
// a row (four at d=16) keep k, v and both accumulators in registers.
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int seq_len, int heads,
                         Strides qst, Strides ks, Strides vs, Strides dst,
                         Strides dks, Strides dvs, float sm_scale, int causal,
                         int window) {
  constexpr int NSUB = D >= 32 ? 8 : 4;
  constexpr int ROWS = THREADS / NSUB;  // 32 (64 at d=16)
  constexpr int C = D / 4;
  constexpr int CPT = C / NSUB;
  static_assert(C % NSUB == 0, "head_dim must be a multiple of 16");
  __shared__ float4 q_tile[TILE][C];  // scale * Q
  __shared__ float4 do_tile[TILE][C];
  __shared__ float lse_t[TILE];
  __shared__ float delta_t[TILE];

  const int tid = threadIdx.x;
  const int row = tid / NSUB;
  const int sub = tid % NSUB;
  const int k0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kpos = k0 + row;
  const bool row_ok = kpos < seq_len;

  float4 kr[CPT], vr[CPT], dka[CPT], dva[CPT];
  const float* krow = k + b * ks.b + (int64_t)kpos * ks.t + h * ks.h;
  const float* vrow = v + b * vs.b + (int64_t)kpos * vs.t + h * vs.h;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    kr[c] = row_ok ? load4(krow + d0) : zero;
    vr[c] = row_ok ? load4(vrow + d0) : zero;
    dka[c] = zero;
    dva[c] = zero;
  }

  // Query tiles that see none of this key tile are skipped, as in
  // `_dkv_kernel`: under causal the walk starts at the diagonal, and with
  // a window it stops once kpos_max + window - 1 is passed.
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  int q_end = seq_len;
  if (window > 0) q_end = min(seq_len, k0 + ROWS - 1 + window);

  const float* qbase = q + b * qst.b + h * qst.h;
  const float* dbase = dout + b * dst.b + h * dst.h;
  const int64_t row0 = ((int64_t)b * heads + h) * seq_len;
  for (int i0 = q_begin; i0 < q_end; i0 += TILE) {
    __syncthreads();
    for (int idx = tid; idx < TILE * C; idx += THREADS) {
      const int r = idx / C;
      const int ch = idx % C;
      const int qp = i0 + r;
      float4 qx = zero, dx = zero;
      if (qp < seq_len) {
        qx = scale4(load4(qbase + (int64_t)qp * qst.t + ch * 4), sm_scale);
        dx = load4(dbase + (int64_t)qp * dst.t + ch * 4);
      }
      q_tile[r][ch] = qx;
      do_tile[r][ch] = dx;
    }
    if (tid < TILE) {
      const int qp = i0 + tid;
      lse_t[tid] = qp < seq_len ? lse[row0 + qp] : 0.f;
      delta_t[tid] = qp < seq_len ? delta[row0 + qp] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < TILE; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s = dot4(kr[c], q_tile[i][c * NSUB + sub], s);
        dp = dot4(vr[c], do_tile[i][c * NSUB + sub], dp);
      }
      s = row_sum<NSUB>(s);
      dp = row_sum<NSUB>(dp);
      const float p = visible(i0 + i, kpos, seq_len, causal, window)
                          ? expf(s - lse_t[i])
                          : 0.f;
      const float dsv = p * (dp - delta_t[i]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        axpy4(p, do_tile[i][c * NSUB + sub], dva[c]);
        axpy4(dsv, q_tile[i][c * NSUB + sub], dka[c]);
      }
    }
  }

  if (!row_ok) return;
  store_row<D, NSUB>(dk + b * dks.b + (int64_t)kpos * dks.t + h * dks.h, dka,
                     sub, 1.f);
  store_row<D, NSUB>(dv + b * dvs.b + (int64_t)kpos * dvs.t + h * dvs.h, dva,
                     sub, 1.f);
}

// ---------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int MMA_ROWS = 64;                 // a block's own rows
constexpr int MMA_WARPS = MMA_ROWS / 16;     // one warp per 16 rows
constexpr int MMA_THREADS = MMA_WARPS * 32;  // 128
constexpr int DQ_BK = 64;                    // keys per streamed K/V tile

// Queries per streamed Q/dO tile of dK/dV.  At d=128 the dK and dV
// accumulators take 128 registers a lane: with 64 queries (S^T and dP^T
// 32 registers each) ptxas spills at its 255-register cap, with 32 it
// does not.
template <int D>
constexpr int dkv_bq() {
  return D >= 128 ? 32 : 64;
}

// Dynamic shared memory: the block's own two (MMA_ROWS, d) matrices, two
// stages of two streamed (`streamed`, d) matrices (rows padded by 8
// elements, 16 bytes, so the 8 rows an ldmatrix reads fall on distinct
// banks), and `floats` f32 values.
template <int D>
constexpr int mma_smem_bytes(int streamed, int floats) {
  return (2 * MMA_ROWS + 4 * streamed) * (D + 8) * 2 + floats * 4;
}

// Copy rows [r0, r0 + ROWS) of one head of a (B, T, H, d) tensor, token
// stride `st`, into a padded shared tile with 16-byte cp.async; rows at or
// past T are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int64_t st, int r0, int seq_len,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < ROWS * CH; idx += MMA_THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool in = r0 + r < seq_len;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8),
               src + (int64_t)(in ? r0 + r : 0) * st + c * 8, in);
  }
}

// dQ: one block per (64-query tile, head, batch), 16 queries a warp; K/V
// tiles of DQ_BK keys stream through the two-stage ring.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int seq_len, int heads,
                            Strides qst, Strides kst, Strides vst,
                            Strides dst, Strides dqs, float sm_scale,
                            int causal, int window) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 8;         // padded shared-memory row, elements
  constexpr int KSTEPS = D / 16;    // k-steps of S and dP over d
  constexpr int NT = DQ_BK / 8;     // 8-key n-tiles of S and dP
  constexpr int DT = D / 8;         // 8-wide d-tiles of dQ
  constexpr int TILE_ELEMS = DQ_BK * LD;  // one K or V stage

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + MMA_ROWS * LD;
  bf16* ks = dos + MMA_ROWS * LD;  // two stages
  bf16* vs = ks + 2 * TILE_ELEMS;  // two stages

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_ROWS;  // longest first
  const int qw = q0 + warp * 16;  // this warp's first query
  const int g = lane / 4;         // row in the 8-row half of a fragment
  const int t4 = lane % 4;        // column pair in a fragment

  const int k_end = causal ? min(seq_len, q0 + MMA_ROWS) : seq_len;
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    k_begin = first > 0 ? (first / DQ_BK) * DQ_BK : 0;
  }
  const int n_tiles = (k_end - k_begin + DQ_BK - 1) / DQ_BK;

  const bf16* kbase = k + b * kst.b + h * kst.h;
  const bf16* vbase = v + b * vst.b + h * vst.h;
  copy_rows<D, MMA_ROWS>(qs, q + b * qst.b + h * qst.h, qst.t, q0, seq_len,
                         tid);
  copy_rows<D, MMA_ROWS>(dos, dout + b * dst.b + h * dst.h, dst.t, q0,
                         seq_len, tid);
  copy_rows<D, DQ_BK>(ks, kbase, kst.t, k_begin, seq_len, tid);
  copy_rows<D, DQ_BK>(vs, vbase, vst.t, k_begin, seq_len, tid);
  cp_async_commit();

  // lse (log2 units) and delta of the lane's rows g and g + 8.
  const int64_t row0 = ((int64_t)b * heads + h) * seq_len;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = qw + g + r * 8;
    row_lse[r] = p < seq_len ? lse[row0 + p] * LOG2E : 0.f;
    row_delta[r] = p < seq_len ? delta[row0 + p] : 0.f;
  }

  // ldmatrix lane addresses (tensor_core.cuh): Q and dO as A; K and V as
  // the col-major B of S and dP; K transposed as the B of dS K.
  const int a_off = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * LD + (lane / 16) * 8;
  const uint32_t q_lane = smem_addr(qs + a_off);
  const uint32_t do_lane = smem_addr(dos + a_off);
  const uint32_t k_lane = smem_addr(ks + b_off);
  const uint32_t v_lane = smem_addr(vs + b_off);
  const uint32_t kt_lane = smem_addr(ks + t_off);
  const float scale_log2 = sm_scale * LOG2E;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * DQ_BK;
    const int stage = j % 2;
    if (j + 1 < n_tiles) {
      const int next = (stage ^ 1) * TILE_ELEMS;
      copy_rows<D, DQ_BK>(ks + next, kbase, kst.t, k0 + DQ_BK, seq_len, tid);
      copy_rows<D, DQ_BK>(vs + next, vbase, vst.t, k0 + DQ_BK, seq_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and on j == 0 Q and dO) is in place

    // A tile wholly masked for this warp's rows adds nothing: skip it.
    const bool skip = qw >= seq_len || (causal && k0 > qw + 15) ||
                      (window > 0 && qw - (k0 + DQ_BK - 1) >= window);
    if (!skip) {
      const uint32_t off = stage * TILE_ELEMS * 2;  // bytes
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, q_lane + kk * 32);
        ldmatrix_x4(da, do_lane + kk * 32);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          const uint32_t at = off + (n2 * 16 * LD + kk * 16) * 2;
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, k_lane + at);
          mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
          ldmatrix_x4(vb, v_lane + at);
          mma_bf16(dp[2 * n2], da, vb[0], vb[1]);
          mma_bf16(dp[2 * n2 + 1], da, vb[2], vb[3]);
        }
      }

      // P and dS = P (dP - delta) in place of dP; the mask only on a tile
      // that crosses the diagonal, the window's left edge or T.
      const bool mask = (causal && k0 + DQ_BK - 1 > qw) ||
                        (window > 0 && qw + 15 - k0 >= window) ||
                        k0 + DQ_BK > seq_len;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float p = exp2f(s[n][e] * scale_log2 - row_lse[r]);
          if (mask) {
            const int pq = qw + g + r * 8;
            const int kp = k0 + n * 8 + t4 * 2 + e % 2;
            bool keep = kp < seq_len;
            if (causal) keep = keep && pq >= kp;
            if (window > 0) keep = keep && pq - kp < window;
            p = keep ? p : 0.f;
          }
          dp[n][e] = p * (dp[n][e] - row_delta[r]);
        }
      }

      // dQ += dS K: n-tiles 2kk and 2kk+1 of dS are the A fragment of
      // k-step kk.
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4];
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < DT / 2; ++n2) {
          uint32_t kt[4];
          ldmatrix_x4_trans(kt, kt_lane + off + (kk * 16 * LD + n2 * 16) * 2);
          mma_bf16(acc[2 * n2], a, kt[0], kt[1]);
          mma_bf16(acc[2 * n2 + 1], a, kt[2], kt[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = qw + g + r * 8;
    if (p >= seq_len) continue;
    bf16* row = dq + b * dqs.b + (int64_t)p * dqs.t + h * dqs.h;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[n][2 * r] * sm_scale,
                                acc[n][2 * r + 1] * sm_scale);
    }
  }
}

// dK/dV: one block per (64-key tile, head, batch), 16 keys a warp, keys as
// the rows of every product; Q/dO tiles of BQ queries, with their lse and
// delta rows, stream through the two-stage ring.
template <int D, int BQ>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int seq_len, int heads, Strides qst,
                             Strides kst, Strides vst, Strides dst,
                             Strides dks, Strides dvs, float sm_scale,
                             int causal, int window) {
  static_assert(D % 16 == 0 && BQ % 16 == 0 && MMA_ROWS % BQ == 0,
                "head_dim and the query tile must be multiples of 16");
  constexpr int LD = D + 8;       // padded shared-memory row, elements
  constexpr int KSTEPS = D / 16;  // k-steps of S^T and dP^T over d
  constexpr int NQ = BQ / 8;      // 8-query n-tiles of S^T and dP^T
  constexpr int DT = D / 8;       // 8-wide d-tiles of dK and dV
  constexpr int TILE_ELEMS = BQ * LD;  // one Q or dO stage

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + MMA_ROWS * LD;
  bf16* qs = vs + MMA_ROWS * LD;    // two stages
  bf16* dos = qs + 2 * TILE_ELEMS;  // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE_ELEMS);
  float* delta_s = lse_s + 2 * BQ;  // lse and delta: two stages each

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // The first key tiles see the most queries under causal: they launch
  // first (the mirror of the forward's reversed query tiles).
  const int k0 = blockIdx.z * MMA_ROWS;
  const int kw = k0 + warp * 16;  // this warp's first key
  const int g = lane / 4;
  const int t4 = lane % 4;

  // Query tiles that see none of this key tile are skipped, as in
  // `_dkv_kernel`: under causal the walk starts at the diagonal, and with
  // a window it stops once the last key's window is passed.
  const int q_begin = causal ? k0 : 0;
  int q_end = seq_len;
  if (window > 0) q_end = min(seq_len, k0 + MMA_ROWS - 1 + window);
  const int n_tiles = (q_end - q_begin + BQ - 1) / BQ;

  const bf16* qbase = q + b * qst.b + h * qst.h;
  const bf16* dbase = dout + b * dst.b + h * dst.h;
  const int64_t row0 = ((int64_t)b * heads + h) * seq_len;
  auto load_q = [&](int i0, int stage) {
    const int at = stage * TILE_ELEMS;
    copy_rows<D, BQ>(qs + at, qbase, qst.t, i0, seq_len, tid);
    copy_rows<D, BQ>(dos + at, dbase, dst.t, i0, seq_len, tid);
    for (int i = tid; i < BQ; i += MMA_THREADS) {
      const bool in = i0 + i < seq_len;
      const int64_t r = row0 + (in ? i0 + i : 0);
      cp_async4(smem_addr(lse_s + stage * BQ + i), lse + r, in);
      cp_async4(smem_addr(delta_s + stage * BQ + i), delta + r, in);
    }
  };
  copy_rows<D, MMA_ROWS>(ks, k + b * kst.b + h * kst.h, kst.t, k0, seq_len,
                         tid);
  copy_rows<D, MMA_ROWS>(vs, v + b * vst.b + h * vst.h, vst.t, k0, seq_len,
                         tid);
  load_q(q_begin, 0);
  cp_async_commit();

  // ldmatrix lane addresses (tensor_core.cuh): K and V as A; Q and dO as
  // the col-major B of S^T and dP^T; dO and Q transposed as the B of
  // P^T dO and dS^T Q.
  const int a_off = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int b_off = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int t_off = (lane % 16) * LD + (lane / 16) * 8;
  const uint32_t k_lane = smem_addr(ks + a_off);
  const uint32_t v_lane = smem_addr(vs + a_off);
  const uint32_t q_lane = smem_addr(qs + b_off);
  const uint32_t do_lane = smem_addr(dos + b_off);
  const uint32_t qt_lane = smem_addr(qs + t_off);
  const uint32_t dot_lane = smem_addr(dos + t_off);
  const float scale_log2 = sm_scale * LOG2E;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int i0 = q_begin + j * BQ;
    const int stage = j % 2;
    if (j + 1 < n_tiles) {
      load_q(i0 + BQ, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and on j == 0 K and V) is in place

    const bool skip = kw >= seq_len || (causal && i0 + BQ - 1 < kw) ||
                      (window > 0 && i0 - (kw + 15) >= window);
    if (!skip) {
      const uint32_t off = stage * TILE_ELEMS * 2;  // bytes
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, k_lane + kk * 32);
        ldmatrix_x4(va, v_lane + kk * 32);
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          const uint32_t at = off + (n2 * 16 * LD + kk * 16) * 2;
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, q_lane + at);
          mma_bf16(s[2 * n2], ka, qb[0], qb[1]);
          mma_bf16(s[2 * n2 + 1], ka, qb[2], qb[3]);
          ldmatrix_x4(ob, do_lane + at);
          mma_bf16(dp[2 * n2], va, ob[0], ob[1]);
          mma_bf16(dp[2 * n2 + 1], va, ob[2], ob[3]);
        }
      }

      // P^T in place of S^T, dS^T = P^T (dP^T - delta) in place of dP^T;
      // a fragment's columns are queries, so lse and delta go by column.
      const bool mask = (causal && i0 < kw + 15) ||
                        (window > 0 && i0 + BQ - 1 - kw >= window) ||
                        i0 + BQ > seq_len;
      const float* ls = lse_s + stage * BQ;
      const float* dl = delta_s + stage * BQ;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = n * 8 + t4 * 2;
        const float2 col_lse = *reinterpret_cast<const float2*>(ls + c);
        const float2 col_delta = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_e = e % 2 ? col_lse.y : col_lse.x;
          const float delta_e = e % 2 ? col_delta.y : col_delta.x;
          float p = exp2f(s[n][e] * scale_log2 - lse_e * LOG2E);
          if (mask) {
            const int pq = i0 + c + e % 2;
            const int kp = kw + g + (e / 2) * 8;
            bool keep = pq < seq_len;
            if (causal) keep = keep && pq >= kp;
            if (window > 0) keep = keep && pq - kp < window;
            p = keep ? p : 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_e);
        }
      }

      // dV += P^T dO and dK += dS^T Q: n-tiles 2kk and 2kk+1 are the A
      // fragment of k-step kk (16 queries).
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < DT / 2; ++n2) {
          const uint32_t at = off + (kk * 16 * LD + n2 * 16) * 2;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, dot_lane + at);
          mma_bf16(dva[2 * n2], pa, ob[0], ob[1]);
          mma_bf16(dva[2 * n2 + 1], pa, ob[2], ob[3]);
          ldmatrix_x4_trans(qb, qt_lane + at);
          mma_bf16(dka[2 * n2], da, qb[0], qb[1]);
          mma_bf16(dka[2 * n2 + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kw + g + r * 8;
    if (kp >= seq_len) continue;
    bf16* krow = dk + b * dks.b + (int64_t)kp * dks.t + h * dks.h;
    bf16* vrow = dv + b * dvs.b + (int64_t)kp * dvs.t + h * dvs.h;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8 + t4 * 2) =
          __floats2bfloat162_rn(dka[n][2 * r] * sm_scale,
                                dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8 + t4 * 2) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Operand order of `st`: q, k, v, dO, then the outputs (dQ; or dK, dV).
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int batch, seq_len, heads;
  const long long* st;
  float sm_scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
int launch_dq_f32(const Args& a) {
  constexpr int ROWS = THREADS / 4;
  dim3 grid((a.seq_len + ROWS - 1) / ROWS, a.heads, a.batch);
  flash_bwd_dq_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), a.seq_len, a.heads, strides_at(a.st, 0),
      strides_at(a.st, 1), strides_at(a.st, 2), strides_at(a.st, 3),
      strides_at(a.st, 4), a.sm_scale, a.causal, a.window);
  return 0;
}

template <int D>
int launch_dkv_f32(const Args& a) {
  constexpr int ROWS = THREADS / (D >= 32 ? 8 : 4);
  dim3 grid((a.seq_len + ROWS - 1) / ROWS, a.heads, a.batch);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.seq_len,
      a.heads, strides_at(a.st, 0), strides_at(a.st, 1), strides_at(a.st, 2),
      strides_at(a.st, 3), strides_at(a.st, 4), strides_at(a.st, 5),
      a.sm_scale, a.causal, a.window);
  return 0;
}

template <int D>
int launch_dq_mma(const Args& a) {
  constexpr int smem = mma_smem_bytes<D>(DQ_BK, 0);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.heads, a.batch, (a.seq_len + MMA_ROWS - 1) / MMA_ROWS);
  flash_bwd_dq_mma_kernel<D><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.seq_len, a.heads, strides_at(a.st, 0),
      strides_at(a.st, 1), strides_at(a.st, 2), strides_at(a.st, 3),
      strides_at(a.st, 4), a.sm_scale, a.causal, a.window);
  return 0;
}

template <int D>
int launch_dkv_mma(const Args& a) {
  constexpr int BQ = dkv_bq<D>();
  constexpr int smem = mma_smem_bytes<D>(BQ, 4 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.heads, a.batch, (a.seq_len + MMA_ROWS - 1) / MMA_ROWS);
  flash_bwd_dkv_mma_kernel<D, BQ><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.seq_len,
      a.heads, strides_at(a.st, 0), strides_at(a.st, 1), strides_at(a.st, 2),
      strides_at(a.st, 3), strides_at(a.st, 4), strides_at(a.st, 5),
      a.sm_scale, a.causal, a.window);
  return 0;
}

// dtype 0 (f32) to the scalar kernels, 1 (bf16) to the tensor-core ones.
template <bool DQ, int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return DQ ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
  if (dtype == 1) return DQ ? launch_dq_mma<D>(a) : launch_dkv_mma<D>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool DQ>
int dispatch(int dtype, int head_dim, const Args& a) {
  int err;
  switch (head_dim) {
    case 16:
      err = launch<DQ, 16>(dtype, a);
      break;
    case 32:
      err = launch<DQ, 32>(dtype, a);
      break;
    case 64:
      err = launch<DQ, 64>(dtype, a);
      break;
    case 128:
      err = launch<DQ, 128>(dtype, a);
      break;
    default:
      err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32 (scalar
// kernels), 1 = bfloat16 (tensor-core kernels), the same for q, k, v, dO
// and the gradients.  Strides are in
// elements, (batch, token, head) for each of q, k, v, dO and then the
// gradients; the head dimension must be contiguous.  lse and delta are
// contiguous (B, H, T) f32.  Each launches on `stream` without
// synchronising and returns cudaGetLastError() (nonzero when the launch
// was refused or the arguments are unsupported).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int dtype, int batch,
                            int seq_len, int heads, int head_dim,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long do_sb, long long do_st, long long do_sh,
                            long long dq_sb, long long dq_st, long long dq_sh,
                            float sm_scale, int causal, int window,
                            void* stream) {
  const long long st[15] = {q_sb,  q_st,  q_sh,  k_sb,  k_st,
                            k_sh,  v_sb,  v_st,  v_sh,  do_sb,
                            do_st, do_sh, dq_sb, dq_st, dq_sh};
  const Args a{q,       k,       v,     dout,     lse,    delta,
               dq,      nullptr, batch, seq_len,  heads,  st,
               sm_scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int dtype,
                             int batch, int seq_len, int heads, int head_dim,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long do_sb, long long do_st,
                             long long do_sh, long long dk_sb,
                             long long dk_st, long long dk_sh,
                             long long dv_sb, long long dv_st,
                             long long dv_sh, float sm_scale, int causal,
                             int window, void* stream) {
  const long long st[18] = {q_sb,  q_st,  q_sh,  k_sb,  k_st,  k_sh,
                            v_sb,  v_st,  v_sh,  do_sb, do_st, do_sh,
                            dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh};
  const Args a{q,       k,      v,     dout,    lse,   delta,
               dk,      dv,     batch, seq_len, heads, st,
               sm_scale, causal, window, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}
