// Causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// k8s_vgpu_scheduler_tpu/ops/flash_attention.py (launched by
// `_flash_fwd_impl`).  It computes the same function: O = softmax(scale *
// Q K^T, masked) V over (B, T, H, d) tensors, with an optional per-row
// logsumexp lse = m + log(l) in f32 for the training slice.
//
// What bounds it on an H100: at llama_7b widths (B=1, T=2048, H=32,
// d=128, causal) one layer does ~34 GFLOP on ~67 MB of q/k/v/o, ~500 FLOP
// per byte, far above the card's ~295 FLOP/byte ridge: it is bound by
// operations (~35 us on the bf16 tensor cores at 989 TFLOP/s).
//
// Two kernels, chosen by dtype inside the one C entry point (dispatch by
// type, not a fallback: a bf16 call the tensor-core kernel cannot take
// fails, it never runs the scalar one):
//
// bf16 -> flash_fwd_mma_kernel, FlashAttention-2 on the tensor cores:
// - one block of 8 warps per (128-row q-tile, head, batch); each warp owns
//   16 query rows.  Blocks visit the q-tiles with the most causal work
//   first (the q-tile is the slowest grid index, reversed), so the long
//   tiles do not trail;
// - Q (once) and 64-key K/V tiles are copied into dynamic shared memory
//   with 16-byte cp.async (zero-fill past T), double-buffered: tile j+1's
//   copy is in flight while tile j is computed.  Rows are padded by 16
//   bytes, so the 8 rows an ldmatrix reads fall on distinct banks;
// - S = Q K^T with mma.sync m16n8k16 bf16 -> f32: the warp's Q fragments
//   are loaded into registers once (ldmatrix), K fragments per tile;
// - the online softmax runs on the f32 accumulator fragments: the row max
//   and sum come from the 4 lanes of a quad (__shfl_xor_sync); m, l and
//   the 16 x d O accumulator stay in f32 registers.  The softmax scale
//   times log2(e) is one f32 multiply on S, and exp2f replaces expf: the
//   same function, rounded differently (a few f32 ulps per weight);
// - O += P V on the tensor cores with P never leaving registers: the f32
//   C fragments of two adjacent 8-key n-tiles are the A fragment of one
//   16-key k-step once packed to bf16 pairs; V comes in with
//   ldmatrix.trans.  l sums the f32 P before its rounding to bf16;
// - masks are applied only on tiles that cross the diagonal, the window's
//   left edge or T; a warp skips a tile wholly masked for its 16 rows
//   (such a tile would add exp(-1e30 - m) = 0 weights).  Tile skipping is
//   the TPU kernel's: start at the window's first tile, stop at the
//   q-tile's diagonal.  Masked scores are the finite -1e30, so a fully
//   masked leading tile's weights are wiped by the rescale
//   exp2(-1e30 - m_new) = 0 once a visible key arrives;
// - epilogue: O / max(l, 1e-20), rounded to bf16, written through O's
//   strides; lse in f32 to the contiguous (B, H, T) buffer.
// Rounding P to bf16 before P V is the one numerical change against the
// TPU kernel (which multiplies f32 P by f32 V); PERF.md derives its size.
// Needs 16-byte aligned q/k/v and batch/token/head strides that are
// multiples of 8 elements (cp.async moves 16 bytes), and O with even
// strides (written in bf16 pairs).  The wrapper checks q/k/v
// (ops/flash_attention.py `_check`) and allocates O contiguous; this file
// does not check again.
//
// f32 -> flash_fwd_kernel, the first port's scalar kernel, kept exact:
// f32 FMAs on f32 tiles, never TF32.  One block per (64-row q-tile, head,
// batch); NSUB lanes share a query row, each owning every NSUB-th float4
// chunk of d; K/V tiles of 32 keys staged in shared memory; the same
// tile skipping, ragged-tail masking and finite -1e30 mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------

constexpr int MMA_BQ = 128;              // query rows per block
constexpr int MMA_BK = 64;               // keys per K/V tile
constexpr int MMA_WARPS = MMA_BQ / 16;   // one warp per 16 rows
constexpr int MMA_THREADS = MMA_WARPS * 32;

template <int D>
constexpr int mma_smem_bytes() {
  // Q tile, then two stages each of K and V; rows padded by 8 elements.
  return (MMA_BQ + 4 * MMA_BK) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int seq_len, int heads,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh,
                         int64_t o_sb, int64_t o_st, int64_t o_sh,
                         float scale_log2, int causal, int window) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 8;         // padded shared-memory row, elements
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;    // k-steps of Q K^T
  constexpr int NT = MMA_BK / 8;    // 8-key n-tiles of S
  constexpr int DT = D / 8;         // 8-wide d-tiles of O
  constexpr int TILE = MMA_BK * LD; // elements of one K or V stage

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + MMA_BQ * LD;
  __nv_bfloat16* vs = ks + 2 * TILE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_BQ;  // longest first
  const int qw = q0 + warp * 16;  // this warp's first row
  const int g = lane / 4;         // row in the 8-row half of a fragment
  const int t4 = lane % 4;        // column pair in a fragment

  const int k_end = causal ? min(seq_len, q0 + MMA_BQ) : seq_len;
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    k_begin = first > 0 ? (first / MMA_BK) * MMA_BK : 0;
  }
  const int n_tiles = (k_end - k_begin + MMA_BK - 1) / MMA_BK;

  const __nv_bfloat16* qbase = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kbase = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vbase = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < MMA_BQ * CH; idx += MMA_THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool in = q0 + r < seq_len;
    cp_async16(smem_addr(qs + r * LD + c * 8),
               qbase + (int64_t)(in ? q0 + r : 0) * q_st + c * 8, in);
  }
  auto load_kv = [&](int k0, int stage) {
    for (int idx = tid; idx < MMA_BK * CH; idx += MMA_THREADS) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool in = k0 + r < seq_len;
      const int64_t row = in ? k0 + r : 0;
      const int off = stage * TILE + r * LD + c * 8;
      cp_async16(smem_addr(ks + off), kbase + row * k_st + c * 8, in);
      cp_async16(smem_addr(vs + off), vbase + row * v_st + c * 8, in);
    }
  };
  load_kv(k_begin, 0);
  cp_async_commit();

  // Per-lane ldmatrix addresses (bytes in shared memory).  Q as the A
  // operand: lanes 0-15 rows 0-15 at column 0, lanes 16-31 at column 8.
  // K as the col-major B operand of two n-tiles: lanes 0-7 / 8-15 keys 0-7
  // at columns 0 / 8, lanes 16-31 the same for keys 8-15.  V transposed:
  // lanes 0-15 keys 0-15 at column 0, lanes 16-31 at column 8.
  const uint32_t q_lane =
      smem_addr(qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8);
  const uint32_t k_lane = smem_addr(
      ks + (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8);
  const uint32_t v_lane =
      smem_addr(vs + (lane % 16) * LD + (lane / 16) * 8);

  uint32_t qf[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // Rows g and g + 8 of the warp's 16: running max (log2 units, scaled)
  // and this lane's share of the running sum.
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * MMA_BK;
    const int stage = j % 2;
    if (j + 1 < n_tiles) {
      load_kv(k0 + MMA_BK, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and on j == 0 the Q tile) is in place
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], q_lane + kk * 32);
    }

    // A tile wholly masked for this warp's rows adds nothing: skip it.
    const bool skip = qw >= seq_len || (causal && k0 > qw + 15) ||
                      (window > 0 && qw - (k0 + MMA_BK - 1) >= window);
    if (!skip) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t k_tile = k_lane + stage * TILE * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, k_tile + (n2 * 16 * LD + kk * 16) * 2);
          mma_bf16(s[2 * n2], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], kb[2], kb[3]);
        }
      }

      // Scale into log2 units; mask only a tile that crosses the
      // diagonal, the window's left edge or T.
      const bool mask = (causal && k0 + MMA_BK - 1 > qw) ||
                        (window > 0 && qw + 15 - k0 >= window) ||
                        k0 + MMA_BK > seq_len;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (mask) {
            const int p = qw + g + (e / 2) * 8;
            const int kp = k0 + n * 8 + t4 * 2 + e % 2;
            bool keep = kp < seq_len;
            if (causal) keep = keep && p >= kp;
            if (window > 0) keep = keep && p - kp < window;
            x = keep ? x : NEG_INF;
          }
          s[n][e] = x;
        }
      }

      // Online softmax on the fragments: a row's 4 lanes are one quad.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float rescale[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        rescale[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= rescale[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - mx[e / 2]);
          l[e / 2] += s[n][e];
        }
      }
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][0] *= rescale[0];
        acc[n][1] *= rescale[0];
        acc[n][2] *= rescale[1];
        acc[n][3] *= rescale[1];
      }

      // O += P V: n-tiles 2kk and 2kk+1 of S are the A fragment of
      // k-step kk.
      const uint32_t v_tile = v_lane + stage * TILE * 2;
#pragma unroll
      for (int kk = 0; kk < MMA_BK / 16; ++kk) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < DT / 2; ++n2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, v_tile + (kk * 16 * LD + n2 * 16) * 2);
          mma_bf16(acc[2 * n2], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * n2 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = qw + g + r * 8;
    if (p >= seq_len) continue;
    const float ll = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / ll;
    __nv_bfloat16* orow = o + b * o_sb + (int64_t)p * o_st + h * o_sh;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (lse != nullptr && t4 == 0) {
      lse[((int64_t)b * heads + h) * seq_len + p] = m[r] * LN2 + logf(ll);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int seq_len, int heads,
               const long long* st, float sm_scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, batch, (seq_len + MMA_BQ - 1) / MMA_BQ);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), seq_len, heads, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      sm_scale * LOG2E, causal, window);
  return 0;
}

int dispatch_bf16(int head_dim, const void* q, const void* k, const void* v,
                  void* o, void* lse, int batch, int seq_len, int heads,
                  const long long* st, float sm_scale, int causal, int window,
                  cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_mma<16>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 32:
      return launch_mma<32>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 64:
      return launch_mma<64>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 128:
      return launch_mma<128>(q, k, v, o, lse, batch, seq_len, heads, st,
                             sm_scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// f32: scalar kernel
// ---------------------------------------------------------------------

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int NSUB = 4;             // threads per query row
constexpr int THREADS = BQ * NSUB;  // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq_len, int heads,
                     int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                     int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                     int64_t v_sh, int64_t o_sb, int64_t o_st, int64_t o_sh,
                     float sm_scale, int causal, int window) {
  constexpr int C = D / 4;        // float4 chunks per row
  constexpr int CPT = C / NSUB;   // chunks per thread
  static_assert(D % (4 * NSUB) == 0, "head_dim must be a multiple of 16");
  __shared__ float4 ks[BK][C];
  __shared__ float4 vs[BK][C];

  const int tid = threadIdx.x;
  const int row = tid / NSUB;
  const int sub = tid % NSUB;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = q0 + row;
  const bool row_ok = qpos < seq_len;

  float4 qr[CPT];
  float4 acc[CPT];
  const float* qrow = q + b * q_sb + (int64_t)qpos * q_st + h * q_sh;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    float4 x = row_ok ? load4(qrow + d0) : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = make_float4(x.x * sm_scale, x.y * sm_scale, x.z * sm_scale,
                        x.w * sm_scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF;
  float l = 0.f;

  // Tiles above the q-tile's diagonal and left of its window are skipped.
  const int k_end = causal ? min(seq_len, q0 + BQ) : seq_len;
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;
    k_begin = first > 0 ? (first / BK) * BK : 0;
  }

  const float* kbase = k + b * k_sb + h * k_sh;
  const float* vbase = v + b * v_sb + h * v_sh;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * C; idx += THREADS) {
      const int r = idx / C;
      const int ch = idx % C;
      const int kp = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kp < seq_len) {
        kx = load4(kbase + (int64_t)kp * k_st + ch * 4);
        vx = load4(vbase + (int64_t)kp * v_st + ch * 4);
      }
      ks[r][ch] = kx;
      vs[r][ch] = vx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 kk = ks[j][c * NSUB + sub];
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
      // The NSUB threads of a row are adjacent lanes of one warp.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      bool keep = kp < seq_len;
      if (causal) keep = keep && qpos >= kp;
      if (window > 0) keep = keep && qpos - kp < window;
      s[j] = keep ? part : NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float rescale = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * rescale + psum;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[c].x *= rescale;
      acc[c].y *= rescale;
      acc[c].z *= rescale;
      acc[c].w *= rescale;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 vv = vs[j][c * NSUB + sub];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  l = fmaxf(l, 1e-20f);
  const float inv = 1.f / l;
  float* orow = o + b * o_sb + (int64_t)qpos * o_st + h * o_sh;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    orow[d0 + 0] = acc[c].x * inv;
    orow[d0 + 1] = acc[c].y * inv;
    orow[d0 + 2] = acc[c].z * inv;
    orow[d0 + 3] = acc[c].w * inv;
  }
  if (lse != nullptr && sub == 0) {
    lse[((int64_t)b * heads + h) * seq_len + qpos] = m + logf(l);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int seq_len, int heads,
               const long long* st, float sm_scale, int causal, int window,
               cudaStream_t stream) {
  dim3 grid((seq_len + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq_len, heads, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], sm_scale,
      causal, window);
  return 0;
}

int dispatch_f32(int head_dim, const void* q, const void* k, const void* v,
                 void* o, void* lse, int batch, int seq_len, int heads,
                 const long long* st, float sm_scale, int causal, int window,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_f32<16>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 32:
      return launch_f32<32>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 64:
      return launch_f32<64>(q, k, v, o, lse, batch, seq_len, heads, st,
                            sm_scale, causal, window, stream);
    case 128:
      return launch_f32<128>(q, k, v, o, lse, batch, seq_len, heads, st,
                             sm_scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32 (scalar
// kernel), 1 = bfloat16 (tensor-core kernel).  Strides are in elements,
// (batch, token, head) for q, k, v, o; the head dimension must be
// contiguous.  lse may be null; otherwise it is a contiguous (B, H, T) f32
// buffer.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (nonzero when the launch was refused or the arguments
// are unsupported).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int batch, int seq_len,
                         int heads, int head_dim, long long q_sb,
                         long long q_st, long long q_sh, long long k_sb,
                         long long k_st, long long k_sh, long long v_sb,
                         long long v_st, long long v_sh, long long o_sb,
                         long long o_st, long long o_sh, float sm_scale,
                         int causal, int window, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_f32(head_dim, q, k, v, o, lse, batch, seq_len, heads, st,
                       sm_scale, causal, window, s);
  } else if (dtype == 1) {
    err = dispatch_bf16(head_dim, q, k, v, o, lse, batch, seq_len, heads, st,
                        sm_scale, causal, window, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
