// Causal / sliding-window flash-attention backward for Hopper (sm_90a):
// one kernel for dQ and one for dK/dV.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// k8s_vgpu_scheduler_tpu/ops/flash_attention.py (both launched by
// `_flash_bwd_impl`).  Same recomputation form, over (B, T, H, d) tensors:
//   P  = exp(scale * Q K^T - lse)          (masked entries are 0)
//   dS = P * (dO V^T - delta),  delta = rowsum(dO * O)  (computed outside)
//   dQ = scale * dS K,  dK = dS^T (scale * Q),  dV = P^T dO
// with lse and delta as contiguous (B, H, T) f32 rows.
//
// What bounds it on an H100: at llama_7b widths (B=1, T=2048, H=32, d=128,
// causal) dQ does 6*d flops per visible (query, key) pair (51.6 GFLOP) on
// ~84 MB, dK/dV 8*d (68.7 GFLOP) on ~101 MB: both far above the card's
// ~295 FLOP/byte ridge, so bound by operations (52 us and 70 us on the bf16
// tensor cores).  This first version is simple and exact rather than fast:
// every product is a scalar f32 FMA on upcast tiles (no TF32, no bf16 P),
// as the TPU kernels do, so it is limited by the f32 FMA rate and by
// shared-memory load throughput.  mma/wgmma and TMA come later.
//
// Design:
// - the TPU's split is kept: dQ is parallel over query tiles, dK/dV over
//   key tiles, so every output element is written by exactly one thread
//   and there is no atomicAdd: gradients are bitwise reproducible;
// - NSUB adjacent lanes share one row, each owning every NSUB-th float4
//   chunk of d; a row's dot products are reduced with xor shuffles, and a
//   shared-memory read of a chunk is one conflict-free 16-byte load;
// - the streamed operand (K/V for dQ, scaled Q/dO and their lse/delta for
//   dK/dV) is staged in shared memory as f32, TILE rows at a time;
// - tiles are skipped as in the TPU kernels: dQ walks keys from the
//   window's first tile to the query tile's diagonal; dK/dV walks queries
//   from the key tile's diagonal to the window's end;
// - (B, T, H, d) is read and written through strides; a ragged T is masked
//   here, not padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;  // streamed rows per shared-memory tile

struct Strides {
  int64_t b, t, h;  // elements; the head dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
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

template <int D, int NSUB, typename T>
__device__ __forceinline__ void store_row(T* row, const float4* x, int sub,
                                          float s) {
#pragma unroll
  for (int c = 0; c < D / 4 / NSUB; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    store(row + d0 + 0, x[c].x * s);
    store(row + d0 + 1, x[c].y * s);
    store(row + d0 + 2, x[c].z * s);
    store(row + d0 + 3, x[c].w * s);
  }
}

// dQ: one block per (query tile of ROWS rows, head, batch).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
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
  const T* qrow = q + b * qs.b + (int64_t)qpos * qs.t + h * qs.h;
  const T* drow = dout + b * ds.b + (int64_t)qpos * ds.t + h * ds.h;
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

  const T* kbase = k + b * kst.b + h * kst.h;
  const T* vbase = v + b * vst.b + h * vst.h;
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

// dK/dV: one block per (key tile of ROWS rows, head, batch).  Eight lanes
// a row (four at d=16) keep k, v and both accumulators in registers.
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int seq_len, int heads,
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
  const T* krow = k + b * ks.b + (int64_t)kpos * ks.t + h * ks.h;
  const T* vrow = v + b * vs.b + (int64_t)kpos * vs.t + h * vs.h;
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

  const T* qbase = q + b * qst.b + h * qst.h;
  const T* dbase = dout + b * dst.b + h * dst.h;
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

template <int D, typename T>
void launch_dq(const Args& a) {
  constexpr int ROWS = THREADS / 4;
  dim3 grid((a.seq_len + ROWS - 1) / ROWS, a.heads, a.batch);
  flash_bwd_dq_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.seq_len, a.heads, strides_at(a.st, 0),
      strides_at(a.st, 1), strides_at(a.st, 2), strides_at(a.st, 3),
      strides_at(a.st, 4), a.sm_scale, a.causal, a.window);
}

template <int D, typename T>
void launch_dkv(const Args& a) {
  constexpr int ROWS = THREADS / (D >= 32 ? 8 : 4);
  dim3 grid((a.seq_len + ROWS - 1) / ROWS, a.heads, a.batch);
  flash_bwd_dkv_kernel<D, T><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.seq_len, a.heads,
      strides_at(a.st, 0), strides_at(a.st, 1), strides_at(a.st, 2),
      strides_at(a.st, 3), strides_at(a.st, 4), strides_at(a.st, 5),
      a.sm_scale, a.causal, a.window);
}

template <bool DQ, typename T>
int dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16:
      if constexpr (DQ) launch_dq<16, T>(a); else launch_dkv<16, T>(a);
      return 0;
    case 32:
      if constexpr (DQ) launch_dq<32, T>(a); else launch_dkv<32, T>(a);
      return 0;
    case 64:
      if constexpr (DQ) launch_dq<64, T>(a); else launch_dkv<64, T>(a);
      return 0;
    case 128:
      if constexpr (DQ) launch_dq<128, T>(a); else launch_dkv<128, T>(a);
      return 0;
    default:
      return 1;
  }
}

template <bool DQ>
int dispatch(int dtype, int head_dim, const Args& a) {
  int bad;
  if (dtype == 0) {
    bad = dispatch_dim<DQ, float>(head_dim, a);
  } else if (dtype == 1) {
    bad = dispatch_dim<DQ, __nv_bfloat16>(head_dim, a);
  } else {
    bad = 1;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, the same for q, k, v, dO and the gradients.  Strides are in
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
