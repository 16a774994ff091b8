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
// operations (~35 us on the bf16 tensor cores at 989 TFLOP/s).  This first
// version is simple and exact rather than fast: all products are scalar
// f32 FMAs (bf16 tiles are upcast to f32 before both products, as the TPU
// kernel does; f32 inputs never touch TF32), so it is limited by the f32
// FMA rate (67 TFLOP/s) and by shared-memory issue.  wgmma/TMA come later.
//
// Design:
// - one thread block per (q-tile of BQ rows, head, batch); NSUB threads
//   share one query row, each owning every NSUB-th float4 chunk of d, so
//   the q row and its f32 accumulator live in registers and a shared-memory
//   read of a K/V chunk is one conflict-free 16-byte load;
// - q/k/v/o are read and written in the (B, T, H, d) layout from strides:
//   no transposed copies (the TPU path folds to (B*H, T, d) first);
// - K/V tiles of BK keys are staged in shared memory as f32; the online
//   softmax (m, l, acc) runs in f32 once per tile;
// - the key loop starts at the window's first tile and stops at the
//   q-tile's diagonal, as the TPU kernel's block skipping does; the ragged
//   tail (T not a multiple of the tiles) is masked here, not padded;
// - masked scores are the finite -1e30 of the TPU kernel, so fully masked
//   leading tiles behave exactly as there (their weight is wiped by
//   exp(-1e30 - m) = 0 once a visible key arrives; every row sees >= 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int NSUB = 4;             // threads per query row
constexpr int THREADS = BQ * NSUB;  // 256
constexpr float NEG_INF = -1e30f;

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

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qrow = q + b * q_sb + (int64_t)qpos * q_st + h * q_sh;
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

  const T* kbase = k + b * k_sb + h * k_sh;
  const T* vbase = v + b * v_sb + h * v_sh;
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
  T* orow = o + b * o_sb + (int64_t)qpos * o_st + h * o_sh;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d0 = (c * NSUB + sub) * 4;
    store(orow + d0 + 0, acc[c].x * inv);
    store(orow + d0 + 1, acc[c].y * inv);
    store(orow + d0 + 2, acc[c].z * inv);
    store(orow + d0 + 3, acc[c].w * inv);
  }
  if (lse != nullptr && sub == 0) {
    lse[((int64_t)b * heads + h) * seq_len + qpos] = m + logf(l);
  }
}

template <int D, typename T>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int batch, int seq_len, int heads, const long long* st,
            float sm_scale, int causal, int window, cudaStream_t stream) {
  dim3 grid((seq_len + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<D, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq_len, heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], sm_scale, causal, window);
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 void* o, void* lse, int batch, int seq_len, int heads,
                 const long long* st, float sm_scale, int causal, int window,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      launch<16, T>(q, k, v, o, lse, batch, seq_len, heads, st, sm_scale,
                    causal, window, stream);
      return 0;
    case 32:
      launch<32, T>(q, k, v, o, lse, batch, seq_len, heads, st, sm_scale,
                    causal, window, stream);
      return 0;
    case 64:
      launch<64, T>(q, k, v, o, lse, batch, seq_len, heads, st, sm_scale,
                    causal, window, stream);
      return 0;
    case 128:
      launch<128, T>(q, k, v, o, lse, batch, seq_len, heads, st, sm_scale,
                     causal, window, stream);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements, (batch, token, head) for q, k, v, o; the head
// dimension must be contiguous.  lse may be null; otherwise it is a
// contiguous (B, H, T) f32 buffer.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (nonzero when the launch
// was refused or the arguments are unsupported).
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
  int bad;
  if (dtype == 0) {
    bad = dispatch_dim<float>(head_dim, q, k, v, o, lse, batch, seq_len,
                              heads, st, sm_scale, causal, window, s);
  } else if (dtype == 1) {
    bad = dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch,
                                      seq_len, heads, st, sm_scale, causal,
                                      window, s);
  } else {
    bad = 1;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
