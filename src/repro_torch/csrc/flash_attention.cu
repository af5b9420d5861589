// Flash attention forward for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind `ops.flash_mha`). Same function, on the model's layout:
// q (B, Sq, H, Dh), k/v (B, Sk, Kv, Dh), any strides; out (B, Sq, H, Dh)
// contiguous. Query head h reads kv head h / (H / Kv) (GQA). Per row:
//   s_k = (scale q) . k_k,  s_k = tanh(s_k / softcap) softcap (if set),
//   masked unless k < Sk, k <= q (causal, index-based, top-left aligned
//   also when Sq != Sk) and k > q - window (if set);
//   out = sum_k softmax(s)_k v_k, an fp32 online softmax over key tiles,
//   finished by dividing by max(l, 1e-20).
// Masked scores are -1e30 (the Pallas kernel's NEG_INF) for the running
// max and contribute exactly 0 to the sums. Keys at index >= Sk are always
// masked: the Pallas kernel lets its zero pad keys into the softmax when it
// is not causal and Sk is not a multiple of its block (no causal or window
// term masks them); this kernel follows mha_ref there. A row with no
// visible key gives 0.
//
// Bound: operations. At the dense prefill's shape (B 4, S 675, H 32, Kv 8,
// Dh 128, causal) the visible (q, k) pairs need 4 Dh FLOPs each per query
// head, 14.95 GFLOP, against 111 MB of q, o and K/V (K/V once per kv
// head): 0.223 ms of fp32 FMAs at 67 TFLOP/s, 0.033 ms of bytes at 3.35
// TB/s. TF32 tensor cores are out: the port keeps fp32 for parity with the
// reference.
//
// Design: grid (ceil(Sq/64), H, B) of 256-thread blocks, heavy (late,
// causal) query tiles first. A block stages its 64 query rows once,
// transposed and scaled, in shared memory, then walks the key tiles of its
// kv head that some row of it can see (the loop bounds skip the tiles that
// causality or the window mask for all 64 rows, as the Pallas kernel's
// `need` does). Per 64-key tile: K^T into shared memory, S = Q K^T with a
// 4 x 4 register tile a thread, masking and the online-softmax statistics
// (row max and sum across the 16 threads of a row by warp shuffles), P^T
// into shared memory, V into the buffer K used, and O += P V with a 4 x Dp/16
// register tile. Head dims pad to Dp = 64 or 128 with zeros in shared
// memory. Operands are read from shared memory as float4. The tile loads
// from device memory are unrolled 8 deep, so that 8 loads a thread are in
// flight; 16 deep takes the registers past two blocks an SM. Nothing is
// summed across blocks, so the result does not depend on the order blocks
// run in. No wgmma, TMA, cp.async double buffering or tensor cores yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;         // query rows and keys per tile
constexpr int kThreads = 256;     // 16 x 16 threads, 4 rows x 4 cols each
constexpr int kStride = kTile + 4;  // row stride of Q^T, K^T, P^T (float4s)
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h, d;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  Strides qs, ks, vs;
  int Sq, Sk, H, Kv, Dh;
  int causal;
  int window;  // 0: none
  float scale;
  float softcap;  // 0: none
};

template <int Dp>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(Args a) {
  constexpr int G = Dp / 64;  // float4 column groups of O a thread holds
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Kv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = tile * kTile;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt_s = smem;                  // Q^T (Dp, kStride), scaled
  float* kv_s = qt_s + Dp * kStride;   // K^T (Dp, kStride), then V (64, Dp)
  float* pt_s = kv_s + Dp * kStride;   // P^T (64, kStride)

  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
#pragma unroll 8
  for (int i = tid; i < kTile * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.f;
    if (q0 + r < a.Sq && d < a.Dh)
      x = qb[(q0 + r) * a.qs.s + d * a.qs.d] * a.scale;
    qt_s[d * kStride + r] = x;
  }

  // the key range some row of this tile can see
  const int q_last = min(q0 + kTile, a.Sq) - 1;
  int hi = a.Sk, lo = 0;
  if (a.causal) hi = min(hi, q_last + 1);
  if (a.window > 0) lo = max(0, q0 - a.window + 1);

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
  }

  const float* kb = a.k + b * a.ks.b + hk * a.ks.h;
  const float* vb = a.v + b * a.vs.b + hk * a.vs.h;
  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
#pragma unroll 8
    for (int i = tid; i < kTile * Dp; i += kThreads) {
      const int c = i / Dp, d = i - c * Dp;
      kv_s[d * kStride + c] = (k0 + c < a.Sk && d < a.Dh)
                                  ? kb[(k0 + c) * a.ks.s + d * a.ks.d]
                                  : 0.f;
    }
    __syncthreads();  // K^T staged (and, on the first tile, Q^T)

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dp; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          qt_s + d * kStride + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(
          kv_s + d * kStride + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // softcap, mask, and the online-softmax update of each row; a row's
    // 64 scores sit in the 16 neighbouring lanes that share ty
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + 4 * ty + i;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + 4 * tx + j;
        vis[j] = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                 (a.window <= 0 || kpos > qpos - a.window);
        float x = s[i][j];
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        s[i][j] = vis[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * G; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // every thread is done reading K^T

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt_s + (4 * tx + j) * kStride + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
#pragma unroll 8
    for (int i = tid; i < kTile * Dp; i += kThreads) {
      const int c = i / Dp, d = i - c * Dp;
      kv_s[c * Dp + d] = (k0 + c < a.Sk && d < a.Dh)
                             ? vb[(k0 + c) * a.vs.s + d * a.vs.d]
                             : 0.f;
    }
    __syncthreads();  // P^T and V staged

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(
          pt_s + c * kStride + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            kv_s + c * Dp + 64 * g + 4 * tx);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * g + j] = fmaf(pa[i], va[j], acc[i][4 * g + j]);
      }
    }
    __syncthreads();  // every thread is done reading P^T and V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* orow = a.o + (((long long)b * a.Sq + qpos) * a.H + h) * a.Dh;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 64 * g + 4 * tx + j;
        if (d < a.Dh) orow[d] = acc[i][4 * g + j] * inv;
      }
  }
}

template <int Dp>
int launch(const Args& a, int B, void* stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)Dp + kTile) * kStride;
  // above 48 KB a kernel needs its dynamic shared-memory limit raised, once
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<Dp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  dim3 grid((a.Sq + kTile - 1) / kTile, a.H, B);
  flash_attention_f32_kernel<Dp>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int Kv, int Dh, long long qsb, long long qss,
    long long qsh, long long qsd, long long ksb, long long kss,
    long long ksh, long long ksd, long long vsb, long long vss,
    long long vsh, long long vsd, int causal, int window, float scale,
    float softcap, void* stream) {
  if (Dh < 1 || Dh > 128 || Kv < 1 || H % Kv) return (int)cudaErrorInvalidValue;
  Args a{(const float*)q, (const float*)k, (const float*)v, (float*)o,
         {qsb, qss, qsh, qsd}, {ksb, kss, ksh, ksd}, {vsb, vss, vsh, vsd},
         Sq, Sk, H, Kv, Dh, causal, window, scale, softcap};
  return Dh <= 64 ? launch<64>(a, B, stream) : launch<128>(a, B, stream);
}
