// Mamba2 SSD intra-chunk terms for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU
// kernel behind `ssd_intra`). Same contract, per (batch, chunk, head), with
// cs = inclusive cumsum of dt * a along the chunk:
//   y[t]   = sum_{u <= t} (C_t . B_u) exp(cs_t - cs_u) dt_u x_u   (Q, P)
//   states = sum_u exp(cs_last - cs_u) dt_u x_u B_u^T             (P, N)
//   decay  = exp(cs_last)
// x (B,NC,Q,H,P), dt (B,NC,Q,H), a (H,), b/c (B,NC,Q,G,N) with G dividing H
// (head h reads group h / (H/G)); out y (B,NC,Q,H,P), states (B,NC,H,P,N),
// decay (B,NC,H). B and NC are flattened into one index here.
//
// The upper triangle (u > t) is never formed: exp(cs_t - cs_u) there can
// be inf in fp32 (cs falls by ~0.7 a token at A = -1), and inf * 0 would be
// NaN. Those terms are skipped, so they are exactly 0, as the reference's
// `where` makes them. Rows past Q (the last 64-row tile's edge) read zeros
// and are not written.
//
// Bound: operations. Per (batch, chunk) the least work is the lower
// triangle of C B^T once per group (Q(Q+1)/2 x N MACs; all the group's
// heads share it) and, per head, the lower triangle of W x (Q(Q+1)/2 x P)
// plus the state product (Q x P x N): ~206 M MACs at Q=256, P=64, N=128,
// H=48, G=1, against ~8 MB of inputs and outputs, so fp32 FMAs (67 TFLOP/s
// outside the tensor cores), not bytes, bound it. TF32 tensor cores are
// out: the port keeps fp32 for parity with the reference.
//
// This kernel forms C B^T in every head's blocks, H/G times per group:
// at G=1 that is about half its FLOPs, and the first thing to remove (one
// S tile per (tile, group, batch x chunk), reused across the group's
// heads).
//
// Design: grid (Q/64 + 1, H, B*NC) of 256-thread blocks. Block x < Q/64
// owns query rows [64x, 64x+64): it stages C for its rows once, then for
// each key tile u0 <= its own stages B, x and dt, forms the 64 x 64 tile
// S = C B^T, turns it into W = S * exp(cs_t - cs_u) * dt_u (0 above the
// diagonal) in shared memory and accumulates y += W x in registers. The
// last block of each (head, batch x chunk) computes the state, a (P, N)
// product over all Q rows of (x * exp(cs_last - cs_u) * dt_u) and B, in
// 64-column tiles of N, and the decay. Every block computes cs for its
// chunk itself (a warp-shuffle scan, 256 rows at a time), so no block waits
// on another and nothing is summed with atomics (the result does not
// depend on the order blocks run in). Each thread holds a 4 x 4 register
// tile of every 64 x 64 product, reading shared memory with a row stride
// that is odd (C and B) or reading along rows (x, W), so a warp's reads
// hit distinct banks or broadcast. No wgmma, TMA or tensor cores yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;      // rows of a tile; the edge of each product
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;

// acc[i][j] += sum_k A(ty + 16 i, k) * Bm(tx + 16 j, k), where A(r, k) is
// a[r * ars + k * aks] and Bm(r, k) is bm[r * brs + k * bks], in shared
// memory.
__device__ __forceinline__ void tile_product(float acc[4][4], const float* a,
                                             int ars, int aks, const float* bm,
                                             int brs, int bks, int depth,
                                             int ty, int tx) {
  for (int k = 0; k < depth; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * ars + k * aks];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bm[(tx + 16 * j) * brs + k * bks];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// cs_s[t] = sum_{u <= t} dt[u] * a for t < Q (dt strided by H), by the
// whole block: a warp-shuffle scan of 256 rows at a time plus a carry.
__device__ void chunk_cumsum(const float* __restrict__ dt, int H, float a,
                             int Q, float* cs_s, float* warp_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kThreads) {
    const int t = base + tid;
    float v = t < Q ? dt[(size_t)t * H] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    float before = carry, total = carry;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_s[w];
      total += warp_s[w];
    }
    if (t < Q) cs_s[t] = before + v;
    carry = total;
    __syncthreads();  // warp_s is rewritten by the next 256 rows
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_intra_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c, float* __restrict__ y,
                     float* __restrict__ states, float* __restrict__ decay,
                     int Q, int H, int P, int G, int N) {
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const size_t bc = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int ns = N + 1;  // odd row stride of the C and B tiles

  extern __shared__ float smem[];
  float* cs_s = smem;                 // Q
  float* warp_s = cs_s + Q;           // kWarps
  float* dt_s = warp_s + kWarps;      // kTile
  float* x_s = dt_s + kTile;          // kTile x kTile (cols >= P are 0)
  float* w_s = x_s + kTile * kTile;   // kTile x (kTile + 1)
  float* b_s = w_s + kTile * (kTile + 1);  // kTile x (N + 1)
  float* c_s = b_s + kTile * ns;           // kTile x (N + 1)

  const float* x_bc = x + bc * Q * H * P + (size_t)h * P;  // row stride H*P
  const float* dt_bc = dt + bc * Q * H + h;                 // row stride H
  const float* b_bc = b + bc * Q * G * N + (size_t)g * N;   // row stride G*N
  const float* c_bc = c + bc * Q * G * N + (size_t)g * N;
  const float a_h = a[h];

  chunk_cumsum(dt_bc, H, a_h, Q, cs_s, warp_s);

  if (tile == n_tiles) {
    // ---- chunk state and decay ----
    const float cs_last = cs_s[Q - 1];
    if (tid == 0) decay[bc * H + h] = expf(cs_last);
    float* bn_s = w_s;  // kTile x kTile: B rows, one 64-column tile of N
    for (int n0 = 0; n0 < N; n0 += kTile) {
      float acc[4][4] = {};
      for (int u0 = 0; u0 < Q; u0 += kTile) {
        __syncthreads();  // the previous tile's reads are done
        if (tid < kTile) {
          // the row's weight; dt_u = 0 (a padded row) adds nothing
          const int u = u0 + tid;
          dt_s[tid] = u < Q ? expf(cs_last - cs_s[u]) * dt_bc[(size_t)u * H]
                            : 0.f;
        }
        __syncthreads();
        for (int i = tid; i < kTile * kTile; i += kThreads) {
          const int r = i / kTile, col = i % kTile, u = u0 + r;
          x_s[i] = (u < Q && col < P)
                       ? x_bc[(size_t)u * H * P + col] * dt_s[r] : 0.f;
          bn_s[i] = (u < Q && n0 + col < N)
                        ? b_bc[(size_t)u * G * N + n0 + col] : 0.f;
        }
        __syncthreads();
        // states[p][n] += sum_u xw[u][p] * B[u][n]
        tile_product(acc, x_s, 1, kTile, bn_s, 1, kTile, kTile, ty, tx);
      }
      float* st = states + (bc * H + h) * (size_t)P * N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = ty + 16 * i, n = n0 + tx + 16 * j;
          if (p < P && n < N) st[(size_t)p * N + n] = acc[i][j];
        }
    }
    return;
  }

  // ---- y for query rows [t0, t0 + 64) ----
  const int t0 = tile * kTile;
  for (int i = tid; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i % N, t = t0 + r;
    c_s[r * ns + n] = t < Q ? c_bc[(size_t)t * G * N + n] : 0.f;
  }
  float acc_y[4][4] = {};
  for (int u0 = 0; u0 <= t0; u0 += kTile) {
    __syncthreads();  // the previous key tile's reads are done
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i % N, u = u0 + r;
      b_s[r * ns + n] = u < Q ? b_bc[(size_t)u * G * N + n] : 0.f;
    }
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, p = i % kTile, u = u0 + r;
      x_s[i] = (u < Q && p < P) ? x_bc[(size_t)u * H * P + p] : 0.f;
    }
    if (tid < kTile)
      dt_s[tid] = u0 + tid < Q ? dt_bc[(size_t)(u0 + tid) * H] : 0.f;
    __syncthreads();
    // S[t][u] = C_t . B_u
    float acc_s[4][4] = {};
    tile_product(acc_s, c_s, ns, 1, b_s, ns, 1, N, ty, tx);
    // W[t][u] = S exp(cs_t - cs_u) dt_u for u <= t, else exactly 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tl = ty + 16 * i, ul = tx + 16 * j;
        const int t = t0 + tl, u = u0 + ul;
        float w = 0.f;
        if (u <= t && t < Q)
          w = acc_s[i][j] * expf(cs_s[t] - cs_s[u]) * dt_s[ul];
        w_s[tl * (kTile + 1) + ul] = w;
      }
    __syncthreads();
    // y[t][p] += sum_u W[t][u] x[u][p]
    tile_product(acc_y, w_s, kTile + 1, 1, x_s, 1, kTile, kTile, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + ty + 16 * i, p = tx + 16 * j;
      if (t < Q && p < P) y[(bc * Q + t) * (size_t)H * P + (size_t)h * P + p] =
          acc_y[i][j];
    }
}

}  // namespace

extern "C" int ssd_intra_f32(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, void* y,
                             void* states, void* decay, int BNC, int Q, int H,
                             int P, int G, int N, void* stream) {
  if (BNC <= 0 || Q <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 ||
      P > kTile || N <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)Q + kWarps + kTile + (size_t)kTile * kTile +
                       (size_t)kTile * (kTile + 1) +
                       2 * (size_t)kTile * (N + 1));
  // raise the kernel's dynamic shared-memory limit only when a launch needs
  // more than it was last raised to, not on every launch
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const int n_tiles = (Q + kTile - 1) / kTile;
  dim3 grid(n_tiles + 1, H, BNC);
  ssd_intra_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)b,
      (const float*)c, (float*)y, (float*)states, (float*)decay, Q, H, P, G,
      N);
  return (int)cudaGetLastError();
}
