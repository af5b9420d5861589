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
// Head dims of any size: every output's head-dim column p depends on x's
// column p alone, and the decay on no column, so a block covers at most
// kT = 64 columns [p0, p0 + 64) of x, y and the states' rows, reading x
// and writing y in place at their row stride H * P (nothing is copied).
// The head-dim blocks of one piece of work are adjacent in the grid, so
// they form the same S = C B^T tiles from the same C and B in L2; only the
// first writes the decay.
//
// The upper triangle (u > t) is never formed: exp(cs_t - cs_u) there can
// be inf in fp32 (cs falls by ~0.7 a token at A = -1), and inf * 0 would be
// NaN. Those terms are skipped, so they are exactly 0, as the reference's
// `where` makes them. Rows past Q read zeros and are not written.
//
// Bound: operations. Per (batch, chunk) the least work is the lower
// triangle of C B^T once per group (Q(Q+1)/2 x N MACs; all the group's
// heads share it) and, per head, the lower triangle of W x (Q(Q+1)/2 x P)
// plus the state product (Q x P x N): ~206 M MACs at Q=256, P=64, N=128,
// H=48, G=1, against ~8 MB of inputs and outputs, so fp32 FMAs (67 TFLOP/s
// outside the tensor cores), not bytes, bound it. TF32 tensor cores are
// out: the port keeps fp32 for parity with the reference.
//
// Design: one 1-D grid of 256-thread blocks of two kinds, heaviest first
// (the host orders the levels by their work), nothing summed with atomics,
// so the result does not depend on the order blocks run in.
//  - A y-block owns 64 query rows [t0, t0 + 64) of `hb` heads of one group
//    in one (batch x chunk), so each S = C B^T tile is formed once per
//    (query tile, key tile, head block) and shared by the block's heads,
//    not formed once per head. Key tiles go in groups of up to kR: the
//    block forms their S tiles over N in 32-column chunks of C and B (a
//    two-slot cp.async ring) and keeps S^T in shared memory; then, head by
//    head, it accumulates y over the group with x tiles streaming through
//    a second two-slot ring. With cs falling along the chunk, exp(cs_t -
//    cs_u) for a key u before t0 is E_t = exp(cs_t - cs_t0) times
//    exp(cs_t0 - cs_u), both <= 1 (no overflow), so an off-diagonal tile
//    adds S (G x) with G_u = exp(cs_t0 - cs_u) dt_u folded into x as it
//    lands, and the sum is scaled by E_t once: no exp and no W per
//    (head, tile). Only the diagonal tile forms W = S * exp(cs_t - cs_u) *
//    dt_u for u <= t, per head. A chunk longer than kR key tiles runs
//    several groups, adding to the y rows the block itself wrote (no other
//    block writes them). The block first computes cs of its heads up to
//    its last row, each head's rows summed in order by one thread, as the
//    plain version's cumsum sums them.
//  - A state block owns one (head, batch x chunk): cs, the decay, the row
//    weights exp(cs_last - cs_u) dt_u, then states = (x * weight)^T B over
//    all Q rows, 32 rows at a time through a two-slot cp.async ring, x and
//    B staged once per 32 rows for 128 columns of N (twice only if N >
//    128).
// Each product keeps a register tile a thread (4 x 4 for S and S x, 4 x 8
// for the state) and reads both operands as 16-byte vectors laid out so a
// warp's reads broadcast or hit distinct banks. On the diagonal tile,
// warps whose columns all lie past their rows skip S, and each warp's W x
// stops at its last row. No wgmma, TMA or tensor cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;          // rows of a tile; the edge of S and W x
constexpr int kThreads = 256;   // 8 warps: 4 (rows) x 2 (columns)
constexpr int kWarps = kThreads / 32;
constexpr int kR = 2;           // key tiles whose S^T a y-block holds
constexpr int kNC = 32;         // columns of N in a C/B chunk
constexpr int kCS = kNC + 4;    // row stride of the C/B chunks
constexpr int kWS = kT + 4;     // row stride of W^T and x tiles (64 columns)
constexpr int kSR = 32;         // rows a state-block step stages
constexpr int kSN = 128;        // columns of N a state pass covers
constexpr int kBS = kSN + 4;    // row stride of the state block's B tile
constexpr int kSlotS = kSR * (kBS + kWS);  // B and x
// shared memory after the cs and dt arrays: a y-block's kR S^T tiles, then
// the larger of phase A's two C/B slots and phase B's W^T plus two x
// slots; a state block's two slots take the same space
constexpr int kRegionA = 2 * 2 * kT * kCS;
constexpr int kRegionB = 3 * kT * kWS;
constexpr int kRegion =
    kR * kT * kWS + (kRegionA > kRegionB ? kRegionA : kRegionB);
static_assert(2 * kSlotS <= kRegion, "state slots exceed the region");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [r0, r0 + rows) x columns [c0, c0 + w) of a row-major global
// matrix (row stride gs floats) to shared memory (row stride ss); rows at
// or past nrows and columns at or past ncols are zero. 16-byte copies when
// `vec` (w, c0, ncols, gs and the base all multiples of 4 floats).
__device__ __forceinline__ void stage(float* dst, int ss, const float* src,
                                      size_t gs, int r0, int rows, int nrows,
                                      int c0, int w, int ncols, bool vec) {
  if (vec) {
    const int w4 = w >> 2;
    for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
      const int r = i / w4, c = 4 * (i - r * w4);
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async16(dst + r * ss + c, ok ? src + (r0 + r) * gs + c0 + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async4(dst + r * ss + c, ok ? src + (r0 + r) * gs + c0 + c : src,
                ok);
    }
  }
}

// Multiplies row r of what this thread copied with the same `stage` call
// by wt[r0 + r] (rows at or past nrows stay zero). Needs no barrier: a
// thread's own cp.async copies are complete after its wait.
__device__ __forceinline__ void scale_rows(float* dst, int ss, int r0,
                                           int rows, int nrows, int w,
                                           const float* wt, bool vec) {
  if (vec) {
    const int w4 = w >> 2;
    for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
      const int r = i / w4, c = 4 * (i - r * w4);
      if (r0 + r < nrows) {
        float4* v = reinterpret_cast<float4*>(dst + r * ss + c);
        const float s = wt[r0 + r];
        float4 e = *v;
        e.x *= s;
        e.y *= s;
        e.z *= s;
        e.w *= s;
        *v = e;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      if (r0 + r < nrows) dst[r * ss + c] *= wt[r0 + r];
    }
  }
}

// For heads j < nh: dt_s[j * ld + t] = dt[t][j] and cs_s[j * ld + t] =
// sum_{u <= t} dt[u][j] * a[j], t < L (dt strided by H). One thread sums a
// head's rows one after another, as the plain version's cumsum over the
// chunk does, so cs matches it to the bit: cs reaches ~180 in a 256-row
// chunk, where another order of the sum moves exp(cs_t - cs_u) by ~1e-5.
__device__ void head_cumsums(const float* __restrict__ dt, int H,
                             const float* __restrict__ a, int nh, int L,
                             int ld, float* cs_s, float* dt_s) {
  for (int i = threadIdx.x; i < L * nh; i += kThreads) {
    const int t = i / nh, j = i - t * nh;
    const float d = dt[(size_t)t * H + j];
    dt_s[j * ld + t] = d;
    cs_s[j * ld + t] = d * a[j];
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    for (int j = threadIdx.x >> 5; j < nh; j += kWarps) {
      float* cs = cs_s + j * ld;
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        acc += cs[t];
        cs[t] = acc;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// acc[i][.] *= E_t = exp(cs_t - cs_t0) for rows t = t0 + tl + i (0 past Q)
__device__ __forceinline__ void scale_by_e(float acc[4][4], const float* cs,
                                           int t0, int tl, int Q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tl + i;
    const float e = t < Q ? expf(cs[t] - cs[t0]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= e;
  }
}

// y rows [t0, t0 + 64) x head-dim columns [p0, p0 + pw) of heads h0 ..
// h0 + nh - 1 (group g) of one chunk
__device__ void y_block(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ c, float* __restrict__ y,
                        size_t bc, int qt, int g, int h0, int nh, int Q,
                        int H, int P, int p0, int pw, int G, int N, int ld,
                        bool vec, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wy = warp >> 1, wx = warp & 1, ly = lane >> 3, lx = lane & 7;
  const int t0 = qt * kT;
  const int L = min(t0 + kT, Q);
  float* cs_s = smem;
  float* dt_s = cs_s + nh * ld;   // dt; G_u for the rows before t0
  float* st_s = dt_s + nh * ld;   // kR tiles of S^T
  float* region = st_s + kR * kT * kWS;  // phase A, then phase B
  float* w_s = region;            // phase B: W^T, then two x slots
  head_cumsums(dt + bc * Q * H + h0, H, a + h0, nh, L, ld, cs_s, dt_s);
  for (int i = tid; i < nh * t0; i += kThreads) {
    const int j = i / t0, u = i - j * t0;
    dt_s[j * ld + u] *= expf(cs_s[j * ld + t0] - cs_s[j * ld + u]);
  }
  __syncthreads();

  const size_t gN = (size_t)G * N, hP = (size_t)H * P;
  const float* c_bc = c + bc * Q * gN + (size_t)g * N;
  const float* b_bc = b + bc * Q * gN + (size_t)g * N;
  const float* x_bc = x + bc * Q * hP + p0;
  float* y_bc = y + bc * Q * hP + p0;
  const int nch = (N + kNC - 1) / kNC;
  // S tile: rows 16 wy + ly + 4 i, columns 32 wx + lx + 8 j
  // W x tile: rows 4 ty + i, columns 4 tx + j
  const int ty = 4 * wy + ly, tx = 8 * wx + lx;
  const int px = vec ? ((pw + 3) & ~3) : pw;  // x columns staged

  for (int g0 = 0; g0 <= qt; g0 += kR) {
    const int nr = min(kR, qt + 1 - g0);
    // ---- phase A: S^T of the group's key tiles into shared memory, over
    // N in 32-column chunks of C and B through a two-slot ring ----
    const int n_c = nr * nch;
    auto stage_cb = [&](int cidx) {
      const int kt = g0 + cidx / nch, n0 = (cidx % nch) * kNC;
      float* slot = region + (cidx & 1) * 2 * kT * kCS;
      stage(slot, kCS, c_bc, gN, t0, kT, Q, n0, kNC, N, vec);
      stage(slot + kT * kCS, kCS, b_bc, gN, kt * kT, kT, Q, n0, kNC, N, vec);
      cp_async_commit();
    };
    stage_cb(0);
    for (int r = 0; r < nr; ++r) {
      float S[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) S[i][j] = 0.f;
      // on the diagonal a warp whose columns all lie past its rows skips
      const bool need = g0 + r < qt || 32 * wx <= 16 * wy + 15;
      for (int ch = 0; ch < nch; ++ch) {
        const int cidx = r * nch + ch;
        if (cidx + 1 < n_c) {
          stage_cb(cidx + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (need) {
          const float* cs = region + (cidx & 1) * 2 * kT * kCS;
          const float* bs = cs + kT * kCS;
#pragma unroll 2
          for (int k = 0; k < kNC; k += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cv[i] = *reinterpret_cast<const float4*>(
                  cs + (16 * wy + ly + 4 * i) * kCS + k);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = *reinterpret_cast<const float4*>(
                  bs + (32 * wx + lx + 8 * j) * kCS + k);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) fma4(S[i][j], cv[i], bv[j]);
          }
        }
        __syncthreads();  // the slot is free for the chunk after next
      }
      // S^T[u][t]: a warp's 32 stores hit 32 banks
      float* sr = st_s + r * kT * kWS;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sr[(32 * wx + lx + 8 * j) * kWS + 16 * wy + ly + 4 * i] = S[i][j];
    }
    // ---- phase B: per head, y += S (G x) over the group's off-diagonal
    // tiles, then * E_t, then + W x on the diagonal; x tiles through a
    // two-slot ring ----
    const int n_steps = nh * nr;
    const bool has_diag = g0 + nr - 1 == qt;
    auto stage_x = [&](int step) {
      const int jh = step / nr, kt = g0 + step % nr;
      stage(w_s + (1 + (step & 1)) * kT * kWS, kWS,
            x_bc + (size_t)(h0 + jh) * P, hP, kt * kT, kT, Q, 0, px, pw,
            vec);
      cp_async_commit();
    };
    stage_x(0);
    for (int jh = 0; jh < nh; ++jh) {
      const float* csh = cs_s + jh * ld;
      const float* dth = dt_s + jh * ld;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < nr; ++r) {
        const int step = jh * nr + r;
        const int kt = g0 + r, u0 = kt * kT;
        const bool diag = kt == qt;
        __syncthreads();  // the last product is done with W^T and x
        if (diag) {
          scale_by_e(acc, csh, t0, 4 * ty, Q);
          // W^T[u][t] = S^T[u][t] exp(cs_t - cs_u) dt_u for u <= t < Q
          const float* sr = st_s + r * kT * kWS;
          for (int e = tid; e < kT * kT; e += kThreads) {
            const int ul = e >> 6, tl = e & (kT - 1);
            const int t = t0 + tl, u = u0 + ul;
            float w = 0.f;
            if (u <= t && t < Q)
              w = sr[ul * kWS + tl] * expf(csh[t] - csh[u]) * dth[u];
            w_s[ul * kWS + tl] = w;
          }
        }
        if (step + 1 < n_steps) {
          stage_x(step + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        float* xs = w_s + (1 + (step & 1)) * kT * kWS;
        if (!diag) scale_rows(xs, kWS, u0, kT, Q, px, dth, vec);
        __syncthreads();
        const float* as = diag ? w_s : st_s + r * kT * kWS;
        // u <= t: on the diagonal a warp stops at its last row
        int kmax = diag ? 16 * wy + 16 : kT;
        kmax = min(kmax, ((Q - u0) + 3) & ~3);
#pragma unroll 4
        for (int u = 0; u < kmax; ++u) {
          const float4 av =
              *reinterpret_cast<const float4*>(as + u * kWS + 4 * ty);
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + u * kWS + 4 * tx);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(ar[i], xr[j], acc[i][j]);
        }
      }
      if (!has_diag) scale_by_e(acc, csh, t0, 4 * ty, Q);
      // y rows of this head: the first group stores, later ones add
      float* yh = y_bc + (size_t)(h0 + jh) * P;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        if (t >= Q) continue;
        float* yr = yh + (size_t)t * hP;
        if (vec) {
          if (4 * tx < pw) {
            float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                   acc[i][3]);
            if (g0 > 0) {
              const float4 o = *reinterpret_cast<const float4*>(yr + 4 * tx);
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *reinterpret_cast<float4*>(yr + 4 * tx) = v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = 4 * tx + j;
            if (p < pw) yr[p] = g0 > 0 ? yr[p] + acc[i][j] : acc[i][j];
          }
        }
      }
    }
    __syncthreads();  // phase B is done with the region
  }
}

// states rows [p0, p0 + pw) of head h of one chunk, and its decay when
// p0 = 0
__device__ void state_block(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ states,
                            float* __restrict__ decay, size_t bc, int h,
                            int Q, int H, int P, int p0, int pw, int G,
                            int N, int ld, bool vec, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = h / (H / G);
  float* cs_s = smem;
  float* wt_s = cs_s + ld;  // dt, then the row weights
  float* region = wt_s + ld;
  head_cumsums(dt + bc * Q * H + h, H, a + h, 1, Q, ld, cs_s, wt_s);
  const float cs_last = cs_s[Q - 1];
  if (tid == 0 && p0 == 0) decay[bc * H + h] = expf(cs_last);
  // the row's weight; a padded row (dt_u = 0) adds nothing
  for (int u = tid; u < Q; u += kThreads)
    wt_s[u] = expf(cs_last - cs_s[u]) * wt_s[u];
  __syncthreads();

  const size_t gN = (size_t)G * N, hP = (size_t)H * P;
  const float* b_bc = b + bc * Q * gN + (size_t)g * N;
  const float* x_h = x + bc * Q * hP + (size_t)h * P + p0;
  float* st = states + ((bc * H + h) * (size_t)P + p0) * N;
  // thread tile: rows p = 4 tp + i, columns n0 + 4 tn + j and n0 + 64 +
  // 4 tn + j
  const int tp = 4 * (warp >> 1) + (lane >> 3);
  const int tn = 8 * (warp & 1) + (lane & 7);
  const int n_steps = (Q + kSR - 1) / kSR;
  for (int n0 = 0; n0 < N; n0 += kSN) {
    auto stage_step = [&](int s) {
      float* slot = region + (s & 1) * kSlotS;
      stage(slot, kBS, b_bc, gN, s * kSR, kSR, Q, n0, kSN, N, vec);
      stage(slot + kSR * kBS, kWS, x_h, hP, s * kSR, kSR, Q, 0, kT, pw, vec);
      cp_async_commit();
    };
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    stage_step(0);
    for (int s = 0; s < n_steps; ++s) {
      if (s + 1 < n_steps) {
        __syncthreads();  // the product two steps back is done
        stage_step(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      float* bs = region + (s & 1) * kSlotS;
      float* xs = bs + kSR * kBS;
      scale_rows(xs, kWS, s * kSR, kSR, Q, kT, wt_s, vec);
      __syncthreads();
      const int kmax = min(kSR, ((Q - s * kSR) + 3) & ~3);
#pragma unroll 4
      for (int u = 0; u < kmax; ++u) {
        const float4 av =
            *reinterpret_cast<const float4*>(xs + u * kWS + 4 * tp);
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + u * kBS + 4 * tn);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + u * kBS + 64 + 4 * tn);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    // states[p][n]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * tp + i;
      if (p >= pw) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + 64 * half + 4 * tn;
        float* sp = st + (size_t)p * N + n;
        if (vec) {
          if (n < N)
            *reinterpret_cast<float4*>(sp) =
                make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                            acc[i][4 * half + 2], acc[i][4 * half + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) sp[j] = acc[i][4 * half + j];
        }
      }
    }
    __syncthreads();  // the region is rewritten by the next pass
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c, float* __restrict__ y,
                     float* __restrict__ states, float* __restrict__ decay,
                     int BNC, int Q, int H, int P, int G, int N, int hb,
                     int top_levels, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int HG = H / G;
  const int n_qt = (Q + kT - 1) / kT;
  const int n_hb = (HG + hb - 1) / hb;
  const long long per_level = (long long)n_hb * G * BNC;
  const long long n_top = top_levels * per_level;
  const long long n_state = (long long)H * BNC;
  const int ld = (Q + 2) & ~1;  // even: what follows stays 16-byte aligned
  // the head-dim block varies fastest: one piece of work's blocks adjoin
  const int n_pb = (P + kT - 1) / kT;
  const int p0 = (int)(blockIdx.x % n_pb) * kT, pw = min(kT, P - p0);
  long long idx = blockIdx.x / n_pb;
  if (idx >= n_top && idx < n_top + n_state) {
    idx -= n_top;
    state_block(x, dt, a, b, states, decay, idx / H, (int)(idx % H), Q, H, P,
                p0, pw, G, N, ld, vec != 0, smem);
    return;
  }
  if (idx >= n_top) idx -= n_state;
  // y-blocks level by level, the longest query tiles first
  const int level = (int)(idx / per_level);
  long long rest = idx - level * per_level;
  const int hblk = (int)(rest % n_hb);
  rest /= n_hb;
  const int g = (int)(rest % G);
  const size_t bc = (size_t)(rest / G);
  const int hg0 = hblk * hb;
  y_block(x, dt, a, b, c, y, bc, n_qt - 1 - level, g, g * HG + hg0,
          min(hb, HG - hg0), Q, H, P, p0, pw, G, N, ld, vec != 0, smem);
}

}  // namespace

// hb: heads a y-block serves (at most H / G); top_levels: how many of the
// longest query-tile levels run before the state blocks; vec: 16-byte
// copies (P and N multiples of 4, every pointer 16-byte aligned).
extern "C" int ssd_intra_f32(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, void* y,
                             void* states, void* decay, int BNC, int Q, int H,
                             int P, int G, int N, int hb, int top_levels,
                             int vec, void* stream) {
  if (BNC <= 0 || Q <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 ||
      N <= 0 || hb <= 0 || hb > H / G || top_levels < 0 ||
      top_levels > (Q + kT - 1) / kT)
    return (int)cudaErrorInvalidValue;
  const int ld = (Q + 2) & ~1;
  const size_t smem =
      sizeof(float) * (2 * (size_t)hb * ld + (size_t)kRegion);
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
  const long long n_qt = (Q + kT - 1) / kT;
  const long long blocks =
      (n_qt * ((H / G + hb - 1) / hb) * G * BNC + (long long)H * BNC) *
      ((P + kT - 1) / kT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_intra_f32_kernel<<<(unsigned)blocks, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)a, (const float*)b,
      (const float*)c, (float*)y, (float*)states, (float*)decay, BNC, Q, H, P,
      G, N, hb, top_levels, vec);
  return (int)cudaGetLastError();
}
