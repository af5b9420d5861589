// Flash attention forward for Hopper (sm_90a), exact fp32.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind `ops.flash_mha`). Same function, on the model's layout:
// q (B, Sq, H, Dh), k/v (B, Sk, Kv, Dh), any strides of the first three
// dimensions and a unit stride along Dh (the wrapper copies an input whose
// Dh is strided); out (B, Sq, H, Dh) contiguous; head dims 1..256. Query
// head h reads kv head h / (H / Kv) (GQA). Per row:
//   s_k = scale (q . k_k),  s_k = tanh(s_k / softcap) softcap (if set),
//   masked unless k < Sk, k <= q (causal, index-based, top-left aligned
//   also when Sq != Sk) and k > q - window (if set, compared in 64 bits);
//   out = sum_k softmax(s)_k v_k, an fp32 online softmax over key tiles,
//   finished by dividing by max(l, 1e-20).
// The running max starts at -1e30 (the Pallas kernel's NEG_INF); masked
// scores are -inf, never raise it, and contribute exactly 0 to the sums.
// Keys at index >= Sk are always masked: the Pallas kernel lets its zero
// pad keys into the softmax when it is not causal and Sk is not a multiple
// of its block (no causal or window term masks them); this kernel follows
// mha_ref there. A row with no visible key gives 0. Nothing is summed
// across blocks, so the result does not depend on the order blocks run in.
//
// Bound: operations. At the dense prefill's shape (B 4, S 675, H 32, Kv 8,
// Dh 128, causal) the visible (q, k) pairs need 4 Dh FLOPs each per query
// head, 14.95 GFLOP, against 111 MB of q, o and K/V (K/V once per kv
// head): 0.223 ms of fp32 FMAs at 67 TFLOP/s, 0.033 ms of bytes at 3.35
// TB/s. Every product is an fp32 FMA on the SIMT units: no mma, wgmma or
// TF32 in any form (the port keeps fp32 for parity with the reference).
// So the design keeps the FMA pipes issuing: few other instructions an
// FMA, no stall on device memory, blocks spread evenly over the SMs.
//
// Design. One 256-thread block per (tile of BM packed query rows, kv head,
// batch row). The rep = H / Kv query heads of a kv head are stacked as
// rows: packed row i of kv head hk is position i / rep of query head
// hk rep + i % rep, the order of memory in the (B, S, H, Dh) layout; each
// row keeps its own position for the masks. Block indices run over every
// (kv head, batch row) of the last (heaviest, when causal) query tile
// first, then the tile before it, so the SMs take the long blocks first
// and finish together. A block walks the 64-key tiles that some of its
// rows can see (causal upper bound, window lower bound). Per key tile:
//   1. S^T = (Q K^T)^T into shared memory. At Dp = 128, d is split in two
//      halves over the warps and each thread keeps an 8 rows x 8 keys
//      tile: per 4 d, 8 float4 of Q and 8 of K for 256 FMAs (one float4
//      read per 16 FMAs); the softmax adds the two halves. At Dp = 64
//      (256) the tile is 8 x 4 (4 x 4) over all of d. A warp whose rows
//      and keys are all masked (the diagonal's upper part, the window's
//      edge, keys past Sk) skips its FMAs.
//   2. The online softmax, 256 / BM threads a row: scale, softcap (its
//      branch hoisted out of the loop), mask, row max and sum by warp
//      shuffles, exp2 of scores taken in base 2; P^T over S^T in place and
//      each row's rescale into shared memory.
//   3. O = O rescale + P V: thread tiles of R rows x 4 Dp/64 columns (8 x 8
//      at Dp = 128: two float4 of P^T and two of V per 64 FMAs). Each warp
//      stops at the last key its rows can see and starts at the first, so
//      the masked part of a diagonal tile is skipped a warp (4 positions
//      at rep 4) at a time.
// K and V tiles stream through a ring of two slots in shared memory,
// K_t V_t K_t+1 V_t+1 ..., by 16-byte cp.async.cg copies (4-byte
// cp.async.ca where Dh or a stride is not a multiple of 4, or a pointer
// not 16-byte aligned) and commit/wait groups: V_t is in flight during
// step 1 and the softmax of tile t, K_t+1 during its softmax and step 3;
// each copy starts as soon as its slot is free. A ring of two (K, V)
// stages does not fit beside Q and S^T (227 KB a block). Q, K and V sit
// row-major with rows padded by 4 floats, so the float4 reads of up to 8
// rows at one column fall in distinct banks; S^T's rows are padded to BM
// + 8 floats, so step 1's scalar stores and the softmax's accesses do too.
// Head dims pad with zeros to Dp = 64, 128 or 256. At Dp = 128, 206 KB of
// shared memory and up to 255 registers: one block an SM; at Dp = 256 the
// tile has BM = 64 rows (218 KB); at Dp = 64, 105 KB and two blocks an
// SM. Three block-wide syncs a key tile.
//
// What this does about the five holds of the previous design: one query
// head a block (now rep heads share each K/V tile, read once for all);
// 4 x 4 thread tiles, 2 float4 reads per 16 FMAs in Q K^T and 3 per 32 in
// P V (now 1 per 16 in both at Dp = 128); plain loads fenced by four
// syncs a tile (now cp.async, overlapped with compute, three syncs); 4-way
// bank conflicts on the transposed Q^T and K^T stores (now no transposed
// store and no conflict); diagonal tiles computed in full (now skipped a
// warp at a time in both products).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // keys per tile
constexpr float kNegInf = -1e30f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int B, Sq, Sk, H, Kv, Dh;
  int causal;
  int window;  // 0: none
  float scale;
  float softcap;  // 0: none
  int vec;        // 1: rows and strides allow 16-byte copies
};

template <int Dp>
struct Cfg {
  static constexpr int BM = Dp > 128 ? 64 : 128;  // packed query rows
  static constexpr int R = BM / 16;   // rows of a thread's O tile
  static constexpr int U = Dp / 64;   // float4 columns of O a thread holds
  static constexpr int QS = Dp + 4;   // row stride of Q, K, V (floats)
  static constexpr int SS = BM + 8;   // row stride of S^T and P^T
  static constexpr int TPR = kThreads / BM;  // softmax threads a row
  // step 1: d split in SPLIT parts over the warps, thread tiles of RS rows
  // x KS keys, KB key blocks of warps
  static constexpr int SPLIT = Dp == 128 ? 2 : 1;
  static constexpr int RS = Dp == 256 ? 4 : 8;
  static constexpr int KS = Dp == 128 ? 8 : 4;
  static constexpr int KB = kBN / (4 * KS);
  static_assert(BM / (8 * RS) * KB * SPLIT == kThreads / 32,
                "step 1 takes every warp");
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)(BM + 2 * kBN) * QS +
                       (size_t)SPLIT * kBN * SS + 2 * BM);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of ROWS rows of Dp floats into dst (row stride Dp + 4):
// row r starts at row(r) and is real when r < n_real; other rows and the
// columns at or past Dh are zero-filled. row(0) is always a real row.
template <int Dp, int ROWS, class RowPtr>
__device__ __forceinline__ void load_rows(float* dst, RowPtr row,
                                          int n_real, int Dh, bool vec) {
  constexpr int QS = Dp + 4;
  if (vec) {
    constexpr int C4 = Dp / 4, STEP = kThreads / C4;
    static_assert(ROWS % STEP == 0, "rows split evenly over the threads");
    const int c = 4 * (threadIdx.x % C4), r0 = threadIdx.x / C4;
#pragma unroll
    for (int n = 0; n < ROWS / STEP; ++n) {
      const int r = r0 + n * STEP;
      const bool ok = r < n_real && c < Dh;
      cp_async16(dst + r * QS + c, ok ? row(r) + c : row(0), ok);
    }
  } else {
    constexpr int STEP = kThreads / Dp;
    const int c = threadIdx.x % Dp, r0 = threadIdx.x / Dp;
#pragma unroll 8
    for (int n = 0; n < ROWS / STEP; ++n) {
      const int r = r0 + n * STEP;
      const bool ok = r < n_real && c < Dh;
      cp_async4(dst + r * QS + c, ok ? row(r) + c : row(0), ok);
    }
  }
}

template <int Dp>
__global__ void __launch_bounds__(kThreads, Dp == 64 ? 2 : 1)
flash_attention_f32_kernel(Args a) {
  using C = Cfg<Dp>;
  constexpr int BM = C::BM, R = C::R, U = C::U, QS = C::QS, SS = C::SS,
                TPR = C::TPR, SPLIT = C::SPLIT, RS = C::RS, KS = C::KS,
                KB = C::KB;
  constexpr int RPW = 32 / TPR;  // rows of a warp in the softmax
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // blocks run in index order: every (kv head, batch row) of the last
  // (heaviest, when causal) query tile first, then the tile before it
  const int groups = a.Kv * a.B, g = blockIdx.x % groups;
  const int tile = gridDim.x / groups - 1 - blockIdx.x / groups;
  const int hk = g % a.Kv, b = g / a.Kv;
  const int rep = a.H / a.Kv;
  const int i0 = tile * BM;  // first packed row (position x rep + head)
  const int n_real = min(BM, a.Sq * rep - i0);
  const bool vec = a.vec != 0;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // Q (BM, QS)
  float* k_s = q_s + BM * QS;                     // ring slot 0: K tiles
  float* v_s = k_s + kBN * QS;                    // ring slot 1: V tiles
  float* p_s = v_s + kBN * QS;  // S^T of each d part, then P^T (kBN, SS)
  float* corr_s = p_s + SPLIT * kBN * SS;         // rescale of each row
  float* l_s = corr_s + BM;                       // final row sums

  const float* qb = a.q + b * a.qsb + (long long)hk * rep * a.qsh;
  const float* kb = a.k + b * a.ksb + hk * a.ksh;
  const float* vb = a.v + b * a.vsb + hk * a.vsh;
  auto q_row = [&](int r) {
    const int i = i0 + r, p = i / rep;
    return qb + p * a.qss + (i - p * rep) * a.qsh;
  };

  // the key range some row of this tile can see
  const long long p_first = i0 / rep, p_last = (i0 + n_real - 1) / rep;
  long long hi = a.Sk, lo = 0;
  if (a.causal) hi = min(hi, p_last + 1);
  if (a.window > 0) lo = max(0LL, p_first - a.window + 1);
  const int t_lo = (int)(lo / kBN), t_hi = (int)((hi + kBN - 1) / kBN);

  // step 1 geometry: warp (d part, row block, key block), rows
  // s_r0 + ty + 8i, keys s_c0 + tx + 4j
  const int ty = lane >> 2, tx = lane & 3;
  constexpr int WP = kThreads / 32 / SPLIT;  // warps a d part
  const int s_part = warp / WP, s_w = warp % WP;
  const int s_r0 = s_w / KB * 8 * RS, s_c0 = s_w % KB * 4 * KS;
  const int s_rl = min(s_r0 + 8 * RS, n_real) - 1;
  const long long s_pmin = (i0 + s_r0) / rep, s_pmax = (i0 + s_rl) / rep;
  // step 2: the thread's row and its part of the row's keys
  const int m_row = warp * RPW + lane % RPW, m_part = lane / RPW;
  const long long m_pos = (i0 + m_row) / rep;
  // step 3: rows w 2R + (lane / 16) R + i, columns 4 (lane % 16) + 64 u
  const int o_w0 = warp * 2 * R, o_r0 = o_w0 + (lane >> 4) * R;
  const int o_c0 = 4 * (lane & 15), o_wl = min(o_w0 + 2 * R, n_real) - 1;
  const long long o_pmin = (i0 + o_w0) / rep, o_pmax = (i0 + o_wl) / rep;

  // scores in base 2: s scale log2(e), or with the softcap
  // tanh(s scale / softcap) softcap log2(e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float sc_in = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  const float sc_out =
      a.softcap > 0.f ? a.softcap * kLog2e : a.scale * kLog2e;
  float m = kNegInf, l = 0.f;  // running max (base 2) and sum of the row
  float acc[R][4 * U];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4 * U; ++j) acc[i][j] = 0.f;

  if (t_lo < t_hi) {
    const long long k0 = (long long)t_lo * kBN;
    const int n_keys = (int)min((long long)kBN, a.Sk - k0);
    load_rows<Dp, BM>(q_s, q_row, n_real, a.Dh, vec);
    load_rows<Dp, kBN>(
        k_s, [&](int c) { return kb + (k0 + c) * a.kss; }, n_keys, a.Dh,
        vec);
    cp_async_commit();
    load_rows<Dp, kBN>(
        v_s, [&](int c) { return vb + (k0 + c) * a.vss; }, n_keys, a.Dh,
        vec);
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const long long k0 = (long long)t * kBN;
    if (t == t_lo)
      cp_async_wait<1>();  // Q and K_t (V_t may still fly)
    else
      cp_async_wait<0>();  // K_t
    __syncthreads();  // K_t visible; every thread is done with tile t-1
    if (t > t_lo) {
      const int n_keys = (int)min((long long)kBN, a.Sk - k0);
      load_rows<Dp, kBN>(
          v_s, [&](int c) { return vb + (k0 + c) * a.vss; }, n_keys, a.Dh,
          vec);
      cp_async_commit();
    }

    // 1. S^T of the warp's d part, skipped by a warp whose rows and keys
    // are all masked apart
    {
      const long long kmin = k0 + s_c0;
      const long long kmax = min(kmin + 4 * KS - 1, (long long)a.Sk - 1);
      bool any = s_rl >= s_r0 && kmin <= kmax;
      if (a.causal) any = any && kmin <= s_pmax;
      if (a.window > 0) any = any && kmax > s_pmin - a.window;
      if (any) {
        float s[RS][KS];
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int j = 0; j < KS; ++j) s[i][j] = 0.f;
        const float* qp = q_s + (s_r0 + ty) * QS + s_part * (Dp / SPLIT);
        const float* kp = k_s + (s_c0 + tx) * QS + s_part * (Dp / SPLIT);
#pragma unroll 2
        for (int d = 0; d < Dp / SPLIT; d += 4) {
          float4 qv[RS], kv[KS];
#pragma unroll
          for (int i = 0; i < RS; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qp + 8 * i * QS + d);
#pragma unroll
          for (int j = 0; j < KS; ++j)
            kv[j] = *reinterpret_cast<const float4*>(kp + 4 * j * QS + d);
#pragma unroll
          for (int i = 0; i < RS; ++i)
#pragma unroll
            for (int j = 0; j < KS; ++j) {
              s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            }
        }
        float* sp = p_s + s_part * kBN * SS;
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int j = 0; j < KS; ++j)
            sp[(s_c0 + tx + 4 * j) * SS + s_r0 + ty + 8 * i] = s[i][j];
      }
    }
    __syncthreads();  // S^T complete; the K slot is free

    if (t + 1 < t_hi) {
      const long long k1 = k0 + kBN;
      const int n_keys = (int)min((long long)kBN, a.Sk - k1);
      load_rows<Dp, kBN>(
          k_s, [&](int c) { return kb + (k1 + c) * a.kss; }, n_keys, a.Dh,
          vec);
    }
    cp_async_commit();  // K_t+1, or nothing on the last tile

    // 2. online softmax in base 2 (scores times log2 e, exp2): the
    // thread's row, keys 4 (n / G) + G part + n % G, so that the TPR parts
    // of a row read distinct banks. The row sees keys c_lo..c_hi here.
    {
      constexpr int G = 4 / TPR, NK = kBN / TPR;
      long long hi_k = min((long long)kBN, a.Sk - k0) - 1, lo_k = 0;
      if (a.causal) hi_k = min(hi_k, m_pos - k0);
      if (a.window > 0) lo_k = max(0LL, m_pos - a.window + 1 - k0);
      const int c_hi = (int)max(hi_k, -1LL);
      const int c_lo = (int)min(lo_k, (long long)kBN);
      auto score = [&](int c) {  // the two halves of d at Dp = 128
        return SPLIT == 2 ? p_s[c * SS + m_row] + p_s[(kBN + c) * SS + m_row]
                          : p_s[c * SS + m_row];
      };
      // masked scores are -inf: they never raise the running max, which
      // starts at -1e30, and exp2 gives them exactly 0
      float x[NK];
      float mx = kNegInf;
      if (a.softcap > 0.f) {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int c = 4 * (n / G) + m_part * G + n % G;
          const float z = tanhf(score(c) * sc_in) * sc_out;
          x[n] = c >= c_lo && c <= c_hi ? z : -INFINITY;
          mx = fmaxf(mx, x[n]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int c = 4 * (n / G) + m_part * G + n % G;
          const float z = score(c) * sc_out;
          x[n] = c >= c_lo && c <= c_hi ? z : -INFINITY;
          mx = fmaxf(mx, x[n]);
        }
      }
#pragma unroll
      for (int off = RPW; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int c = 4 * (n / G) + m_part * G + n % G;
        const float p = exp2f(x[n] - m_new);
        p_s[c * SS + m_row] = p;
        sum += p;
      }
#pragma unroll
      for (int off = RPW; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = l * corr + sum;
      m = m_new;
      if (m_part == 0) corr_s[m_row] = corr;
    }
    cp_async_wait<1>();  // V_t (K_t+1 may still fly)
    __syncthreads();     // P^T, the rescales and V_t visible

    // 3. O = O rescale + P V over the keys this warp's rows can see
    {
#pragma unroll
      for (int i4 = 0; i4 < R; i4 += 4) {
        const float4 cr = *reinterpret_cast<const float4*>(corr_s + o_r0 + i4);
        const float c4[4] = {cr.x, cr.y, cr.z, cr.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4 * U; ++j) acc[i4 + i][j] *= c4[i];
      }
      long long c_hi = min((long long)kBN, a.Sk - k0), c_lo = 0;
      if (a.causal) c_hi = min(c_hi, o_pmax - k0 + 1);
      if (a.window > 0) c_lo = max(0LL, o_pmin - a.window + 1 - k0);
      if (o_wl < o_w0) c_hi = 0;  // no real row in this warp
      const int ce = (int)max(c_hi, c_lo);
#pragma unroll 4
      for (int c = (int)c_lo; c < ce; ++c) {
        float pa[R];
#pragma unroll
        for (int i4 = 0; i4 < R; i4 += 4) {
          const float4 pv =
              *reinterpret_cast<const float4*>(p_s + c * SS + o_r0 + i4);
          pa[i4] = pv.x;
          pa[i4 + 1] = pv.y;
          pa[i4 + 2] = pv.z;
          pa[i4 + 3] = pv.w;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 vv =
              *reinterpret_cast<const float4*>(v_s + c * QS + 64 * u + o_c0);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i][4 * u] = fmaf(pa[i], vv.x, acc[i][4 * u]);
            acc[i][4 * u + 1] = fmaf(pa[i], vv.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pa[i], vv.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pa[i], vv.w, acc[i][4 * u + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (m_part == 0) l_s[m_row] = l;
  __syncthreads();
  const bool vec_out = (a.Dh & 3) == 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = o_r0 + i;
    if (r >= n_real) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-20f);
    const int pi = i0 + r, pos = pi / rep, h = hk * rep + (pi - pos * rep);
    float* orow = a.o + (((long long)b * a.Sq + pos) * a.H + h) * a.Dh;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = 64 * u + o_c0;
      if (d >= a.Dh) continue;
      const float4 y =
          make_float4(acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv,
                      acc[i][4 * u + 2] * inv, acc[i][4 * u + 3] * inv);
      if (vec_out) {
        *reinterpret_cast<float4*>(orow + d) = y;
      } else {
        const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d + j < a.Dh) orow[d + j] = ya[j];
      }
    }
  }
}

template <int Dp>
int launch(const Args& a, void* stream) {
  using C = Cfg<Dp>;
  // above 48 KB a kernel needs its dynamic shared-memory limit raised, once
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<Dp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const long long rows = (long long)a.Sq * (a.H / a.Kv);
  const long long blocks = (rows + C::BM - 1) / C::BM * a.Kv * a.B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_f32_kernel<Dp>
      <<<(unsigned)blocks, kThreads, C::kSmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int Dp>
int blocks_per_sm(int* n) {
  using C = Cfg<Dp>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_f32_kernel<Dp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, flash_attention_f32_kernel<Dp>, kThreads, C::kSmem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int Kv, int Dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, float softcap, void* stream) {
  if (Dh < 1 || Dh > 256 || Kv < 1 || H % Kv ||
      (long long)Sq * (H / Kv) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  bool vec = Dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : strides) vec = vec && s % 4 == 0;
  Args a{(const float*)q, (const float*)k, (const float*)v, (float*)o,
         qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
         B, Sq, Sk, H, Kv, Dh, causal, window, scale, softcap, vec ? 1 : 0};
  if (Dh <= 64) return launch<64>(a, stream);
  if (Dh <= 128) return launch<128>(a, stream);
  return launch<256>(a, stream);
}

// Resident blocks an SM for the head dim's build of the kernel.
extern "C" int flash_attention_f32_blocks_per_sm(int Dh, int* n) {
  if (Dh < 1 || Dh > 256) return (int)cudaErrorInvalidValue;
  if (Dh <= 64) return blocks_per_sm<64>(n);
  if (Dh <= 128) return blocks_per_sm<128>(n);
  return blocks_per_sm<256>(n);
}
