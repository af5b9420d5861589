// Paged decode attention for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/paged_attention.py::_paged_kernel (the Pallas
// TPU kernel behind `paged_attention`). Same contract: one query token per
// sequence, q (S, H, Dh); K/V in a physical page pool (P, page, Kv, Dh)
// reached through block_tables (S, n_pages) int32; keys at or past
// context_lens[s] are masked and pages starting past it are skipped; the
// optional tanh softcap applies before the mask (mask value -1e30, as the
// reference); lanes with context_len 0 return exact zeros. Query head
// j*rep + r reads kv head j (rep = H / Kv).
//
// Bound: bytes. Every decode step must read ctx x Kv x Dh x 4 B of K and
// the same of V for each sequence, against 4 FLOPs per key element read;
// far below the card's operations-per-byte line. So the design puts as
// many bytes in flight on as many SMs as the step's keys allow.
//
// Design: split-K over the context (flash-decoding), exact fp32 FMAs.
//  - Pass 1, grid (split, kv head x head group, sequence), 256 threads:
//    each block owns a fixed chunk of `chunk` keys (a multiple of 32) of
//    one sequence for up to kMaxHeads query heads of one kv head. The
//    wrapper picks the chunk from shapes only (table width x page size,
//    the SM count, the heads), never from context_lens, so no decode step
//    waits on the host. A block whose chunk starts at or past the
//    sequence's keys returns at once; pass 2 never reads its partial.
//    An active block walks its chunk 32 keys at a time: it stages the
//    tile's block-table entries, then gathers the tile's K rows and V rows
//    through them, one key row at a time (any page size), as 16-byte
//    cp.async copies all in flight together, K and V in two groups so the
//    scores start as soon as K has landed. One thread forms one (head,
//    key) score (32 keys x 4 heads = 128 at the main path's GQA: small
//    tiles put more blocks, and more bytes in flight, on the SMs), reading
//    K rows padded to Dh + 4 floats, so a warp's 16-byte reads hit
//    distinct banks; the scale, softcap and online softmax are fp32 as the
//    reference's. P V runs over float4 columns with the keys split across
//    thread groups and summed in a fixed order. The block writes its
//    partial (m, l, acc[Dh]) per query head to a scratch buffer.
//  - Pass 2, grid (H, S), a programmatic dependent launch (its launch
//    overlaps pass 1's tail): merges the active partials of each
//    (sequence, head) in split order, out = sum_i e^(m_i - M) acc_i /
//    max(sum_i e^(m_i - M) l_i, 1e-20), so two calls give the same bits
//    and a lane with context_len 0 (no active split) gives exact zeros.
// Both passes launch from one C entry point. Only rows below context_len
// are read; block-table slots past it are never dereferenced (the engine
// points them at the null page 0). Limits: head_dim % 4 == 0 and <= 256.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileKeys = 32;  // keys a block holds in shared memory
constexpr int kMaxHeads = 16;  // query heads of one kv head a block serves
constexpr int kMaxHeadDim = 256;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// floats of shared memory a pass-1 block uses (the host sizes the launch)
inline int split_smem_floats(int hb, int Dh, int bt_slots) {
  const int k_region = kTileKeys * (Dh + 4) > 4 * kThreads
                           ? kTileKeys * (Dh + 4) : 4 * kThreads;
  return hb * Dh            // q, pre-scaled
         + k_region         // K tile; then P V's partial sums
         + kTileKeys * Dh   // V tile
         + hb * kTileKeys   // scores, then probabilities
         + hb * Dh          // running acc
         + 3 * hb           // running max, sum, this tile's correction
         + bt_slots;        // the tile's page ids (ints)
}

__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pages,
                   const float* __restrict__ v_pages,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int H, int Kv, int Dh, int page_size, int n_pages,
                   int chunk, int n_splits, int hb, float scale,
                   float softcap) {
  const int split = blockIdx.x;
  const int rep = H / Kv;
  const int n_hg = (rep + hb - 1) / hb;
  const int kvh = blockIdx.y / n_hg;
  const int r0 = (blockIdx.y - kvh * n_hg) * hb;  // first head of the group
  const int nh = min(hb, rep - r0);
  const int s = blockIdx.z;
  // pass 2 may start launching now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n_keys = min(context_lens[s], n_pages * page_size);
  const int k_begin = split * chunk;
  if (k_begin >= n_keys) return;  // no key here; pass 2 skips this split
  const int k_end = min(n_keys, k_begin + chunk);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dq = Dh / 4;  // float4s a row
  const int ks = Dh + 4;  // padded K row stride

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + hb * Dh;
  float* red_s = k_s;  // P V's partial sums, once the scores are done
  const int k_region = kTileKeys * ks > 4 * kThreads ? kTileKeys * ks
                                                     : 4 * kThreads;
  float* v_s = k_s + k_region;
  float* p_s = v_s + kTileKeys * Dh;
  float* acc_s = p_s + hb * kTileKeys;
  float* m_s = acc_s + hb * Dh;
  float* l_s = m_s + hb;
  float* c_s = l_s + hb;
  int* bt_s = reinterpret_cast<int*>(c_s + hb);  // the tile's page ids

  const int h0 = kvh * rep + r0;  // first query head of this block
  const float* q_base = q + ((size_t)s * H + h0) * Dh;
  for (int i = tid; i < nh * Dh; i += kThreads) {
    q_s[i] = q_base[i] * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < nh; r += kThreads) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.f;
  }
  const int* bt = block_tables + (size_t)s * n_pages;
  const size_t row_stride = (size_t)Kv * Dh;  // between tokens of a page

  for (int kt = k_begin; kt < k_end; kt += kTileKeys) {
    const int nv = min(kTileKeys, k_end - kt);
    const int first_page = kt / page_size;
    const int n_bt = (kt + nv - 1) / page_size - first_page + 1;
    // the previous tile's readers of bt_s, k_s/red_s, v_s and p_s are done
    __syncthreads();
    for (int i = tid; i < n_bt; i += kThreads) bt_s[i] = bt[first_page + i];
    __syncthreads();
    // gather the tile: K rows, then V rows, 16 bytes a copy
    for (int i = tid; i < nv * dq; i += kThreads) {
      const int t = i / dq, d = 4 * (i - t * dq);
      const int key = kt + t;
      const int page = bt_s[key / page_size - first_page];
      cp_async16(k_s + t * ks + d,
                 k_pages + ((size_t)page * page_size + key % page_size) *
                               row_stride + (size_t)kvh * Dh + d);
    }
    cp_async_commit();
    for (int i = tid; i < nv * dq; i += kThreads) {
      const int t = i / dq, d = 4 * (i - t * dq);
      const int key = kt + t;
      const int page = bt_s[key / page_size - first_page];
      cp_async16(v_s + t * Dh + d,
                 v_pages + ((size_t)page * page_size + key % page_size) *
                               row_stride + (size_t)kvh * Dh + d);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's K copies have landed
    __syncthreads();
    // scores: one (head, key) pair a thread
    for (int i = tid; i < nh * kTileKeys; i += kThreads) {
      const int r = i / kTileKeys, t = i - r * kTileKeys;
      if (t < nv) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * Dh);
        const float4* kr = reinterpret_cast<const float4*>(k_s + t * ks);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int d = 0; d < dq; ++d) {
          const float4 qv = qr[d], kv = kr[d];
          a0 = fmaf(qv.x, kv.x, a0);
          a1 = fmaf(qv.y, kv.y, a1);
          a2 = fmaf(qv.z, kv.z, a2);
          a3 = fmaf(qv.w, kv.w, a3);
        }
        float dot = (a0 + a1) + (a2 + a3);
        if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
        p_s[r * kTileKeys + t] = dot;
      }
    }
    __syncthreads();
    // online softmax over this tile: one warp a query head
    for (int r = warp; r < nh; r += kThreads / 32) {
      float* pr = p_s + r * kTileKeys;
      float mx = kMaskValue;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, pr[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nv; t += 32) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    cp_async_wait<0>();  // V has landed
    __syncthreads();
    // acc = acc * corr + P V: float4 column o of the nh x Dh outputs, keys
    // split over kg groups, the groups' sums added in a fixed order
    const int n_out = nh * dq;
    const int kg = n_out >= kThreads ? 1 : kThreads / n_out;
    float4* acc4 = reinterpret_cast<float4*>(acc_s);
    float4* red4 = reinterpret_cast<float4*>(red_s);
    for (int i = tid; i < n_out * kg; i += kThreads) {
      const int o = i % n_out, j = i / n_out;
      const int r = o / dq, d4 = o - r * dq;
      const float* pr = p_s + r * kTileKeys;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = j; t < nv; t += kg) {
        const float p = pr[t];
        const float4 v = reinterpret_cast<const float4*>(v_s + t * Dh)[d4];
        a.x = fmaf(p, v.x, a.x);
        a.y = fmaf(p, v.y, a.y);
        a.z = fmaf(p, v.z, a.z);
        a.w = fmaf(p, v.w, a.w);
      }
      if (kg == 1) {
        const float c = c_s[r];
        float4 o4 = acc4[o];
        o4.x = fmaf(o4.x, c, a.x);
        o4.y = fmaf(o4.y, c, a.y);
        o4.z = fmaf(o4.z, c, a.z);
        o4.w = fmaf(o4.w, c, a.w);
        acc4[o] = o4;
      } else {
        red4[j * n_out + o] = a;
      }
    }
    if (kg > 1) {
      __syncthreads();
      for (int o = tid; o < n_out; o += kThreads) {
        float4 a = red4[o];
        for (int j = 1; j < kg; ++j) {
          const float4 b = red4[j * n_out + o];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        const float c = c_s[o / dq];
        float4 o4 = acc4[o];
        o4.x = fmaf(o4.x, c, a.x);
        o4.y = fmaf(o4.y, c, a.y);
        o4.z = fmaf(o4.z, c, a.z);
        o4.w = fmaf(o4.w, c, a.w);
        acc4[o] = o4;
      }
    }
  }
  __syncthreads();
  // the partial of each query head: (m, l) and acc[Dh]
  for (int i = tid; i < nh * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    part_acc[(((size_t)s * H + h0 + r) * n_splits + split) * Dh + d] =
        acc_s[i];
  }
  for (int r = tid; r < nh; r += kThreads) {
    const size_t at = ((size_t)s * H + h0 + r) * n_splits + split;
    part_ml[2 * at] = m_s[r];
    part_ml[2 * at + 1] = l_s[r];
  }
}

__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc,
                     const int* __restrict__ context_lens,
                     float* __restrict__ out, int H, int Dh, int max_keys,
                     int chunk, int n_splits) {
  const int h = blockIdx.x, s = blockIdx.y;
  const int n_keys = min(context_lens[s], max_keys);
  const int n_act = n_keys > 0 ? (n_keys + chunk - 1) / chunk : 0;
  const size_t base = ((size_t)s * H + h) * n_splits;
  // launched early (programmatic dependent launch): wait until pass 1 has
  // finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + 2 * base;
  const float* acc = part_acc + base * Dh;
  float m_all = kMaskValue;
  for (int i = 0; i < n_act; ++i) m_all = fmaxf(m_all, ml[2 * i]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_act; ++i) {  // in split order: the same bits
      const float w = expf(ml[2 * i] - m_all);
      l = fmaf(w, ml[2 * i + 1], l);
      a = fmaf(w, acc[(size_t)i * Dh + d], a);
    }
    // no active split (context_len 0): 0 / 1e-20 is exactly 0
    out[((size_t)s * H + h) * Dh + d] = a / fmaxf(l, 1e-20f);
  }
}

}  // namespace

// part_ml holds S x H x n_splits (m, l) pairs and part_acc S x H x
// n_splits x Dh floats; both are scratch the caller allocates. `chunk`
// (a multiple of 32) and `n_splits` cover n_pages x page_size keys; `hb`
// (at most 16) is the query heads a block serves.
extern "C" int paged_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out,
    void* part_ml, void* part_acc, int S, int H, int Kv, int Dh,
    int page_size, int n_pages, int chunk, int n_splits, int hb,
    float scale, float softcap, void* stream) {
  const int rep = H / Kv;
  if (S <= 0 || Kv <= 0 || H % Kv || Dh <= 0 || Dh % 4 ||
      Dh > kMaxHeadDim || page_size <= 0 || n_pages <= 0 || chunk <= 0 ||
      chunk % kTileKeys || n_splits <= 0 ||
      (long long)chunk * n_splits < (long long)n_pages * page_size ||
      hb <= 0 || hb > kMaxHeads || hb > rep)
    return (int)cudaErrorInvalidValue;
  const int bt_slots = (kTileKeys + page_size - 1) / page_size + 1;
  const size_t smem = sizeof(float) * split_smem_floats(hb, Dh, bt_slots);
  // raise the kernel's dynamic shared-memory limit only when a launch needs
  // more than it was last raised to, not on every launch
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const int n_hg = (rep + hb - 1) / hb;
  cudaStream_t st = (cudaStream_t)stream;
  paged_split_kernel<<<dim3(n_splits, Kv * n_hg, S), kThreads, smem, st>>>(
      (const float*)q, (const float*)k_pages, (const float*)v_pages,
      (const int*)block_tables, (const int*)context_lens, (float*)part_ml,
      (float*)part_acc, H, Kv, Dh, page_size, n_pages, chunk, n_splits, hb,
      scale, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // pass 2 as a programmatic dependent launch: its launch overlaps pass 1's
  // tail, and each block waits for pass 1 before it reads a partial
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, S);
  cfg.blockDim = dim3(Dh >= 128 ? 128 : ((Dh + 31) / 32) * 32);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, paged_combine_kernel, (const float*)part_ml,
      (const float*)part_acc, (const int*)context_lens, (float*)out, H, Dh,
      n_pages * page_size, chunk, n_splits);
}
