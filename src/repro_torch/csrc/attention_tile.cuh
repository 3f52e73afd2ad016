// Blocked online-softmax attention over a contiguous KV cache, shared by the
// port's three attention kernels (flash_attention.cu, chunk_attention.cu).
//
// One thread block owns one kv head `kh` and one tile of BQ query positions,
// and computes all G = H / K query heads that share that kv head: ROWS = 64
// query rows (row r = position r / G, head kh * G + r % G). K/V tiles of BK
// keys are staged in shared memory once and read by all G heads, which is
// the GQA saving the TPU kernels got from their h // g BlockSpec maps. The
// TPU's sequential kv grid axis becomes a loop inside the block; the running
// max, sum and accumulator live in fp32 registers.
//
// What bounds it on an H100: decode and mixed ticks are bytes-bound (each
// row's live K/V is read once per kv head); prefill tiles are
// operations-bound. This first version computes the products with scalar
// fp32 FMAs from shared memory (no mma.sync / wgmma / TMA yet), so prefill
// runs far below the tensor-core rate; the design keeps the byte traffic at
// one read of each live K/V tile per block and skips every tile that lies
// above the causal diagonal, past a row's valid end, or outside the window.
//
// Per-row rules (mirroring the Pallas kernels):
//   * query row with absolute position `pos` attends to keys kp with
//     kp <= pos, kp < kv_limit and, when window > 0, kp > pos - window;
//   * rows that are not live (past q_len, padding, gaps) are written as
//     zeros, so a whole dead tile is zeros.
// Packed mode finds each query position's owning row itself (binary search
// over row_starts): a tile may straddle rows, and then it runs the kv loop
// once per owning row, each pass with only that row's queries live. So the
// packed axis needs no alignment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aios {

constexpr int THREADS = 128;        // 16 x 8 threads
constexpr int TY = 16;
constexpr int TX = 8;
constexpr int ROWS = 64;            // query rows per block (positions x heads)
constexpr int BK = 32;              // keys per kv tile
constexpr int RPT = ROWS / TY;      // rows per thread
constexpr int CPT = BK / TX;        // key columns per thread

enum Mode { FLASH = 0, CHUNK = 1, PACKED = 2 };

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // FLASH: a0 = q_offsets[B], a1 = kv_lens[B]
  // CHUNK: a0 = q_offsets[B], a1 = q_lens[B]
  // PACKED: a0 = row_starts[B], a1 = q_offsets[B], a2 = q_lens[B]
  const int* a0;
  const int* a1;
  const int* a2;
  int B, Sq, H, K, S, window, G, BQ;
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy HD contiguous elements (16-byte aligned) into a float row, scaled.
template <typename T, int HD>
__device__ __forceinline__ void load_vec(float* dst, const T* src, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f<T>(vals[i]) * scale;
}

// Stage keys k0 .. k0 + n - 1 of one (row, kv head) into a [BK][HD+1] tile;
// rows past n are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(float* dst, const T* base,
                                             long long s_stride, int k0, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;
  for (int e = threadIdx.x; e < BK * VPR; e += THREADS) {
    const int c = e / VPR, dv = (e % VPR) * VEC;
    float* drow = dst + c * (HD + 1) + dv;
    if (c < n) {
      load_vec<T, HD>(drow, base + (long long)(k0 + c) * s_stride + dv, 1.f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) drow[i] = 0.f;
    }
  }
}

__host__ __device__ constexpr size_t smem_floats(int hd) {
  return (size_t)ROWS * (hd + 1) + 2 * (size_t)BK * (hd + 1) + (size_t)ROWS * (BK + 1);
}

template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(THREADS) attn_kernel(const AttnArgs a) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [ROWS][HD+1], pre-scaled
  float* Ks = Qs + ROWS * (HD + 1);      // [BK][HD+1]
  float* Vs = Ks + BK * (HD + 1);        // [BK][HD+1]
  float* Ps = Vs + BK * (HD + 1);        // [ROWS][BK+1]
  __shared__ int s_pos[ROWS], s_seg[ROWS], s_live[ROWS];

  constexpr int DPT = HD / TX;           // accumulator dims per thread
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int kh = blockIdx.y;
  const int b = (MODE == PACKED) ? 0 : blockIdx.z;
  const int G = a.G, BQ = a.BQ;
  const int q0 = blockIdx.x * BQ;

  // per-query-position metadata: absolute position, owning row, liveness
  int live = 0;
  if (tid < BQ) {
    const int idx = q0 + tid;
    int pos = 0, seg = b;
    if (MODE == FLASH) {
      live = idx < a.Sq;
      pos = a.a0[b] + idx;
    } else if (MODE == CHUNK) {
      live = idx < a.Sq && idx < a.a1[b];
      pos = a.a0[b] + idx;
    } else if (idx < a.Sq) {
      int lo = 0, hi = a.B - 1;          // last row with row_starts <= idx
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.a0[mid] <= idx) lo = mid; else hi = mid - 1;
      }
      const int off = idx - a.a0[lo];
      seg = lo;
      live = off >= 0 && off < a.a2[lo];
      pos = a.a1[lo] + off;
    }
    s_pos[tid] = pos;
    s_seg[tid] = seg;
    s_live[tid] = live;
  }
  const int n_live = __syncthreads_count(live);

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  if (n_live > 0) {
    // Q tile: row r -> position q0 + r / G, head kh * G + r % G
    {
      constexpr int VEC = 16 / sizeof(T), VPR = HD / VEC;
      const T* q = static_cast<const T*>(a.q);
      for (int e = tid; e < ROWS * VPR; e += THREADS) {
        const int r = e / VPR, dv = (e % VPR) * VEC;
        const int qi = r / G, gh = r % G;
        float* drow = Qs + r * (HD + 1) + dv;
        if (qi < BQ && s_live[qi]) {
          const long long off = (long long)b * a.q_b + (long long)(q0 + qi) * a.q_s +
                                (long long)(kh * G + gh) * a.q_h + dv;
          load_vec<T, HD>(drow, q + off, a.scale);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) drow[i] = 0.f;
        }
      }
    }
    // owning rows that this tile's live queries span (one for FLASH/CHUNK)
    int seg_lo = 1 << 30, seg_hi = -1;
    for (int qi = 0; qi < BQ; ++qi) {
      if (s_live[qi]) {
        seg_lo = min(seg_lo, s_seg[qi]);
        seg_hi = max(seg_hi, s_seg[qi]);
      }
    }
    const T* kbase = static_cast<const T*>(a.k);
    const T* vbase = static_cast<const T*>(a.v);
    for (int seg = seg_lo; seg <= seg_hi; ++seg) {
      int lo_pos = 1 << 30, hi_pos = -1;
      for (int qi = 0; qi < BQ; ++qi) {
        if (s_live[qi] && s_seg[qi] == seg) {
          lo_pos = min(lo_pos, s_pos[qi]);
          hi_pos = max(hi_pos, s_pos[qi]);
        }
      }
      if (hi_pos < 0) continue;          // packed: a length-0 row in the span
      int k_hi = min(hi_pos + 1, a.S);
      if (MODE == FLASH) k_hi = min(k_hi, a.a1[seg]);
      int k_lo = a.window > 0 ? max(0, lo_pos - a.window + 1) : 0;
      k_lo = (k_lo / BK) * BK;
      const T* kb = kbase + (long long)seg * a.k_b + (long long)kh * a.k_h;
      const T* vb = vbase + (long long)seg * a.v_b + (long long)kh * a.v_h;

      int rpos[RPT];
      bool rlive[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int qi = (ty + TY * i) / G;
        rlive[i] = qi < BQ && s_live[qi] && s_seg[qi] == seg;
        rpos[i] = rlive[i] ? s_pos[qi] : 0;
      }

      for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        const int n = min(BK, k_hi - k0);
        __syncthreads();                 // previous tile's readers are done
        load_kv_tile<T, HD>(Ks, kb, a.k_s, k0, n);
        load_kv_tile<T, HD>(Vs, vb, a.v_s, k0, n);
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          float qv[RPT], kv[CPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * (HD + 1) + d];
#pragma unroll
          for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * (HD + 1) + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const int kp = k0 + tx + TX * j;
            const bool ok = rlive[i] && kp < k_hi && kp <= rpos[i] &&
                            (a.window <= 0 || kp > rpos[i] - a.window);
            s[i][j] = ok ? s[i][j] : -INFINITY;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 1; off < TX; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);
          float alpha = 1.f, sum = 0.f;
          float p[CPT];
          if (m_new == -INFINITY) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) p[j] = 0.f;
          } else {
            alpha = expf(m[i] - m_new);
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              p[j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
              sum += p[j];
            }
          }
#pragma unroll
          for (int off = 1; off < TX; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
          const int r = ty + TY * i;
#pragma unroll
          for (int j = 0; j < CPT; ++j) Ps[r * (BK + 1) + tx + TX * j] = p[j];
        }
        __syncthreads();

        for (int c = 0; c < n; ++c) {
          float pv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            const float vv = Vs[c * (HD + 1) + tx + TX * j];
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
          }
        }
      }
    }
  }

  // epilogue: live rows get acc / l, every other in-range row zeros
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    const int qi = r / G, gh = r % G;
    if (qi >= BQ || q0 + qi >= a.Sq) continue;
    const float inv = (s_live[qi] && l[i] > 0.f) ? 1.f / l[i] : 0.f;
    const long long off = (long long)b * a.o_b + (long long)(q0 + qi) * a.o_s +
                          (long long)(kh * G + gh) * a.o_h;
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[off + tx + TX * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD, int MODE>
int launch_typed(const AttnArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_floats(HD) * sizeof(float);
  static bool configured = false;        // idempotent; a race only repeats it
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<T, HD, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  attn_kernel<T, HD, MODE><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t, or -1 for a
// dtype / head_dim this build does not instantiate.
template <int MODE>
int launch(int dtype, int hd, const AttnArgs& a, dim3 grid, cudaStream_t stream) {
#define AIOS_HD_CASES(T)                                                  \
  switch (hd) {                                                           \
    case 16: return launch_typed<T, 16, MODE>(a, grid, stream);           \
    case 32: return launch_typed<T, 32, MODE>(a, grid, stream);           \
    case 64: return launch_typed<T, 64, MODE>(a, grid, stream);           \
    case 128: return launch_typed<T, 128, MODE>(a, grid, stream);         \
    default: return -1;                                                   \
  }
  if (dtype == 0) { AIOS_HD_CASES(float) }
  if (dtype == 1) { AIOS_HD_CASES(__nv_bfloat16) }
#undef AIOS_HD_CASES
  return -1;
}

inline AttnArgs make_args(const void* q, const void* k, const void* v, void* o,
                          const int* a0, const int* a1, const int* a2, int B, int Sq,
                          int H, int K, int S, int window, int G, int BQ, long long q_b,
                          long long q_s, long long q_h, long long k_b, long long k_s,
                          long long k_h, long long v_b, long long v_s, long long v_h,
                          long long o_b, long long o_s, long long o_h, float scale) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.a0 = a0; a.a1 = a1; a.a2 = a2;
  a.B = B; a.Sq = Sq; a.H = H; a.K = K; a.S = S; a.window = window; a.G = G; a.BQ = BQ;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.o_b = o_b; a.o_s = o_s; a.o_h = o_h;
  a.scale = scale;
  return a;
}

}  // namespace aios

// Every launcher of the port has this one C signature (bound with ctypes in
// kernels/_build.py): pointers and the stream as void*, strides in elements.
#define AIOS_LAUNCHER_PARAMS                                                        \
  const void *q, const void *k, const void *v, void *o, const int *a0, const int *a1, \
      const int *a2, int B, int Sq, int H, int K, int S, int window, int G, int BQ,   \
      long long q_b, long long q_s, long long q_h, long long k_b, long long k_s,      \
      long long k_h, long long v_b, long long v_s, long long v_h, long long o_b,      \
      long long o_s, long long o_h, float scale, int dtype, int hd, void *stream
#define AIOS_LAUNCHER_ARGS                                                               \
  aios::make_args(q, k, v, o, a0, a1, a2, B, Sq, H, K, S, window, G, BQ, q_b, q_s, q_h, \
                  k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h, scale)
