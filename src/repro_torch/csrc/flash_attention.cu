// Blocked flash attention, forward: causal or not, GQA, per-sequence
// query offset and valid KV length, any query and key length.
//
// Replaces the TPU kernel flash_attention_fwd (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py: the same function — mask
// k < kv_valid_len and, when causal, k <= q_offset + i; query head h
// reads KV head h / G; scores scaled by 1/sqrt(hd); online softmax in
// float32 starting from m = NEG_INF = -1e30; output acc / max(l, 1e-30)
// cast to the input dtype. Inputs are bf16 or float32, read in the
// reference's public layout (B, S, heads, hd) through their strides (no
// transposed copies); the output is a new contiguous (B, Sq, H, hdv).
//
// What bounds it on an H100: operations. A prefill of L tokens does
// ~2 L^2 (hd + hdv) / 2 flops per head for L (hd + hdv) bytes of K/V per
// KV head — hundreds of flops per byte, well above the card's ~295
// flops/byte ridge. The roof is the tensor cores (989 TFLOP/s bf16).
// This first version stays off them: it multiplies with float32 FMAs
// on the CUDA cores (67 TFLOP/s peak), from float32 tiles in shared
// memory, so it is exact to float32 rounding for both input types and
// simple to hold against the plain version. What the design does about
// the bound: each thread keeps a 4 x 4 block of scores and a 4 x hdv/16
// block of the output in registers (16 and up to 32 accumulators), Q is
// kept transposed so its four rows come in one 16-byte shared load, and
// key tiles the mask leaves empty are never visited: the loop stops at
// min(Skv, kv_valid_len, last causal position + 1), which in serving's
// prefill (Skv = the cache's max_len, kv_valid_len = the prompt) skips
// the unwritten cache and the upper triangle. Skipping is exact: once a
// row has seen one valid key, a fully masked tile leaves m, l and acc
// unchanged (alpha = exp(0) = 1, p = exp(-1e30 - m) = 0). Key 0 is
// valid for every row once kv_valid_len >= 1 and q_offset >= 0; a block
// with a row that has no valid key walks every tile, so it gets the
// reference's uniform average too. wgmma/mma.sync on bf16 tiles, TMA
// loads and a pipelined K/V ring are later work.
//
// One block of 256 threads (16 x 16) per (q-tile of 64 rows, head,
// sequence); a loop over key tiles of 64 replaces the TPU grid's
// sequential nk axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: 16 (tx, key/out columns) x 16 (ty)
constexpr int PP = BQ + 4;      // row pitch of the transposed P tile

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

// 16 bytes of T -> floats
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* d) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* d) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [r0, r0 + rows) of a (S, D) slice at `src` (row stride `stride`)
// into shared memory as float32: element (r, d) goes to
// dst[r * rs + d * ds]. Rows at or past `limit` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int rs, int ds,
                                          const T* src, long long stride,
                                          int r0, int rows, int limit) {
  constexpr int N = Vec<T>::N;
  constexpr int CH = D / N;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * N;
    float x[N];
    if (r0 + r < limit) {
      load16(src + (long long)(r0 + r) * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * rs + (c + e) * ds] = x[e];
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          const int* __restrict__ q_offset, const int* __restrict__ kv_len,
          int Sq, int Skv, int G, Strides qs, Strides ks, Strides vs,
          Strides os, int causal, float scale) {
  constexpr int KP = HD + 1;            // row pitch of the K tile
  constexpr int NC = HDV / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* sQt = smem;                    // HD x BQ (transposed)
  float* sK = sQt + HD * BQ;            // BK x KP
  float* sV = sK + BK * KP;             // BK x HDV
  float* sPt = sV + BK * HDV;           // BK x PP (transposed)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qoff = q_offset[b], kvl = kv_len[b];

  load_tile<T, HD>(sQt, 1, BQ, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq);

  const int qlast = min(q0 + BQ, Sq) - 1;
  int kend = min(Skv, kvl);
  if (causal) kend = min(kend, qoff + qlast + 1);
  if (kend <= 0 || (causal && qoff + q0 < 0)) kend = Skv;
  const int nk = (kend + BK - 1) / BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // last tile's K, V, P reads done
    load_tile<T, HD>(sK, KP, 1, kb, ks.s, k0, BK, Skv);
    load_tile<T, HDV>(sV, HDV, 1, vb, vs.s, k0, BK, Skv);
    __syncthreads();

    // scores of rows 4 ty + i, keys k0 + tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(sQt + d * BQ +
                                                         4 * ty);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = sK[(tx + 16 * j) * KP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }

    // mask and online softmax; a row's 64 keys sit on its 16 tx lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qoff + q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        const bool ok = kk < kvl && (!causal || kk <= qpos);
        // keys past Skv do not exist: -inf gives them p = 0 exactly
        s[i][j] = kk >= Skv ? -INFINITY : (ok ? s[i][j] * scale : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sPt[(tx + 16 * j) * PP + 4 * ty + i] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[rows 4 ty + i][cols tx + 16 c] += P V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(sPt + j * PP +
                                                         4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[j * HDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= Sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    T* o = out + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tx + 16 * c, acc[i][c] / lm);
  }
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* q_offset, const int* kv_len, int B, int Sq, int Skv,
           int H, int G, const long long* st, int causal,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (HD * BQ + BK * (HD + 1) + BK * HDV + BK * PP);
  auto kern = flash_fwd<T, HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, q_offset, kv_len, Sq,
      Skv, G, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, int hdv, const void* q, const void* k, const void* v,
             void* out, const int* qo, const int* kl, int B, int Sq,
             int Skv, int H, int G, const long long* st, int causal,
             cudaStream_t s) {
  if (hd == 64 && hdv == 64)
    return launch<T, 64, 64>(q, k, v, out, qo, kl, B, Sq, Skv, H, G, st,
                             causal, s);
  if (hd == 128 && hdv == 128)
    return launch<T, 128, 128>(q, k, v, out, qo, kl, B, Sq, Skv, H, G, st,
                               causal, s);
  if (hd == 32 && hdv == 32)
    return launch<T, 32, 32>(q, k, v, out, qo, kl, B, Sq, Skv, H, G, st,
                             causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q (B,Sq,H,hd), k (B,Skv,KV,hd),
// v (B,Skv,KV,hdv), out (B,Sq,H,hdv): the last dim contiguous, other
// element strides in `strides` as {q b,s,h, k b,s,h, v b,s,h, out b,s,h};
// every row start 16-byte aligned. q_offset, kv_len: (B,) int32.
// (hd, hdv) in {(32,32), (64,64), (128,128)}; the wrapper checks all of
// it and raises before calling.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, const int* q_offset,
                                      const int* kv_len, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int hdv, const long long* strides,
                                      int causal, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const int G = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, hdv, q, k, v, out, q_offset, kv_len, B, Sq,
                           Skv, H, G, strides, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, hdv, q, k, v, out, q_offset, kv_len,
                                   B, Sq, Skv, H, G, strides, causal, s);
  return (int)cudaErrorInvalidValue;
}
