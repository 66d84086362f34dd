// Flash-decode: one query token per sequence against its KV cache.
//
// Replaces the TPU kernel decode_attention_fwd (_dec_kernel) in
// src/repro/kernels/decode_attention/kernel.py: the same function — the
// G = H / KV query heads of one KV head attend together over keys
// j < valid = min(position + 1, kv_valid_len), scores scaled by
// 1/sqrt(hd), online softmax in float32 from m = NEG_INF = -1e30,
// output acc / max(l, 1e-30) in the input dtype. q is (B, 1, H, hd) and
// k, v the cache (B, S, KV, hd[v]), read through their strides, bf16 or
// float32; the output is a new contiguous (B, 1, H, hdv).
//
// What bounds it on an H100: bytes. Every valid key and value row is
// read once for G query heads, so the kernel does ~2 G flops per byte of
// cache (G = 4 for granite-3-2b), far below the ~295 flops/byte ridge:
// the roof is the valid cache over 3.35 TB/s. What the design does about
// it: the loop stops at the valid length (the reference walks all S/512
// blocks masked; skipping the masked tail is exact, since after key 0 a
// fully masked tile leaves m, l and acc unchanged), the G heads share
// each K/V tile so the cache is read once per KV head and not once per
// query head, and tiles are read with 16-byte loads. A sequence with no
// valid key walks the whole cache, as the reference does, and gets its
// uniform average.
//
// Known limit: one block of 128 threads per (KV head, sequence), so at 8
// slots x 8 KV heads the grid has 64 blocks for 132 SMs and each block
// walks its keys tile by tile with one load in flight per thread. The
// fix is to split the key range over more blocks and merge their
// partial (m, l, acc) in a second pass (split-K flash-decode) — later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 128;         // threads per block (4 warps)
constexpr int BK = 64;          // keys per tile

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

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

// rows [r0, r0 + rows) of a (S, D) slice (row stride `stride`) into
// dst[r * pitch + d] as float32; rows at or past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* src, long long stride,
                                          int r0, int rows, int limit) {
  constexpr int N = Vec<T>::N;
  constexpr int CH = D / N;
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
    for (int e = 0; e < N; ++e) dst[r * pitch + c + e] = x[e];
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(NT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           const int* __restrict__ positions,
           const int* __restrict__ kv_len, int S, int G, Strides qs,
           Strides ks, Strides vs, Strides os, float scale) {
  constexpr int KP = HD + 1;            // row pitch of the K tile
  extern __shared__ float smem[];
  float* sK = smem;                     // BK x KP
  float* sV = sK + BK * KP;             // BK x HDV
  float* sQ = sV + BK * HDV;            // G x HD
  float* sS = sQ + G * HD;              // G x BK scores, then p
  float* sAcc = sS + G * BK;            // G x HDV
  float* sM = sAcc + G * HDV;           // G
  float* sL = sM + G;                   // G
  float* sAlpha = sL + G;               // G

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = min(positions[b] + 1, kv_len[b]);
  int kend = min(S, valid);
  if (kend <= 0) kend = S;              // no valid key: the uniform average
  const int nk = (kend + BK - 1) / BK;

  // the group's G query rows are heads kvh * G .. kvh * G + G - 1
  for (int g = 0; g < G; ++g)
    load_rows<T, HD>(sQ + g * HD, HD, q + b * qs.b + (kvh * G + g) * qs.h,
                     0, 0, 1, 1);
  for (int i = tid; i < G * HDV; i += NT) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += NT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // last tile's reads done
    load_rows<T, HD>(sK, KP, kb, ks.s, k0, BK, S);
    load_rows<T, HDV>(sV, HDV, vb, vs.s, k0, BK, S);
    __syncthreads();

    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, j = i % BK, kk = k0 + j;
      float sc = -INFINITY;             // keys past S: p = 0 exactly
      if (kk < S) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          dot = fmaf(sQ[g * HD + d], sK[j * KP + d], dot);
        sc = kk < valid ? dot * scale : kNegInf;
      }
      sS[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per head; each lane holds BK / 32 keys
    for (int g = warp; g < G; g += NT / 32) {
      float* row = sS + g * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float rs = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = row[j] == -INFINITY ? 0.f : expf(row[j] - m_new);
        row[j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + rs;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HDV; i += NT) {
      const int g = i / HDV, c = i % HDV;
      const float* p = sS + g * BK;
      float a = sAcc[i] * sAlpha[g];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(p[j], sV[j * HDV + c], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * HDV; i += NT) {
    const int g = i / HDV, c = i % HDV;
    store(out + b * os.b + (kvh * G + g) * os.h + c,
          sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T, int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* positions, const int* kv_len, int B, int S, int KV,
           int G, const long long* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BK * (HD + 1) + BK * HDV + G * HD +
                                       G * BK + G * HDV + 3 * G);
  auto kern = decode_fwd<T, HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KV, B);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, positions, kv_len, S,
      G, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, int hdv, const void* q, const void* k, const void* v,
             void* out, const int* pos, const int* kl, int B, int S, int KV,
             int G, const long long* st, cudaStream_t s) {
  if (hd == 64 && hdv == 64)
    return launch<T, 64, 64>(q, k, v, out, pos, kl, B, S, KV, G, st, s);
  if (hd == 128 && hdv == 128)
    return launch<T, 128, 128>(q, k, v, out, pos, kl, B, S, KV, G, st, s);
  if (hd == 32 && hdv == 32)
    return launch<T, 32, 32>(q, k, v, out, pos, kl, B, S, KV, G, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q (B,1,H,hd), k (B,S,KV,hd),
// v (B,S,KV,hdv), out (B,1,H,hdv): the last dim contiguous, other
// element strides in `strides` as {q b,s,h, k b,s,h, v b,s,h, out b,s,h};
// every row start 16-byte aligned. positions, kv_len: (B,) int32.
// (hd, hdv) in {(32,32), (64,64), (128,128)}; the wrapper checks all of
// it and raises before calling.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, const int* positions,
                                       const int* kv_len, int B, int S,
                                       int H, int KV, int hd, int hdv,
                                       const long long* strides,
                                       void* stream) {
  if (B == 0 || H == 0) return 0;
  const int G = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, hdv, q, k, v, out, positions, kv_len, B, S,
                           KV, G, strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, hdv, q, k, v, out, positions, kv_len,
                                   B, S, KV, G, strides, s);
  return (int)cudaErrorInvalidValue;
}
