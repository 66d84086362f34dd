// WKV6: the RWKV-6 (Finch) time-mix recurrence with data-dependent decay.
//
// Replaces the TPU kernel wkv6_fwd (_wkv_kernel) in
// src/repro/kernels/rwkv6/kernel.py: the same function — for every
// (batch, head), with w_t = exp(logw_t),
//   y_t = r_t . (S + diag(u) k_t^T v_t)
//       = sum_i r_t[i] S[i, :] + (sum_i r_t[i] u[i] k_t[i]) v_t,
//   S   = diag(w_t) S + k_t^T v_t,
// carrying an (hd, hd) float32 state from s0 over S steps; y is float32.
// r, k, v are (B, S, H, hd) bf16 or float32 and logw float32, read
// through their strides (the reference's fold transposes become no
// copies); u is (H, hd) and s0 (B, H, hd, hd) float32. Unlike the Pallas
// kernel, which asserts S % chunk == 0, any S >= 1 is taken: a
// 1000-token prompt prefills in one launch and S = 1 is a decode step.
//
// What bounds it on an H100: bytes in principle — per step and head it
// does ~4 hd^2 float32 operations on 3 hd input and hd output values plus
// the state read and written once per launch, so a launch moves ~14 B
// per (step, channel) and ~8 B per state element against ~4 hd
// operations per channel: below the ridge. In practice the recurrence
// is sequential in time: each (batch, head) walks its S steps one after
// the other, so a prefill of a few rows is bound by the latency of one
// step times S, not by either roof.
//
// Design (simple and right first): one block per (b, h) with hd threads;
// thread j keeps the state column S[:, j] in registers (hd floats) for
// the whole launch, so the state is read from device memory once and
// written once. At each step the block stages r_t, k_t and w_t in shared
// memory (double-buffered, one __syncthreads per step), thread j computes
// y_t[j] and updates its column; the next step's inputs are loaded into
// registers while the current step computes. Accumulation is float32
// throughout. Because each block owns its (b, h) state and each thread
// its column, sT may be the same memory as s0 (the wrapper's in-place
// mode writes a cache slot's state over itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* s0, float* sT,
         float* __restrict__ y, int S, int H, Strides rs, Strides ks,
         Strides vs, Strides ws, Strides ys, long long s0b, long long s0h,
         long long sTb, long long sTh) {
  __shared__ __align__(16) float sr[2][HD];
  __shared__ __align__(16) float sk[2][HD];
  __shared__ __align__(16) float sw[2][HD];
  __shared__ __align__(16) float su[HD];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const float* st0 = s0 + b * s0b + h * s0h;
  float s[HD];                  // the state column S[:, j]
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = st0[i * HD + j];
  su[j] = u[h * HD + j];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = logw + b * ws.b + h * ws.h + j;
  float* yp = y + b * ys.b + h * ys.h + j;

  float rn = load(rp), kn = load(kp), vn = load(vp), wn = expf(*wp);
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    // one barrier per step: the buffer written at step t + 1 was last
    // read at step t - 1, which every thread finished before this one
    __syncthreads();
    if (t + 1 < S) {            // the next step's inputs, in flight now
      rn = load(rp + (t + 1) * rs.s);
      kn = load(kp + (t + 1) * ks.s);
      vn = load(vp + (t + 1) * vs.s);
      wn = expf(wp[(t + 1) * ws.s]);
    }
    const float4* r4 = reinterpret_cast<const float4*>(sr[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(sk[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(sw[buf]);
    const float4* u4 = reinterpret_cast<const float4*>(su);
    float acc = 0.f, bonus = 0.f;
#pragma unroll
    for (int q = 0; q < HD / 4; ++q) {
      const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
      const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
      const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
      const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
      const float ui[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        acc = fmaf(ri[e], s[i], acc);
        bonus = fmaf(ri[e] * ui[e], ki[e], bonus);
        s[i] = fmaf(wi[e], s[i], ki[e] * vj);
      }
    }
    yp[t * ys.s] = fmaf(bonus, vj, acc);
  }

  float* stT = sT + b * sTb + h * sTh;
#pragma unroll
  for (int i = 0; i < HD; ++i) stT[i * HD + j] = s[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* sT, float* y, int B,
           int S, int H, const long long* st, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_fwd<T, HD><<<grid, HD, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, logw, u, s0, sT, y, S, H,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, st[15], st[16], st[17], st[18]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const float* logw, const float* u, const float* s0, float* sT,
             float* y, int B, int S, int H, const long long* st,
             cudaStream_t s) {
  if (hd == 64)
    return launch<T, 64>(r, k, v, logw, u, s0, sT, y, B, S, H, st, s);
  if (hd == 32)
    return launch<T, 32>(r, k, v, logw, u, s0, sT, y, B, S, H, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of r, k, v): 0 float32, 1 bfloat16. r, k, v, logw, y
// (B, S, H, hd): the last dim contiguous, the (b, s, h) element strides
// in `strides` as {r, k, v, logw, y} x {b, s, h}, then s0 {b, h} and
// sT {b, h}; the (hd, hd) state of one (b, h) contiguous. u (H, hd)
// contiguous. sT may equal s0 (in place). hd in {32, 64}; S >= 1. The
// wrapper checks all of it and raises before calling.
extern "C" int wkv6_launch(int dtype, const void* r, const void* k,
                           const void* v, const float* logw, const float* u,
                           const float* s0, float* sT, float* y, int B,
                           int S, int H, int hd, const long long* strides,
                           void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(hd, r, k, v, logw, u, s0, sT, y, B, S, H,
                           strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, r, k, v, logw, u, s0, sT, y, B, S, H,
                                   strides, s);
  return (int)cudaErrorInvalidValue;
}
