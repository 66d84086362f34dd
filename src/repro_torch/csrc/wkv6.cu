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
// What bounds it on an H100: per step and head it does ~5 hd^2 float32
// operations on 3 hd input and hd output values, plus the state read and
// written once per launch: ~4 hd operations per channel against ~14 B,
// above the float32 ridge (~20 operations per byte) at hd 64, so the
// float32 CUDA-core rate bounds a long prefill. The recurrence is
// sequential in time, so walked one step at a time a prefill of a few
// rows is bound by the latency of one step times S, not by either roof.
//
// Two kernels, one C entry; the entry picks by S alone (no host sync).
// Both compute every step with the same float32 operations in the same
// order, so they give the same bits:
//
// wkv6_seq (S < STAGED_MIN_S: decode steps and short prompts): one block
// per (b, h) with hd threads; thread j keeps the state column S[:, j] in
// registers for the whole launch. At each step the block stages r_t, k_t
// and w_t in shared memory (double-buffered, one __syncthreads per step),
// thread j computes y_t[j] and updates its column; the next step's inputs
// are loaded while the current step computes.
//
// wkv6_staged (S >= STAGED_MIN_S): the same walk without its per-step
// costs. Per (b, h) one block of 3 hd threads in two roles works on two
// chunks of CHUNK steps at once, handing them over through two buffers
// in shared memory with named barriers (bar.arrive / bar.sync, "full"
// and "empty" per buffer): 2 hd producer threads stage chunk c + 1 (r,
// k, v, w = exp(logw), with the next chunk's loads in flight) and
// compute each step's bonus sum_i r_t[i] u[i] k_t[i] once, where
// wkv6_seq has every thread compute it; the hd consumer threads, one per
// state column, walk chunk c step after step with no barrier between
// steps. A step then costs a thread 2 hd float32 FMAs and hd multiplies
// on its column, and a head's time is its consumer warps' walk: neither
// spreading a head over two SMs nor overlapping steps moved it (PERF.md).
// (A chunked form, which turns the recurrence inside a chunk into
// products, ran a little faster but sums in another order: its launches
// held the plain version to 1e-5, yet the served rwkv6-1.6b's bf16
// logits then drew another realization of the random-weight model's
// rounding chaos, past the check that holds them to the plain path's;
// PERF.md.)
//
// Accumulation is float32 throughout. Each block owns its (b, h) state,
// read once before it is written, so sT may be the same memory as s0
// (the wrapper's in-place mode writes a cache slot's state over itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;             // steps staged at a time
constexpr int STAGED_MIN_S = 2 * CHUNK;

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_seq(const T* __restrict__ r, const T* __restrict__ k,
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

// a chunk's values of one channel at steps g + 2 m (m < CHUNK / 2), raw:
// p points at step g, step2 is 2 steps' stride, valid the steps left from
// step g; past them, zero (r = k = v = 0 and logw = 0, w = 1, leave y
// and S as they are)
template <typename T>
__device__ __forceinline__ void fetch(T (&xn)[CHUNK / 2], const T* p,
                                      long long step2, int valid) {
#pragma unroll
  for (int m = 0; m < CHUNK / 2; ++m)
    xn[m] = 2 * m < valid ? p[m * step2] : T(0.f);
}

// named barriers: the producers' own, and per buffer "full" (producers
// arrive, consumers wait) and "empty" (the reverse)
enum { BAR_PROD = 1, BAR_FULL = 2, BAR_EMPTY = 4 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(3 * HD)
wkv6_staged(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* s0, float* sT,
            float* __restrict__ y, int S, int H, Strides rs, Strides ks,
            Strides vs, Strides ws, Strides ys, long long s0b,
            long long s0h, long long sTb, long long sTh) {
  // two buffers of a chunk's staged steps: r, k, v, w = exp(logw) and
  // the bonus sum_i r_t[i] u[i] k_t[i] of each step
  __shared__ __align__(16) float sr[2][CHUNK][HD];
  __shared__ __align__(16) float sk[2][CHUNK][HD];
  __shared__ __align__(16) float sw[2][CHUNK][HD];
  __shared__ __align__(16) float sv[2][CHUNK][HD];
  __shared__ float sbonus[2][CHUNK];
  __shared__ __align__(16) float su[HD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int nchunks = (S + CHUNK - 1) / CHUNK;

  if (threadIdx.x >= HD) {
    // producers (2 hd threads): chunk c into buffer c % 2 while the
    // consumers walk chunk c - 1; thread (g, j) stages steps g + 2 m of
    // channel j, thread t < CHUNK the bonus of step t
    const int tid = threadIdx.x - HD, g = tid / HD, j = tid % HD;
    if (tid < HD) su[tid] = u[h * HD + tid];
    const T* rp = r + b * rs.b + h * rs.h + j + g * rs.s;
    const T* kp = k + b * ks.b + h * ks.h + j + g * ks.s;
    const T* vp = v + b * vs.b + h * vs.h + j + g * vs.s;
    const float* wp = logw + b * ws.b + h * ws.h + j + g * ws.s;
    // the next chunk's values, raw: converted only when stored, so that
    // no instruction waits on these loads before the next chunk
    T rn[CHUNK / 2], kn[CHUNK / 2], vn[CHUNK / 2];
    float ln[CHUNK / 2];
    fetch(rn, rp, 2 * rs.s, S - g);
    fetch(kn, kp, 2 * ks.s, S - g);
    fetch(vn, vp, 2 * vs.s, S - g);
    fetch(ln, wp, 2 * ws.s, S - g);
    for (int c = 0; c < nchunks; ++c) {
      const int buf = c & 1, t1 = (c + 1) * CHUNK;
      if (c >= 2) bar_sync(BAR_EMPTY + buf, 3 * HD);
#pragma unroll
      for (int m = 0; m < CHUNK / 2; ++m) {
        sr[buf][g + 2 * m][j] = to_float(rn[m]);
        sk[buf][g + 2 * m][j] = to_float(kn[m]);
        sv[buf][g + 2 * m][j] = to_float(vn[m]);
        sw[buf][g + 2 * m][j] = expf(ln[m]);
      }
      if (t1 < S) {
        fetch(rn, rp + t1 * rs.s, 2 * rs.s, S - t1 - g);
        fetch(kn, kp + t1 * ks.s, 2 * ks.s, S - t1 - g);
        fetch(vn, vp + t1 * vs.s, 2 * vs.s, S - t1 - g);
        fetch(ln, wp + t1 * ws.s, 2 * ws.s, S - t1 - g);
      }
      bar_sync(BAR_PROD, 2 * HD);
      if (tid < CHUNK) {        // in wkv6_seq's order of the sum
        const float4* r4 = reinterpret_cast<const float4*>(sr[buf][tid]);
        const float4* k4 = reinterpret_cast<const float4*>(sk[buf][tid]);
        const float4* u4 = reinterpret_cast<const float4*>(su);
        float bonus = 0.f;
#pragma unroll
        for (int q = 0; q < HD / 4; ++q) {
          const float4 rq = r4[q], kq = k4[q], uq = u4[q];
          bonus = fmaf(rq.x * uq.x, kq.x, bonus);
          bonus = fmaf(rq.y * uq.y, kq.y, bonus);
          bonus = fmaf(rq.z * uq.z, kq.z, bonus);
          bonus = fmaf(rq.w * uq.w, kq.w, bonus);
        }
        sbonus[buf][tid] = bonus;
      }
      bar_arrive(BAR_FULL + buf, 3 * HD);
    }
    return;
  }

  // consumers (hd threads): thread j keeps the state column S[:, j] in
  // registers for the whole launch and walks the staged steps with
  // wkv6_seq's arithmetic, operation for operation
  const int j = threadIdx.x;
  const float* st0 = s0 + b * s0b + h * s0h;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = st0[i * HD + j];
  float* yp = y + b * ys.b + h * ys.h + j;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1, t0 = c * CHUNK;
    const int steps = min(CHUNK, S - t0);
    bar_sync(BAR_FULL + buf, 3 * HD);
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(sr[buf][t]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[buf][t]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[buf][t]);
      const float vj = sv[buf][t][j];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
        const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          acc = fmaf(ri[e], s[i], acc);
          s[i] = fmaf(wi[e], s[i], ki[e] * vj);
        }
      }
      yp[(long long)(t0 + t) * ys.s] = fmaf(sbonus[buf][t], vj, acc);
    }
    // buffer buf is read: the producers may fill it with chunk c + 2
    if (c + 2 < nchunks) bar_arrive(BAR_EMPTY + buf, 3 * HD);
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
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  if (S >= STAGED_MIN_S) {
    wkv6_staged<T, HD><<<grid, 3 * HD, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, logw, u, s0, sT, y, S, H, rs,
        ks, vs, ws, ys, st[15], st[16], st[17], st[18]);
  } else
    wkv6_seq<T, HD><<<grid, HD, 0, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, logw, u, s0, sT, y, S, H, rs,
        ks, vs, ws, ys, st[15], st[16], st[17], st[18]);
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
// wrapper checks all of it and raises before calling. One kernel per
// call: wkv6_staged from S >= STAGED_MIN_S (32) steps, else wkv6_seq.
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
