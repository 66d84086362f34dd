// Mamba selective scan: the SSM recurrence of a Mamba mixer.
//
// Replaces the TPU kernel mamba_scan_fwd (_scan_kernel) in
// src/repro/kernels/mamba_scan/kernel.py: the same function — for every
// (batch, channel d), with A = -exp(a_log[d, :]) and a float32 state
// h[0:DS] carried from h0 over S steps,
//   h   = exp(dt_t A) * h + (dt_t x_t) B_t,
//   y_t = h . C_t,
// y written in x's dtype (bf16 or float32), the final state hT float32.
// dt, x (B, S, di) and b, c (B, S, DS) are read through their strides:
// in the model b and c are column slices of the x_proj output (row stride
// dt_rank + 2 DS), read with no copy. Unlike the Pallas kernel, which
// asserts S % chunk == 0, any S >= 1 is taken: a 1000-token prompt
// prefills in one launch and S = 1 is a decode step.
//
// What bounds it on an H100: bytes in principle — per (step, channel) it
// reads dt and x and writes y (2 bytes each in bf16) and does ~5 float32
// operations and one exp for each of the DS state entries, below the
// float32 ridge; the state is read and written once per launch. In
// practice the exps: DS = 16 of them per (step, channel) on the special-
// function units (16 per clock per SM) take ~2x as long as the bytes at a
// 4 x 1000 prefill of jamba (d_inner 16384). And the recurrence is
// sequential in time, so a thread walks its S steps one after another.
//
// Design (simple and right first): one thread per (sequence, channel),
// 128 channels per block, grid (ceil(di / 128), B). Each thread keeps its
// state h[DS] and A[DS] (pre-scaled by log2(e), so that exp(dt A) is one
// exp2f, which is accurate to 2 ulp and runs on the special-function unit)
// in registers for the whole launch: the state is read from device memory
// once and written once. The steps go in chunks of CHUNK: a chunk's dt and
// x values are loaded into registers one chunk ahead (coalesced across the
// block's channels), and its B and C rows, shared by all channels, are
// staged in shared memory, double-buffered with one barrier per chunk.
// Arithmetic is float32 throughout. Because each thread owns its (b, d)
// state row, hT may be the same memory as h0 (the wrapper's in-place mode
// writes a cache slot's state over itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // channels per block
constexpr int CHUNK = 16;       // steps per register tile and shared stage
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                // element strides of dims 0-1; dim 2 is 1
  long long b, s;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the B and C rows of steps t0 .. t0 + CHUNK - 1 into shared memory
template <typename T, int DS>
__device__ __forceinline__ void stage(float (&sb)[CHUNK][DS],
                                      float (&sc)[CHUNK][DS], const T* bp,
                                      const T* cp, Strides bs, Strides cs,
                                      int t0, int S) {
  for (int i = threadIdx.x; i < CHUNK * DS; i += THREADS) {
    const int t = i / DS, s = i % DS;
    float bv = 0.f, cv = 0.f;
    if (t0 + t < S) {
      bv = load(bp + (t0 + t) * bs.s + s);
      cv = load(cp + (t0 + t) * cs.s + s);
    }
    sb[t][s] = bv;
    sc[t][s] = cv;
  }
}

// a chunk's dt and x values of one channel into registers
template <typename T>
__device__ __forceinline__ void fetch(float (&dtr)[CHUNK],
                                      float (&xr)[CHUNK], const T* dtp,
                                      const T* xp, Strides dts, Strides xs,
                                      int t0, int S) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const bool in = t0 + i < S;
    dtr[i] = in ? load(dtp + (t0 + i) * dts.s) : 0.f;
    xr[i] = in ? load(xp + (t0 + i) * xs.s) : 0.f;
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd(const float* __restrict__ a_log, const T* __restrict__ dt,
               const T* __restrict__ b, const T* __restrict__ c,
               const T* __restrict__ x, const float* h0, float* hT,
               T* __restrict__ y, int S, int di, Strides dts, Strides bs,
               Strides cs, Strides xs, long long h0b, long long hTb) {
  __shared__ float sb[2][CHUNK][DS];
  __shared__ float sc[2][CHUNK][DS];

  const int bb = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;
  const int dd = live ? d : di - 1;   // idle lanes load a valid channel

  float A2[DS], h[DS];
  const float* st0 = h0 + bb * h0b + (long long)dd * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A2[s] = -expf(a_log[dd * DS + s]) * LOG2E;
    h[s] = st0[s];
  }

  const T* dtp = dt + bb * dts.b + dd;
  const T* xp = x + bb * xs.b + dd;
  const T* bp = b + bb * bs.b;
  const T* cp = c + bb * cs.b;
  T* yp = y + (long long)bb * S * di + d;

  float dtr[CHUNK], xr[CHUNK];
  fetch<T>(dtr, xr, dtp, xp, dts, xs, 0, S);
  stage<T, DS>(sb[0], sc[0], bp, cp, bs, cs, 0, S);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int t1 = t0 + CHUNK;
    float dtn[CHUNK], xn[CHUNK];   // the next chunk, in flight now
    fetch<T>(dtn, xn, dtp, xp, dts, xs, t1, S);
    if (t1 < S)
      stage<T, DS>(sb[buf ^ 1], sc[buf ^ 1], bp, cp, bs, cs, t1, S);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (t0 + i < S) {            // the same for every thread
        const float dtv = dtr[i], dx = dtr[i] * xr[i];
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = fmaf(exp2f(dtv * A2[s]), h[s], dx * sb[buf][i][s]);
          acc = fmaf(h[s], sc[buf][i][s], acc);
        }
        if (live) store(yp + (long long)(t0 + i) * di, acc);
      }
    }
    // one barrier per chunk: the next chunk's rows are visible after it,
    // and the buffer read here is written again only after the next one
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      dtr[i] = dtn[i];
      xr[i] = xn[i];
    }
    buf ^= 1;
  }

  if (live) {
    float* stT = hT + bb * hTb + (long long)d * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) stT[s] = h[s];
  }
}

template <typename T, int DS>
int launch(const float* a_log, const void* dt, const void* b, const void* c,
           const void* x, const float* h0, float* hT, void* y, int B, int S,
           int di, const long long* st, cudaStream_t stream) {
  const dim3 grid((di + THREADS - 1) / THREADS, B);
  mamba_scan_fwd<T, DS><<<grid, THREADS, 0, stream>>>(
      a_log, (const T*)dt, (const T*)b, (const T*)c, (const T*)x, h0, hT,
      (T*)y, S, di, Strides{st[0], st[1]}, Strides{st[2], st[3]},
      Strides{st[4], st[5]}, Strides{st[6], st[7]}, st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int ds, const float* a_log, const void* dt, const void* b,
             const void* c, const void* x, const float* h0, float* hT,
             void* y, int B, int S, int di, const long long* st,
             cudaStream_t s) {
  if (ds == 16)
    return launch<T, 16>(a_log, dt, b, c, x, h0, hT, y, B, S, di, st, s);
  if (ds == 8)
    return launch<T, 8>(a_log, dt, b, c, x, h0, hT, y, B, S, di, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of dt, b, c, x and y): 0 float32, 1 bfloat16. dt, x (B, S, di)
// and b, c (B, S, ds): the last dim contiguous, the (b, s) element strides
// in `strides` as {dt, b, c, x} x {b, s}, then the batch strides of h0 and
// hT, whose (di, ds) state of one sequence is contiguous. a_log (di, ds)
// float32 contiguous; y (B, S, di) contiguous. hT may equal h0 (in
// place). ds in {8, 16}; S >= 1. The wrapper checks all of it and raises
// before calling.
extern "C" int mamba_scan_launch(int dtype, int ds, const float* a_log,
                                 const void* dt, const void* b,
                                 const void* c, const void* x,
                                 const float* h0, float* hT, void* y, int B,
                                 int S, int di, const long long* strides,
                                 void* stream) {
  if (B == 0 || S == 0 || di == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(ds, a_log, dt, b, c, x, h0, hT, y, B, S, di,
                           strides, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(ds, a_log, dt, b, c, x, h0, hT, y, B, S,
                                   di, strides, s);
  return (int)cudaErrorInvalidValue;
}
