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
// practice the instructions: DS = 16 exps per (step, channel) on the
// special-function units (16 per clock per SM; at a 4 x 1000 prefill of
// jamba, d_inner 16384, they alone take ~2x as long as the bytes), and
// for each entry a multiply for dt A, a multiply for dt x B, the state's
// multiply-add, the output's multiply-add and the reads of B and C from
// shared memory. The recurrence is sequential in time, so a thread walks
// its S steps one after another. At a decode step (S = 1) the state is
// nearly all of the bytes.
//
// Two kernels, one C entry; the entry picks by S and alignment alone (no
// host sync):
//
// mamba_scan_fwd (prefill: S > DECODE_MAX_S): one thread per (sequence,
// channel), 64 channels per block, grid (ceil(di / 64), B). Each thread
// keeps its state h[DS] and A[DS] (pre-scaled by log2(e), so that exp(dt
// A) is one exp2) in registers for the whole launch. The steps go in
// chunks of CHUNK: a chunk's dt and x values are loaded into registers
// one chunk ahead (coalesced across the block's channels), and its B and
// C rows, shared by all channels, are loaded one chunk ahead into
// registers and staged in shared memory, double-buffered with one barrier
// per chunk. Chunks of 8 steps and blocks of 64 threads keep a thread at
// 128 registers, so that a 4 x 1000 prefill of jamba (B x di = 65,536
// threads) is resident on the 132 SMs at once (with 16 steps and 128
// threads it took 165 and ran in 1.3 waves). The kernel is bound by
// instruction issue; per (step, entry) the instructions are cut to what the
// function needs: exp2 is one ex2.approx.ftz (MUFU.EX2; its argument dt A
// is <= 0, so flushing results below 2^-126 to 0 cannot move the state by
// 1e-5; exp2f wraps range fix-ups around it), B and C are read from
// shared memory as float4, y sums in two chains. (Taking a share of the
// exps onto the FMA pipe by a polynomial, as FlashAttention-3 does, made
// the kernel slower: it is bound by instruction issue, not by the
// special-function units; PERF.md.)
//
// mamba_scan_step (decode: S <= DECODE_MAX_S, 16-byte aligned state and
// a_log): lanes cover (channel, 4 state entries) pairs, DS / 4 lanes per
// channel, so the state and a_log move as coalesced float4s; A = -exp(a_log)
// is one ex2 per entry; y is a shuffle reduction over the channel's lanes.
//
// Arithmetic is float32 throughout. Each thread owns its state entries,
// read once before they are written, so hT may be the same memory as h0
// (the wrapper's in-place mode writes a cache slot's state over itself).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;     // channels per block (prefill)
constexpr int CHUNK = 8;        // steps per register tile and shared stage
constexpr int DECODE_MAX_S = 4;    // mamba_scan_step up to this many steps
constexpr int STEP_THREADS = 256;  // threads per block (decode)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                // element strides of dims 0-1; dim 2 is 1
  long long b, s;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 2^x on the special-function unit: MUFU.EX2 alone, results below 2^-126
// flushed to 0 (exp2f adds range fix-ups around it for those)
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// the B and C rows of steps t0 .. t0 + CHUNK - 1, raw, into registers:
// element threadIdx.x + THREADS * m of the chunk's CHUNK x DS rows
template <typename T, int DS>
__device__ __forceinline__ void fetch_bc(T (&bn)[CHUNK * DS / THREADS],
                                         T (&cn)[CHUNK * DS / THREADS],
                                         const T* bp, const T* cp,
                                         Strides bs, Strides cs, int t0,
                                         int S) {
#pragma unroll
  for (int m = 0; m < CHUNK * DS / THREADS; ++m) {
    const int i = threadIdx.x + THREADS * m, t = i / DS, s = i % DS;
    const bool in = t0 + t < S;
    bn[m] = in ? bp[(long long)(t0 + t) * bs.s + s] : T(0.f);
    cn[m] = in ? cp[(long long)(t0 + t) * cs.s + s] : T(0.f);
  }
}

// ... and from registers into shared memory
template <typename T, int DS>
__device__ __forceinline__ void stage(float (&sb)[CHUNK][DS],
                                      float (&sc)[CHUNK][DS],
                                      const T (&bn)[CHUNK * DS / THREADS],
                                      const T (&cn)[CHUNK * DS / THREADS]) {
#pragma unroll
  for (int m = 0; m < CHUNK * DS / THREADS; ++m) {
    const int i = threadIdx.x + THREADS * m;
    sb[i / DS][i % DS] = to_float(bn[m]);
    sc[i / DS][i % DS] = to_float(cn[m]);
  }
}

// a chunk's dt and x values of one channel, raw, into registers
template <typename T>
__device__ __forceinline__ void fetch(T (&dtr)[CHUNK], T (&xr)[CHUNK],
                                      const T* dtp, const T* xp,
                                      Strides dts, Strides xs, int t0,
                                      int S) {
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    const bool in = t0 + i < S;
    dtr[i] = in ? dtp[(long long)(t0 + i) * dts.s] : T(0.f);
    xr[i] = in ? xp[(long long)(t0 + i) * xs.s] : T(0.f);
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd(const float* __restrict__ a_log, const T* __restrict__ dt,
               const T* __restrict__ b, const T* __restrict__ c,
               const T* __restrict__ x, const float* h0, float* hT,
               T* __restrict__ y, int S, int di, Strides dts, Strides bs,
               Strides cs, Strides xs, long long h0b, long long hTb) {
  static_assert(CHUNK * DS % THREADS == 0 && DS % 4 == 0, "layout");
  constexpr int SPT = CHUNK * DS / THREADS;    // B, C values per thread
  __shared__ __align__(16) float sb[2][CHUNK][DS];
  __shared__ __align__(16) float sc[2][CHUNK][DS];

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

  T dtr[CHUNK], xr[CHUNK], bn[SPT], cn[SPT];
  fetch<T>(dtr, xr, dtp, xp, dts, xs, 0, S);
  fetch_bc<T, DS>(bn, cn, bp, cp, bs, cs, 0, S);
  stage<T, DS>(sb[0], sc[0], bn, cn);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int t1 = t0 + CHUNK;
    T dtn[CHUNK], xn[CHUNK];      // the next chunk, in flight now
    fetch<T>(dtn, xn, dtp, xp, dts, xs, t1, S);
    if (t1 < S) fetch_bc<T, DS>(bn, cn, bp, cp, bs, cs, t1, S);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (t0 + i < S) {            // the same for every thread
        const float dtv = to_float(dtr[i]), dx = dtv * to_float(xr[i]);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int s4 = 0; s4 < DS; s4 += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              &sb[buf][i][s4]);
          const float4 c4 = *reinterpret_cast<const float4*>(
              &sc[buf][i][s4]);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s4 + e;
            h[s] = fmaf(ex2(dtv * A2[s]), h[s], dx * bv[e]);
            if (s & 1)
              acc1 = fmaf(h[s], cv[e], acc1);
            else
              acc0 = fmaf(h[s], cv[e], acc0);
          }
        }
        if (live) store(yp + (long long)(t0 + i) * di, acc0 + acc1);
      }
    }
    // the next chunk's rows into the other buffer, then one barrier per
    // chunk: they are visible after it, and the buffer read here is
    // written again only after the next one
    if (t1 < S) stage<T, DS>(sb[buf ^ 1], sc[buf ^ 1], bn, cn);
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
__global__ void __launch_bounds__(STEP_THREADS)
mamba_scan_step(const float* __restrict__ a_log, const T* __restrict__ dt,
                const T* __restrict__ b, const T* __restrict__ c,
                const T* __restrict__ x, const float* h0, float* hT,
                T* __restrict__ y, int B, int S, int di, Strides dts,
                Strides bs, Strides cs, Strides xs, long long h0b,
                long long hTb) {
  constexpr int L = DS / 4;     // lanes of one channel, 4 entries each
  const long long total = (long long)B * di * L;
  const long long gid = (long long)blockIdx.x * STEP_THREADS + threadIdx.x;
  const bool live = gid < total;
  // a channel's L lanes are all live or all idle; idle ones take the
  // last channel, so that every lane of a warp joins the shuffles
  const long long e = live ? gid : total - L + gid % L;
  const int q = (int)(e % L);
  const int d = (int)((e / L) % di);
  const int bb = (int)(e / ((long long)L * di));

  const float4 al = *reinterpret_cast<const float4*>(
      a_log + (long long)d * DS + 4 * q);
  const float A2[4] = {-ex2(al.x * LOG2E) * LOG2E, -ex2(al.y * LOG2E) * LOG2E,
                       -ex2(al.z * LOG2E) * LOG2E,
                       -ex2(al.w * LOG2E) * LOG2E};
  float4 h4 = *reinterpret_cast<const float4*>(
      h0 + bb * h0b + (long long)d * DS + 4 * q);
  float h[4] = {h4.x, h4.y, h4.z, h4.w};

  for (int t = 0; t < S; ++t) {
    const float dtv = load(dt + bb * dts.b + t * dts.s + d);
    const float dx = dtv * load(x + bb * xs.b + t * xs.s + d);
    const T* bp = b + bb * bs.b + t * bs.s + 4 * q;
    const T* cp = c + bb * cs.b + t * cs.s + 4 * q;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = fmaf(ex2(dtv * A2[i]), h[i], dx * load(bp + i));
      acc = fmaf(h[i], load(cp + i), acc);
    }
#pragma unroll
    for (int off = L / 2; off >= 1; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && q == 0) store(y + ((long long)bb * S + t) * di + d, acc);
  }
  if (live)
    *reinterpret_cast<float4*>(hT + bb * hTb + (long long)d * DS + 4 * q) =
        make_float4(h[0], h[1], h[2], h[3]);
}

template <typename T, int DS>
int launch(const float* a_log, const void* dt, const void* b, const void* c,
           const void* x, const float* h0, float* hT, void* y, int B, int S,
           int di, const long long* st, cudaStream_t stream) {
  const Strides dts{st[0], st[1]}, bs{st[2], st[3]}, cs{st[4], st[5]},
      xs{st[6], st[7]};
  // the decode kernel moves the state and a_log as float4s
  const bool aligned = ((uintptr_t)a_log | (uintptr_t)h0 | (uintptr_t)hT)
                           % 16 == 0 && st[8] % 4 == 0 && st[9] % 4 == 0;
  if (S <= DECODE_MAX_S && aligned) {
    const long long threads = (long long)B * di * (DS / 4);
    const unsigned blocks =
        (unsigned)((threads + STEP_THREADS - 1) / STEP_THREADS);
    mamba_scan_step<T, DS><<<blocks, STEP_THREADS, 0, stream>>>(
        a_log, (const T*)dt, (const T*)b, (const T*)c, (const T*)x, h0, hT,
        (T*)y, B, S, di, dts, bs, cs, xs, st[8], st[9]);
  } else {
    const dim3 grid((di + THREADS - 1) / THREADS, B);
    mamba_scan_fwd<T, DS><<<grid, THREADS, 0, stream>>>(
        a_log, (const T*)dt, (const T*)b, (const T*)c, (const T*)x, h0, hT,
        (T*)y, S, di, dts, bs, cs, xs, st[8], st[9]);
  }
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
// before calling. One kernel per call: mamba_scan_step for S <=
// DECODE_MAX_S (4) with 16-byte aligned a_log, h0 and hT (whose batch
// strides are multiples of 4), else mamba_scan_fwd.
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
