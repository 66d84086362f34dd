// RMSNorm with its residual add, and RoPE with the KV-cache write: the
// elementwise tail of a decoder layer as two kernels.
//
// No TPU kernel is replaced. The JAX package leaves its norms, rotations
// and cache writes (src/repro/models/layers.py rmsnorm and apply_rope,
// src/repro/models/attention.py _update_cache) to XLA, which fuses them.
// The port ran them as PyTorch's composition: a norm is 9 kernels (casts,
// a square, a mean, an add, a rsqrt, two products), a rotation 9 more for
// q and again for k, each cache write an index_put_, each residual an add:
// ~40 kernels a decode layer for 32 rows of 2,048 values.
//
// What bounds them on an H100: bytes, and at decode the launch itself. A
// norm reads x (and delta) and writes y (and the sum) once, ~4 flops an
// element; a rotation reads q, k, v and the angles and writes each once.
// Both kernels do that in one pass, with 16-byte vector loads and stores
// where the pointers and strides allow (scalar ones otherwise), and keep
// their float32 intermediates in registers.
//
// Arithmetic, chosen so that every value is the PyTorch composition's:
//   rmsnorm: s = x + delta, the float32 sum rounded to x's dtype (PyTorch's
//     add); ss = the float32 sum of s * s, each product rounded; var = ss *
//     (1 / D); r = rsqrtf(var + eps); y = (s * r) * scale, two rounded
//     float32 products, one cast back. Only the order of the sum of squares
//     differs from PyTorch's reduction, so y is within one unit in the last
//     place of the composition's in bf16 and fp16 (a few units in float32),
//     and s is bit for bit.
//   rope_cache: out1 = x1 cos - x2 sin, out2 = x1 sin + x2 cos over the two
//     halves of the head dim, each product, difference and sum rounded in
//     float32 (no fused multiply-add), cast to x's dtype with round to
//     nearest even, then to the cache's dtype: bit for bit apply_rope and
//     the index_put_ that wrote the rows.
//
// rmsnorm_kernel: a row's D / VEC vectors are spread over `tpr` threads. A
// row of at most 32 vectors takes a power-of-two group of lanes of one warp
// (several rows a block; jamba's B and C norms are 2 vectors wide); a wider
// row takes a block of up to 1024 threads (granite's 2,048 bf16 values are
// 256 vectors, one a thread). A thread keeps its first ITEMS vectors in
// registers between the sum of squares and the output; past that (rows
// wider than ITEMS * 1024 vectors) it reads its vectors again.
//
// rope_cache_kernel: one thread a VEC-wide piece of both halves of one head
// row of one token: q heads, then k heads, then v heads (v is only copied).
// Cache rows come from `cols` (the rows _update_cache indexes), and a row
// outside [0, max_len) is not written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int ITEMS = 2;            // vectors a thread keeps in registers
constexpr int SMALL_THREADS = 256;  // block of rows of at most 32 vectors
constexpr int MAX_THREADS = 1024;
constexpr int ROPE_THREADS = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// rmsnorm
// ---------------------------------------------------------------------------

// vector i of a row: s = x (+ delta, rounded to T; stored to sr where
// `store`), f = float(s), ss += f * f
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* xr, const T* dr, T* sr,
                                         int i, bool store, float (&f)[VEC],
                                         float& ss) {
  using P = Pack<T, VEC>;
  P a = reinterpret_cast<const P*>(xr)[i];
  if (dr != nullptr) {
    const P d = reinterpret_cast<const P*>(dr)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      a.v[j] = from_f<T>(__fadd_rn(to_f(a.v[j]), to_f(d.v[j])));
    if (store) reinterpret_cast<P*>(sr)[i] = a;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    f[j] = to_f(a.v[j]);
    ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
  }
}

template <typename T, typename S, int VEC>
__device__ __forceinline__ void store_row(T* yr, const S* scale, int i,
                                          const float (&f)[VEC], float r) {
  const Pack<S, VEC> sc = reinterpret_cast<const Pack<S, VEC>*>(scale)[i];
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = from_f<T>(__fmul_rn(__fmul_rn(f[j], r), to_f(sc.v[j])));
  reinterpret_cast<Pack<T, VEC>*>(yr)[i] = o;
}

// the sum of v over a row's tpr threads, the same value in each: a
// butterfly within the warp (each step adds two values, in either order
// the same float), then the warps' sums in warp order
__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int o = (tpr < 32 ? tpr : 32) / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tpr <= 32) return v;
  __shared__ float part[MAX_THREADS / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) t = __fadd_rn(t, part[w]);
  return t;
}

// rows of nvec vectors; x and delta at row strides xs and ds (elements),
// sum and y contiguous; tpr threads a row (a power of two up to 32, or
// blockDim.x, one row a block)
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, long long xs,
               const T* __restrict__ delta, long long ds, T* __restrict__ sum,
               T* __restrict__ y, const S* __restrict__ scale,
               long long rows, int nvec, int tpr, float inv_d, float eps) {
  const int lane = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const long long at = live ? row : 0;
  const long long width = (long long)nvec * VEC;
  const T* xr = x + at * xs;
  const T* dr = delta == nullptr ? nullptr : delta + at * ds;
  T* sr = sum == nullptr ? nullptr : sum + at * width;
  T* yr = y + at * width;
  float keep[ITEMS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lane + k * tpr;
    if (live && i < nvec) load_row<T, VEC>(xr, dr, sr, i, true, keep[k], ss);
  }
  for (int i = lane + ITEMS * tpr; live && i < nvec; i += tpr) {
    float f[VEC];
    load_row<T, VEC>(xr, dr, sr, i, true, f, ss);
  }
  ss = row_sum(ss, tpr);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = lane + k * tpr;
    if (live && i < nvec) store_row<T, S, VEC>(yr, scale, i, keep[k], r);
  }
  for (int i = lane + ITEMS * tpr; live && i < nvec; i += tpr) {
    float f[VEC], unused = 0.f;
    load_row<T, VEC>(xr, dr, sr, i, false, f, unused);
    store_row<T, S, VEC>(yr, scale, i, f, r);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, typename S, int VEC>
cudaError_t launch_norm(const void* x, long long xs, const void* delta,
                        long long ds, void* sum, void* y, const void* scale,
                        long long rows, int D, float eps, cudaStream_t st) {
  const int nvec = D / VEC;
  int tpr, threads;
  long long blocks;
  if (nvec <= 32) {
    tpr = 1;
    while (tpr < nvec) tpr <<= 1;
    threads = SMALL_THREADS;
    blocks = (rows + threads / tpr - 1) / (threads / tpr);
  } else {
    tpr = threads = nvec < MAX_THREADS ? (nvec + 31) / 32 * 32 : MAX_THREADS;
    blocks = rows;
  }
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, S, VEC><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<const T*>(x), xs, static_cast<const T*>(delta), ds,
      static_cast<T*>(sum), static_cast<T*>(y), static_cast<const S*>(scale),
      rows, nvec, tpr, 1.0f / (float)D, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t norm_typed(const void* x, long long xs, const void* delta,
                       long long ds, void* sum, void* y, const void* scale,
                       long long rows, int D, float eps, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr unsigned SA = V * sizeof(S) < 16 ? V * sizeof(S) : 16;
  const bool vec = D % V == 0 && aligned(x, 16) && aligned(y, 16) &&
                   (xs * (long long)sizeof(T)) % 16 == 0 &&
                   (delta == nullptr ||
                    (aligned(delta, 16) && aligned(sum, 16) &&
                     (ds * (long long)sizeof(T)) % 16 == 0)) &&
                   aligned(scale, SA);
  return vec ? launch_norm<T, S, V>(x, xs, delta, ds, sum, y, scale, rows, D,
                                    eps, st)
             : launch_norm<T, S, 1>(x, xs, delta, ds, sum, y, scale, rows, D,
                                    eps, st);
}

template <typename T>
cudaError_t norm_by_scale(bool f32_scale, const void* x, long long xs,
                          const void* delta, long long ds, void* sum, void* y,
                          const void* scale, long long rows, int D, float eps,
                          cudaStream_t st) {
  return f32_scale ? norm_typed<T, float>(x, xs, delta, ds, sum, y, scale,
                                          rows, D, eps, st)
                   : norm_typed<T, T>(x, xs, delta, ds, sum, y, scale, rows,
                                      D, eps, st);
}

// ---------------------------------------------------------------------------
// rope_cache
// ---------------------------------------------------------------------------

struct Str3 {             // element strides of dims 0-2; the last dim is 1
  long long b, s, h;
};

struct Rope {
  const void *q, *k, *v;
  void *qo, *ck, *cv;
  const float *cos, *sin;
  const long long* cols;
  Str3 qs, ks, vs, cks, cvs;
  long long tb, ts, cb, cs;   // angles' and cols' strides of dims 0-1
  int B, S, H, KV, half;
  long long max_len;
};

template <typename T, typename C, int VEC>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_cache_kernel(Rope a, int hq, long long total) {
  using P = Pack<T, VEC>;
  using PC = Pack<C, VEC>;
  using PF = Pack<float, VEC>;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nc = a.half / VEC, nrows = hq + 2 * a.KV;
  const int j = (int)(idx % nc) * VEC;
  const long long rest = idx / nc;
  const int r = (int)(rest % nrows);
  const long long t = rest / nrows;
  const long long b = t / a.S, s = t % a.S;
  const T* src;
  if (r < hq) {
    src = static_cast<const T*>(a.q) + b * a.qs.b + s * a.qs.s + r * a.qs.h;
  } else if (r < hq + a.KV) {
    src = static_cast<const T*>(a.k) + b * a.ks.b + s * a.ks.s +
          (r - hq) * a.ks.h;
  } else {
    src = static_cast<const T*>(a.v) + b * a.vs.b + s * a.vs.s +
          (r - hq - a.KV) * a.vs.h;
  }
  P x1 = *reinterpret_cast<const P*>(src + j);
  P x2 = *reinterpret_cast<const P*>(src + a.half + j);
  if (a.cos != nullptr && r < hq + a.KV) {
    const long long ta = b * a.tb + s * a.ts + j;
    const PF c = *reinterpret_cast<const PF*>(a.cos + ta);
    const PF n = *reinterpret_cast<const PF*>(a.sin + ta);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f1 = to_f(x1.v[e]), f2 = to_f(x2.v[e]);
      x1.v[e] = from_f<T>(
          __fsub_rn(__fmul_rn(f1, c.v[e]), __fmul_rn(f2, n.v[e])));
      x2.v[e] = from_f<T>(
          __fadd_rn(__fmul_rn(f1, n.v[e]), __fmul_rn(f2, c.v[e])));
    }
  }
  if (r < hq) {
    T* dst = static_cast<T*>(a.qo) +
             ((b * a.S + s) * a.H + r) * (long long)(2 * a.half);
    *reinterpret_cast<P*>(dst + j) = x1;
    *reinterpret_cast<P*>(dst + a.half + j) = x2;
    return;
  }
  const long long col = a.cols[b * a.cb + s * a.cs];
  if (col < 0 || col >= a.max_len) return;
  C* dst;
  if (r < hq + a.KV) {
    dst = static_cast<C*>(a.ck) + b * a.cks.b + col * a.cks.s +
          (r - hq) * a.cks.h;
  } else {
    dst = static_cast<C*>(a.cv) + b * a.cvs.b + col * a.cvs.s +
          (r - hq - a.KV) * a.cvs.h;
  }
  PC o1, o2;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    o1.v[e] = from_f<C>(to_f(x1.v[e]));
    o2.v[e] = from_f<C>(to_f(x2.v[e]));
  }
  *reinterpret_cast<PC*>(dst + j) = o1;
  *reinterpret_cast<PC*>(dst + a.half + j) = o2;
}

template <typename T, typename C, int VEC>
cudaError_t launch_rope(const Rope& a, cudaStream_t st) {
  const int hq = a.cos != nullptr ? a.H : 0;
  const long long total =
      (long long)a.B * a.S * (hq + 2 * a.KV) * (a.half / VEC);
  const long long blocks = (total + ROPE_THREADS - 1) / ROPE_THREADS;
  if (total == 0) return cudaSuccess;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  rope_cache_kernel<T, C, VEC><<<(unsigned)blocks, ROPE_THREADS, 0, st>>>(
      a, hq, total);
  return cudaGetLastError();
}

// every address a VEC-wide piece starts at: each base pointer and each
// stride, and the half head dim, a multiple of the piece's alignment
template <typename T, typename C, int VEC>
bool rope_vectors(const Rope& a) {
  constexpr unsigned AT = alignof(Pack<T, VEC>), AC = alignof(Pack<C, VEC>),
                     AF = alignof(Pack<float, VEC>);
  auto mult = [](long long elems, unsigned es, unsigned al) {
    return (elems * (long long)es) % al == 0;
  };
  bool ok = a.half % VEC == 0 && aligned(a.k, AT) && aligned(a.v, AT) &&
            aligned(a.ck, AC) && aligned(a.cv, AC) &&
            mult(a.half, sizeof(T), AT) && mult(a.half, sizeof(C), AC);
  for (const Str3& s : {a.ks, a.vs})
    ok = ok && mult(s.b, sizeof(T), AT) && mult(s.s, sizeof(T), AT) &&
         mult(s.h, sizeof(T), AT);
  for (const Str3& s : {a.cks, a.cvs})
    ok = ok && mult(s.b, sizeof(C), AC) && mult(s.s, sizeof(C), AC) &&
         mult(s.h, sizeof(C), AC);
  if (a.cos != nullptr)
    ok = ok && aligned(a.q, AT) && aligned(a.qo, AT) && aligned(a.cos, AF) &&
         aligned(a.sin, AF) && mult(a.qs.b, sizeof(T), AT) &&
         mult(a.qs.s, sizeof(T), AT) && mult(a.qs.h, sizeof(T), AT) &&
         mult(a.tb, 4, AF) && mult(a.ts, 4, AF);
  return ok;
}

template <typename T, typename C>
cudaError_t rope_typed(const Rope& a, cudaStream_t st) {
  constexpr int V = 16 / (int)sizeof(T);
  return rope_vectors<T, C, V>(a) ? launch_rope<T, C, V>(a, st)
                                  : launch_rope<T, C, 1>(a, st);
}

template <typename T>
cudaError_t rope_by_cache(int cdtype, const Rope& a, cudaStream_t st) {
  switch (cdtype) {
    case 0: return rope_typed<T, float>(a, st);
    case 1: return rope_typed<T, __nv_bfloat16>(a, st);
    case 2: return rope_typed<T, __half>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.
// x: rows of D elements of `dtype` at row stride xs (elements), the last
// dim contiguous; delta: NULL or the same at row stride ds, then sum (a
// contiguous (rows, D) output) receives x + delta; y: contiguous (rows, D)
// output; scale: D contiguous elements of sdtype, float32 or x's dtype.
extern "C" int rmsnorm_launch(int dtype, int sdtype, const void* x,
                              long long xs, const void* delta, long long ds,
                              void* sum, void* y, const void* scale,
                              long long rows, int D, float eps,
                              void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || D < 1 || (delta != nullptr && sum == nullptr) ||
      (sdtype != 0 && sdtype != dtype))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool f32 = sdtype == 0;
  switch (dtype) {
    case 0:
      return (int)norm_typed<float, float>(x, xs, delta, ds, sum, y, scale,
                                           rows, D, eps, st);
    case 1:
      return (int)norm_by_scale<__nv_bfloat16>(f32, x, xs, delta, ds, sum, y,
                                               scale, rows, D, eps, st);
    case 2:
      return (int)norm_by_scale<__half>(f32, x, xs, delta, ds, sum, y, scale,
                                        rows, D, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q: (B, S, H, hd), k and v: (B, S, KV, hd) of `dtype`; qo: a contiguous
// (B, S, H, hd) output, or NULL without rotation (cos and sin NULL: q is
// neither read nor written); ck and cv: caches (>= B, max_len, KV, hd) of
// `cdtype`; cos and sin: float32 (B, S, hd / 2); cols: int64 (B, S), the
// cache row of token (b, s). strides (elements, the last dim of each
// tensor contiguous): q, k, v, ck, cv 3 each (dims 0-2), then the angles'
// 2 and cols' 2 (dims 0-1).
extern "C" int rope_cache_launch(int dtype, int cdtype, const void* q,
                                 const void* k, const void* v, void* qo,
                                 void* ck, void* cv, const float* cos,
                                 const float* sin, const long long* cols,
                                 const int64_t* strides, int B, int S, int H,
                                 int KV, int hd, long long max_len,
                                 void* stream) {
  if (B < 0 || S < 0 || H < 1 || KV < 1 || hd < 2 || hd % 2 ||
      (cos == nullptr) != (sin == nullptr) ||
      (cos != nullptr && qo == nullptr))
    return (int)cudaErrorInvalidValue;
  Rope a;
  a.q = q; a.k = k; a.v = v; a.qo = qo; a.ck = ck; a.cv = cv;
  a.cos = cos; a.sin = sin; a.cols = cols;
  Str3* s3[] = {&a.qs, &a.ks, &a.vs, &a.cks, &a.cvs};
  for (int i = 0; i < 5; ++i)
    *s3[i] = Str3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.tb = strides[15]; a.ts = strides[16];
  a.cb = strides[17]; a.cs = strides[18];
  a.B = B; a.S = S; a.H = H; a.KV = KV; a.half = hd / 2;
  a.max_len = max_len;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)rope_by_cache<float>(cdtype, a, st);
    case 1: return (int)rope_by_cache<__nv_bfloat16>(cdtype, a, st);
    case 2: return (int)rope_by_cache<__half>(cdtype, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
