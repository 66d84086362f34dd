// Flash-decode: one query token per sequence against its KV cache,
// split over the key range (split-K flash-decode).
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
// it:
//
// - Enough reads in flight. One block per (KV head, sequence) gives 64
//   blocks at 8 slots x 8 KV heads for 132 SMs. Pass 1 runs one block
//   per (split, KV head, sequence) instead: a sequence's keys
//   [0, kend) are cut into nsplit equal ranges, kend = min(S, valid)
//   read on the device (or S when valid <= 0), so every split of a
//   sequence gets the same share of its valid keys whatever its length.
//   nsplit comes from host-known shapes only (S, B, KV, the SM count;
//   the wrapper's _attn.decode_splits), so no device value reaches the
//   host. Within a block, tiles of 64 keys arrive by cp.async (16-byte
//   copies, zero-filled past the split) into a two-stage ring: tile t + 1
//   is in flight while tile t is used. The G heads share each K/V tile,
//   so the cache is read once per KV head and not once per query head.
// - Little work between the loads. bf16 (decode_split_mma): the G heads
//   of a KV head (up to 16; more take more blocks) are the 16 rows of an
//   mma.sync m16n8k16 tile, zero rows past G. Each of the 4 warps takes
//   16 keys of every 64-key tile: QK^T and PV on the tensor cores (K
//   through ldmatrix, V through ldmatrix.trans), the online softmax in
//   registers (rows over quad shuffles), P reused from the score
//   registers as bf16, with float32 accumulation; the warps' (m, l, acc)
//   are combined once, at the end. The unnormalised p <= 1 is rounded to
//   bf16 before PV, as in flash attention. float32 (decode_split_fma):
//   float32 FMAs on the CUDA cores, exact to float32 rounding (the
//   float32 replays' 2e-5 tolerance), scores and weights through shared
//   memory. The choice is by dtype, in the C entry; neither falls back.
// - Pass 1 writes each split's float32 (m, l, acc[G, hdv]) into a
//   workspace the wrapper allocates; pass 2 (one block per query head,
//   one thread per output column) merges the splits and writes
//   acc / max(l, 1e-30). A split with no keys (lo >= hi: valid shorter
//   than nsplit keys) writes m = -inf, l = 0, acc = 0 and exits; the
//   merge gives it weight 0.
// - Skipping the masked tail is exact (the reference walks all S/512
//   blocks masked): after key 0 a fully masked tile leaves m, l and acc
//   unchanged. A sequence with no valid key walks the whole cache with
//   -1e30 scores in every split, and the merge gives the reference's
//   uniform average over all S.
//
// One wrapper call is one call of the C entry, which launches both
// passes on the caller's stream; it allocates nothing and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 128;         // threads per pass-1 block (4 warps)
constexpr int BK = 64;          // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of a (S, D) slice (row stride `stride`) into a
// (ROWS, D + 16 bytes) tile of T by cp.async; rows at or past `limit`
// are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long stride, int r0,
                                                int limit) {
  constexpr int N = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int CH = D / N;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * N;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (D + N) + c,
               ok ? src + (long long)(r0 + r) * stride + c : src, ok);
  }
}

// The split's key range [lo, hi) of [0, kend): nsplit ranges of
// ceil(kend / nsplit) keys, the last ones short or empty.
__device__ __forceinline__ void split_range(int kend, int nsplit, int split,
                                            int* lo, int* hi) {
  const int width = (kend + nsplit - 1) / nsplit;
  *lo = min(kend, split * width);
  *hi = min(kend, *lo + width);
}

// The keys a sequence's splits walk: [0, min(S, valid)), or all S when it
// has no valid key (the reference's uniform average).
__device__ __forceinline__ int walked(int S, int valid) {
  return valid <= 0 ? S : min(S, valid);
}

// an empty split's partial: m = -inf, l = 0, acc = 0 for `rows` heads
template <int HDV>
__device__ __forceinline__ void write_empty(float* part, int rows) {
  for (int i = threadIdx.x; i < rows * (HDV + 2); i += blockDim.x)
    part[i] = i % (HDV + 2) == 0 ? -INFINITY : 0.f;
}

// ---------------------------------------------------------------------------
// pass 1, bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int HG = 16;          // heads per block: the mma tile's rows

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// workspace per (sequence, KV head, split, head): m, l, acc[HDV]; block
// (split, KV head x head group, sequence), heads h0 .. h0 + 15 of the
// KV head's group
template <int HD, int HDV>
__global__ void __launch_bounds__(NT)
decode_split_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 float* __restrict__ ws, const int* __restrict__ positions,
                 const int* __restrict__ kv_len, int S, int G, Strides qs,
                 Strides ks, Strides vs, float scale_log2) {
  constexpr int KP = HD + 8, VP = HDV + 8;   // padded row pitches (bf16)
  constexpr int NO = HDV / 8;                // output n-tiles of 8 columns
  constexpr int RING = 2 * BK * (KP + VP) * 2;          // bytes
  constexpr int COMB = 4 * HG * (HDV + 2) * 4;          // bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + 2 * BK * KP;      // 2 stages each
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (RING > COMB ? RING : COMB));          // HG x KP

  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.z;
  const int ng = (G + HG - 1) / HG, KV = gridDim.y / ng;
  const int kvh = blockIdx.y / ng, h0 = (blockIdx.y % ng) * HG;
  const int rows = min(HG, G - h0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;    // mma fragment row, col pair
  const int valid = min(positions[b] + 1, kv_len[b]);
  int lo, hi;
  split_range(walked(S, valid), nsplit, split, &lo, &hi);
  float* part = ws + (((long long)b * KV + kvh) * nsplit + split) * G *
                         (HDV + 2) + h0 * (HDV + 2);
  if (lo >= hi) {
    write_empty<HDV>(part, rows);
    return;
  }
  const int nk = (hi - lo + BK - 1) / BK;

  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  // the heads kvh * G + h0 .. as the tile's rows (zero past `rows`)
  load_tile_async<__nv_bfloat16, HD, HG>(
      sQ, q + b * qs.b + (kvh * G + h0) * qs.h, qs.h, 0, rows);
  load_tile_async<__nv_bfloat16, HD, BK>(sK, kb, ks.s, lo, hi);
  load_tile_async<__nv_bfloat16, HDV, BK>(sV, vb, vs.s, lo, hi);
  cp_async_commit();

  uint32_t qf[HD / 16][4];
  float o[NO][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = lo + t * BK, st = t & 1;
    if (t + 1 < nk) {                   // tile t + 1 flies while t is used
      load_tile_async<__nv_bfloat16, HD, BK>(sK + (st ^ 1) * BK * KP, kb,
                                             ks.s, k0 + BK, hi);
      load_tile_async<__nv_bfloat16, HDV, BK>(sV + (st ^ 1) * BK * VP, vb,
                                              vs.s, k0 + BK, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk],
                    sQ + (lane & 15) * KP + kk * 16 + (lane >> 4) * 8);
    }
    // this warp's 16 keys of the tile
    const __nv_bfloat16* tK = sK + st * BK * KP + warp * 16 * KP;
    const __nv_bfloat16* tV = sV + st * BK * VP + warp * 16 * VP;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, tK + ((lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf[kk], bk[0], bk[1]);
      mma_bf16(s[1], qf[kk], bk[2], bk[3]);
    }
    // keys past the split do not exist here (-inf: p = 0 exactly); with
    // no valid key every score is -1e30
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + warp * 16 + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = kk >= hi ? -INFINITY
                           : (kk < valid ? s[j][e] * scale_log2 : kNegInf);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                       fmaxf(s[1][2 * hh], s[1][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = exp2f(s[j][e] - m_new);   // -inf -> 0
          s[j][e] = p;
          rs += p;
        }
      l[hh] = l[hh] * alpha + rs;       // this lane's share of the row
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, tV + ((lane & 7) + ((lane >> 3) & 1) * 8) * VP +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
    __syncthreads();                    // stage st is refilled next
  }

  // combine the 4 warps' (m, l, acc) per head; the K/V ring is free now
  float* sO = reinterpret_cast<float*>(smem_raw);    // 4 x HG x HDV
  float* sM = sO + 4 * HG * HDV;                     // 4 x HG
  float* sL = sM + 4 * HG;                           // 4 x HG
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = warp * HG + g + 8 * hh;
    if (t4 == 0) {
      sM[r] = m[hh];
      sL[r] = lr;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      sO[r * HDV + 8 * j + 2 * t4] = o[j][2 * hh];
      sO[r * HDV + 8 * j + 2 * t4 + 1] = o[j][2 * hh + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * HDV; i += NT) {
    const int r = i / HDV, c = i % HDV;
    const float mx = fmaxf(fmaxf(sM[r], sM[HG + r]),
                           fmaxf(sM[2 * HG + r], sM[3 * HG + r]));
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      a = fmaf(exp2f(sM[w * HG + r] - mx), sO[(w * HG + r) * HDV + c], a);
    part[r * (HDV + 2) + 2 + c] = a;
    if (c == 0) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        lsum = fmaf(exp2f(sM[w * HG + r] - mx), sL[w * HG + r], lsum);
      part[r * (HDV + 2)] = mx * kLn2;  // the merge works in base e
      part[r * (HDV + 2) + 1] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 1, float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

// block (split, KV head, sequence); all G heads
template <int HD, int HDV>
__global__ void __launch_bounds__(NT)
decode_split_fma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ ws,
                 const int* __restrict__ positions,
                 const int* __restrict__ kv_len, int S, int G, Strides qs,
                 Strides ks, Strides vs, float scale) {
  constexpr int KP = HD + 4, VP = HDV + 4;   // padded row pitches
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // 2 stages of BK x KP
  float* sV = sK + 2 * BK * KP;         // 2 stages of BK x VP
  float* sQ = sV + 2 * BK * VP;         // G x HD
  float* sS = sQ + G * HD;              // G x BK scores, then p
  float* sAcc = sS + G * BK;            // G x HDV
  float* sM = sAcc + G * HDV;           // G
  float* sL = sM + G;                   // G
  float* sAlpha = sL + G;               // G

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = min(positions[b] + 1, kv_len[b]);
  int lo, hi;
  split_range(walked(S, valid), nsplit, split, &lo, &hi);
  float* part = ws + (((long long)b * gridDim.y + kvh) * nsplit + split) *
                         G * (HDV + 2);
  if (lo >= hi) {
    write_empty<HDV>(part, G);
    return;
  }
  const int nk = (hi - lo + BK - 1) / BK;

  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  load_tile_async<float, HD, BK>(sK, kb, ks.s, lo, hi);
  load_tile_async<float, HDV, BK>(sV, vb, vs.s, lo, hi);
  cp_async_commit();

  // the group's G query rows are heads kvh * G .. kvh * G + G - 1
  for (int i = tid; i < G * (HD / 4); i += NT) {
    const int g = i / (HD / 4), c = (i % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(sQ + g * HD + c) =
        *reinterpret_cast<const float4*>(q + b * qs.b +
                                         (kvh * G + g) * qs.h + c);
  }
  for (int i = tid; i < G * HDV; i += NT) sAcc[i] = 0.f;
  for (int g = tid; g < G; g += NT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = lo + t * BK, st = t & 1;
    if (t + 1 < nk) {                   // tile t + 1 flies while t is used
      load_tile_async<float, HD, BK>(sK + (st ^ 1) * BK * KP, kb, ks.s,
                                     k0 + BK, hi);
      load_tile_async<float, HDV, BK>(sV + (st ^ 1) * BK * VP, vb, vs.s,
                                      k0 + BK, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tK = sK + st * BK * KP;
    const float* tV = sV + st * BK * VP;

    // scores: key j = tid % 64 against heads tid / 64 + 2 i, four heads
    // per pass over the key's row; q comes as float4 broadcasts (every
    // lane of a warp reads the same head)
    {
      const int j = tid & (BK - 1), kk = k0 + j;
      for (int g0 = tid / BK; g0 < G; g0 += 8) {
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < HD; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(tK + j * KP + c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int gu = g0 + 2 * u;
            if (gu < G) {
              const float4 a = *reinterpret_cast<const float4*>(
                  sQ + gu * HD + c);
              dot[u] = fmaf(a.x, x.x, dot[u]);
              dot[u] = fmaf(a.y, x.y, dot[u]);
              dot[u] = fmaf(a.z, x.z, dot[u]);
              dot[u] = fmaf(a.w, x.w, dot[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gu = g0 + 2 * u;
          // keys past the split do not exist here: p = 0 exactly
          if (gu < G)
            sS[gu * BK + j] = kk >= hi ? -INFINITY
                                       : (kk < valid ? dot[u] * scale
                                                     : kNegInf);
        }
      }
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

    // acc += P V, two adjacent columns per thread and pass; p comes as
    // float4 broadcasts (a warp's lanes share a head)
    for (int i = tid; i < G * (HDV / 2); i += NT) {
      const int g = i / (HDV / 2), c = (i % (HDV / 2)) * 2;
      const float* p = sS + g * BK;
      const float alpha = sAlpha[g];
      float a0 = sAcc[g * HDV + c] * alpha, a1 = sAcc[g * HDV + c + 1] *
                                                 alpha;
#pragma unroll 4
      for (int j = 0; j < BK; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(p + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 vv = *reinterpret_cast<const float2*>(
              tV + (j + e) * VP + c);
          a0 = fmaf(pj[e], vv.x, a0);
          a1 = fmaf(pj[e], vv.y, a1);
        }
      }
      sAcc[g * HDV + c] = a0;
      sAcc[g * HDV + c + 1] = a1;
    }
    __syncthreads();                    // stage st is refilled next
  }

  for (int i = tid; i < G * HDV; i += NT) {
    const int g = i / HDV, c = i % HDV;
    part[g * (HDV + 2) + 2 + c] = sAcc[i];
  }
  for (int g = tid; g < G; g += NT) {
    part[g * (HDV + 2)] = sM[g];
    part[g * (HDV + 2) + 1] = sL[g];
  }
}

// ---------------------------------------------------------------------------
// pass 2: merge the splits
// ---------------------------------------------------------------------------

// one block per (query head, KV head, sequence), one thread per output
// column: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
// w_s = exp(m_s - max_s m_s), 0 for an empty split (m_s = -inf, whose
// l and acc are 0). Every load is independent of the others, so they
// are all in flight together.
template <typename T, int HDV>
__global__ void __launch_bounds__(HDV)
decode_merge(const float* __restrict__ ws, T* __restrict__ out, int nsplit,
             Strides os) {
  const int g = blockIdx.x, G = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x;
  const long long step = (long long)G * (HDV + 2);     // split to split
  const float* p = ws + ((long long)b * gridDim.y + kvh) * nsplit * step +
                   g * (HDV + 2);
  float mx = -INFINITY;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p[s * step]);
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const float m = p[s * step];
    const float w = m == -INFINITY ? 0.f : expf(m - mx);
    l = fmaf(w, p[s * step + 1], l);
    a = fmaf(w, p[s * step + 2 + c], a);
  }
  store(out + b * os.b + (kvh * G + g) * os.h + c, a / fmaxf(l, 1e-30f));
}

template <int HD, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, float* ws, const int* positions, const int* kv_len,
           int B, int S, int KV, int G, int nsplit, const long long* st,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaError_t err;
  if (dtype == 1) {
    // the K/V ring (the warps' combine reuses it), then Q
    const size_t ring = sizeof(__nv_bfloat16) *
                        (2 * BK * (HD + 8) + 2 * BK * (HDV + 8));
    const size_t comb = sizeof(float) * 4 * HG * (HDV + 2);
    const size_t smem =
        (ring > comb ? ring : comb) + sizeof(__nv_bfloat16) * HG * (HD + 8);
    auto kern = decode_split_mma<HD, HDV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int ng = (G + HG - 1) / HG;
    kern<<<dim3(nsplit, KV * ng, B), NT, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, ws, positions, kv_len, S, G, qs, ks, vs,
        kLog2e / sqrtf((float)HD));
  } else if (dtype == 0) {
    const size_t smem = sizeof(float) * (2 * BK * (HD + 4 + HDV + 4) +
                                         G * (HD + BK + HDV + 3));
    auto kern = decode_split_fma<HD, HDV>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nsplit, KV, B), NT, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, ws, positions,
        kv_len, S, G, qs, ks, vs, 1.0f / sqrtf((float)HD));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    decode_merge<__nv_bfloat16, HDV><<<dim3(G, KV, B), HDV, 0, stream>>>(
        ws, (__nv_bfloat16*)out, nsplit, os);
  else
    decode_merge<float, HDV><<<dim3(G, KV, B), HDV, 0, stream>>>(
        ws, (float*)out, nsplit, os);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA-core pass 1), 1 bfloat16 (tensor-core pass 1).
// q (B,1,H,hd), k (B,S,KV,hd), v (B,S,KV,hdv), out (B,1,H,hdv): the
// last dim contiguous, other element strides in `strides` as
// {q b,s,h, k b,s,h, v b,s,h, out b,s,h}; every row start 16-byte
// aligned. positions, kv_len: (B,) int32. ws: float32 workspace of
// B * KV * nsplit * G * (hdv + 2) values, nsplit >= 1. (hd, hdv) in
// {(32,32), (64,64), (128,128)}; the wrapper checks all of it and raises
// before calling.
extern "C" int decode_attention_launch(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, void* ws,
                                       const int* positions,
                                       const int* kv_len, int B, int S,
                                       int H, int KV, int hd, int hdv,
                                       int nsplit, const long long* strides,
                                       void* stream) {
  if (B == 0 || H == 0) return 0;
  if (nsplit < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (hd == 64 && hdv == 64)
    return launch<64, 64>(dtype, q, k, v, out, w, positions, kv_len, B, S,
                          KV, G, nsplit, strides, s);
  if (hd == 128 && hdv == 128)
    return launch<128, 128>(dtype, q, k, v, out, w, positions, kv_len, B, S,
                            KV, G, nsplit, strides, s);
  if (hd == 32 && hdv == 32)
    return launch<32, 32>(dtype, q, k, v, out, w, positions, kv_len, B, S,
                          KV, G, nsplit, strides, s);
  return (int)cudaErrorInvalidValue;
}
