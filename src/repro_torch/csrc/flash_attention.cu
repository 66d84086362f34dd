// Blocked flash attention, forward: causal or not, GQA, per-sequence
// query offset and valid KV length, any query and key length.
//
// Replaces the TPU kernel flash_attention_fwd (_fa_kernel) in
// src/repro/kernels/flash_attention/kernel.py: the same function — mask
// k < kv_valid_len and, when causal, k <= q_offset + i; query head h
// reads KV head h / G; scores scaled by 1/sqrt(hd), or by the scale the
// caller gives (MLA under YaRN); online softmax in
// float32 starting from m = NEG_INF = -1e30; output acc / max(l, 1e-30)
// cast to the input dtype. Inputs are bf16 or float32, read in the
// reference's public layout (B, S, heads, hd) through their strides (no
// transposed copies); the output is a new contiguous (B, Sq, H, hdv).
//
// What bounds it on an H100: operations. A prefill of L tokens does
// ~2 L^2 (hd + hdv) / 2 flops per head for L (hd + hdv) bytes of K/V per
// KV head — hundreds of flops per byte, well above the card's ~295
// flops/byte ridge. The roof is the tensor cores (989 TFLOP/s bf16).
//
// Two kernels, chosen by dtype in the C entry (not a fallback: each
// dtype has exactly one).
//
// bf16 (flash_fwd_mma): FlashAttention-2's shape on the tensor cores.
// Each warp owns 16 query rows (4 warps, 64 rows per block); its Q
// fragments are read once with ldmatrix and stay in registers for the
// whole key loop. Both products are mma.sync m16n8k16 bf16 with float32
// accumulation: QK^T with K as the column operand (ldmatrix), PV with V
// through ldmatrix.trans. The score accumulator is masked, scaled into
// the exp2 domain, exponentiated in place (row max and row sum over the
// quad's 4 lanes with shuffles), rounded to bf16 and used directly as
// the A operand of PV: P never goes through shared memory. K and V
// tiles of 64 keys arrive by cp.async (16-byte copies, zero-filled past
// Skv) into a two-stage ring kept in bf16, rows padded by 16 bytes so
// ldmatrix's eight row reads hit distinct banks; tile t + 1 is in flight
// while tile t is multiplied. The one numerical change against the FMA
// kernel: the unnormalised p <= 1 is rounded to bf16 before PV (the
// plain version rounds the normalised weights to bf16, the same ~2^-8
// relative rounding); l sums the float32 p.
//
// float32 (flash_fwd_fma): float32 FMAs on the CUDA cores (67 TFLOP/s)
// from float32 tiles in shared memory, exact to float32 rounding, which
// the float32 replays' 2e-5 tolerance needs (the tensor cores' TF32
// keeps ~3 digits). Each thread keeps a 4 x 4 block of scores and a
// 4 x hdv/16 block of the output in registers.
//
// Shared by both: key tiles the mask leaves empty are never visited:
// the loop stops at min(Skv, kv_valid_len, last causal position + 1),
// which in serving's prefill (Skv = the cache's max_len, kv_valid_len =
// the prompt) skips the unwritten cache and the upper triangle, and the
// bf16 kernel masks only the tiles that cross the diagonal,
// kv_valid_len or Skv. Skipping is exact: once a row has seen one valid
// key, a fully masked tile leaves m, l and acc unchanged (alpha = 1,
// p = exp(-1e30 - m) = 0). Key 0 is valid for every row once
// kv_valid_len >= 1 and q_offset >= 0; a block with a row that has no
// valid key walks every tile, so it gets the reference's uniform
// average too. Keys past Skv do not exist: their score is -inf, so
// p = 0 exactly. One block per (q-tile of 64 rows, head, sequence); the
// bf16 kernel takes the q-tiles last to first, so that under causal
// masking the longest tiles start first. TMA, wgmma and a persistent
// schedule are later work.
//
// Head dims: (32, 32), (64, 64), (128, 128), and (192, 128), the prefill
// of DeepSeek-V2's multi-head latent attention (q and k: 128 "nope" + 64
// rotary columns a head, v 128). At (192, 128) the bf16 kernel keeps 12
// Q fragments and 16 output n-tiles a warp in registers (ptxas: 225
// registers, no spill) and its shared ring takes 2 x (64 x 200 + 2 x 64
// x 200 + 2 x 64 x 136) = 111,616 bytes; the float32 kernel 4 x (192 x 64
// + 64 x 193 + 64 x 128 + 64 x 68) = 148,736 bytes (127 registers, no
// spill). Both sit under Hopper's 227 KB opt-in, set per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile

struct Strides {                // element strides of dims 0-2; dim 3 is 1
  long long b, s, h;
};

// The last key tile's end for the q-tile [q0, q0 + BQ): every tile past
// it is fully masked for every row, unless a row has no valid key, when
// all Skv keys are walked (the reference's uniform average).
__device__ __forceinline__ int key_end(int q0, int Sq, int Skv, int qoff,
                                       int kvl, int causal) {
  const int qlast = min(q0 + BQ, Sq) - 1;
  int kend = min(Skv, kvl);
  if (causal) kend = min(kend, qoff + qlast + 1);
  if (kend <= 0 || (causal && qoff + q0 < 0)) kend = Skv;
  return kend;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int NW = BQ / 16;     // warps, 16 query rows each
constexpr int NT_MMA = 32 * NW;
constexpr int PAD = 8;          // bf16 elements (16 bytes) of row padding
constexpr float kLog2e = 1.4426950408889634f;

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

// rows [r0, r0 + BQ or BK) of a (S, D) slice into a (rows, D + PAD) bf16
// tile by cp.async; rows at or past `limit` are zero
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int limit) {
  constexpr int CH = D / 8;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT_MMA) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (D + PAD) + c,
               ok ? src + (long long)(r0 + r) * stride + c : src, ok);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(NT_MMA)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out,
              const int* __restrict__ q_offset,
              const int* __restrict__ kv_len, int Sq, int Skv, int G,
              Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale_log2) {
  constexpr int QP = HD + PAD, KP = HD + PAD, VP = HDV + PAD;
  constexpr int NS = BK / 8;            // score n-tiles of 8 keys
  constexpr int NO = HDV / 8;           // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * QP;     // 2 stages of BK x KP
  __nv_bfloat16* sV = sK + 2 * BK * KP; // 2 stages of BK x VP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row, column pair
  const int qoff = q_offset[b], kvl = kv_len[b];
  const int kend = key_end(q0, Sq, Skv, qoff, kvl, causal);
  const int nk = (kend + BK - 1) / BK;
  const int kv_lim = min(Skv, kvl);     // keys past it are masked

  const __nv_bfloat16* kb = k + b * ks.b + (h / G) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / G) * vs.h;
  load_tile_async<HD, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile_async<HD, BK>(sK, kb, ks.s, 0, Skv);
  load_tile_async<HDV, BK>(sV, vb, vs.s, 0, Skv);
  cp_async_commit();

  uint32_t qf[HD / 16][4];              // this warp's 16 rows of Q
  float o[NO][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g, g + 8
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK, st = t & 1;
    if (t + 1 < nk) {                   // tile t + 1 flies while t is used
      load_tile_async<HD, BK>(sK + (st ^ 1) * BK * KP, kb, ks.s, k0 + BK,
                              Skv);
      load_tile_async<HDV, BK>(sV + (st ^ 1) * BK * VP, vb, vs.s, k0 + BK,
                               Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * QP + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* tK = sK + st * BK * KP;
    const __nv_bfloat16* tV = sV + st * BK * VP;

    // S = Q K^T: s[j] holds rows g, g + 8 x keys k0 + 8 j + 2 t4 + {0, 1}
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale into the exp2 domain; mask only tiles that cross the
    // diagonal (for the block's first row), kv_valid_len or Skv
    const bool masked = k0 + BK > kv_lim || (causal && k0 + BK - 1 >
                                             qoff + q0);
    const int r0 = qoff + q0 + warp * 16 + g;   // absolute position, row g
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int kk = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = r0 + (e >> 1) * 8;
          const bool ok = kk < kvl && (!causal || kk <= qpos);
          x = kk >= Skv ? -INFINITY : (ok ? x : kNegInf);
        }
        s[j][e] = x;
      }

    // online softmax per row half: the row's keys sit on the quad's lanes
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = exp2f(m[hh] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
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

    // O += P V, P from the score registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * VP
                                 + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // stage st is refilled next
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = q0 + warp * 16 + g + 8 * hh;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    __nv_bfloat16* orow = out + b * os.b + qi * os.s + h * os.h + 2 * t4;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
  }
}

template <int HD, int HDV>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* q_offset, const int* kv_len, int B, int Sq,
               int Skv, int H, int G, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      (BQ * (HD + PAD) + 2 * BK * (HD + PAD) +
                       2 * BK * (HDV + PAD));
  auto kern = flash_fwd_mma<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT_MMA, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, q_offset, kv_len, Sq,
      Skv, G, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      scale > 0.f ? kLog2e * scale : kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int NT_FMA = 256;     // threads: 16 (tx, key/out columns) x 16 (ty)
constexpr int PP = BQ + 4;      // row pitch of the transposed P tile

// Rows [r0, r0 + rows) of a (S, D) slice at `src` (row stride `stride`)
// into shared memory: element (r, d) goes to dst[r * rs + d * ds]. Rows
// at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int rs, int ds,
                                          const float* src, long long stride,
                                          int r0, int rows, int limit) {
  constexpr int CH = D / 4;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += NT_FMA) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) *
                                                     stride + c);
    dst[r * rs + c * ds] = x.x;
    dst[r * rs + (c + 1) * ds] = x.y;
    dst[r * rs + (c + 2) * ds] = x.z;
    dst[r * rs + (c + 3) * ds] = x.w;
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(NT_FMA)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              const int* __restrict__ q_offset,
              const int* __restrict__ kv_len, int Sq, int Skv, int G,
              Strides qs, Strides ks, Strides vs, Strides os, int causal,
              float scale) {
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

  load_tile<HD>(sQt, 1, BQ, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq);

  const int nk = (key_end(q0, Sq, Skv, qoff, kvl, causal) + BK - 1) / BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const float* kb = k + b * ks.b + (h / G) * ks.h;
  const float* vb = v + b * vs.b + (h / G) * vs.h;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // last tile's K, V, P reads done
    load_tile<HD>(sK, KP, 1, kb, ks.s, k0, BK, Skv);
    load_tile<HDV>(sV, HDV, 1, vb, vs.s, k0, BK, Skv);
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
    float* o = out + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[i][c] / lm;
  }
}

template <int HD, int HDV>
int launch_fma(const void* q, const void* k, const void* v, void* out,
               const int* q_offset, const int* kv_len, int B, int Sq,
               int Skv, int H, int G, const long long* st, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (HD * BQ + BK * (HD + 1) + BK * HDV + BK * PP);
  auto kern = flash_fwd_fma<HD, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT_FMA, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      q_offset, kv_len, Sq, Skv, G, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, causal,
      scale > 0.f ? scale : 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, const int* qo, const int* kl, int B, int Sq, int Skv,
           int H, int G, const long long* st, int causal, float scale,
           cudaStream_t s) {
  if (dtype == 0)
    return launch_fma<HD, HDV>(q, k, v, out, qo, kl, B, Sq, Skv, H, G, st,
                               causal, scale, s);
  if (dtype == 1)
    return launch_mma<HD, HDV>(q, k, v, out, qo, kl, B, Sq, Skv, H, G, st,
                               causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (tensor-core kernel).
// q (B,Sq,H,hd), k (B,Skv,KV,hd), v (B,Skv,KV,hdv), out (B,Sq,H,hdv):
// the last dim contiguous, other element strides in `strides` as
// {q b,s,h, k b,s,h, v b,s,h, out b,s,h}; every row start 16-byte
// aligned. q_offset, kv_len: (B,) int32. (hd, hdv) in {(32,32),
// (64,64), (128,128), (192,128)}; the wrapper checks all of it and
// raises before calling. scale: the scores' scale, or 0 for 1/sqrt(hd)
// (computed here, as before the argument existed).
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, const int* q_offset,
                                      const int* kv_len, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int hdv, const long long* strides,
                                      int causal, float scale,
                                      void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const int G = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64 && hdv == 64)
    return launch<64, 64>(dtype, q, k, v, out, q_offset, kv_len, B, Sq, Skv,
                          H, G, strides, causal, scale, s);
  if (hd == 128 && hdv == 128)
    return launch<128, 128>(dtype, q, k, v, out, q_offset, kv_len, B, Sq,
                            Skv, H, G, strides, causal, scale, s);
  if (hd == 32 && hdv == 32)
    return launch<32, 32>(dtype, q, k, v, out, q_offset, kv_len, B, Sq, Skv,
                          H, G, strides, causal, scale, s);
  if (hd == 192 && hdv == 128)
    return launch<192, 128>(dtype, q, k, v, out, q_offset, kv_len, B, Sq,
                            Skv, H, G, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
