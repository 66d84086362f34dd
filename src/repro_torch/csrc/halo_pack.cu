// Merged halo pack / unpack for the Faces 26-neighbour exchange (paper §5.4).
//
// Replaces the TPU kernels halo_pack_fwd (_pack_kernel) and
// halo_unpack_fwd (_unpack_kernel) in src/repro/kernels/halo_pack/kernel.py.
// Those run one rank's (nx,ny,nz) block as a single VMEM block; here one
// launch covers all R ranks, which the port keeps on one card.
//
// Surface d of a block is the slab/pencil/cell facing neighbour d; the 26
// surfaces come in DIRECTIONS order (dx, dy, dz each over -1, 0, 1, the
// centre skipped). Surface k lives at ptr[k] + r * stride[k] for rank r:
// 26 separate (R, s_k) buffers (stride s_k) or one flat (R, total) buffer
// (26 pointers into it, stride total) take the same kernel.
//
// What bounds them on an H100: memory, once the index work per thread is
// small. Pack reads and writes the R * total surface elements (6.49 MB each
// way for R = 64, n = 64^3); unpack writes the whole (R, nx, ny, nz)
// accumulator (64 MiB at that size) and reads the surfaces. A warp runs as
// long as its slowest lane, so no thread scans all 26 directions (measured:
// such a scan kept an earlier unpack at 11x its bound). The design:
//   * pack: one thread per surface element, one block row per rank; it
//     finds its surface by a 5-step binary search over the prefix offsets
//     and its source cell with two divisions; the stores are coalesced. A
//     pure copy: bit-identical to the reference. The z-faces read one
//     float per 32-byte sector.
//   * unpack: one launch that writes every cell of the accumulator exactly
//     once, in full 16-byte stores along z. The accumulator is ~95% interior
//     zeros at n = 64^3 and does not stay in the 50 MB L2, so a zero fill
//     followed by a pass over the boundary cells (the earlier two-launch
//     design) sent the z-plane sectors to memory twice; here each sector is
//     stored once. The rank's (x, y) rows of nz cells split in two sets:
//     in an interior row (x and y interior) only z = 0 and z = nz - 1 are
//     boundary cells, each in one z-face (0.0f + that element), the rest
//     0.0f: a handful of instructions a vector, pure streaming. In a
//     boundary row (x or y on the boundary, 6% of the rows at n = 64^3)
//     each cell is 0.0f plus, in DIRECTIONS order, the element of each of
//     the <= 2x2x2 surfaces that contain it, with the (dx, dy, dz) loops
//     unrolled so that the loads do not wait on one another. No atomics,
//     the reference's scatter-add order: bit-identical. The boundary rows
//     take blocks of their own, dispatched before the interior ones, so
//     their loads overlap the stream of interior stores instead of holding
//     up every block that has a boundary row (measured: a block per
//     (rank, x) plane with both kinds of rows in it stayed at about twice
//     the bound, while the same blocks storing zeros alone reached it).
//     Row and unit indices are a multiply-high and a shift, not a
//     division. When nz % 4 != 0 the rows do not start on 16-byte
//     boundaries and every cell takes a store of its own.
//   * unpack with the per-rank max|acc| (Faces' merged unpack+compare, paper
//     §5.4): the same pass reduces the stored values' |bits| per warp and
//     per block and lands one atomicMax per block on the rank's slot (as
//     unsigned bits, exact for values >= 0; a NaN's bits exceed +inf's, so
//     a NaN wins, as in torch.linalg.vector_norm(ord=inf)). The
//     accumulator is not read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNdir = 26;
constexpr int kThreads = 256;

struct Surfaces {
  float* ptr[kNdir];
  long long stride[kNdir];  // rank stride of surface k, in elements
  int off[kNdir + 1];       // prefix offsets of the surface sizes
};

// Direction k of DIRECTIONS as (dx, dy, dz) in {-1, 0, 1}^3.
__host__ __device__ constexpr int dir_x(int k) { return (k < 13 ? k : k + 1) / 9 - 1; }
__host__ __device__ constexpr int dir_y(int k) { return ((k < 13 ? k : k + 1) / 3) % 3 - 1; }
__host__ __device__ constexpr int dir_z(int k) { return (k < 13 ? k : k + 1) % 3 - 1; }

__host__ __device__ inline int extent(int d, int n) { return d ? 1 : n; }
__host__ __device__ inline int coord(int d, int n, int e) {
  return d < 0 ? 0 : (d > 0 ? n - 1 : e);
}

// DIRECTIONS index of (dx, dy, dz).
__device__ inline int dir_index(int dx, int dy, int dz) {
  const int m = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
  return m < 13 ? m : m - 1;
}

// grid: (ceil(total / kThreads), R); one thread per element of one rank's
// flat surface space, which finds its surface by binary search over the
// 27 prefix offsets.
__global__ void pack_kernel(const float* __restrict__ src, int nx, int ny,
                            int nz, const __grid_constant__ Surfaces s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s.off[kNdir]) return;
  const long long r = blockIdx.y;
  int k = 0, hi = kNdir;                 // s.off[k] <= j < s.off[hi]
  while (hi - k > 1) {
    const int mid = (k + hi) >> 1;
    if (s.off[mid] <= j) k = mid; else hi = mid;
  }
  const int dx = dir_x(k), dy = dir_y(k), dz = dir_z(k);
  const int e = j - s.off[k];
  const int sy = extent(dy, ny), sz = extent(dz, nz);
  const int x = coord(dx, nx, e / (sy * sz));
  const int y = coord(dy, ny, (e / sz) % sy);
  const int z = coord(dz, nz, e % sz);
  s.ptr[k][r * s.stride[k] + e] =
      src[((r * nx + x) * ny + y) * (long long)nz + z];
}

// Division by a divisor fixed for the launch, as a multiply-high and a
// shift (exact for dividends below 2^31; the round-up method of
// Granlund and Montgomery, with a 31 + ceil(log2 d) bit shift).
struct FastDiv {
  unsigned mul;
  int shift;  // < 0: the divisor is 1
};

FastDiv make_fastdiv(int d) {
  if (d == 1) return FastDiv{0u, -1};
  int l = 0;
  while ((1LL << l) < d) ++l;
  const int p = 31 + l;
  return FastDiv{(unsigned)(((1ULL << p) + d - 1) / (unsigned long long)d),
                 p - 32};
}

__device__ __forceinline__ int fast_div(FastDiv f, int n) {
  return f.shift < 0 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

__host__ __device__ inline int ends(int n) { return n == 1 ? 1 : 2; }
__host__ __device__ inline int inner(int n) { return n > 2 ? n - 2 : 0; }

// A rank's block as rows: its nx * ny (x, y) rows of nz cells, cut into
// units of W consecutive cells (W = 4 when nz % 4 == 0: one 16-byte
// vector; else 1). Boundary rows (x or y on the boundary) are the ends(nx)
// x-planes' ny rows, then the inner(nx) planes' ends(ny) y-rows; interior
// rows are the rest. Each rank has gb blocks of boundary units and gi
// blocks of interior units.
struct Rows {
  int nx, ny, nz;
  int nb, ni;         // boundary and interior rows of a rank
  int upr;            // units per row
  FastDiv fu, fy;     // division by upr and by inner(ny)
  int gb, gi;
};

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// The W cells (x, y, z0 + i) of a boundary row: each 0.0f plus, in
// DIRECTIONS order (dx, then dy, then dz ascending), the element of each
// surface that contains it. The (dx, dy, dz) loops are unrolled, so every
// surface's address is known and the loads do not wait on one another.
template <int W>
__device__ __forceinline__ void boundary_cells(const Surfaces& s, long long r,
                                               const Rows& h, int x, int y,
                                               int z0, float (&a)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    if (dx < 0 ? x != 0 : (dx > 0 && x != h.nx - 1)) continue;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      if (dy < 0 ? y != 0 : (dy > 0 && y != h.ny - 1)) continue;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        if (dx == 0 && dy == 0 && dz == 0) continue;   // no surface
        const int k = dir_index(dx, dy, dz);
        const int sy = extent(dy, h.ny), sz = extent(dz, h.nz);
        const float* p = s.ptr[k] + r * s.stride[k] +
                         (long long)((dx ? 0 : x) * sy + (dy ? 0 : y)) * sz;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int z = z0 + i;
          if (dz < 0 ? z == 0 : (dz > 0 ? z == h.nz - 1 : true))
            a[i] += p[dz ? 0 : z];
        }
      }
    }
  }
}

// DIRECTIONS indices of the z-faces (0, 0, -1) and (0, 0, 1).
constexpr int kZlo = 12, kZhi = 13;

// Units of an interior block per thread: their z-face loads are all
// issued before the first store, so a warp waits for one load latency per
// 4 x 512 bytes it stores, not per 512.
constexpr int kInteriorUnits = 4;

template <int W>
__device__ __forceinline__ void store_unit(float* out, const float (&a)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
  else
    out[0] = a[0];
}

// grid: R * (gb + gi) blocks, the boundary blocks of all R ranks first, so
// that their longer work runs beside the interior blocks' stores. A boundary
// thread writes one unit; an interior thread kInteriorUnits units, a block
// apart. In an interior row only z = 0 and z = nz - 1 are boundary cells,
// each in one z-face (0.0f + that element); the rest are 0.0f. rmax
// (kMax): the rank's max |cell| as float bits, zero on entry.
template <int W, bool kMax>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(float* __restrict__ acc, const Rows h,
              const __grid_constant__ Surfaces s,
              unsigned* __restrict__ rmax) {
  const int R = gridDim.x / (h.gb + h.gi);
  int bid = blockIdx.x;
  const bool boundary = bid < R * h.gb;
  long long r;
  if (boundary) {
    r = bid / h.gb;
    bid -= (int)r * h.gb;
  } else {
    bid -= R * h.gb;
    r = bid / h.gi;
    bid -= (int)r * h.gi;
  }
  float* const rank = acc + r * h.nx * h.ny * (long long)h.nz;
  unsigned m = 0;
  if (boundary) {
    const int u = bid * blockDim.x + threadIdx.x;
    if (u < h.nb * h.upr) {
      const int row = fast_div(h.fu, u);
      const int z0 = (u - row * h.upr) * W;
      const int ex = ends(h.nx) * h.ny;        // rows of the x-end planes
      int x, y;
      if (row < ex) {
        x = row < h.ny ? 0 : h.nx - 1;
        y = row < h.ny ? row : row - h.ny;
      } else {
        const int b = row - ex, e = ends(h.ny);
        x = 1 + b / e;
        y = b % e ? h.ny - 1 : 0;
      }
      float a[W];
      boundary_cells<W>(s, r, h, x, y, z0, a);
      store_unit<W>(rank + (x * h.ny + y) * (long long)h.nz + z0, a);
      if (kMax) {
#pragma unroll
        for (int i = 0; i < W; ++i) m = max(m, abs_bits(a[i]));
      }
    }
  } else {
    const float* zlo = s.ptr[kZlo] + r * s.stride[kZlo];
    const float* zhi = s.ptr[kZhi] + r * s.stride[kZhi];
    const int units = h.ni * h.upr;
    long long at[kInteriorUnits];      // the unit's first cell in the rank
    int z0[kInteriorUnits];
    float lo[kInteriorUnits], hi[kInteriorUnits];
#pragma unroll
    for (int k = 0; k < kInteriorUnits; ++k) {
      const int u = (bid * kInteriorUnits + k) * blockDim.x + threadIdx.x;
      const int row = fast_div(h.fu, u);
      const int xi = fast_div(h.fy, row);
      const int x = 1 + xi, y = 1 + row - xi * inner(h.ny);
      z0[k] = u < units ? (u - row * h.upr) * W : -1;   // -1: no unit
      at[k] = (x * h.ny + y) * (long long)h.nz + z0[k];
      lo[k] = z0[k] == 0 ? zlo[x * h.ny + y] : 0.0f;
      hi[k] = z0[k] >= 0 && z0[k] + W == h.nz ? zhi[x * h.ny + y] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kInteriorUnits; ++k) {
      if (z0[k] < 0) continue;
      float a[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int z = z0[k] + i;
        float v = 0.0f;
        if (z == 0) v = v + lo[k];
        if (z == h.nz - 1) v = v + hi[k];
        a[i] = v;
        if (kMax) m = max(m, abs_bits(v));
      }
      store_unit<W>(rank + at[k], a);
    }
  }
  if (kMax) {
    __shared__ unsigned wmax[kThreads / 32];
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < blockDim.x / 32 ? wmax[threadIdx.x] : 0u;
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x == 0 && m != 0) atomicMax(rmax + r, m);
    }
  }
}

Surfaces make_surfaces(int nx, int ny, int nz, const uint64_t* ptrs,
                       const int64_t* strides) {
  Surfaces s;
  int off = 0;
  for (int k = 0; k < kNdir; ++k) {
    s.ptr[k] = reinterpret_cast<float*>(ptrs[k]);
    s.stride[k] = strides[k];
    s.off[k] = off;
    off += extent(dir_x(k), nx) * extent(dir_y(k), ny) * extent(dir_z(k), nz);
  }
  s.off[kNdir] = off;
  return s;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// gridDim.y carries the rank (at most 65535); in-rank indices are 32-bit.
bool shape_ok(int R, int nx, int ny, int nz) {
  return R > 0 && R <= 65535 && nx > 0 && ny > 0 && nz > 0 &&
         (long long)nx * ny * nz < (1LL << 31);
}

}  // namespace

// src: contiguous (R, nx, ny, nz) float32; ptrs/strides: host arrays of 26
// surface base pointers (device addresses) and rank strides.
extern "C" int halo_pack_launch(const float* src, int R, int nx, int ny,
                                int nz, const uint64_t* ptrs,
                                const int64_t* strides, void* stream) {
  if (R == 0) return 0;
  if (!shape_ok(R, nx, ny, nz)) return (int)cudaErrorInvalidValue;
  Surfaces s = make_surfaces(nx, ny, nz, ptrs, strides);
  const dim3 grid(cdiv(s.off[kNdir], kThreads), R);
  pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, nx, ny, nz,
                                                           s);
  return (int)cudaGetLastError();
}

// acc: contiguous (R, nx, ny, nz) float32 output, every cell written once;
// rmax: NULL, or R float32 slots (zero on entry) that receive each rank's
// max |acc|.
extern "C" int halo_unpack_launch(float* acc, int R, int nx, int ny, int nz,
                                  const uint64_t* ptrs,
                                  const int64_t* strides, float* rmax,
                                  void* stream) {
  if (R == 0) return 0;
  if (!shape_ok(R, nx, ny, nz)) return (int)cudaErrorInvalidValue;
  Surfaces s = make_surfaces(nx, ny, nz, ptrs, strides);
  const int W = nz % 4 == 0 ? 4 : 1;
  Rows h;
  h.nx = nx; h.ny = ny; h.nz = nz;
  h.nb = ends(nx) * ny + inner(nx) * ends(ny);
  h.ni = inner(nx) * inner(ny);
  h.upr = nz / W;
  h.fu = make_fastdiv(h.upr);
  h.fy = make_fastdiv(inner(ny) > 0 ? inner(ny) : 1);
  h.gb = cdiv(h.nb * h.upr, kThreads);
  h.gi = cdiv(h.ni * h.upr, kThreads * kInteriorUnits);
  if ((long long)R * (h.gb + h.gi) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(R * (h.gb + h.gi));
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned* m = reinterpret_cast<unsigned*>(rmax);
  if (W == 4 && m != nullptr)
    unpack_kernel<4, true><<<grid, kThreads, 0, st>>>(acc, h, s, m);
  else if (W == 4)
    unpack_kernel<4, false><<<grid, kThreads, 0, st>>>(acc, h, s, m);
  else if (m != nullptr)
    unpack_kernel<1, true><<<grid, kThreads, 0, st>>>(acc, h, s, m);
  else
    unpack_kernel<1, false><<<grid, kThreads, 0, st>>>(acc, h, s, m);
  return (int)cudaGetLastError();
}
