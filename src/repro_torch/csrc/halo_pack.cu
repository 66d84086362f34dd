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
// such a scan kept the unpack at 11x its bound). The design:
//   * pack: one thread per surface element, one block row per rank; it
//     finds its surface by a 5-step binary search over the prefix offsets
//     and its source cell with two divisions; the stores are coalesced. A
//     pure copy: bit-identical to the reference. The z-faces read one
//     float per 32-byte sector.
//   * unpack: gather form, in two launches on the caller's stream. The
//     accumulator is ~95% interior zeros, so a zero fill in 16-byte stores
//     writes it at the store rate first (one thread per cell in one pass
//     stored at 0.26-0.86 TB/s in the five layouts measured). Then one
//     thread per boundary
//     cell — each counted once — starts from 0.0f and adds, in DIRECTIONS
//     order, the element of each of the <= 2x2x2 surfaces that contain it:
//     no atomics, the reference's scatter-add order, bit-identical.

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

// Unpack, step 1: zero the whole accumulator, n floats, in 16-byte stores
// (torch.empty's allocations are 512-byte aligned).
__global__ void zero_kernel(float* __restrict__ out, long long n) {
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long n4 = n / 4;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += step)
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) out[n4 * 4 + threadIdx.x] = 0.0f;
}

// The boundary cells of a block, each counted once: the x-planes (x = 0,
// nx - 1), then the y-planes of the x-interior, then the z-planes of the
// x- and y-interior.
struct Shell {
  int nx, ny, nz;
  int cx, cy, cz;  // cells in each part
};

__host__ __device__ inline int ends(int n) { return n == 1 ? 1 : 2; }
__host__ __device__ inline int inner(int n) { return n > 2 ? n - 2 : 0; }

Shell make_shell(int nx, int ny, int nz) {
  Shell h{nx, ny, nz, 0, 0, 0};
  h.cx = ends(nx) * ny * nz;
  h.cy = inner(nx) * ends(ny) * nz;
  h.cz = inner(nx) * inner(ny) * ends(nz);
  return h;
}

// Unpack, step 2. grid: (ceil(boundary cells / kThreads), R); one thread
// per boundary cell, which starts from 0.0f and adds, in DIRECTIONS order,
// the element of each of the <= 2x2x2 surfaces that contain it.
__global__ void shell_kernel(float* __restrict__ acc, Shell h,
                             const __grid_constant__ Surfaces s) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = blockIdx.y;
  const int nx = h.nx, ny = h.ny, nz = h.nz;
  int x, y, z;
  if (b < h.cx) {
    z = b % nz;
    b /= nz;
    y = b % ny;
    x = (b / ny) ? nx - 1 : 0;
  } else if ((b -= h.cx) < h.cy) {
    z = b % nz;
    b /= nz;
    y = (b % ends(ny)) ? ny - 1 : 0;
    x = 1 + b / ends(ny);
  } else if ((b -= h.cy) < h.cz) {
    z = (b % ends(nz)) ? nz - 1 : 0;
    b /= ends(nz);
    y = 1 + b % inner(ny);
    x = 1 + b / inner(ny);
  } else {
    return;
  }
  float a = 0.0f;
  for (int dx = x == 0 ? -1 : 0; dx <= (x == nx - 1 ? 1 : 0); ++dx) {
    for (int dy = y == 0 ? -1 : 0; dy <= (y == ny - 1 ? 1 : 0); ++dy) {
      for (int dz = z == 0 ? -1 : 0; dz <= (z == nz - 1 ? 1 : 0); ++dz) {
        if (dx == 0 && dy == 0 && dz == 0) continue;   // no surface
        const int k = dir_index(dx, dy, dz);
        const int sy = extent(dy, ny), sz = extent(dz, nz);
        const int e = ((dx ? 0 : x) * sy + (dy ? 0 : y)) * sz + (dz ? 0 : z);
        a += s.ptr[k][r * s.stride[k] + e];
      }
    }
  }
  acc[((r * nx + x) * ny + y) * (long long)nz + z] = a;
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

// acc: contiguous (R, nx, ny, nz) float32 output, every cell written: the
// zero fill, then (same stream, so in order) the boundary cells.
extern "C" int halo_unpack_launch(float* acc, int R, int nx, int ny, int nz,
                                  const uint64_t* ptrs,
                                  const int64_t* strides, void* stream) {
  if (R == 0) return 0;
  if (!shape_ok(R, nx, ny, nz)) return (int)cudaErrorInvalidValue;
  Surfaces s = make_surfaces(nx, ny, nz, ptrs, strides);
  const long long cells = (long long)R * nx * ny * nz;
  long long fill_blocks = (cells / 4 + kThreads - 1) / kThreads;
  fill_blocks = fill_blocks < 1 ? 1 : (fill_blocks > 4096 ? 4096 : fill_blocks);
  zero_kernel<<<(unsigned)fill_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      acc, cells);
  const cudaError_t fill_err = cudaGetLastError();
  if (fill_err != cudaSuccess) return (int)fill_err;
  const Shell h = make_shell(nx, ny, nz);
  shell_kernel<<<dim3(cdiv(h.cx + h.cy + h.cz, kThreads), R), kThreads, 0,
                 (cudaStream_t)stream>>>(acc, h, s);
  return (int)cudaGetLastError();
}
