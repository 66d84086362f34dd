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
// small. Pack reads the boundary shell of every rank's block and writes the
// R * total surface elements (6.49 MB for R = 64, n = 64^3, float32);
// unpack writes the whole (R, nx, ny, nz) accumulator (64 MiB at that size)
// and reads the surfaces. A warp runs as long as its slowest lane, so no
// thread scans all 26 directions (measured: such a scan kept an earlier
// unpack at 11x its bound). The designs:
//   * pack: the card reads device memory in 32-byte sectors at the least.
//     The dz != 0 surfaces (the z-faces, 8 edges, 8 corners) need only the
//     two end cells, z = 0 and z = nz - 1, of each (x, y) row; at nz = 64
//     a row is 256 bytes, so each end cell costs a sector of its own (19.9
//     MB of distinct sectors at R = 64, n = 64^3, against 6.1 MB of useful
//     bytes). Nothing coalesces below a sector, and such scattered reads
//     are bound by their count, not their bytes: on an H100 SXM (700 W) a
//     cold 67 MB field read one float per 256-byte row takes 0.0090 ms,
//     8 or 16 floats per row 0.0094 and 0.0102, both end floats 0.0158
//     (one-off readings of a probe kernel, one thread a row, that this
//     file carried when the pack was redesigned; its source is in this
//     file's git history). Staging whole rows to coalesce the end cells
//     would stream all 67 MB, more than the end reads cost. So the end
//     reads are issued as densely as they can be. One launch, blocks of
//     two roles:
//       - copy blocks, dispatched first: the dz = 0 surfaces are runs that
//         are contiguous in src and in the surface (the two x-planes, one
//         ny * nz run each; the y = 0 and y = ny - 1 rows of every
//         x-plane and the four x-y edges, runs of nz), streamed in 16-byte
//         stores aligned on the destination, loaded 16 bytes at a time
//         where the source's alignment matches and narrower where it does
//         not, the ragged ends of a run 2 bytes at a time (1 byte for
//         1-byte elements);
//       - end-sector blocks: one thread a row loads both end cells, then
//         writes the z-faces (index x * ny + y: a warp's stores are
//         coalesced) and, where x or y is on the boundary, the dz != 0
//         edges and corners that contain them. One row a thread was
//         faster than 2, 4 or 8 (more threads, fewer loads each); a lo
//         pass apart from a hi pass, and walking the ranks from the last,
//         were no faster. The loads carry the evict-first hint
//         (ld.global.cs): in Faces the increment has just written the
//         field, and with L1-allocating loads (ld.global.nc) the pack
//         there took 0.021 ms against 0.016; cold, .cs is ~6 % slower.
//     A block's role and rank come from blockIdx ranges, its runs and rows
//     from a multiply-high: no search, division or modulo per element.
//     Elements of 1, 2, 4 or 8 bytes are copied as bytes, so any dtype of
//     those sizes packs (a 16-byte vector holds 16 one-byte cells); a pure
//     copy, bit for bit the plain pack.
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
//     division. A vector holds W = 16 / element size cells (4 in float32);
//     when nz % W != 0 the rows do not start on 16-byte boundaries and
//     every cell takes a store of its own.
//     The accumulator takes the surfaces' dtype, as halo_unpack_fwd's
//     does: float32, float64, bfloat16, float16, int32, int64, uint8, int8
//     or int16. Each add is rounded to that type, in DIRECTIONS order, as
//     the plain version's `acc[...] += buf`: a 2-byte float's sum of two
//     values is formed in float32, where it is exact, and rounded once to
//     nearest even (what PyTorch's add does); integers of every width wrap,
//     as PyTorch's do. So every dtype is bit for bit
//     the plain unpack. Nothing else depends on the type.
//   * unpack with the per-rank max|acc| (Faces' merged unpack+compare, paper
//     §5.4): the same pass reduces the stored values' |bits| per warp and
//     per block and lands one atomic max per block on the rank's slot (as
//     unsigned bits, exact for values >= 0; a NaN's bits exceed +inf's, so
//     a NaN wins, as in torch.linalg.vector_norm(ord=inf)), in the
//     accumulator's floating type: atomicMax on 4- and 8-byte bits, a
//     compare-and-swap loop on 2-byte ones. Integer accumulators have no
//     max (the plain version's norm refuses them). The accumulator is not
//     read back.
//
// Beside them, Faces' increment, which replaces no TPU kernel: the
// reference computes it as a jnp closure (src/repro/core/halo.py,
// make_faces_kernels' increment), which the port first wrote as four
// PyTorch kernels (remainder, + 1, the broadcast + step, it + 1) that read
// and wrote the whole block twice. One launch reads each element once and
// writes it once: src' = (src + 1) + remainder(it[r], 3) over rank r's
// block, and it' = it + 1. Bound by bytes: 537 MB read and 537 MB written
// at R = 64, n = 128^3, float32 (0.32 ms at 3.35 TB/s). The grid is
// (chunks of a rank's block) x R, so a block's step comes from one
// uniform load of it[r]; each thread issues kIncVectors 16-byte loads
// (evict-first: the old block is not read again) before its first store,
// 16 KB a block in flight; 0.367 ms at n = 128^3 (87 % of the bound) and
// 0.048 at 64^3 on an H100 SXM at 700 W. 2 or 8 vectors a thread, plain
// or read-only loads, evict-first stores: within 1.5 % alone and no
// faster in the Faces program (evict-first stores 2 % slower there: the
// pack reads the new block next). Where a block's cell count is not a
// multiple of a vector's, a rank's block may start off a 16-byte boundary;
// its cells before the first boundary and after its last whole vector are
// added one by one. Two roundings in the plain version's order, remainder
// as torch.remainder takes it (fmod, then the divisor added where the
// signs differ): bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNdir = 26;
constexpr int kThreads = 256;

// Surface k of rank r starts at ptr[k] + r * stride[k] elements.
struct Surfaces {
  void* ptr[kNdir];
  long long stride[kNdir];  // rank stride of surface k, in elements
};

template <typename T>
__device__ __forceinline__ T* surface(const Surfaces& s, int k, long long r) {
  return static_cast<T*>(s.ptr[k]) + r * s.stride[k];
}

__host__ __device__ inline int extent(int d, int n) { return d ? 1 : n; }

// DIRECTIONS index of (dx, dy, dz).
__host__ __device__ constexpr int dir_index(int dx, int dy, int dz) {
  const int m = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
  return m < 13 ? m : m - 1;
}

// DIRECTIONS indices of the z-faces (0, 0, -1) and (0, 0, 1).
constexpr int kZlo = dir_index(0, 0, -1), kZhi = dir_index(0, 0, 1);

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

int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// pack
// ---------------------------------------------------------------------------

// 16-byte destination chunks a copy thread moves, a block apart; all their
// loads are issued before the first store.
constexpr int kCopyChunks = 4;

// The runs of the dz = 0 surfaces, in two sets of equal-length runs: set 0,
// the two x-planes (one run of ny * nz each); set 1, the y = 0 rows of
// every x-plane, then the y = ny - 1 rows (nx runs of nz each), then the
// four x-y edges (one run of nz each). A run of len elements can touch
// `slots` 16-byte destination chunks, whatever its alignment.
struct RunSet {
  int runs, len, slots;
  FastDiv fslots;
  int blocks;         // blocks of a rank
  FastDiv fblocks;
};

struct Pack {
  int R, nx, ny, nz;
  long long cells;    // of a rank
  RunSet set[2];
  int rows;           // (x, y) rows of a rank
  FastDiv fny;
  int end_blocks;     // end-sector blocks of a rank
  FastDiv fend;
};

// Run j of set q: its surface, its first cell in the rank's block and its
// first element in the surface's rank row.
__device__ __forceinline__ void run_at(const Pack& p, int q, int j, int& k,
                                       long long& src, long long& dst) {
  const long long plane = (long long)p.ny * p.nz;
  if (q == 0) {                                   // x = 0, x = nx - 1
    k = j ? dir_index(1, 0, 0) : dir_index(-1, 0, 0);
    src = j ? (p.nx - 1) * plane : 0;
    dst = 0;
  } else if (j < 2 * p.nx) {                      // y = 0, y = ny - 1 rows
    const int hi = j >= p.nx, x = j - hi * p.nx;
    k = hi ? dir_index(0, 1, 0) : dir_index(0, -1, 0);
    src = x * plane + (hi ? p.ny - 1 : 0) * (long long)p.nz;
    dst = (long long)x * p.nz;
  } else {                          // the x-y edges, in DIRECTIONS order
    const int e = j - 2 * p.nx, dx = e & 2 ? 1 : -1, dy = e & 1 ? 1 : -1;
    k = dir_index(dx, dy, 0);
    src = (dx < 0 ? 0 : p.nx - 1) * plane +
          (dy < 0 ? 0 : p.ny - 1) * (long long)p.nz;
    dst = 0;
  }
}

// 16 bytes from s, in the widest loads its alignment allows (s is odd
// only for 1-byte elements).
__device__ __forceinline__ uint4 load16(const char* s) {
  const unsigned m = (unsigned)(uintptr_t)s & 15u;
  if (m & 1) {
    const unsigned char* q = reinterpret_cast<const unsigned char*>(s);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)q[4 * i] | ((unsigned)q[4 * i + 1] << 8) |
             ((unsigned)q[4 * i + 2] << 16) | ((unsigned)q[4 * i + 3] << 24);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (m == 0) return *reinterpret_cast<const uint4*>(s);
  if ((m & 7) == 0) {
    const uint2* q = reinterpret_cast<const uint2*>(s);
    const uint2 a = q[0], b = q[1];
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  if ((m & 3) == 0) {
    const unsigned* q = reinterpret_cast<const unsigned*>(s);
    return make_uint4(q[0], q[1], q[2], q[3]);
  }
  const unsigned short* q = reinterpret_cast<const unsigned short*>(s);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)q[2 * i] | ((unsigned)q[2 * i + 1] << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy blocks of set q: chunk slot u of a rank is chunk u % slots of run
// u / slots; chunk c of a run whose destination starts at byte d covers
// destination bytes [a + 16c, a + 16c + 16) of the run, a = d rounded down
// to 16. A whole chunk is one 16-byte store; a chunk the run's ends cut
// (at most two a run) is copied 2 bytes at a time (1 for 1-byte elements).
__device__ __forceinline__ void copy_runs(const char* src, const Pack& p,
                                          const Surfaces& s, int q,
                                          long long r, int b, int es) {
  const RunSet& rs = p.set[q];
  const long long nbytes = (long long)rs.len * es;
  uint4 v[kCopyChunks];
  char* to[kCopyChunks];
#pragma unroll
  for (int i = 0; i < kCopyChunks; ++i) {
    to[i] = nullptr;
    const int u = (b * kCopyChunks + i) * kThreads + threadIdx.x;
    const int j = fast_div(rs.fslots, u);
    if (j >= rs.runs) continue;
    int k;
    long long so, dof;
    run_at(p, q, j, k, so, dof);
    char* d = static_cast<char*>(s.ptr[k]) + (r * s.stride[k] + dof) * es;
    const char* from = src + (r * p.cells + so) * es;
    char* lo = reinterpret_cast<char*>(
        (reinterpret_cast<uintptr_t>(d) & ~(uintptr_t)15) +
        16 * (uintptr_t)(u - j * rs.slots));
    char* end = d + nbytes;
    if (lo >= d && lo + 16 <= end) {
      v[i] = load16(from + (lo - d));
      to[i] = lo;
    } else if (es == 1) {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        char* a = lo + t;
        if (a >= d && a < end) *a = from[a - d];
      }
    } else {
#pragma unroll
      for (int t = 0; t < 16; t += 2) {
        char* a = lo + t;
        if (a >= d && a < end)
          *reinterpret_cast<unsigned short*>(a) =
              *reinterpret_cast<const unsigned short*>(from + (a - d));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kCopyChunks; ++i)
    if (to[i]) *reinterpret_cast<uint4*>(to[i]) = v[i];
}

// End-sector blocks: thread t of block b owns row b * kThreads + t of the
// rank (a warp's lanes on consecutive rows, so its z-face stores are
// coalesced). It loads both end cells, each the one cell the pack needs
// from its sector, with the evict-first hint (ld.global.cs), then writes
// the z-faces and, where x or y is on the boundary, the dz != 0 edges and
// corners that contain them.
template <typename T>
__device__ __forceinline__ void pack_ends(const T* __restrict__ src,
                                          const Pack& p, const Surfaces& s,
                                          long long r, int b) {
  const int row = b * kThreads + threadIdx.x;
  if (row >= p.rows) return;
  const T* c = src + r * p.cells + (long long)row * p.nz;
  const T lo = __ldcs(c), hi = __ldcs(c + p.nz - 1);
  const int x = fast_div(p.fny, row), y = row - x * p.ny;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    if (dx < 0 ? x != 0 : (dx > 0 && x != p.nx - 1)) continue;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      if (dy < 0 ? y != 0 : (dy > 0 && y != p.ny - 1)) continue;
      // the element of (x, y) in the surface: x * ny + y in a z-face, y in
      // an x-z edge, x in a y-z edge, 0 in a corner
      const long long e = (long long)(dx ? 0 : x) * (dy ? 1 : p.ny) +
                          (dy ? 0 : y);
      surface<T>(s, dir_index(dx, dy, -1), r)[e] = lo;
      surface<T>(s, dir_index(dx, dy, 1), r)[e] = hi;
    }
  }
}

// grid: the blocks of each role for all R ranks, in the order copy set 0,
// copy set 1, end sectors; T: an unsigned type of the element's size.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_pack_kernel(const T* __restrict__ src, const __grid_constant__ Pack p,
                 const __grid_constant__ Surfaces s) {
  int b = blockIdx.x;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const RunSet& rs = p.set[q];
    if (b < p.R * rs.blocks) {
      const int r = fast_div(rs.fblocks, b);
      copy_runs(reinterpret_cast<const char*>(src), p, s, q, r,
                b - r * rs.blocks, (int)sizeof(T));
      return;
    }
    b -= p.R * rs.blocks;
  }
  const int r = fast_div(p.fend, b);
  pack_ends<T>(src, p, s, r, b - r * p.end_blocks);
}

// ---------------------------------------------------------------------------
// unpack
// ---------------------------------------------------------------------------

__host__ __device__ inline int ends(int n) { return n == 1 ? 1 : 2; }
__host__ __device__ inline int inner(int n) { return n > 2 ? n - 2 : 0; }

// A rank's block as rows: its nx * ny (x, y) rows of nz cells, cut into
// units of W consecutive cells (W cells = one 16-byte vector when
// nz % W == 0; else W = 1). Boundary rows (x or y on the boundary) are
// the ends(nx) x-planes' ny rows, then the inner(nx) planes' ends(ny)
// y-rows; interior rows are the rest. Each rank has gb blocks of boundary
// units and gi blocks of interior units.
struct Rows {
  int nx, ny, nz;
  int nb, ni;         // boundary and interior rows of a rank
  int upr;            // units per row
  FastDiv fu, fy;     // division by upr and by inner(ny)
  int gb, gi;
};

// The accumulator's element types: zero, the add rounded to the type
// (the plain version's `+=`), and the bits (unsigned, of the element's
// size) whose magnitude part orders |v| for a float.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Bits = unsigned;
  static constexpr bool kFloat = true;
  static constexpr Bits kAbs = 0x7fffffffu;
  __device__ static float zero() { return 0.0f; }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static Bits bits(float v) { return __float_as_uint(v); }
};
template <> struct Elem<double> {
  using Bits = unsigned long long;
  static constexpr bool kFloat = true;
  static constexpr Bits kAbs = 0x7fffffffffffffffull;
  __device__ static double zero() { return 0.0; }
  __device__ static double add(double a, double b) { return a + b; }
  __device__ static Bits bits(double v) {
    return (Bits)__double_as_longlong(v);
  }
};
template <> struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr bool kFloat = true;
  static constexpr Bits kAbs = 0x7fff;
  __device__ static __nv_bfloat16 zero() { return __ushort_as_bfloat16(0); }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static Bits bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
};
template <> struct Elem<__half> {
  using Bits = unsigned short;
  static constexpr bool kFloat = true;
  static constexpr Bits kAbs = 0x7fff;
  __device__ static __half zero() { return __ushort_as_half(0); }
  __device__ static __half add(__half a, __half b) {
    return __float2half(__half2float(a) + __half2float(b));
  }
  __device__ static Bits bits(__half v) { return __half_as_ushort(v); }
};
template <> struct Elem<int> {
  using Bits = unsigned;
  static constexpr bool kFloat = false;
  static constexpr Bits kAbs = 0;
  __device__ static int zero() { return 0; }
  __device__ static int add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
  __device__ static Bits bits(int v) { return (Bits)v; }
};
// 1- and 2-byte integers: added as unsigned values of their width, so
// the sum wraps.
template <typename T, typename U> struct SmallInt {
  using Bits = U;
  static constexpr bool kFloat = false;
  static constexpr Bits kAbs = 0;
  __device__ static T zero() { return 0; }
  __device__ static T add(T a, T b) { return (T)(U)((U)a + (U)b); }
  __device__ static Bits bits(T v) { return (Bits)v; }
};
template <> struct Elem<uint8_t> : SmallInt<uint8_t, uint8_t> {};
template <> struct Elem<int8_t> : SmallInt<int8_t, uint8_t> {};
template <> struct Elem<int16_t> : SmallInt<int16_t, unsigned short> {};
template <> struct Elem<long long> {
  using Bits = unsigned long long;
  static constexpr bool kFloat = false;
  static constexpr Bits kAbs = 0;
  __device__ static long long zero() { return 0; }
  __device__ static long long add(long long a, long long b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  __device__ static Bits bits(long long v) { return (Bits)v; }
};

// The running max of |bits|: 32 bits wide for 2- and 4-byte elements.
template <typename T>
using MaxBits = typename std::conditional<sizeof(T) == 8, unsigned long long,
                                          unsigned>::type;

template <typename T>
__device__ __forceinline__ MaxBits<T> abs_bits(T v) {
  return (MaxBits<T>)(Elem<T>::bits(v) & Elem<T>::kAbs);
}

__device__ __forceinline__ unsigned warp_max(unsigned m) {
  return __reduce_max_sync(0xffffffffu, m);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long m) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(0xffffffffu, m, o);
    m = v > m ? v : m;
  }
  return m;
}

// The rank's slot of rmax, an element of T holding the max |cell|'s bits.
template <typename T>
__device__ __forceinline__ void slot_max(void* rmax, long long r,
                                         MaxBits<T> m) {
  if constexpr (sizeof(T) == 2) {
    unsigned short* p = static_cast<unsigned short*>(rmax) + r;
    unsigned short old = *p, seen;
    do {
      seen = old;
      if (seen >= m) return;
      old = atomicCAS(p, seen, (unsigned short)m);
    } while (old != seen);
  } else {
    atomicMax(static_cast<MaxBits<T>*>(rmax) + r, m);
  }
}

// The W cells (x, y, z0 + i) of a boundary row: each zero plus, in
// DIRECTIONS order (dx, then dy, then dz ascending), the element of each
// surface that contains it. The (dx, dy, dz) loops are unrolled, so every
// surface's address is known and the loads do not wait on one another.
template <typename T, int W>
__device__ __forceinline__ void boundary_cells(const Surfaces& s, long long r,
                                               const Rows& h, int x, int y,
                                               int z0, T (&a)[W]) {
  using E = Elem<T>;
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = E::zero();
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
        const T* p = surface<const T>(s, k, r) +
                     (long long)((dx ? 0 : x) * sy + (dy ? 0 : y)) * sz;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const int z = z0 + i;
          if (dz < 0 ? z == 0 : (dz > 0 ? z == h.nz - 1 : true))
            a[i] = E::add(a[i], p[dz ? 0 : z]);
        }
      }
    }
  }
}

// Units of an interior block per thread: their z-face loads are all
// issued before the first store, so a warp waits for one load latency per
// 4 x 512 bytes it stores, not per 512.
constexpr int kInteriorUnits = 4;

// 32-bit word i of a 16-byte vector of W cells.
template <typename T, int W>
__device__ __forceinline__ unsigned vector_word(const T (&a)[W], int i) {
  using E = Elem<T>;
  if constexpr (sizeof(T) == 1) {
    return (unsigned)E::bits(a[4 * i]) |
           ((unsigned)E::bits(a[4 * i + 1]) << 8) |
           ((unsigned)E::bits(a[4 * i + 2]) << 16) |
           ((unsigned)E::bits(a[4 * i + 3]) << 24);
  } else if constexpr (sizeof(T) == 2) {
    return (unsigned)E::bits(a[2 * i]) |
           ((unsigned)E::bits(a[2 * i + 1]) << 16);
  } else if constexpr (sizeof(T) == 4) {
    return (unsigned)E::bits(a[i]);
  } else {
    const unsigned long long b = E::bits(a[i / 2]);
    return (unsigned)(i & 1 ? b >> 32 : b);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_unit(T* out, const T (&a)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(out) =
        make_uint4(vector_word<T, W>(a, 0), vector_word<T, W>(a, 1),
                   vector_word<T, W>(a, 2), vector_word<T, W>(a, 3));
  } else {
    out[0] = a[0];
  }
}

// grid: R * (gb + gi) blocks, the boundary blocks of all R ranks first, so
// that their longer work runs beside the interior blocks' stores. A boundary
// thread writes one unit; an interior thread kInteriorUnits units, a block
// apart. In an interior row only z = 0 and z = nz - 1 are boundary cells,
// each in one z-face (zero + that element); the rest are zero. rmax
// (kMax): the rank's max |cell| as the bits of a T, zero on entry.
template <typename T, int W, bool kMax>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(T* __restrict__ acc, const Rows h,
              const __grid_constant__ Surfaces s, void* __restrict__ rmax) {
  using E = Elem<T>;
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
  T* const rank = acc + r * h.nx * h.ny * (long long)h.nz;
  MaxBits<T> m = 0;
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
      T a[W];
      boundary_cells<T, W>(s, r, h, x, y, z0, a);
      store_unit<T, W>(rank + (x * h.ny + y) * (long long)h.nz + z0, a);
      if constexpr (kMax) {
#pragma unroll
        for (int i = 0; i < W; ++i) m = max(m, abs_bits(a[i]));
      }
    }
  } else {
    const T* zlo = surface<const T>(s, kZlo, r);
    const T* zhi = surface<const T>(s, kZhi, r);
    const int units = h.ni * h.upr;
    long long at[kInteriorUnits];      // the unit's first cell in the rank
    int z0[kInteriorUnits];
    T lo[kInteriorUnits], hi[kInteriorUnits];
#pragma unroll
    for (int k = 0; k < kInteriorUnits; ++k) {
      const int u = (bid * kInteriorUnits + k) * blockDim.x + threadIdx.x;
      const int row = fast_div(h.fu, u);
      const int xi = fast_div(h.fy, row);
      const int x = 1 + xi, y = 1 + row - xi * inner(h.ny);
      z0[k] = u < units ? (u - row * h.upr) * W : -1;   // -1: no unit
      at[k] = (x * h.ny + y) * (long long)h.nz + z0[k];
      lo[k] = z0[k] == 0 ? zlo[x * h.ny + y] : E::zero();
      hi[k] = z0[k] >= 0 && z0[k] + W == h.nz ? zhi[x * h.ny + y]
                                               : E::zero();
    }
#pragma unroll
    for (int k = 0; k < kInteriorUnits; ++k) {
      if (z0[k] < 0) continue;
      T a[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int z = z0[k] + i;
        T v = E::zero();
        if (z == 0) v = E::add(v, lo[k]);
        if (z == h.nz - 1) v = E::add(v, hi[k]);
        a[i] = v;
        if constexpr (kMax) m = max(m, abs_bits(v));
      }
      store_unit<T, W>(rank + at[k], a);
    }
  }
  if constexpr (kMax) {
    __shared__ MaxBits<T> wmax[kThreads / 32];
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < blockDim.x / 32 ? wmax[threadIdx.x] : 0;
      m = warp_max(m);
      if (threadIdx.x == 0 && m != 0) slot_max<T>(rmax, r, m);
    }
  }
}

// ---------------------------------------------------------------------------
// Faces increment
// ---------------------------------------------------------------------------

// 16-byte vectors a thread loads before its first store.
constexpr int kIncVectors = 4;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using V = float4;
  static constexpr int kW = 4;
  __device__ static float& at(V& v, int i) { return (&v.x)[i]; }
};
template <> struct Vec16<double> {
  using V = double2;
  static constexpr int kW = 2;
  __device__ static double& at(V& v, int i) { return (&v.x)[i]; }
};

// a + b rounded to nearest even, never contracted into another operation
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float fmod3(float x) { return fmodf(x, 3.0f); }
__device__ __forceinline__ double fmod3(double x) { return fmod(x, 3.0); }

// torch.remainder(x, 3): fmod, plus the divisor where the remainder is
// nonzero and its sign is not the divisor's (fmod is exact)
template <typename T>
__device__ __forceinline__ T remainder3(T x) {
  const T m = fmod3(x);
  return m < T(0) ? add_rn(m, T(3)) : m;
}

template <typename T>
__device__ __forceinline__ T increment(T s, T step) {
  return add_rn(add_rn(s, T(1)), step);
}

// grid: (chunks, R); chunk c of rank r holds the rank's vectors
// [c * kThreads * kIncVectors, (c + 1) * kThreads * kIncVectors), a
// thread's a block apart. src and out are 16-byte aligned and their rank
// blocks of `cells` elements adjoin, so rank r's first vector starts
// `head` cells into its block; chunk 0 also adds the head's and the
// tail's cells and writes it'[r].
template <typename T>
__global__ void __launch_bounds__(kThreads)
faces_increment_kernel(const T* __restrict__ src, const T* __restrict__ it,
                       T* __restrict__ out, T* __restrict__ it_out,
                       long long cells) {
  using Vec = Vec16<T>;
  using V = typename Vec::V;
  constexpr int W = Vec::kW;
  const int r = blockIdx.y;
  const T i = it[r];
  const T step = remainder3(i);
  const long long base = (long long)r * cells;
  const int head = (int)min((W - base % W) % W, cells);
  const long long nvec = (cells - head) / W;
  const T* s = src + base;
  T* o = out + base;
  if (blockIdx.x == 0) {
    const long long tail = cells - head - nvec * W;
    if (threadIdx.x == 0) it_out[r] = add_rn(i, T(1));
    if (threadIdx.x < head) o[threadIdx.x] = increment(s[threadIdx.x], step);
    if (threadIdx.x < tail) {
      const long long j = head + nvec * W + threadIdx.x;
      o[j] = increment(s[j], step);
    }
  }
  const V* sv = reinterpret_cast<const V*>(s + head);
  V* ov = reinterpret_cast<V*>(o + head);
  const long long v0 =
      (long long)blockIdx.x * (kThreads * kIncVectors) + threadIdx.x;
  V v[kIncVectors];
#pragma unroll
  for (int u = 0; u < kIncVectors; ++u) {
    const long long j = v0 + u * kThreads;
    if (j < nvec) v[u] = __ldcs(sv + j);
  }
#pragma unroll
  for (int u = 0; u < kIncVectors; ++u) {
    const long long j = v0 + u * kThreads;
    if (j < nvec) {
#pragma unroll
      for (int e = 0; e < W; ++e)
        Vec::at(v[u], e) = increment(Vec::at(v[u], e), step);
      ov[j] = v[u];
    }
  }
}

Surfaces make_surfaces(const uint64_t* ptrs, const int64_t* strides) {
  Surfaces s;
  for (int k = 0; k < kNdir; ++k) {
    s.ptr[k] = reinterpret_cast<void*>(ptrs[k]);
    s.stride[k] = strides[k];
  }
  return s;
}

// In-rank indices are 32-bit.
bool shape_ok(int R, int nx, int ny, int nz) {
  return R > 0 && nx > 0 && ny > 0 && nz > 0 &&
         (long long)nx * ny * nz < (1LL << 31);
}

RunSet make_runs(int runs, int len, int es) {
  RunSet rs;
  rs.runs = runs;
  rs.len = len;
  // a run's first byte sits 0 .. 16 - es bytes past a 16-byte boundary
  rs.slots = (int)(((long long)len * es + 16 - es + 15) / 16);
  rs.fslots = make_fastdiv(rs.slots);
  rs.blocks = cdiv(runs * rs.slots, kThreads * kCopyChunks);
  rs.fblocks = make_fastdiv(rs.blocks);
  return rs;
}

template <typename T>
cudaError_t launch_pack(const void* src, const Pack& p, const Surfaces& s,
                        unsigned grid, cudaStream_t stream) {
  halo_pack_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), p, s);
  return cudaGetLastError();
}

template <typename T, int W, bool kMax>
cudaError_t launch_unpack(void* acc, const Rows& h, const Surfaces& s,
                          void* rmax, unsigned grid, cudaStream_t st) {
  unpack_kernel<T, W, kMax><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(acc), h, s, rmax);
  return cudaGetLastError();
}

template <typename T>
cudaError_t unpack_typed(void* acc, int R, int nx, int ny, int nz,
                         const Surfaces& s, void* rmax, cudaStream_t st) {
  constexpr int kW = 16 / (int)sizeof(T);
  const int W = nz % kW == 0 ? kW : 1;
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
    return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(R * (h.gb + h.gi));
  if (rmax != nullptr) {
    if constexpr (Elem<T>::kFloat) {
      return W == kW ? launch_unpack<T, kW, true>(acc, h, s, rmax, grid, st)
                     : launch_unpack<T, 1, true>(acc, h, s, rmax, grid, st);
    } else {
      return cudaErrorInvalidValue;      // an integer has no max |acc|
    }
  }
  return W == kW ? launch_unpack<T, kW, false>(acc, h, s, rmax, grid, st)
                 : launch_unpack<T, 1, false>(acc, h, s, rmax, grid, st);
}

template <typename T>
cudaError_t increment_typed(const void* src, const void* it, void* out,
                            void* it_out, int R, long long cells,
                            cudaStream_t st) {
  const long long chunks =
      (cells / Vec16<T>::kW + kThreads * kIncVectors - 1) /
      (kThreads * kIncVectors);
  if (chunks >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(chunks > 0 ? chunks : 1), (unsigned)R);
  faces_increment_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(src), static_cast<const T*>(it),
      static_cast<T*>(out), static_cast<T*>(it_out), cells);
  return cudaGetLastError();
}

}  // namespace

// src: contiguous (R, nx, ny, nz) elements of es = 1, 2, 4 or 8 bytes;
// ptrs/strides: host arrays of 26 surface base pointers (device addresses)
// and rank strides in elements. Every address is a multiple of es.
extern "C" int halo_pack_launch(const void* src, int R, int nx, int ny,
                                int nz, int es, const uint64_t* ptrs,
                                const int64_t* strides, void* stream) {
  if (R == 0) return 0;
  if (!shape_ok(R, nx, ny, nz) ||
      (es != 1 && es != 2 && es != 4 && es != 8) ||
      (long long)ny * nz * es + 32 >= (1LL << 31) ||
      (long long)(2 * nx + 4) * ((long long)nz * es / 16 + 2) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Pack p;
  p.R = R; p.nx = nx; p.ny = ny; p.nz = nz;
  p.cells = (long long)nx * ny * nz;
  p.set[0] = make_runs(2, ny * nz, es);
  p.set[1] = make_runs(2 * nx + 4, nz, es);
  p.rows = nx * ny;
  p.fny = make_fastdiv(ny);
  p.end_blocks = cdiv(p.rows, kThreads);
  p.fend = make_fastdiv(p.end_blocks);
  const long long grid = (long long)R * (p.set[0].blocks + p.set[1].blocks +
                                         p.end_blocks);
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Surfaces s = make_surfaces(ptrs, strides);
  const cudaStream_t st = (cudaStream_t)stream;
  if (es == 1)
    return (int)launch_pack<unsigned char>(src, p, s, (unsigned)grid, st);
  if (es == 2)
    return (int)launch_pack<unsigned short>(src, p, s, (unsigned)grid, st);
  if (es == 4)
    return (int)launch_pack<unsigned>(src, p, s, (unsigned)grid, st);
  return (int)launch_pack<unsigned long long>(src, p, s, (unsigned)grid, st);
}

// acc: contiguous (R, nx, ny, nz) output of the surfaces' dtype, every
// cell written once; dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16,
// 4 int32, 5 int64, 6 uint8, 7 int8, 8 int16; rmax: NULL, or R slots of
// that (floating) dtype, zero
// on entry, that receive each rank's max |acc|.
extern "C" int halo_unpack_launch(void* acc, int dtype, int R, int nx, int ny,
                                  int nz, const uint64_t* ptrs,
                                  const int64_t* strides, void* rmax,
                                  void* stream) {
  if (R == 0) return 0;
  if (!shape_ok(R, nx, ny, nz)) return (int)cudaErrorInvalidValue;
  const Surfaces s = make_surfaces(ptrs, strides);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)unpack_typed<float>(acc, R, nx, ny, nz, s, rmax, st);
    case 1: return (int)unpack_typed<double>(acc, R, nx, ny, nz, s, rmax, st);
    case 2:
      return (int)unpack_typed<__nv_bfloat16>(acc, R, nx, ny, nz, s, rmax,
                                              st);
    case 3: return (int)unpack_typed<__half>(acc, R, nx, ny, nz, s, rmax, st);
    case 4: return (int)unpack_typed<int>(acc, R, nx, ny, nz, s, rmax, st);
    case 5:
      return (int)unpack_typed<long long>(acc, R, nx, ny, nz, s, rmax, st);
    case 6: return (int)unpack_typed<uint8_t>(acc, R, nx, ny, nz, s, rmax, st);
    case 7: return (int)unpack_typed<int8_t>(acc, R, nx, ny, nz, s, rmax, st);
    case 8:
      return (int)unpack_typed<int16_t>(acc, R, nx, ny, nz, s, rmax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// src, out: contiguous (R, cells) elements of dtype 0 float32 or 1
// float64, both 16-byte aligned; it, it_out: R elements of that dtype.
// out = (src + 1) + remainder(it[r], 3) in rank r's cells, it_out = it + 1.
extern "C" int faces_increment_launch(const void* src, const void* it,
                                      void* out, void* it_out, int dtype,
                                      int R, long long cells, void* stream) {
  if (R == 0) return 0;
  if (R < 0 || R > 65535 || cells < 1 ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)increment_typed<float>(src, it, out, it_out, R, cells, st);
    case 1:
      return (int)increment_typed<double>(src, it, out, it_out, R, cells, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
