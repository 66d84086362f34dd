// Device-resident counter bump, and the puts (unicast and multicast) that
// carry their completion signal in their own launch.
//
// Replaces the TPU kernel _pallas_bump in src/repro/core/engine.py, the
// progress engine's merged post-signal bump on the counter arena, and the
// chained completion signal the reference lands as "a second triggered put
// ... triggered by the payload's arrival" (src/repro/core/engine.py,
// _emit_completion_signal). Counters are (R, npeers) int32 buffers bumped by
// a precomputed update of the same shape.
//
// What bounds them on an H100: the launch, not the bytes. Faces' counters
// are 64 x 26 int32 (6.5 KB); a bump reads two and writes one, about 20 KB,
// which the memory moves in nanoseconds against microseconds to launch. No
// design of a lone bump gets under that floor, so the design removes
// launches instead:
//   * counter_bump: out = sig + upd, one thread per slot. It stays for the
//     merged post signal and for the host-orchestrated baseline, whose
//     completion handling is its own dispatch (paper Fig. 9a).
//   * put_signal: the permuted copy of a put (row dst of the output is row
//     perm[dst] of the payload, zeros where perm[dst] is -1: the
//     non-periodic scatter) and, in the same launch, its chained completion
//     signal sig + upd. The payload and the counter take one launch instead
//     of two. Rows are copied as bytes, in 16-byte vectors where the row
//     size, the rank stride and both base addresses allow and narrower ones
//     otherwise, so float32, bf16 and int32 payloads all take it. The copy
//     is bound by the payload's bytes (a Faces face is 64 x 16 KB); a block
//     row per destination rank keeps every load and store coalesced.
//
//   * put_multicast: the multicast descriptor of the broadcast pattern (the
//     reference emits it as one ppermute per branch plus the completion
//     tree, src/repro/core/engine.py, emit_node's mcast_dirs branch): one
//     payload, nb branch tables perms[b] (row dst of branch b's landing
//     buffer is row perms[b][dst] of the payload, zeros where -1), and the
//     completion tree's counter update sig + upd, all in one launch. It is
//     bound by its bytes: the payload read once and written nb times (the
//     broadcast's 8 x 16 MB tiles to 3 branches: 128 MB in, 384 MB out).
//     So it goes source-major: block row r first lists, in shared memory,
//     every (branch, dst) that payload row r feeds (a scan of the nb x R
//     table; no inverse table to build or keep) and every branch whose row
//     r has no source; then each thread loads a vector of row r ONCE and
//     stores it to every destination on the list, and zeros where row r of
//     a branch has no source. A destination-major grid would re-read the
//     payload once per branch, and 128 MB does not stay in the 50 MB L2.
//     The nb landing buffers are one (nb, R, row) allocation.
//
// Why no fence between payload and signal: every reader of either output is
// a later launch on the same stream, and a launch sees all memory effects of
// the launches before it on its stream. A device-side wait poll (a kernel
// spinning on the counter while this one runs, ROADMAP Queue 1 item 13)
// would need a release ordering here: the payload stores, then
// __threadfence(), then the signal, written by the last block to finish.
//
// Integer adds and copies are exact: both results equal the reference bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void bump_kernel(const int32_t* __restrict__ sig,
                            const int32_t* __restrict__ upd,
                            int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = sig[i] + upd[i];
}

// grid: (copy blocks per row [+ 1], max(R, 1)); block row r writes output
// row r from payload row perm[r], nvec vectors of V. With a signal, the
// last block of each row writes signal slots instead (nsig between them):
// the signal's loads then run beside the copy's two dependent ones (the
// source rank, then its row), not after them.
template <typename V>
__global__ void put_signal_kernel(const char* __restrict__ x,
                                  long long x_stride, char* __restrict__ out,
                                  long long nvec, int R,
                                  const int64_t* __restrict__ perm,
                                  const int32_t* __restrict__ sig,
                                  const int32_t* __restrict__ upd,
                                  int32_t* __restrict__ sig_out,
                                  long long nsig) {
  const int r = blockIdx.y;
  const int copy_blocks = gridDim.x - (sig_out != nullptr);
  if ((int)blockIdx.x == copy_blocks) {
    for (long long k = r * (long long)blockDim.x + threadIdx.x; k < nsig;
         k += (long long)gridDim.y * blockDim.x)
      sig_out[k] = sig[k] + upd[k];
    return;
  }
  if (r >= R) return;
  const long long step = (long long)copy_blocks * blockDim.x;
  const long long j0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  V* dst = reinterpret_cast<V*>(out) + r * nvec;
  const long long src = perm[r];
  if (src >= 0) {
    const V* row = reinterpret_cast<const V*>(x + src * x_stride);
    for (long long j = j0; j < nvec; j += step) dst[j] = row[j];
  } else {
    for (long long j = j0; j < nvec; j += step) dst[j] = V{};
  }
}

// grid: (copy blocks [+ 1], max(R, 1)); out is (nb, R, nvec vectors of V).
// Block row r stores payload row r into every (branch, dst) with
// perm[b][dst] == r, and zeros into row r of every branch with
// perm[b][r] == -1. Dynamic shared memory: nb * R + nb ints.
template <typename V>
__global__ void put_multicast_kernel(const char* __restrict__ x,
                                     long long x_stride,
                                     char* __restrict__ out, long long nvec,
                                     int R, int nb,
                                     const int64_t* __restrict__ perm,
                                     const int32_t* __restrict__ sig,
                                     const int32_t* __restrict__ upd,
                                     int32_t* __restrict__ sig_out,
                                     long long nsig) {
  extern __shared__ int lists[];
  __shared__ int counts[2];
  const int r = blockIdx.y;
  const int copy_blocks = gridDim.x - (sig_out != nullptr);
  if ((int)blockIdx.x == copy_blocks) {
    for (long long k = r * (long long)blockDim.x + threadIdx.x; k < nsig;
         k += (long long)gridDim.y * blockDim.x)
      sig_out[k] = sig[k] + upd[k];
    return;
  }
  if (r >= R) return;
  const long long table = (long long)nb * R;
  int* fed = lists;                  // b * R + dst, fed by payload row r
  int* zeros = lists + table;        // b, whose row r has no source
  if (threadIdx.x < 2) counts[threadIdx.x] = 0;
  __syncthreads();
  for (long long k = threadIdx.x; k < table; k += blockDim.x) {
    const long long src = perm[k];
    if (src == r) fed[atomicAdd(&counts[0], 1)] = (int)k;
    else if (src < 0 && k % R == r) zeros[atomicAdd(&counts[1], 1)] =
        (int)(k / R);
  }
  __syncthreads();
  const int nfed = counts[0], nzero = counts[1];
  const long long step = (long long)copy_blocks * blockDim.x;
  const long long j0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  V* o = reinterpret_cast<V*>(out);
  const V* row = reinterpret_cast<const V*>(x + r * x_stride);
  for (long long j = j0; j < nvec; j += step) {
    if (nfed) {
      const V v = row[j];
      for (int i = 0; i < nfed; ++i) o[fed[i] * nvec + j] = v;
    }
    for (int i = 0; i < nzero; ++i)
      o[((long long)zeros[i] * R + r) * nvec + j] = V{};
  }
}

template <typename V>
cudaError_t launch_put(const char* x, long long x_stride, char* out,
                       long long row_bytes, int R, const int64_t* perm,
                       const int32_t* sig, const int32_t* upd,
                       int32_t* sig_out, long long nsig, cudaStream_t stream) {
  const long long nvec = row_bytes / (long long)sizeof(V);
  // a warp at least, a block at most; a Faces face (1,024 16-byte vectors)
  // takes 4 blocks a row, an edge or a corner one warp
  long long threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  long long bx = (nvec + threads - 1) / threads;
  bx = bx < 1 ? 1 : (bx > 1024 ? 1024 : bx);
  const dim3 grid((unsigned)(bx + (sig_out != nullptr)),
                  (unsigned)(R > 0 ? R : 1));
  put_signal_kernel<V><<<grid, (unsigned)threads, 0, stream>>>(
      x, x_stride, out, nvec, R, perm, sig, upd, sig_out, nsig);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_multicast(const char* x, long long x_stride, char* out,
                             long long row_bytes, int R, int nb,
                             const int64_t* perm, const int32_t* sig,
                             const int32_t* upd, int32_t* sig_out,
                             long long nsig, cudaStream_t stream) {
  const long long nvec = row_bytes / (long long)sizeof(V);
  long long threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  long long bx = (nvec + threads - 1) / threads;
  bx = bx < 1 ? 1 : (bx > 1024 ? 1024 : bx);
  const dim3 grid((unsigned)(bx + (sig_out != nullptr)),
                  (unsigned)(R > 0 ? R : 1));
  const size_t smem = ((size_t)nb * R + nb) * sizeof(int);
  put_multicast_kernel<V><<<grid, (unsigned)threads, smem, stream>>>(
      x, x_stride, out, nvec, R, nb, perm, sig, upd, sig_out, nsig);
  return cudaGetLastError();
}

}  // namespace

// sig, upd, out: contiguous int32 buffers of n elements on one device.
extern "C" int counter_bump_launch(const int32_t* sig, const int32_t* upd,
                                   int32_t* out, long long n, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bump_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(sig, upd, out, n);
  return (int)cudaGetLastError();
}

// x: R payload rows of row_bytes bytes each, row r at x + r * x_stride
// bytes; out: contiguous (R, row_bytes); perm: R source ranks in [-1, R)
// on the device (-1: zero fill). sig_out == nullptr puts with no signal;
// else sig, upd, sig_out are contiguous int32 buffers of nsig elements.
extern "C" int put_signal_launch(const void* x, long long x_stride, void* out,
                                 long long row_bytes, int R,
                                 const int64_t* perm, const int32_t* sig,
                                 const int32_t* upd, int32_t* sig_out,
                                 long long nsig, void* stream) {
  if (R < 0 || R > 65535 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (sig_out == nullptr) nsig = 0;
  if ((R == 0 || row_bytes == 0) && nsig == 0) return 0;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out |
                          (uintptr_t)row_bytes | (uintptr_t)x_stride;
  const char* xs = static_cast<const char*>(x);
  char* os = static_cast<char*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (align % 16 == 0)
    return (int)launch_put<uint4>(xs, x_stride, os, row_bytes, R, perm, sig,
                                  upd, sig_out, nsig, s);
  if (align % 8 == 0)
    return (int)launch_put<uint2>(xs, x_stride, os, row_bytes, R, perm, sig,
                                  upd, sig_out, nsig, s);
  if (align % 4 == 0)
    return (int)launch_put<uint32_t>(xs, x_stride, os, row_bytes, R, perm,
                                     sig, upd, sig_out, nsig, s);
  if (align % 2 == 0)
    return (int)launch_put<uint16_t>(xs, x_stride, os, row_bytes, R, perm,
                                     sig, upd, sig_out, nsig, s);
  return (int)launch_put<uint8_t>(xs, x_stride, os, row_bytes, R, perm, sig,
                                  upd, sig_out, nsig, s);
}

// x: R payload rows of row_bytes bytes each, row r at x + r * x_stride
// bytes; out: contiguous (nb, R, row_bytes); perm: contiguous (nb, R)
// source ranks in [-1, R) on the device (-1: zero fill). nb * R + nb ints
// of the table's lists must fit in 48 KB of shared memory. sig_out ==
// nullptr puts with no signal; else sig, upd, sig_out are contiguous int32
// buffers of nsig elements.
extern "C" int put_multicast_launch(const void* x, long long x_stride,
                                    void* out, long long row_bytes, int R,
                                    int nb, const int64_t* perm,
                                    const int32_t* sig, const int32_t* upd,
                                    int32_t* sig_out, long long nsig,
                                    void* stream) {
  if (R < 0 || R > 65535 || nb < 1 || row_bytes < 0 ||
      ((long long)nb * R + nb) * (long long)sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (sig_out == nullptr) nsig = 0;
  if ((R == 0 || row_bytes == 0) && nsig == 0) return 0;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out |
                          (uintptr_t)row_bytes | (uintptr_t)x_stride;
  const char* xs = static_cast<const char*>(x);
  char* os = static_cast<char*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (align % 16 == 0)
    return (int)launch_multicast<uint4>(xs, x_stride, os, row_bytes, R, nb,
                                        perm, sig, upd, sig_out, nsig, s);
  if (align % 8 == 0)
    return (int)launch_multicast<uint2>(xs, x_stride, os, row_bytes, R, nb,
                                        perm, sig, upd, sig_out, nsig, s);
  if (align % 4 == 0)
    return (int)launch_multicast<uint32_t>(xs, x_stride, os, row_bytes, R,
                                           nb, perm, sig, upd, sig_out,
                                           nsig, s);
  if (align % 2 == 0)
    return (int)launch_multicast<uint16_t>(xs, x_stride, os, row_bytes, R,
                                           nb, perm, sig, upd, sig_out,
                                           nsig, s);
  return (int)launch_multicast<uint8_t>(xs, x_stride, os, row_bytes, R, nb,
                                        perm, sig, upd, sig_out, nsig, s);
}
