// Device-resident counter bump: out = sig + upd over int32 counter slots.
//
// Replaces the TPU kernel _pallas_bump in src/repro/core/engine.py, the
// progress engine's merged post-signal bump on the counter arena. In the
// port every counter effect of the epoch protocol (post signals, chained
// completion signals) is one such bump of a (R, npeers) counter buffer by
// a precomputed update of the same shape.
//
// What bounds it on an H100: launch latency. Faces' counters are
// 64 x 26 int32 (6.5 KB); the kernel reads two and writes one, about
// 20 KB, which the memory moves in nanoseconds against microseconds to
// launch. The design is therefore the simplest one: one thread per slot,
// no shared memory, a single small grid. Integer adds are exact, so the
// result equals the reference bit for bit. A device-side wait poll and a
// persistent per-segment kernel, which would remove launches, are later
// work.

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

}  // namespace

// sig, upd, out: contiguous int32 buffers of n elements on one device.
extern "C" int counter_bump_launch(const int32_t* sig, const int32_t* upd,
                                   int32_t* out, long long n, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bump_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(sig, upd, out, n);
  return (int)cudaGetLastError();
}
