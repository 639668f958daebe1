// QOI chunk replay for Hopper, called from JAX through the FFI.
//
// One thread per lane.  Each lane's 64-slot table lives in shared memory
// as tab[slot * blockDim.x + thread], so an INDEX read and the hash
// write-back are single directly indexed accesses (no one-hot) and the
// accesses of a warp never share a bank.  Meta/val rows are chunk-major
// (rows, lanes), so a warp's per-row loads are coalesced; each loop
// iteration loads the next U rows while it replays the current ones.
// The per-row chain (table read, select, hash, table write) is latency
// bound, so each block is one warp: 128 lanes take 4 SMs.
//
// Same semantics and argument layout as qoipp_tpu/ops/replay_kernel.py:
//   meta = cls | (arg << 3) | (reset << 9), val per cls;
//   in: meta, val (rows, B); prev (1, B); seen (64, B)
//   out: emits (rows, B); prev (1, B); seen (64, B); pupd (1, B); swr (64, B)
// rows must be a multiple of U (the caller pads with NOP rows).

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr uint32_t kStart = 0xFF000000u;
constexpr int kStartHash = (11 * 255) % 64;
constexpr int U = 16;  // rows per iteration; the next U are loaded ahead
constexpr int kThreads = 32;

// per-byte add mod 256 (SIMD within a register)
__device__ __forceinline__ uint32_t swar_add(uint32_t x, uint32_t y) {
  return __vadd4(x, y);
}

// QOI hash r*3 + g*5 + b*7 + a*11 (mod 64) as one byte dot product
__device__ __forceinline__ uint32_t hash6(uint32_t v) {
  return __dp4a(v, 0x0B070503u, 0u) & 63;
}

template <bool kSummary>
__global__ void replay_kernel(const uint32_t* __restrict__ meta,
                              const uint32_t* __restrict__ val,
                              const uint32_t* __restrict__ prev_in,
                              const uint32_t* __restrict__ seen_in,
                              uint32_t* __restrict__ emit,
                              uint32_t* __restrict__ prev_out,
                              uint32_t* __restrict__ seen_out,
                              int32_t* __restrict__ pupd_out,
                              int32_t* __restrict__ swr_out, int64_t rows,
                              int64_t b) {
  __shared__ uint32_t tab[64 * kThreads];
  const int t = threadIdx.x;
  const int64_t lane = int64_t(blockIdx.x) * kThreads + t;
  if (lane >= b) return;  // no block-wide barrier follows

  for (int s = 0; s < 64; ++s) tab[s * kThreads + t] = seen_in[s * b + lane];
  uint32_t prev = prev_in[lane];
  bool pupd = false;
  uint64_t swr = 0;

  uint32_t mb[U], xb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    mb[u] = __ldg(meta + u * b + lane);
    xb[u] = __ldg(val + u * b + lane);
  }
  for (int64_t r0 = 0; r0 < rows; r0 += U) {
    const int64_t rn = r0 + U < rows ? r0 + U : r0;
    uint32_t mn[U], xn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mn[u] = __ldg(meta + (rn + u) * b + lane);
      xn[u] = __ldg(val + (rn + u) * b + lane);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t m = mb[u], x = xb[u];
      const uint32_t cls = m & 7;
      if (m & 512u) {  // stream start: re-enter the initial carry
        prev = kStart;
        for (int s = 0; s < 64; ++s)
          tab[s * kThreads + t] = s == kStartHash ? kStart : 0u;
        if (kSummary) {
          pupd = true;
          swr = ~0ull;
        }
      }
      const uint32_t idx_val = tab[((m >> 3) & 63) * kThreads + t];
      uint32_t v = prev;
      if (cls == 1) v = x;
      else if (cls == 2) v = (prev & 0xFF000000u) | x;
      else if (cls == 3) v = swar_add(prev, x);
      else if (cls == 4) v = idx_val;
      if (cls >= 1 && cls <= 4) {
        const uint32_t h = hash6(v);
        prev = v;
        tab[h * kThreads + t] = v;
        if (kSummary) {
          pupd = true;
          swr |= 1ull << h;
        }
      }
      emit[(r0 + u) * b + lane] = v;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mb[u] = mn[u];
      xb[u] = xn[u];
    }
  }

  prev_out[lane] = prev;
  for (int s = 0; s < 64; ++s) seen_out[s * b + lane] = tab[s * kThreads + t];
  if (kSummary) {
    pupd_out[lane] = pupd ? 1 : 0;
    for (int s = 0; s < 64; ++s)
      swr_out[s * b + lane] = int32_t((swr >> s) & 1);
  }
}

template <bool kSummary>
ffi::Error Replay(cudaStream_t stream, ffi::Buffer<ffi::U32> meta,
                  ffi::Buffer<ffi::U32> val, ffi::Buffer<ffi::U32> prev_in,
                  ffi::Buffer<ffi::U32> seen_in,
                  ffi::ResultBuffer<ffi::U32> emit,
                  ffi::ResultBuffer<ffi::U32> prev_out,
                  ffi::ResultBuffer<ffi::U32> seen_out,
                  ffi::ResultBuffer<ffi::S32> pupd,
                  ffi::ResultBuffer<ffi::S32> swr) {
  auto dims = meta.dimensions();
  if (dims.size() != 2 || dims[0] % U != 0)
    return ffi::Error::InvalidArgument(
        "meta must be (rows, lanes) with rows a multiple of 16");
  const int64_t rows = dims[0], b = dims[1];
  if (rows == 0 || b == 0) return ffi::Error::Success();
  const int blocks = int((b + kThreads - 1) / kThreads);
  replay_kernel<kSummary><<<blocks, kThreads, 0, stream>>>(
      meta.typed_data(), val.typed_data(), prev_in.typed_data(),
      seen_in.typed_data(), emit->typed_data(), prev_out->typed_data(),
      seen_out->typed_data(), pupd->typed_data(), swr->typed_data(), rows, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

#define QOI_REPLAY_BINDING                                  \
  ffi::Ffi::Bind()                                          \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()             \
      .Arg<ffi::Buffer<ffi::U32>>()                         \
      .Arg<ffi::Buffer<ffi::U32>>()                         \
      .Arg<ffi::Buffer<ffi::U32>>()                         \
      .Arg<ffi::Buffer<ffi::U32>>()                         \
      .Ret<ffi::Buffer<ffi::U32>>()                         \
      .Ret<ffi::Buffer<ffi::U32>>()                         \
      .Ret<ffi::Buffer<ffi::U32>>()                         \
      .Ret<ffi::Buffer<ffi::S32>>()                         \
      .Ret<ffi::Buffer<ffi::S32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(QoiReplay, Replay<false>, QOI_REPLAY_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(QoiReplaySummary, Replay<true>,
                              QOI_REPLAY_BINDING);
