// The FFT DST-I's glue around cuFFT, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel. qgcm_tpu's FFT DST
// (qgcm_tpu/solver/helmholtz.py::dst1) builds the odd extension
// [0, x, 0, -rev x] and reads -imag of its real FFT; XLA fuses those
// copies into the FFT's operand and result on the TPU. In PyTorch the same
// chain (ops/dst.py::chain) is a flip, two negations, a cat and a strided
// slice, each a pass over device memory, and the y-DST's flip and cat
// read across rows: at 3x4801^2 the chain's copies took three quarters of
// the solve, more than cuFFT itself (PERF.md, section 5). cuFFT's r2c stays
// (torch.fft.rfft, the same plans); these kernels make what feeds it and
// read what it returns:
//   * extend: a real input (..., P, Q) read through its strides (the
//     caller's view: the p-grid's interior, a transposed spectrum) ->
//     the contiguous odd extension (..., P, 2Q+2) along its last axis,
//     [0, s*v, 0, -s*rev v] with s = -1 for a turn (below), else 1;
//   * turn: an extend whose input is the imaginary parts of the last
//     r2c's bins 1..N, read transposed: the x-DST's -imag and the
//     y-DST's odd extension in one read and one write;
//   * extract: the imaginary parts of the bins 1..Q of an r2c's
//     spectrum -> -imag as a contiguous (..., P, Q);
//   * extract_pad: the same read transposed, times the inverse
//     transform's norm, into the interior of a zero-walled (..., Q+2,
//     P+2): the box solve's last pass, in place of a multiply and a pad.
// Every value is the chain's: a copy, a negation, or the one product
// (-v) * norm in the input's type, the chain's own rounding, so the
// kernels' arrays are the chain's bit for bit (-0.0 included), and cuFFT
// sees the same contiguous extension the chain builds.
//
// What bounds them: device-memory traffic. Each reads its input once and
// writes its output once, with no arithmetic to speak of; the time to
// beat is bytes / 3.35 TB/s. An extend or a turn writes twice what it
// reads (each value twice, once reversed), an extract reads twice what it
// writes (a complex spectrum of which it keeps the imaginary parts; the
// real parts share their 32-byte sectors).
//
// Design. Where the input's fast axis is the transform's (q), a row
// kernel (extend_rows, extract_rows) walks one row of a block's 1024
// columns per iteration, kRowItems loads in flight a thread, reading
// along q and writing along q: both coalesced, the reversed half too.
// Where the input's fast axis is the other one (p: a y-DST of a row-major
// field, or a turn out of the x-DST's spectrum), a 32 x 32 tile goes
// through shared memory (extend_tile, extract_pad): loads along p,
// stores along q, the tile's pitch 33 so that neither side conflicts on
// the banks (2-way in float64); an extension's tile holds 64 q by 32 p,
// extract_pad's 32 by 32 (64 gained it nothing). The leading axes are at most two batch
// axes with their own strides (ops/dst.py merges the rest), so a member
// axis under vmap or a padded interior needs no copy.
//
// Limits: P, Q + 2 and the rows' count below 2^31, the tiles' grid rows
// at most 65535 (P and Q + 2 below 2,097,152).

#include <cuda_runtime.h>
#include <limits.h>

// A real input (..., P, Q) as the kernels read it: two batch axes of
// b1 x b2, their strides, then the rows (p) and the transform's axis (q),
// every stride in elements. Outside the unnamed namespace: dst_run, which
// takes it, has external linkage.
struct DstPlane {
  long long sb1, sb2, sp, sq;
  int b1, b2, p, q;
};

namespace {

// the operations of dst_run (ops/dst.py)
enum Op { kExtendRows = 0, kExtendTile = 1, kExtractRows = 2,
          kExtractPad = 3 };

constexpr int kRowThreads = 256;
constexpr int kRowItems = 4;
constexpr int kRowSpan = kRowThreads * kRowItems;
constexpr int kTile = 32;
constexpr int kTileRows = 8;
// q entries of an extension's tile: 64 loads of 8 in flight a thread took
// a 3x4801^2 float32 y-extension and turn 10-11% below 32's (PERF.md)
constexpr int kTileQ = 64;
constexpr long long kMaxGrid = 65535;

__device__ __forceinline__ long long batch_offset(const DstPlane& d,
                                                  long long b) {
  return (b / d.b2) * d.sb1 + (b % d.b2) * d.sb2;
}

// z[r, :] = [0, s v, 0, -s rev v] of row r = (batch, p) of the input,
// s = -1 with kNeg.
template <typename T, bool kNeg>
__global__ void __launch_bounds__(kRowThreads)
extend_rows(const T* __restrict__ in, T* __restrict__ z, DstPlane d) {
  const long long rows = (long long)d.b1 * d.b2 * d.p;
  const long long ext = 2LL * d.q + 2;
  const int q0 = blockIdx.x * kRowSpan + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / d.p;
    const int p = (int)(r - b * d.p);
    const T* src = in + batch_offset(d, b) + p * d.sp;
    T* row = z + r * ext;
    T v[kRowItems];
#pragma unroll
    for (int i = 0; i < kRowItems; ++i) {
      const int q = q0 + i * kRowThreads;
      v[i] = q < d.q ? src[q * d.sq] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kRowItems; ++i) {
      const int q = q0 + i * kRowThreads;
      if (q < d.q) {
        const T w = kNeg ? -v[i] : v[i];
        row[1 + q] = w;
        row[2 * d.q + 1 - q] = -w;
      }
    }
    if (q0 == 0) {
      row[0] = T(0);
      row[d.q + 1] = T(0);
    }
  }
}

// The same extension from an input read along p, through a tile: block
// (x, y) owns q in [64x, 64x + 64) and p in [32y, 32y + 32), and walks
// the batches from z.
template <typename T, bool kNeg>
__global__ void __launch_bounds__(kTile * kTileRows)
extend_tile(const T* __restrict__ in, T* __restrict__ z, DstPlane d) {
  __shared__ T tile[kTileQ][kTile + 1];       // [q][p]
  const int p0 = blockIdx.y * kTile, q0 = blockIdx.x * kTileQ;
  const long long ext = 2LL * d.q + 2;
  const long long batches = (long long)d.b1 * d.b2;
  for (long long b = blockIdx.z; b < batches; b += gridDim.z) {
    const T* src = in + batch_offset(d, b);
    const int lp = p0 + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kTileQ; i += kTileRows) {
      const int q = q0 + threadIdx.y + i;
      if (lp < d.p && q < d.q) {
        const T v = src[lp * d.sp + q * d.sq];
        tile[threadIdx.y + i][threadIdx.x] = kNeg ? -v : v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kTileQ; h += kTile) {
      const int q = q0 + h + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kTile; i += kTileRows) {
        const int p = p0 + threadIdx.y + i;
        if (p < d.p) {
          T* row = z + (b * d.p + p) * ext;
          if (q < d.q) {
            const T w = tile[h + threadIdx.x][threadIdx.y + i];
            row[1 + q] = w;
            row[2 * d.q + 1 - q] = -w;
          }
          if (q0 == 0 && h == 0 && threadIdx.x == 0) {
            row[0] = T(0);
            row[d.q + 1] = T(0);
          }
        }
      }
    }
    __syncthreads();                          // before the next batch's tile
  }
}

// out[r, q] = -in[r, q], out contiguous (rows, Q).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
extract_rows(const T* __restrict__ in, T* __restrict__ out, DstPlane d) {
  const long long rows = (long long)d.b1 * d.b2 * d.p;
  const int q0 = blockIdx.x * kRowSpan + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / d.p;
    const int p = (int)(r - b * d.p);
    const T* src = in + batch_offset(d, b) + p * d.sp;
    T* row = out + r * d.q;
    T v[kRowItems];
#pragma unroll
    for (int i = 0; i < kRowItems; ++i) {
      const int q = q0 + i * kRowThreads;
      v[i] = q < d.q ? src[q * d.sq] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kRowItems; ++i) {
      const int q = q0 + i * kRowThreads;
      if (q < d.q) row[q] = -v[i];
    }
  }
}

// out[batch, 1 + q, 1 + p] = (-in[batch, p, q]) * scale, zero on the
// walls; out contiguous (batches, Q + 2, P + 2). Block (x, y) owns the
// output's columns [32x, 32x + 32) and rows [32y, 32y + 32).
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
extract_pad(const T* __restrict__ in, T* __restrict__ out, DstPlane d,
            double scale) {
  __shared__ T tile[kTile][kTile + 1];        // [column][row]
  const T s = T(scale);
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int cols = d.p + 2, rows = d.q + 2;
  const long long plane = (long long)rows * cols;
  const long long batches = (long long)d.b1 * d.b2;
  for (long long b = blockIdx.z; b < batches; b += gridDim.z) {
    const T* src = in + batch_offset(d, b);
    const int q = r0 - 1 + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kTile; i += kTileRows) {
      const int p = c0 - 1 + threadIdx.y + i;
      T v = T(0);
      if (p >= 0 && p < d.p && q >= 0 && q < d.q)
        v = -src[p * d.sp + q * d.sq] * s;
      tile[threadIdx.y + i][threadIdx.x] = v;
    }
    __syncthreads();
    const int c = c0 + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kTile; i += kTileRows) {
      const int r = r0 + threadIdx.y + i;
      if (r < rows && c < cols)
        out[b * plane + (long long)r * cols + c] =
            tile[threadIdx.x][threadIdx.y + i];
    }
    __syncthreads();
  }
}

unsigned capped(long long n) {
  return (unsigned)(n < kMaxGrid ? n : kMaxGrid);
}

template <typename T>
int launch(int op, int negate, const T* in, T* out, const DstPlane& d,
           double scale, cudaStream_t st) {
  if (d.b1 < 1 || d.b2 < 1 || d.p < 1 || d.q < 1 || d.p > INT_MAX - 2
      || d.q > (INT_MAX - 2) / 2)
    return (int)cudaErrorInvalidValue;
  const long long batches = (long long)d.b1 * d.b2;
  const long long rows = batches * d.p;
  const dim3 tile_block(kTile, kTileRows);
  switch (op) {
    case kExtendRows:
    case kExtractRows: {
      const dim3 grid((d.q + kRowSpan - 1) / kRowSpan, capped(rows));
      if (op == kExtractRows)
        extract_rows<T><<<grid, kRowThreads, 0, st>>>(in, out, d);
      else if (negate)
        extend_rows<T, true><<<grid, kRowThreads, 0, st>>>(in, out, d);
      else
        extend_rows<T, false><<<grid, kRowThreads, 0, st>>>(in, out, d);
      break;
    }
    case kExtendTile: {
      const long long gy = (d.p + kTile - 1) / kTile;
      if (gy > kMaxGrid) return (int)cudaErrorInvalidValue;
      const dim3 grid((d.q + kTileQ - 1) / kTileQ, (unsigned)gy,
                      capped(batches));
      if (negate)
        extend_tile<T, true><<<grid, tile_block, 0, st>>>(in, out, d);
      else
        extend_tile<T, false><<<grid, tile_block, 0, st>>>(in, out, d);
      break;
    }
    case kExtractPad: {
      const long long gy = (d.q + 2 + kTile - 1) / kTile;
      if (gy > kMaxGrid) return (int)cudaErrorInvalidValue;
      const dim3 grid((d.p + 2 + kTile - 1) / kTile, (unsigned)gy,
                      capped(batches));
      extract_pad<T><<<grid, tile_block, 0, st>>>(in, out, d, scale);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One operation (Op) on the input `in` described by *d, into `out` (see
// the kernels for each one's layout): float64 where f64, else float32;
// `negate` flips the extensions' input (a turn); `scale` is
// extract_pad's. Returns the launch's CUDA error (0 when it was taken).
int dst_run(int op, int f64, int negate, const void* in, void* out,
            const DstPlane* d, double scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64)
    return launch<double>(op, negate, (const double*)in, (double*)out, *d,
                          scale, st);
  return launch<float>(op, negate, (const float*)in, (float*)out, *d, scale,
                       st);
}

}  // extern "C"
