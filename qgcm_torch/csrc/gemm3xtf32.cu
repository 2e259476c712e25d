// Float32 GEMM as three TF32 tensor-core products, for NVIDIA Hopper
// (sm_90a): the GEMM DST's products at solver_precision='high'.
//
// Replaces no Pallas kernel. qgcm_tpu computes the GEMM DST's products
// as XLA dots (qgcm_tpu/solver/helmholtz.py:109-120, `_mm`), and at
// solver_precision='high' asks for jax.lax.Precision.HIGH
// (helmholtz.py:101-107): XLA's three-pass bf16 product on the MXU. This
// kernel is the card's counterpart: each operand x is split into
// hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and C = A.B is summed in
// float32 as
//     a_hi.b_hi + (a_lo.b_hi + a_hi.b_lo)
// with the two correction products in an accumulator of their own (the
// lo.lo term, ~2^-22 relative, is dropped): about float32's accuracy,
// where one TF32 pass would keep 11 bits.
//
// C[b] = A[b] . B for b < batch. A (batch, M, K) is the field, with
// element strides of which the row's or the column's is 1; B (K, N) is a
// constant of the solver, handed over as its hi and lo planes, split once
// per matrix by ops/gemm.py (rounded as cvt.rna.tf32.f32 rounds), K-major:
// plane[p][n][k] with a row pitch padded with zeros to a multiple of 4
// floats (16 bytes, for TMA). C is written through element strides (scb,
// scm, scn): a contraction along a field's second-last axis, C = K^T . x,
// is computed as C^T = x^T . K (the field is A again, through its
// transposed strides) and written transposed.
//
// What bounds it: operations. Three TF32 passes need 3 * 2MNK operations
// at 495 TFLOP/s; the DST's products (M = 3 x 959 ... 3 x 4799 rows, N
// and K of 240-2400) read (MK + KN) * 4 bytes and write MN * 4, far less
// than the operations' time at 3.35 TB/s. What the design does about it:
//   * The products are wgmma.mma_async.m64nNk8.f32.tf32.tf32, the only
//     instruction that reaches the tensor cores' full rate on Hopper: A's
//     fragments from registers, B's hi and lo planes from shared memory.
//   * B reaches shared memory by TMA (one 3-D box of both planes, 32 deep
//     and BN wide, 128-byte swizzled as wgmma reads it) under an mbarrier.
//     B is split once per matrix, not per tile or per call.
//   * The field's rows (959, 479, 480, 239 ... floats) are no multiple of
//     16 bytes, so TMA cannot describe it. A producer warpgroup copies its
//     tile with cp.async in whole 16-byte chunks along the contiguous
//     axis: each line of the tile (a row of 32 depths, or a depth of 128
//     rows) from the aligned chunk that holds its first element, so a line
//     lands shifted by 0-3 floats, which the consumers add back. Each
//     thread's 9 chunks a stage are worked out once a tile, so a copy
//     costs a compare, an add and the cp.async. The copies still cost
//     9-18% of the kernel's time on the H100 (their bytes 2-14%, their
//     issue the rest: PERF.md, timed without them, with copies that read
//     nothing and with each issued twice); the rest is the tensor cores'.
//     Zero fill past M and K; a depth past K that a chunk brings in from
//     the next row is zeroed as it is read.
//     cp.async.mbarrier.arrive signals the same barrier as the TMA. The
//     consumers read their fragments from shared memory and split them in
//     registers: cvt.rna, a subtraction, cvt.
//   * A block is one producer warpgroup (setmaxnreg down) and two consumer
//     warpgroups (setmaxnreg up) over a ring of kStages stages, each 32
//     deep; a tile of C is 128 x BN, 64 rows a consumer, BN in {128, 96,
//     64} chosen by the wrapper so that the tiles fill the 132 SMs
//     (ops/gemm.py::plan). The blocks are persistent: each walks the tiles
//     (batch, row tile, column tile; columns fastest, so that the blocks
//     in flight share the field's rows in L2), the producer loading the
//     next tile while the consumers write the last one.
//   * The consumers keep hi.hi and the corrections in two accumulators of
//     BN / 2 registers each and issue three wgmma a k-step of 8; the
//     tensor cores sum the whole depth. Adding each stage's partial sums
//     into float32 registers instead (promotion) cut the error 4-16x on the
//     H100 for 10-17% more time (PERF.md); both meet the GEMM DST's bars,
//     and the faster is the one kept.
//   * The epilogue stages C in shared memory, 32 columns at a time, and
//     stores it along whichever axis of C is contiguous (C's rows are no
//     multiple of 16 bytes either: coalesced st.global, no TMA store).
//   * No split-K: every element of C is summed in one order, whatever the
//     shape.
// Limits: M, N, K, the tile count and 128 times the field's row or depth
// stride below 2^31; K's planes 16-byte aligned (torch's allocations
// are).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBM = 128;          // rows of C a tile: two consumers of 64
constexpr int kBK = 32;           // depth of a stage: one 128-byte row
constexpr int kThreads = 384;     // producer warpgroup + 2 consumers
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 is the
// 384 x 168 the block is launched with
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kCChunk = 32;       // columns of C staged at a time
constexpr int kCPitch = kCChunk + 1;
// A's stage, in floats. Rows contiguous (A's depth axis has stride 1): a
// row of the tile a line of kRowPitch, its 32 depths from the 16-byte
// chunk that holds the first (9 chunks); columns contiguous: a depth a
// line of kColPitch, its 128 rows from the chunk that holds the first (33
// chunks; the pitch 8 banks apart from line to line).
constexpr int kRowPitch = 36;
constexpr int kColPitch = 136;
constexpr int kAFloats = kBM * kRowPitch;     // >= kBK * kColPitch
constexpr int kCopies = 9;        // chunks a producer thread copies a stage

template <int BN>
struct Tile {
  static constexpr int kStages = BN == 64 ? 6 : 4;
  static constexpr int kPlaneBytes = BN * kBK * 4;   // one plane's box
  static constexpr int kBBytes = 2 * kPlaneBytes;    // hi and lo
  static constexpr int kABytes = kAFloats * 4;
  static constexpr int kCBytes = 2 * 64 * kCPitch * 4;
  // 1024 bytes of slack to align the swizzled planes
  static constexpr int kSmem =
      1024 + kStages * (kBBytes + kABytes) + kCBytes + 2 * kStages * 8;
};

struct Params {
  const float* a;
  float* c;
  int m, n, k;
  long long sab, sam, sak;        // the field as A (batch, M, K)
  long long scb, scm, scn;        // where C[b][m][n] goes
  int tiles_m, tiles_n, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// spins for about 2^35 cycles (over 15 s) traps: a launch error rather
// than a card that hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// one 16-byte chunk; src-size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// arrive on `bar` once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

// both planes' (32 deep, BN wide) box at depth k0, column n0
__device__ __forceinline__ void tma_planes(uint32_t dst, const CUtensorMap* map,
                                           int k0, int n0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n0),
      "r"(0), "r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler's reads and writes of an accumulator on their side of
// the wgmma fences and waits
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x as hi + lo, both TF32 (in 32-bit containers)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// wgmma descriptor of a K-major plane tile: 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t plane_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// D (64 x N, f32) += A (64 x 8, tf32, registers) . B (8 x N, tf32, shared
// memory by descriptor); scale 0 overwrites D
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int scale) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], const uint32_t (&a)[4],
                                          uint64_t desc, int scale) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc, int scale) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));
  }
};


// How far (0-3 floats) element offset `off` of the field lies past a
// 16-byte boundary: where its chunk's copy puts it in a line of A's stage.
__device__ __forceinline__ int shift(unsigned long long base, long long off) {
  return static_cast<int>((base + static_cast<unsigned long long>(off)) & 3);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm3xtf32_kernel(const __grid_constant__ CUtensorMap planes,
                      const Params p) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_smem = smem;                          // S x (hi, lo) boxes
  float* a_smem = reinterpret_cast<float*>(smem + S * T::kBBytes);
  float* c_smem = a_smem + S * kAFloats;           // 2 x 64 x kCPitch
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_smem + 2 * 64 * kCPitch);
  const uint32_t full0 = smem_u32(bars);           // + 8 s: stage s landed
  const uint32_t empty0 = smem_u32(bars + S);      // + 8 s: stage s read

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 128 + 1);   // the copiers, the TMA's bytes
      mbar_init(empty0 + 8 * s, 8);        // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (p.k + kBK - 1) / kBK;
  const bool rows = p.sak == 1;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    // ---- producer: the field's tile by cp.async, the planes by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = threadIdx.x;
    // a 16-byte aligned address for the copies that read nothing
    const float* aligned =
        reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p.a) & ~15ull);
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
      const int m0 = (rest % p.tiles_m) * kBM, n0 = nt * BN;
      // the tile's first element, A(m0, 0), and this thread's chunks: each
      // whole 16-byte chunk, holding at least one element of the tile (so
      // inside the field's allocation), as an offset from the stage's first
      // element, its line's slot in shared memory, and the depth that
      // decides whether it is copied (past K, or a row past M: zero fill)
      const float* tile_a = p.a + (rest / p.tiles_m) * p.sab +
                            static_cast<long long>(m0) * p.sam;
      const unsigned long long words =
          reinterpret_cast<uintptr_t>(tile_a) >> 2;
      int off[kCopies], lim[kCopies], dst[kCopies];
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int e = t + 128 * i;
        if (rows) {              // 128 lines (rows) of 9 chunks
          const int r = e / 9, ch = e - 9 * r;
          const int line = r * static_cast<int>(p.sam);
          const int first = 4 * ch - shift(words, line);
          off[i] = line + first;
          lim[i] = m0 + r < p.m ? first : INT_MAX;
          dst[i] = 4 * (r * kRowPitch + 4 * ch);
        } else {                 // 32 lines (depths) of 33 chunks
          const int kr = min(e / 33, kBK - 1), ch = e - 33 * (e / 33);
          const int line = kr * static_cast<int>(p.sak);
          const int first = 4 * ch - shift(words, line);
          off[i] = line + first;
          lim[i] = m0 + first < p.m ? kr : INT_MAX;
          dst[i] = 4 * (kr * kColPitch + 4 * ch);
        }
      }
      for (int ks = 0; ks < nk; ++ks) {
        const int k0 = ks * kBK;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (t == 0) {
          mbar_expect_tx(full, T::kBBytes);
          tma_planes(smem_u32(b_smem + stage * T::kBBytes), &planes, k0, n0,
                     full);
        }
        const uint32_t as = smem_u32(a_smem + stage * kAFloats);
        const float* stage_a =
            tile_a + (rows ? k0 : static_cast<long long>(k0) * p.sak);
        const int left = p.k - k0;
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          // the columns' 1056 chunks leave the last copy to warp 0
          if (rows || i < kCopies - 1 || t < 32) {
            const bool ok = lim[i] < left;
            cp_async16(as + dst[i], ok ? stage_a + off[i] : aligned, ok);
          }
        }
        cp_async_arrive(full);
        if (++stage == S) { stage = 0; phase ^= 1; }
      }
    }
    // every stage read before the producer leaves
    for (int s = 0; s < S; ++s) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (++stage == S) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- consumers: 64 rows of the tile each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  constexpr int R = BN / 2;       // accumulator registers a thread
  const int cw = wg - 1;
  const int wt = threadIdx.x & 127;
  const int warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = cw * 64 + warp * 16 + g;    // rows r0 and r0 + 8
  float* cs = c_smem + cw * 64 * kCPitch;
  float big[R], small[R];
#pragma unroll
  for (int i = 0; i < R; ++i) big[i] = small[i] = 0.0f;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int nt = tile % p.tiles_n, rest = tile / p.tiles_n;
    const int m0 = (rest % p.tiles_m) * kBM, n0 = nt * BN;
    float* c = p.c + (rest / p.tiles_m) * p.scb;
    // where this thread's elements sit in A's lines, shifted as the
    // producer's chunks put them: rows r0 and r0 + 8 (rows contiguous), or
    // depths q and q + 4 of every k-step (columns contiguous; 4 sak is a
    // multiple of 4)
    const unsigned long long words = reinterpret_cast<uintptr_t>(
        p.a + (rest / p.tiles_m) * p.sab + static_cast<long long>(m0) * p.sam)
        >> 2;
    int at0, at1, line;
    if (rows) {
      at0 = r0 * kRowPitch + shift(words, r0 * static_cast<int>(p.sam));
      at1 = (r0 + 8) * kRowPitch +
            shift(words, (r0 + 8) * static_cast<int>(p.sam));
      line = 1;
    } else {
      at0 = r0 + shift(words, q * static_cast<int>(p.sak));
      at1 = at0 + 8;
      line = kColPitch;
    }
    int prev = 0;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const int k0 = ks * kBK;
      const float* as = a_smem + stage * kAFloats;
      const uint32_t bs = smem_u32(b_smem + stage * T::kBBytes);
      const uint64_t dhi = plane_desc(bs), dlo = plane_desc(bs + T::kPlaneBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        // A(r0, k), A(r0 + 8, k), A(r0, k + 4), A(r0 + 8, k + 4); a
        // depth past K reads a neighbour's element (rows contiguous):
        // zero it
        const int k = kk * 8 + q;
        const bool in0 = k0 + k < p.k, in4 = k0 + k + 4 < p.k;
        const float x0 = as[at0 + k * line], x1 = as[at1 + k * line];
        const float x2 = as[at0 + (k + 4) * line];
        const float x3 = as[at1 + (k + 4) * line];
        uint32_t hi[4], lo[4];
        split(in0 ? x0 : 0.0f, hi[0], lo[0]);
        split(in0 ? x1 : 0.0f, hi[1], lo[1]);
        split(in4 ? x2 : 0.0f, hi[2], lo[2]);
        split(in4 ? x3 : 0.0f, hi[3], lo[3]);
        // 0: the first product of a tile overwrites the accumulator
        const int keep = ks + kk;
        wgmma_fence();
        Wgmma<BN>::mma(small, lo, dhi + 2 * kk, keep);
        Wgmma<BN>::mma(small, hi, dlo + 2 * kk, 1);
        Wgmma<BN>::mma(big, hi, dhi + 2 * kk, keep);
        wgmma_commit();
        wgmma_wait<1>();
        // the last stage's products are done once this one's first are
        // under way
        if (kk == 0 && ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = stage;
      if (++stage == S) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    pin(big);
    pin(small);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // epilogue: 32 columns at a time through shared memory
    const int mw = m0 + cw * 64;
    const bool along_n = p.scn == 1;
#pragma unroll
    for (int cc = 0; cc < BN / kCChunk; ++cc) {
#pragma unroll
      for (int j = 0; j < kCChunk / 8; ++j) {
        const int i = 4 * (cc * (kCChunk / 8) + j);
        const int col = 8 * j + 2 * q, row = warp * 16 + g;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[(row + (e >> 1) * 8) * kCPitch + col + (e & 1)] =
              big[i + e] + small[i + e];
        }
      }
      named_sync(1 + cw);
#pragma unroll
      for (int e = 0; e < 64 * kCChunk / 128; ++e) {
        // along C's contiguous axis: a warp stores 32 columns of a row,
        // or 32 rows of a column
        const int r = along_n ? warp + 4 * e : lane + 32 * (e & 1);
        const int col = along_n ? lane : warp + 4 * (e >> 1);
        const int gm = mw + r, gn = n0 + cc * kCChunk + col;
        if (gm < p.m && gn < p.n)
          c[static_cast<long long>(gm) * p.scm +
            static_cast<long long>(gn) * p.scn] = cs[r * kCPitch + col];
      }
      named_sync(1 + cw);
    }
  }
}

template <int BN>
int launch(const Params& p, const CUtensorMap& map, int grid,
           cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm3xtf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  gemm3xtf32_kernel<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

}  // namespace

// The TMA descriptor (128 bytes, written to `out`) of a constant's planes
// (2, n, pitch) float32 for tiles of `bn` columns: boxes of 32 depths x bn
// columns x both planes, 128-byte swizzled, zero past the edges. Returns
// 0, or the CUresult (-1: no driver entry point).
extern "C" int gemm3xtf32_planes_map(void* out, const float* planes, int n,
                                     int pitch, int bn) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return -1;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(pitch),
                              static_cast<cuuint64_t>(n), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch) * 4,
                                 static_cast<cuuint64_t>(pitch) * n * 4};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(bn), 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(planes), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res == CUDA_SUCCESS) memcpy(out, &map, sizeof(map));
  return static_cast<int>(res);
}

// The dynamic shared memory a block of tile width bn takes (0: no such
// width).
extern "C" int gemm3xtf32_smem(int bn) {
  switch (bn) {
    case 128: return Tile<128>::kSmem;
    case 96: return Tile<96>::kSmem;
    case 64: return Tile<64>::kSmem;
    default: return 0;
  }
}

// C = A . B for `batch` products on `stream`, B given by `map` (made by
// gemm3xtf32_planes_map for the same bn), `grid` persistent blocks.
// Returns the launch's CUDA error (0 on success). Strides are in elements.
extern "C" int gemm3xtf32(const float* a, float* c, const void* map, int bn,
                          int batch, int m, int n, int k, long long sab,
                          long long sam, long long sak, long long scb,
                          long long scm, long long scn, int grid,
                          void* stream) {
  const int tiles_n = (n + bn - 1) / bn, tiles_m = (m + kBM - 1) / kBM;
  Params p{a, c, m, n, k, sab, sam, sak, scb, scm, scn, tiles_m, tiles_n,
           batch * tiles_m * tiles_n};
  CUtensorMap tmap;
  memcpy(&tmap, map, sizeof(tmap));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return launch<128>(p, tmap, grid, s);
    case 96: return launch<96>(p, tmap, grid, s);
    case 64: return launch<64>(p, tmap, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
