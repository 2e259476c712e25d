// Float32 GEMM as three TF32 tensor-core products, for NVIDIA Hopper
// (sm_90a): the GEMM DST's products at solver_precision='high'.
//
// Replaces no Pallas kernel. qgcm_tpu computes the GEMM DST's products
// as XLA dots (qgcm_tpu/solver/helmholtz.py:109-120, `_mm`), and at
// solver_precision='high' asks for jax.lax.Precision.HIGH
// (helmholtz.py:101-107): XLA's three-pass bf16 product on the MXU, about
// 6e-5 relative error in a solve. This kernel is the card's counterpart:
// each operand x is split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi),
// and C = A.B is accumulated in float32 as
//     a_hi.b_hi + (a_lo.b_hi + a_hi.b_lo)
// on mma.sync.m16n8k8 tf32, the two correction products in an accumulator
// of their own so that the large one is rounded once a k-step and not
// three times (the lo.lo term, ~2^-22 relative, is dropped).
// That keeps about float32's accuracy (22 of its 24 bits per product),
// where one TF32 pass would keep 11: the port never runs a DST in single
// TF32 (torch's allow_tf32 stays off).
//
// C[b] = A[b] . B[b] for b < batch, A (M, K) and B (K, N) with arbitrary
// element strides (int64; a batch stride of 0 shares one matrix among the
// batch), C (batch, M, N) contiguous. The DST contracts a field's last axis
// as x . K (x is A, K is B with batch stride 0) and its second-last axis as
// K^T . x (K^T, a transposed view, is A with batch stride 0; x is B), so no
// field is copied or transposed for either axis, and a gradient is the
// same kernel on the transposed strides.
//
// What bounds it: operations. The DST's products are (M, K) x (K, N) with
// M, N, K of 240-2400 (at 961^2: x (3, 959, 479) . (479, 480)); three TF32
// passes need 3 * 2MNK operations at 495 TFLOP/s against (MK + KN + MN) * 4
// bytes at 3.35 TB/s, so the bound is max(6MNK / 495e12, bytes / 3.35e12),
// the first for every shape of the DST.
//
// The design, a simple kernel that is right (wgmma and TMA are later work):
//   * A block computes a 64 x 64 tile of C with 4 warps in a 2 x 2 grid,
//     each warp 32 x 32: 2 (m16) x 4 (n8) mma tiles, 3 mma.sync per tile
//     and k-step of 8.
//   * K advances in slices of kBK = 16 through two shared-memory stages:
//     cp.async fills the next slice while the warps multiply the current
//     one. The fields' rows are 959 or 4799 floats (not multiples of 16
//     bytes), and one operand is often a transposed view, so the copies
//     are 4-byte cp.async, one element each, laid along whichever axis of
//     the operand is contiguous so that a warp's copies coalesce; the
//     zero-fill form (src-size 0) pads the ragged edges of M, N and K.
//   * The hi/lo split is made as the warps read their fragments from
//     shared memory (cvt.rna.tf32.f32, a subtraction, cvt again).
//   * Shared rows are padded (A: 16 + 4, B: 64 + 8 floats) so that the
//     fragment reads of a warp fall on 32 distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;          // rows of C per block
constexpr int kBN = 64;          // columns of C per block
constexpr int kBK = 16;          // depth of one shared-memory slice
constexpr int kThreads = 128;    // 4 warps, 2 x 2, each 32 x 32
constexpr int kApad = kBK + 4;   // A slice row pitch (floats), [m][k]
constexpr int kBpad = kBN + 8;   // B slice row pitch (floats), [k][n]

struct Operands {
  const float* a;
  const float* b;
  float* c;
  int m, n, k;
  long long sab, sam, sak;       // A's batch, row and depth strides
  long long sbb, sbk, sbn;       // B's batch, depth and column strides
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int bytes = valid ? 4 : 0;     // 0: write a zero, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32 (in 32-bit containers)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the copies of K-slice [k0, k0 + kBK) of A and B into one stage.
__device__ __forceinline__ void load_slice(const Operands& p,
                                           const float* a, const float* b,
                                           int m0, int n0, int k0,
                                           float* as, float* bs) {
  const int t = threadIdx.x;
  // A: kBM x kBK elements, 8 a thread; along k where A's rows are
  // contiguous, else along m
  const bool a_rows = p.sak == 1;
#pragma unroll
  for (int i = 0; i < kBM * kBK / kThreads; ++i) {
    int e = t + i * kThreads;
    int r = a_rows ? e / kBK : e % kBM;
    int c = a_rows ? e % kBK : e / kBM;
    int gm = m0 + r, gk = k0 + c;
    bool ok = gm < p.m && gk < p.k;
    const float* src = ok ? a + gm * p.sam + gk * p.sak : a;
    cp_async4(as + r * kApad + c, src, ok);
  }
  // B: kBK x kBN elements, 8 a thread; along n where B's rows are
  // contiguous, else along k
  const bool b_rows = p.sbn == 1;
#pragma unroll
  for (int i = 0; i < kBK * kBN / kThreads; ++i) {
    int e = t + i * kThreads;
    int r = b_rows ? e / kBN : e % kBK;
    int c = b_rows ? e % kBN : e / kBK;
    int gk = k0 + r, gn = n0 + c;
    bool ok = gk < p.k && gn < p.n;
    const float* src = ok ? b + gk * p.sbk + gn * p.sbn : b;
    cp_async4(bs + r * kBpad + c, src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    gemm3xtf32_kernel(Operands p) {
  __shared__ __align__(16) float as[2][kBM * kApad];
  __shared__ __align__(16) float bs[2][kBK * kBpad];

  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const float* a = p.a + batch * p.sab;
  const float* b = p.b + batch * p.sbb;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, q = lane % 4;   // groupID, thread in group

  float acc[2][4][4], small[2][4][4];   // hi.hi; the corrections
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = small[i][j][r] = 0.0f;

  const int slices = (p.k + kBK - 1) / kBK;
  load_slice(p, a, b, m0, n0, 0, as[0], bs[0]);
  cp_async_commit();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) {
      load_slice(p, a, b, m0, n0, (s + 1) * kBK, as[cur ^ 1], bs[cur ^ 1]);
    }
    cp_async_commit();           // an empty group on the last slice
    cp_async_wait<1>();          // slice s has landed (this thread's)
    __syncthreads();             // ... and every thread's

    const float* A = as[cur];
    const float* B = bs[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* r0 = A + (wm + i * 16 + g) * kApad + kk + q;
        const float* r8 = r0 + 8 * kApad;
        split(r0[0], ahi[i][0], alo[i][0]);   // (g,     q)
        split(r8[0], ahi[i][1], alo[i][1]);   // (g + 8, q)
        split(r0[4], ahi[i][2], alo[i][2]);   // (g,     q + 4)
        split(r8[4], ahi[i][3], alo[i][3]);   // (g + 8, q + 4)
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* c0 = B + (kk + q) * kBpad + wn + j * 8 + g;
        split(c0[0], bhi[j][0], blo[j][0]);          // (k = q,     n = g)
        split(c0[4 * kBpad], bhi[j][1], blo[j][1]);  // (k = q + 4, n = g)
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(small[i][j], alo[i], bhi[j]);
          mma_tf32(small[i][j], ahi[i], blo[j]);
          mma_tf32(acc[i][j], ahi[i], bhi[j]);
        }
    }
    __syncthreads();             // the stage is free for slice s + 2
  }

  float* c = p.c + static_cast<long long>(batch) * p.m * p.n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int gm = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        int gn = n0 + wn + j * 8 + 2 * q + (r & 1);
        if (gm < p.m && gn < p.n) {
          c[static_cast<long long>(gm) * p.n + gn] =
              acc[i][j][r] + small[i][j][r];
        }
      }
}

}  // namespace

// C = A . B for `batch` products on `stream`; returns the launch's CUDA
// error (0 on success). Strides are in elements.
extern "C" int gemm3xtf32(const float* a, const float* b, float* c,
                          int batch, int m, int n, int k, long long sab,
                          long long sam, long long sak, long long sbb,
                          long long sbk, long long sbn, void* stream) {
  Operands p{a, b, c, m, n, k, sab, sam, sak, sbb, sbk, sbn};
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  gemm3xtf32_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
