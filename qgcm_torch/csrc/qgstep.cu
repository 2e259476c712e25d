// Fused QG vorticity leapfrog for the ocean, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qgcm_tpu/ops/pallas_qg.py::qgstep_pallas
// (pallas_call at :277, body _make_kernel.kernel :71-216) in its
// full-field mode: box or cyclic-x, optional k247 sponge. One pass
// computes, per layer k and grid point,
//   del2, del4 of the lagged pressure pom with mixed-BC walls (bcfac),
//   del6 (zero on the edges), the Arakawa 9-point J(qo, po),
//   dqdt = adfac*J + (ah2_k/f0)*del4 - (ah4_k/f0)*del6 (zero on box W/E),
//   layer forcing: layer 0 + f0/H0*(wek - ent), layer 1 + f0/H1*ent,
//   bottom layer - bdrfac*del2,
//   qnew = qom + 2dt*dqdt [+ 2dt*c1spl*r_spl*(qom - beta*y)],
// and the zonal rows keep the old qo.
//
// Bound: device-memory traffic. Per point it reads pom, po, qo, qom, wek,
// ent (and r_spl) once and writes qnew once; the three nested
// Laplacians and the 9-point Jacobian are ~100 flops, far below the
// card's flop/byte balance. The design keeps every intermediate
// (del2, del4, del6, J) out of device memory: a 2-D block stages its
// pom tile with a 3-point halo in shared memory and shrinks it through
// del2 and del4 there; the radius-1 po/qo reads of the Jacobian go
// straight to global memory and are served by L1. One thread per output
// point, blockIdx.z per layer.
//
// Ghosts outside the domain are zeros (box) or the x-wrap (cyclic: west
// of column 0 is column nx-2, east of nx-1 is column 1); every output a
// ghost reaches is overwritten by a wall mask, as in the Pallas kernel
// (pallas_qg.py:14-19). Rows at or beyond ny are never read or written.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;          // block width (x, contiguous)
constexpr int kBY = 8;           // block height (y)
constexpr int kHalo = 3;         // del6 = three nested 5-point stencils
constexpr int kMaxLayers = 8;

}  // namespace

// Must match QgParams in qgcm_torch/ops/qgstep.py field for field.
struct QgParams {
  int nl, ny, nx, cyclic, sponge, pad;
  // dxm2, bcfac, adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0, beta*dy,
  // f0/H0, f0/H1
  double c[11];
  double ah2[kMaxLayers];
  double ah4[kMaxLayers];
};

namespace {

// Global column of a window column, with the cyclic wrap; -1 marks a
// zero ghost (box, or a row outside the domain).
__device__ __forceinline__ int wrap_col(int gc, int nx, bool cyclic) {
  if (gc >= 0 && gc < nx) return gc;
  if (!cyclic) return -1;
  return gc < 0 ? gc + nx - 1 : gc - nx + 1;
}

template <typename T>
__device__ __forceinline__ T load_or_zero(const T* __restrict__ f, int gr,
                                          int gc, int ny, int nx,
                                          bool cyclic) {
  if (gr < 0 || gr >= ny) return T(0);
  const int c = wrap_col(gc, nx, cyclic);
  return c < 0 ? T(0) : __ldg(f + (size_t)gr * nx + c);
}

// Mixed-BC Laplacian at window point (i, j) of `src` (row stride `ld`),
// whose global position is (gr, gc): the S/N walls win over W/E, and the
// W/E condition applies only off the zonal rows and only in the box
// (copies lap_bc, pallas_qg.py:137-153, and del2_bc, stencils.py:92-95).
template <typename T>
__device__ __forceinline__ T lap_bc(const T* src, int ld, int i, int j,
                                    int gr, int gc, int ny, int nx,
                                    bool cyclic, T dxm2, T bcfac) {
  const T c = src[i * ld + j];
  const T s = src[(i - 1) * ld + j];
  const T n = src[(i + 1) * ld + j];
  const T w = src[i * ld + j - 1];
  const T e = src[i * ld + j + 1];
  if (gr == 0) return bcfac * (n - c);
  if (gr == ny - 1) return bcfac * (s - c);
  if (!cyclic) {
    if (gc == 0) return bcfac * (e - c);
    if (gc == nx - 1) return bcfac * (w - c);
  }
  return dxm2 * (s + n + w + e - T(4) * c);
}

template <typename T>
__global__ void __launch_bounds__(kBX * kBY)
qgstep_kernel(const T* __restrict__ pom, const T* __restrict__ po,
              const T* __restrict__ qo, const T* __restrict__ qom,
              const T* __restrict__ wek, const T* __restrict__ ent,
              const T* __restrict__ rspl, T* __restrict__ out,
              const QgParams prm) {
  constexpr int W0 = kBX + 2 * kHalo, H0 = kBY + 2 * kHalo;  // pom tile
  constexpr int W1 = W0 - 2, H1 = H0 - 2;                    // del2 tile
  constexpr int W2 = W1 - 2, H2 = H1 - 2;                    // del4 tile
  __shared__ T s_pom[H0 * W0];
  __shared__ T s_d2[H1 * W1];
  __shared__ T s_d4[H2 * W2];

  const int ny = prm.ny, nx = prm.nx, nl = prm.nl;
  const bool cyclic = prm.cyclic != 0;
  const T dxm2 = T(prm.c[0]), bcfac = T(prm.c[1]), adfac = T(prm.c[2]);
  const T rfnot = T(prm.c[3]), tdt = T(prm.c[4]), bdrfac = T(prm.c[5]);
  const T c1spl = T(prm.c[6]), beta_y0 = T(prm.c[7]);
  const T beta_dy = T(prm.c[8]), fohfac0 = T(prm.c[9]);
  const T fohfac1 = T(prm.c[10]);

  const int k = blockIdx.z;
  const int r0 = blockIdx.y * kBY, c0 = blockIdx.x * kBX;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  constexpr int nthr = kBX * kBY;
  const size_t plane = (size_t)ny * nx;
  const T* pom_k = pom + k * plane;

  // Stage the pom tile with its 3-point halo (window origin r0-3, c0-3).
  for (int t = tid; t < H0 * W0; t += nthr) {
    const int i = t / W0, j = t - i * W0;
    s_pom[t] = load_or_zero(pom_k, r0 - kHalo + i, c0 - kHalo + j, ny, nx,
                            cyclic);
  }
  __syncthreads();

  // del2 on the tile shrunk by one (window origin r0-2, c0-2).
  for (int t = tid; t < H1 * W1; t += nthr) {
    const int i = t / W1, j = t - i * W1;
    s_d2[t] = lap_bc(s_pom, W0, i + 1, j + 1, r0 - 2 + i, c0 - 2 + j, ny, nx,
                     cyclic, dxm2, bcfac);
  }
  __syncthreads();

  // del4 on the tile shrunk by two (window origin r0-1, c0-1).
  for (int t = tid; t < H2 * W2; t += nthr) {
    const int i = t / W2, j = t - i * W2;
    s_d4[t] = lap_bc(s_d2, W1, i + 1, j + 1, r0 - 1 + i, c0 - 1 + j, ny, nx,
                     cyclic, dxm2, bcfac);
  }
  __syncthreads();

  const int gr = r0 + threadIdx.y, gc = c0 + threadIdx.x;
  if (gr >= ny || gc >= nx) return;
  const size_t idx = k * plane + (size_t)gr * nx + gc;

  const bool zonal = gr == 0 || gr == ny - 1;
  if (zonal) {  // the boundary PV relation overwrites these rows later
    out[idx] = qo[idx];
    return;
  }
  const bool we_wall = !cyclic && (gc == 0 || gc == nx - 1);

  // del6 at the centre from the del4 tile; zero on the edges.
  const int i4 = threadIdx.y + 1, j4 = threadIdx.x + 1;
  const T d4c = s_d4[i4 * W2 + j4];
  T d6 = T(0);
  T jac = T(0);
  if (!we_wall) {
    d6 = dxm2 * (s_d4[(i4 - 1) * W2 + j4] + s_d4[(i4 + 1) * W2 + j4]
                 + s_d4[i4 * W2 + j4 - 1] + s_d4[i4 * W2 + j4 + 1]
                 - T(4) * d4c);
    // Arakawa 9-point J(q, p): interior rows only, so rows gr+-1 exist.
    const T* q = qo + k * plane;
    const T* p = po + k * plane;
    const size_t rn = (size_t)(gr + 1) * nx, rc = (size_t)gr * nx;
    const size_t rs = (size_t)(gr - 1) * nx;
    const int ce = wrap_col(gc + 1, nx, cyclic);
    const int cw = wrap_col(gc - 1, nx, cyclic);
    const T qe = __ldg(q + rc + ce), qw = __ldg(q + rc + cw);
    const T qn = __ldg(q + rn + gc), qs = __ldg(q + rs + gc);
    const T qne = __ldg(q + rn + ce), qnw = __ldg(q + rn + cw);
    const T qse = __ldg(q + rs + ce), qsw = __ldg(q + rs + cw);
    const T pe = __ldg(p + rc + ce), pw = __ldg(p + rc + cw);
    const T pn = __ldg(p + rn + gc), ps = __ldg(p + rs + gc);
    const T pne = __ldg(p + rn + ce), pnw = __ldg(p + rn + cw);
    const T pse = __ldg(p + rs + ce), psw = __ldg(p + rs + cw);
    jac = (qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
          + qe * (pne - pse) - qw * (pnw - psw)
          - qn * (pne - pnw) + qs * (pse - psw)
          + pn * (qne - qnw) - ps * (qse - qsw)
          - pe * (qne - qse) + pw * (qnw - qsw);
  }

  T dqdt = T(0);
  if (!we_wall) {
    const T ah2k = T(prm.ah2[k]), ah4k = T(prm.ah4[k]);
    dqdt = adfac * jac + (ah2k * rfnot) * d4c - (ah4k * rfnot) * d6;
  }
  const size_t i2 = (size_t)gr * nx + gc;
  if (k == 0) dqdt = dqdt + fohfac0 * (wek[i2] - ent[i2]);
  if (k == 1) dqdt = dqdt + fohfac1 * ent[i2];
  if (k == nl - 1) {
    const T d2c = s_d2[(threadIdx.y + 2) * W1 + threadIdx.x + 2];
    dqdt = dqdt - bdrfac * d2c;
  }

  const T qm = qom[idx];
  T qnew = qm + tdt * dqdt;
  if (prm.sponge) {
    const T betay = beta_y0 + beta_dy * T(gr);
    qnew = qnew + (tdt * c1spl) * rspl[i2] * (qm - betay);
  }
  out[idx] = qnew;
}

template <typename T>
int launch(const T* pom, const T* po, const T* qo, const T* qom,
           const T* wek, const T* ent, const T* rspl, T* out,
           const QgParams* prm, void* stream) {
  if (prm->nl < 2 || prm->nl > kMaxLayers || prm->ny < 3 || prm->nx < 3)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBX, kBY, 1);
  const dim3 grid((prm->nx + kBX - 1) / kBX, (prm->ny + kBY - 1) / kBY,
                  prm->nl);
  qgstep_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      pom, po, qo, qom, wek, ent, rspl, out, *prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int qgstep_f32(const float* pom, const float* po, const float* qo,
               const float* qom, const float* wek, const float* ent,
               const float* rspl, float* out, const QgParams* prm,
               void* stream) {
  return launch<float>(pom, po, qo, qom, wek, ent, rspl, out, prm, stream);
}

int qgstep_f64(const double* pom, const double* po, const double* qo,
               const double* qom, const double* wek, const double* ent,
               const double* rspl, double* out, const QgParams* prm,
               void* stream) {
  return launch<double>(pom, po, qo, qom, wek, ent, rspl, out, prm, stream);
}

}  // extern "C"
