// Fused QG vorticity leapfrog for the ocean, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel qgcm_tpu/ops/pallas_qg.py::qgstep_pallas
// (pallas_call at :277, body _make_kernel.kernel :71-216): box or
// cyclic-x, optional k247 sponge, in its three modes (pallas_qg.py:
// 227-244):
//   * full field: the arrays are the whole (nl, ny, nx) grid;
//   * row window (row0/ny_total): pom, po and qo are a window of the
//     output rows with 3 ghost rows on each side, whose first output row
//     sits at global row `row0` of a grid `ny_total` rows tall; the walls,
//     the zonal rows and the sponge's beta*y key on global rows, and
//     output rows at or beyond ny_total are padding, written as zeros
//     (parallel/halo.py's deep and overlap schedules);
//   * x_ext (box only): the window also carries 3 real ghost columns on
//     each side, and the W/E walls key on global columns (col0,
//     nx_total); output columns at or beyond nx_total are padding.
// In the window modes qom, wek, ent, r_spl and the output have the
// output's (core) shape: the Pallas kernel's outputs on ghost rows were
// discarded by every caller (halo.py:425, :578), so none is computed.
// The full-field mode also steps the members of an ensemble in one
// launch: `members` copies of the problem, each input with its own
// member stride (0 for an input all members share, such as the wind's
// Ekman pumping), the output members contiguous. The grid's z runs over
// member x layer; a member's arithmetic is the single launch's, point
// for point, whatever strip height the larger launch picks, so the
// batched launch is bit for bit the per-member launches (qgcm_tpu could
// not batch its Pallas kernel: Mosaic's batching corrupted members,
// tests/test_pallas_qg.py:75). A launch of one member takes the
// kernel's kBatched = false instance, whose addresses are those of the
// single-member kernel: the member's offsets cost the float64 kernel
// registers, and with them 16% of its time at 3x961^2.
// One pass computes, per layer k and grid point,
//   del2, del4 of the lagged pressure pom with mixed-BC walls (bcfac),
//   del6 (zero on the edges), the Arakawa 9-point J(qo, po),
//   dqdt = adfac*J + (ah2_k/f0)*del4 - (ah4_k/f0)*del6 (zero on box W/E),
//   layer forcing: layer 0 + f0/H0*(wek - ent), layer 1 + f0/H1*ent,
//   bottom layer - bdrfac*del2,
//   qnew = qom + 2dt*dqdt [+ 2dt*c1spl*r_spl*(qom - beta*y)],
// and the zonal rows keep the old qo.
//
// What bounds it: device-memory traffic. Per point it reads pom, po, qo,
// qom, wek, ent (and r_spl) once and writes qnew once, about 100 flops
// against 6-7 loads: far below the card's flop/byte balance, and no
// product for the tensor cores. The time to beat is bytes / 3.35 TB/s.
// At that rate each SM must finish a grid point every ~1.5 clocks, so
// the instructions issued per point are the next limit: the design below
// is about latency and about those.
//
// What the card's usual tools cannot do here: TMA needs row pitches
// that are multiples of 16 bytes, and 16-byte vector loads need 16-byte
// aligned rows. The grids are 961 or 4801 points wide (3844 / 19204 B
// in float32, 7688 / 38408 B in float64); none is a multiple of 16, and
// padding the pitch would change every other op of the port. So rows
// come in as element-sized cp.async copies (4 B, 8 B in float64), which
// need only element alignment.
//
// The full-field design (also the member mode's). A block owns a strip
// kStripW outputs wide and strip_h rows
// tall, for one layer of one member (blockIdx.z), and marches down it
// one row per iteration with one __syncthreads per row. Thread t owns the window
// columns 2t and 2t+1 (global columns c0 - 3 + 2t and the next) for the
// whole march, so their wall and cyclic-wrap tests are made once; the
// row tests of the S/N walls and the zonal rows are uniform across the
// block.
//   * Every input streams through a ring of kRing row slots per field in
//     shared memory. The copies for iteration s + kAhead are issued
//     (cp.async, one commit group per row) right after the barrier of
//     iteration s, so kAhead rows of every field are in flight while the
//     block computes: 12-18 KB a block in float32, about 100 KB a SM at
//     8 resident blocks, where 3.35 TB/s at ~700 ns latency needs ~20 KB.
//   * The stencils are skewed so that each phase of an iteration reads
//     from shared memory only rows that an earlier iteration finished:
//     at iteration s the block forms del2 at row s-1 (from pom rows
//     s-2..s), del4 at row s-2 (del2 rows s-3..s-1) and the output at row
//     s-3 (del4 rows s-4..s-2, po/qo rows s-4..s-2). po/qo rows are
//     copied 2 rows behind pom and the pointwise fields (qom, wek, ent,
//     r_spl) 3 rows behind, so every field of iteration s lands in ring
//     slot s. Every input row is read from device memory once per strip
//     (halo rows of neighbouring strips mostly from L2), and each
//     del2/del4 value is computed once.
//   * Each thread keeps the rows of its two columns that a stencil still
//     needs (pom, del2, del4, and po/qo with their west and east
//     neighbours) in registers, rotated by one row per iteration; from
//     shared memory come only a new row and the two values beyond its
//     pair that its neighbours produced. del2 and del4 cross between
//     threads through two-row rings.
//   * Two columns a thread halve the per-point share of what every
//     thread pays per row (barrier, copy addresses, row tests, loop), and
//     the pair comes from shared memory in one 8-byte (16-byte) load.
//   * The coefficients are converted to T once, on the host (Coef), and
//     read from the kernel's parameter space.
// The launch geometry (strip height, strip counts) is computed by the
// wrapper, ops/qgstep.py::launch_geometry, from the blocks the card
// holds at once (qgstep_resident_blocks), and checked here.
//
// On an H100 SXM at 700 W this reaches about two thirds of the byte bound
// at 3x4801^2 float32 and about half at 3x961^2 (PERF.md). What is left
// is instruction issue: most instructions are not floating-point but the
// element-wise copies and their addresses, the row and wall tests and the
// register rotation (chip_smoke.py prints the census).
//
// The window design (row window and x_ext). A rank's window is small: a
// quarter of the 961^2 box is 241 rows, 2.3 MB a field, and the whole
// launch reads about 16 MB, which the 50 MB L2 holds. The march fits it
// badly: at its shortest strip (MIN_STRIP_H = 16) 241 rows x 8 strips x
// 3 layers are 384 blocks of 2 warps where the card holds 1056, and a
// 16-row strip spends 6 of its 22 serial iterations filling its pipeline,
// so the launch waits on latency at a quarter of its byte bound. Here a
// block owns a 2-D tile instead, kTileH output rows by kTileW columns of
// one layer, on kGroups row groups of kPairs threads:
//   * thread t owns window columns 2t and 2t+1 (global columns
//     c0 - 3 + 2t and the next), as in the march, with their wall, wrap
//     and padding tests made once; its row group walks its share of each
//     stage's rows down the pair, keeping the rows a stencil still needs
//     in registers;
//   * all copies are issued up front, element-sized cp.async into shared
//     memory: pom over kTileH+6 rows, po and qo over kTileH+2; the
//     pointwise fields (qom, wek, ent, r_spl) of the thread's own output
//     rows go straight into registers with plain loads, which complete
//     while the stencils run;
//   * then three barrier-separated stages: del2 over kTileH+4 rows, del4
//     over kTileH+2 (into pom's space, dead by then), the output over
//     kTileH, each stage's rows rounded up to a whole share a group so
//     that every loop unrolls whole (the extra del2/del4 rows reach no
//     output);
//   * a tile whose stencils meet no wall row, W/E wall or padding row --
//     most of them -- takes the interior forms (lap5 for lap_bc, no
//     zonal or wall tests), a block-uniform branch.
// Three barriers a tile and no pipeline to fill; the halo rows and columns
// of neighbouring tiles are read again, from L2. On an H100 SXM at 700 W
// this reaches about half the byte bound at a rank's 241-row window and
// at a 481^2 x_ext block, twice the march's speed there, and halves a
// 3-row band's time (PERF.md); what is left is instruction issue and the
// launch's fixed cost. Which design a window
// gets is the wrapper's pure function of its shape and the two designs'
// resident blocks (ops/qgstep.py::window_geometry): the tile unless the
// march already fills a wave of the card, as at a 961-row window.
// The tile forms every output with the march's per-point arithmetic:
// lap_bc and jacobian are shared, and lap5 and leapfrog copy the march's
// expressions operand for operand, so a window's outputs are the
// full-field kernel's bit for bit (chip_smoke.py, phase 12). (Calling
// shared functions from the march too cost it 16 instructions and 2-3% at
// 3x961^2 and NAtl's window; the march's source is kept as it was.)
//
// Ghosts outside the input arrays are zeros (box) or the x-wrap (cyclic:
// west of column 0 is column nx-2, east of nx-1 is column 1); every
// output a ghost reaches is overwritten by a wall mask, as in the Pallas
// kernel (pallas_qg.py:14-19). Input rows outside the arrays load zeros;
// output rows and columns beyond the output's shape are never written.
// Values formed in the first iterations of a march, and in the window's
// edge columns, from rows or neighbours that were never loaded, reach no
// output. So do values formed on padding rows and columns (at or beyond
// ny_total / nx_total): the north and east walls' conditions read only
// inward, and every output next to them is a wall output.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 128;     // window columns of a strip
constexpr int kThreads = kWindow / 2;          // two columns a thread
constexpr int kHalo = 3;         // del6 = three nested 5-point stencils
constexpr int kStripW = kWindow - 2 * kHalo;   // output columns per strip
constexpr int kRing = 8;         // row slots per input field
constexpr int kAhead = 6;        // rows of copies in flight
constexpr int kLagPQ = 2;        // po/qo row copied at iteration i: i - 2
constexpr int kLagOut = 3;       // output row of iteration s: s - 3
constexpr int kMaxLayers = 8;
// the window design's tile: window columns (two a thread), output rows,
// and row groups of threads
constexpr int kLanes = 64;
constexpr int kPairs = kLanes / 2;
constexpr int kTileW = kLanes - 2 * kHalo;     // output columns per tile
constexpr int kTileH = 8;
constexpr int kGroups = 4;
static_assert(kTileH % kGroups == 0, "the row groups share the output rows");
// input fields, in ring order; r_spl's ring exists only with the sponge
enum { kPom, kPo, kQo, kQom, kWek, kEnt, kRspl, kStreams };

// pom row s is read at iterations s and s + 1; its slot is refilled by
// the copies issued at iteration s + kRing - kAhead.
static_assert((kRing & (kRing - 1)) == 0 && kRing >= kAhead + 2,
              "a slot is rewritten only after its last read");

}  // namespace

// Must match _QgParams in qgcm_torch/ops/qgstep.py field for field.
struct QgParams {
  // ny, nx: the output's rows and columns (the whole grid in the
  // full-field mode)
  int nl, ny, nx, cyclic, sponge;
  // launch geometry: output columns and rows per strip (or tile), strip
  // (tile) counts, and the design: 0 the march, 1 the window tile
  int strip_w, strip_h, strips_x, strips_y, tiled;
  // the input window of pom/po/qo: its rows and columns, and the input
  // row and column of output (0, 0): (ny, nx, 0, 0) in the full-field
  // mode, (ny + 6, nx, 3, 0) for a row window, (ny + 6, nx + 6, 3, 3) in
  // x_ext mode
  int ny_in, nx_in, gy, gx;
  // the global row and column of output (0, 0) and the global grid's
  // extent, on which the walls, the zonal rows and the padding key
  int row0, col0, ny_total, nx_total;
  // members stepped (1 in the window modes), and each input's member
  // stride in elements, in kernel-argument order (pom, po, qo, qom, wek,
  // ent, rspl); 0 shares one copy among all members
  int members;
  int mstride[7];
  // dxm2, bcfac, adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0, beta*dy,
  // f0/H0, f0/H1
  double c[11];
  double ah2[kMaxLayers];
  double ah4[kMaxLayers];
};

namespace {

// The coefficients in the kernel's type, as the kernel uses them.
template <typename T>
struct Coef {
  T dxm2, bcfac, adfac, tdt, bdrfac, tdt_c1spl, beta_y0, beta_dy;
  T fohfac0, fohfac1;
  T ah2f[kMaxLayers], ah4f[kMaxLayers];  // ah2/f0, ah4/f0 by layer
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// One element from global to shared memory (address `dst` in the shared
// window), asynchronously; with ok == false the slot is filled with zero
// and nothing is read.
template <typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src, bool ok) {
  const int n = ok ? int(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A window row around a thread's two columns: the west neighbour, the
// pair, the east neighbour.
template <typename T>
struct Quad {
  T w, a, b, e;
};

// The row at p (the thread's first column); wo/eo are the offsets of
// the west/east neighbours, clamped to the pair at the window's edges.
template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* p, int wo, int eo) {
  using V = typename Vec2<T>::type;
  const V v = *reinterpret_cast<const V*>(p);
  return {p[wo], v.x, v.y, p[eo]};
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, T a, T b) {
  using V = typename Vec2<T>::type;
  *reinterpret_cast<V*>(p) = V{a, b};
}

// Mixed-BC Laplacian at `row` of one column from its centre, south,
// north, west and east values: the S/N walls win over W/E, and the W/E
// condition applies only in the box (wall_w/wall_e are false when
// cyclic). Copies lap_bc, pallas_qg.py:137-153, and del2_bc,
// stencils.py:92-95. `row` is uniform across the block, so the first
// two tests do not diverge.
template <typename T>
__device__ __forceinline__ T lap_bc(T c, T s, T n, T w, T e, int row, int ny,
                                    bool wall_w, bool wall_e, T dxm2,
                                    T bcfac) {
  if (row == 0) return bcfac * (n - c);
  if (row == ny - 1) return bcfac * (s - c);
  if (wall_w) return bcfac * (e - c);
  if (wall_e) return bcfac * (w - c);
  return dxm2 * (s + n + w + e - T(4) * c);
}

// Arakawa 9-point J(q, p) of one point from its 3x3 neighbourhoods: s,
// c, n are the rows r-1, r, r+1, and w/x/e the columns j-1, j, j+1.
template <typename T>
__device__ __forceinline__ T jacobian(T qsw, T qs, T qse, T qw, T qe, T qnw,
                                      T qn, T qne, T psw, T ps, T pse, T pw,
                                      T pe, T pnw, T pn, T pne) {
  return (qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
         + qe * (pne - pse) - qw * (pnw - psw)
         - qn * (pne - pnw) + qs * (pse - psw)
         + pn * (qne - qnw) - ps * (qse - qsw)
         - pe * (qne - qse) + pw * (qnw - qsw);
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
qgstep_kernel(const T* __restrict__ pom, const T* __restrict__ po,
              const T* __restrict__ qo, const T* __restrict__ qom,
              const T* __restrict__ wek, const T* __restrict__ ent,
              const T* __restrict__ rspl, T* __restrict__ out,
              const QgParams prm, const Coef<T> cf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d2s = reinterpret_cast<T*>(smem_raw);         // [2][kWindow]
  T* d4s = d2s + 2 * kWindow;                      // [2][kWindow]
  T* ring = d4s + 2 * kWindow;                     // [field][kRing][kWindow]
  constexpr int kField = kRing * kWindow;          // one field's ring
  constexpr int M = kRing - 1;

  const int ny = prm.ny, nx = prm.nx, nl = prm.nl;
  const int ny_in = prm.ny_in, nx_in = prm.nx_in, gy = prm.gy;
  const int row0 = prm.row0, ny_total = prm.ny_total;
  const bool cyclic = prm.cyclic != 0, sponge = prm.sponge != 0;
  const T dxm2 = cf.dxm2, bcfac = cf.bcfac;

  const int k = kBatched ? blockIdx.z % nl : blockIdx.z;   // layer
  // the layer's viscosities, selected without indexing the parameter
  // block (which would copy it to local memory)
  T ah2f = cf.ah2f[0], ah4f = cf.ah4f[0];
#pragma unroll
  for (int j = 1; j < kMaxLayers; ++j) {
    if (k == j) {
      ah2f = cf.ah2f[j];
      ah4f = cf.ah4f[j];
    }
  }
  const int r0 = blockIdx.y * prm.strip_h;
  const int r_end = min(r0 + prm.strip_h, ny);     // rows [r0, r_end)
  const int t = threadIdx.x;
  const int x0 = 2 * t;                            // window column of pair
  const int gc0 = blockIdx.x * kStripW - kHalo + x0;  // output column

  // Per column of the pair: where it is read from (its input column, its
  // cyclic wrap of period nx_in - 1 -- the east column duplicates the
  // west one -- or nowhere, a zero ghost of the box), its walls and
  // padding by global column, and whether it is an output column of this
  // strip.
  int cin[2];
  bool col_ok[2], wall_w[2], wall_e[2], writer[2], pad_col[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gc = gc0 + c;
    int src = gc + prm.gx;
    if (cyclic && (src < 0 || src >= nx_in))
      src = (src % (nx_in - 1) + nx_in - 1) % (nx_in - 1);
    col_ok[c] = src >= 0 && src < nx_in;
    cin[c] = col_ok[c] ? src : 0;
    const int g = prm.col0 + gc;                   // global column
    wall_w[c] = !cyclic && g == 0;
    wall_e[c] = !cyclic && g == prm.nx_total - 1;
    pad_col[c] = g >= prm.nx_total;
    writer[c] = x0 + c >= kHalo && x0 + c < kWindow - kHalo && gc < nx;
  }
  const int pt0 = writer[0] ? gc0 : 0, pt1 = writer[1] ? gc0 + 1 : 0;
  // the window's edge threads take their pair for a missing neighbour;
  // what they compute reaches no output
  const int wo = t > 0 ? -1 : 0, eo = t < kThreads - 1 ? 2 : 1;

  // Element offsets within a member are 32-bit: the launch checks
  // nl * ny_in * nx_in < 2^31. A member's offsets are 64-bit.
  const int koff = k * ny * nx;
  const int kin = k * ny_in * nx_in;
  const long long mm = kBatched ? blockIdx.z / nl : 0;     // member
  const T* pom_k = pom + mm * prm.mstride[kPom] + kin;
  const T* po_k = po + mm * prm.mstride[kPo] + kin;
  const T* qo_k = qo + mm * prm.mstride[kQo] + kin;
  const T* qom_k = qom + mm * prm.mstride[kQom] + koff;
  const T* wek_m = wek + mm * prm.mstride[kWek];
  const T* ent_m = ent + mm * prm.mstride[kEnt];
  const T* rspl_m = rspl + mm * prm.mstride[kRspl];
  T* out_k = out + mm * nl * ny * nx + koff;
  const unsigned my_sh =
      static_cast<unsigned>(__cvta_generic_to_shared(ring + x0));
  constexpr unsigned kRowB = kWindow * sizeof(T);
  constexpr unsigned kFieldB = kField * sizeof(T);
  constexpr unsigned kE = sizeof(T);

  // The copies of iteration i into ring slot i: pom row i, po/qo row
  // i - kLagPQ and the pointwise fields of output row i - kLagOut, each
  // only while the strip needs it. Always one commit group.
  auto issue = [&](int i) {
    const unsigned sh = my_sh + (i & M) * kRowB;
    if (i <= r_end + 2) {                          // pom rows r0-3..r_end+2
      const int ri = i + gy;                       // input row
      const bool in = ri >= 0 && ri < ny_in;
      const int off = in ? ri * nx_in : 0;
      cp_async(sh + kPom * kFieldB, pom_k + off + cin[0], in && col_ok[0]);
      cp_async(sh + kPom * kFieldB + kE, pom_k + off + cin[1],
               in && col_ok[1]);
    }
    const int rq = i - kLagPQ;
    if (rq >= r0 - 1 && rq <= r_end) {             // po/qo rows r0-1..r_end
      const int ri = rq + gy;
      const bool in = ri >= 0 && ri < ny_in;
      const int off = in ? ri * nx_in : 0;
      const bool ok0 = in && col_ok[0], ok1 = in && col_ok[1];
      cp_async(sh + kPo * kFieldB, po_k + off + cin[0], ok0);
      cp_async(sh + kPo * kFieldB + kE, po_k + off + cin[1], ok1);
      cp_async(sh + kQo * kFieldB, qo_k + off + cin[0], ok0);
      cp_async(sh + kQo * kFieldB + kE, qo_k + off + cin[1], ok1);
    }
    const int ro = i - kLagOut;
    if (ro >= r0 && ro < r_end) {                  // output rows
      const int off = ro * nx;
      // a column that writes nothing copies nothing (ok = false)
      cp_async(sh + kQom * kFieldB, qom_k + off + pt0, writer[0]);
      cp_async(sh + kQom * kFieldB + kE, qom_k + off + pt1, writer[1]);
      if (k == 0) {
        cp_async(sh + kWek * kFieldB, wek_m + off + pt0, writer[0]);
        cp_async(sh + kWek * kFieldB + kE, wek_m + off + pt1, writer[1]);
      }
      if (k <= 1) {
        cp_async(sh + kEnt * kFieldB, ent_m + off + pt0, writer[0]);
        cp_async(sh + kEnt * kFieldB + kE, ent_m + off + pt1, writer[1]);
      }
      if (sponge) {
        cp_async(sh + kRspl * kFieldB, rspl_m + off + pt0, writer[0]);
        cp_async(sh + kRspl * kFieldB + kE, rspl_m + off + pt1, writer[1]);
      }
    }
    cp_async_commit();
  };

  // The pair's columns, rotated by one row per iteration; at the top of
  // iteration s: pom rows s-2 (S), s-1 (C); del2 rows s-3, s-2; del4
  // rows s-4, s-3; po/qo rows s-4, s-3 with their west and east values.
  T pS[2] = {}, pC[2] = {};
  T d2S[2] = {}, d2C[2] = {};
  T d4S[2] = {}, d4C[2] = {};
  Quad<T> qS = {}, qC = {}, oS = {}, oC = {};

  const int s_first = r0 - kHalo;
  const int s_last = r_end - 1 + kLagOut;
  for (int p = 0; p < kAhead; ++p) issue(s_first + p);

  for (int s = s_first; s <= s_last; ++s) {
    cp_async_wait<kAhead - 1>();                   // this thread's row s
    __syncthreads();                               // everyone's row s
    issue(s + kAhead);
    const T* slot = ring + (s & M) * kWindow + x0;          // iteration s
    const T* prev = ring + ((s - 1) & M) * kWindow + x0;    // iteration s-1

    // del2 at row s-1; the row's own values are the pair's pC
    const T* P = slot + kPom * kField;
    const T pN[2] = {P[0], P[1]};
    T v2[2];
    {
      const T* R = prev + kPom * kField;
      const T w = R[wo], e = R[eo];
      const int g = row0 + s - 1;                  // global row
      v2[0] = lap_bc(pC[0], pS[0], pN[0], w, pC[1], g, ny_total, wall_w[0],
                     wall_e[0], dxm2, bcfac);
      v2[1] = lap_bc(pC[1], pS[1], pN[1], pC[0], e, g, ny_total, wall_w[1],
                     wall_e[1], dxm2, bcfac);
    }
    store_pair(d2s + ((s - 1) & 1) * kWindow + x0, v2[0], v2[1]);

    // del4 at row s-2 (the neighbours' del2 of that row was written at
    // iteration s-1)
    T v4[2];
    {
      const T* R = d2s + ((s - 2) & 1) * kWindow + x0;
      const T w = R[wo], e = R[eo];
      const int g = row0 + s - 2;
      v4[0] = lap_bc(d2C[0], d2S[0], v2[0], w, d2C[1], g, ny_total,
                     wall_w[0], wall_e[0], dxm2, bcfac);
      v4[1] = lap_bc(d2C[1], d2S[1], v2[1], d2C[0], e, g, ny_total,
                     wall_w[1], wall_e[1], dxm2, bcfac);
    }
    store_pair(d4s + ((s - 2) & 1) * kWindow + x0, v4[0], v4[1]);

    // po/qo row s-2 (N)
    const Quad<T> qN = load_quad(slot + kQo * kField, wo, eo);
    const Quad<T> oN = load_quad(slot + kPo * kField, wo, eo);

    // the output at row r = s-3
    const int r = s - kLagOut;
    if (r >= r0) {
      T qnew[2];
      const int gr = row0 + r;                     // global row
      if (gr >= ny_total) {                        // padding
        qnew[0] = T(0);
        qnew[1] = T(0);
      } else if (gr == 0 || gr == ny_total - 1) {
        // the boundary PV relation rewrites these
        qnew[0] = qC.a;
        qnew[1] = qC.b;
      } else {
        const T* D = d4s + (r & 1) * kWindow + x0;
        const T dw = D[wo], de = D[eo];
        const T d6[2] = {
            dxm2 * (d4S[0] + v4[0] + dw + d4C[1] - T(4) * d4C[0]),
            dxm2 * (d4S[1] + v4[1] + d4C[0] + de - T(4) * d4C[1])};
        // interior rows only, so rows r+-1 exist; north is row r+1
        const T jac[2] = {
            jacobian(qS.w, qS.a, qS.b, qC.w, qC.b, qN.w, qN.a, qN.b,
                     oS.w, oS.a, oS.b, oC.w, oC.b, oN.w, oN.a, oN.b),
            jacobian(qS.a, qS.b, qS.e, qC.a, qC.e, qN.a, qN.b, qN.e,
                     oS.a, oS.b, oS.e, oC.a, oC.e, oN.a, oN.b, oN.e)};
        using V = typename Vec2<T>::type;
        const V qm = *reinterpret_cast<const V*>(slot + kQom * kField);
        V wk = {}, en = {}, rs = {};
        if (k == 0) wk = *reinterpret_cast<const V*>(slot + kWek * kField);
        if (k <= 1) en = *reinterpret_cast<const V*>(slot + kEnt * kField);
        if (sponge) rs = *reinterpret_cast<const V*>(slot + kRspl * kField);
        const T qmv[2] = {qm.x, qm.y}, wkv[2] = {wk.x, wk.y};
        const T env[2] = {en.x, en.y}, rsv[2] = {rs.x, rs.y};
        const T betay = cf.beta_y0 + cf.beta_dy * T(gr);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          T dqdt = T(0);
          if (!(wall_w[c] || wall_e[c]))
            dqdt = cf.adfac * jac[c] + ah2f * d4C[c] - ah4f * d6[c];
          if (k == 0) dqdt = dqdt + cf.fohfac0 * (wkv[c] - env[c]);
          if (k == 1) dqdt = dqdt + cf.fohfac1 * env[c];
          if (k == nl - 1) dqdt = dqdt - cf.bdrfac * d2S[c];
          qnew[c] = qmv[c] + cf.tdt * dqdt;
          if (sponge)
            qnew[c] = qnew[c] + cf.tdt_c1spl * rsv[c] * (qmv[c] - betay);
        }
      }
      if (writer[0]) out_k[r * nx + gc0] = pad_col[0] ? T(0) : qnew[0];
      if (writer[1]) out_k[r * nx + gc0 + 1] = pad_col[1] ? T(0) : qnew[1];
    }

    // rotate the windows by one row
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      pS[c] = pC[c]; pC[c] = pN[c];
      d2S[c] = d2C[c]; d2C[c] = v2[c];
      d4S[c] = d4C[c]; d4C[c] = v4[c];
    }
    qS = qC; qC = qN;
    oS = oC; oC = oN;
  }
}

// The window design's per-point arithmetic is the march's above, written
// out operand for operand, so that a window's outputs are the full-field
// kernel's bit for bit.

// The 5-point Laplacian of one point from its centre, south, north,
// west and east values: del6 of del4, as the march forms it.
template <typename T>
__device__ __forceinline__ T lap5(T c, T s, T n, T w, T e, T dxm2) {
  return dxm2 * (s + n + w + e - T(4) * c);
}

// The new PV of one interior point of layer k from its Jacobian, del2,
// del4 and del6 and its pointwise inputs (wk is read in layer 0 only, en
// in layers 0 and 1, rs with the sponge only): dq/dt (zero on a box's
// W/E wall), the layer forcing, the leapfrog and the sponge.
template <typename T>
__device__ __forceinline__ T leapfrog(T jac, T d2, T d4, T d6, T qm, T wk,
                                      T en, T rs, T betay, bool we_wall,
                                      int k, int nl, bool sponge, T ah2f,
                                      T ah4f, const Coef<T>& cf) {
  T dqdt = T(0);
  if (!we_wall) dqdt = cf.adfac * jac + ah2f * d4 - ah4f * d6;
  if (k == 0) dqdt = dqdt + cf.fohfac0 * (wk - en);
  if (k == 1) dqdt = dqdt + cf.fohfac1 * en;
  if (k == nl - 1) dqdt = dqdt - cf.bdrfac * d2;
  T qnew = qm + cf.tdt * dqdt;
  if (sponge) qnew = qnew + cf.tdt_c1spl * rs * (qm - betay);
  return qnew;
}

// The layer's viscosities, selected without indexing the parameter block
// (which would copy it to local memory).
template <typename T>
__device__ __forceinline__ void layer_visc(const Coef<T>& cf, int k, T& ah2f,
                                           T& ah4f) {
  ah2f = cf.ah2f[0];
  ah4f = cf.ah4f[0];
#pragma unroll
  for (int j = 1; j < kMaxLayers; ++j) {
    if (k == j) {
      ah2f = cf.ah2f[j];
      ah4f = cf.ah4f[j];
    }
  }
}

// Where window column gc (an output column; negative and beyond nx in
// the halo) is read from and what it is: its input column, its cyclic
// wrap of period nx_in - 1 (the east column duplicates the west one) or
// nowhere (ok = false: a zero ghost of the box), and its walls and
// padding by global column.
struct Column {
  int cin;
  bool ok, wall_w, wall_e, pad;
};

__device__ __forceinline__ Column window_column(const QgParams& prm, int gc) {
  const bool cyclic = prm.cyclic != 0;
  const int nx_in = prm.nx_in;
  int src = gc + prm.gx;
  if (cyclic && (src < 0 || src >= nx_in))
    src = (src % (nx_in - 1) + nx_in - 1) % (nx_in - 1);
  Column col;
  col.ok = src >= 0 && src < nx_in;
  col.cin = col.ok ? src : 0;
  const int g = prm.col0 + gc;                     // global column
  col.wall_w = !cyclic && g == 0;
  col.wall_e = !cyclic && g == prm.nx_total - 1;
  col.pad = g >= prm.nx_total;
  return col;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A stage's rows, rounded up to a whole number a row group: each group
// walks the same number of rows, so the stages' loops are unrolled whole.
__host__ __device__ constexpr int group_share(int rows) {
  return (rows + kGroups - 1) / kGroups;
}

// The window design (see the head of the file): block (bx, by, k) steps
// output rows [by*kTileH, +kTileH) and columns [bx*kTileW, +kTileW) of
// layer k. Tile row i (0 .. kTileH+5) is output row by*kTileH - 3 + i,
// and window column x (0 .. kLanes-1) output column bx*kTileW - 3 + x,
// in every shared array. Thread (t, g) owns window columns 2t and 2t+1,
// as a thread of the march does, and row group g's share of each
// stage's rows.
template <typename T>
__global__ void __launch_bounds__(kPairs * kGroups)
qgstep_tile_kernel(const T* __restrict__ pom, const T* __restrict__ po,
                   const T* __restrict__ qo, const T* __restrict__ qom,
                   const T* __restrict__ wek, const T* __restrict__ ent,
                   const T* __restrict__ rspl, T* __restrict__ out,
                   const QgParams prm, const Coef<T> cf) {
  using V = typename Vec2<T>::type;
  // Rows a group walks in each stage: del2 at tile rows 1 .., del4 at 2
  // .., the output at 3 ..; del2 and del4 are formed over whole shares,
  // beyond the kTileH+4 and kTileH+2 rows the outputs need, and the rows
  // beyond (read from rows never written) reach no output.
  constexpr int kD2Share = group_share(kTileH + 4);
  constexpr int kD4Share = group_share(kTileH + 2);
  constexpr int kOut = kTileH / kGroups;
  constexpr int kPomRows = kTileH + 2 * kHalo;   // pom: tile rows 0..
  constexpr int kPQRows = kTileH + 2;            // po, qo: rows 2..
  constexpr int kD2Rows = kGroups * kD4Share + 2;   // del2 read: rows 1..
  constexpr int kPomAlloc =                      // pom, then del4 rows 2..
      kPomRows > kGroups * kD4Share ? kPomRows : kGroups * kD4Share;
  static_assert(kGroups * kD2Share + 2 <= kPomRows
                    && kGroups * kD2Share <= kD2Rows,
                "the del2 stage reads copied pom rows and fits its array");
  __shared__ __align__(16) T pom_s[kPomAlloc * kLanes];  // then del4
  __shared__ __align__(16) T po_s[kPQRows * kLanes];
  __shared__ __align__(16) T qo_s[kPQRows * kLanes];
  __shared__ __align__(16) T d2_s[kD2Rows * kLanes];
  T* d4_s = pom_s;

  const int ny = prm.ny, nx = prm.nx, nl = prm.nl;
  const int ny_in = prm.ny_in, nx_in = prm.nx_in, gy = prm.gy;
  const int row0 = prm.row0, ny_total = prm.ny_total;
  const bool sponge = prm.sponge != 0;
  const T dxm2 = cf.dxm2, bcfac = cf.bcfac;
  const int k = blockIdx.z;                        // layer
  T ah2f, ah4f;
  layer_visc(cf, k, ah2f, ah4f);
  const int t = threadIdx.x, grp = threadIdx.y;
  const int x0 = 2 * t;                            // window column of pair
  const int r0 = blockIdx.y * kTileH;              // first output row
  const int gt = row0 + r0 - kHalo;                // global row of tile row 0
  const int gc0 = blockIdx.x * kTileW - kHalo + x0;  // output column
  int cin[2];
  bool col_ok[2], wall_w[2], wall_e[2], writer[2], pad_col[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const Column col = window_column(prm, gc0 + c);
    cin[c] = col.cin;
    col_ok[c] = col.ok;
    wall_w[c] = col.wall_w;
    wall_e[c] = col.wall_e;
    pad_col[c] = col.pad;
    writer[c] = x0 + c >= kHalo && x0 + c < kLanes - kHalo && gc0 + c < nx;
  }
  const int wo = t > 0 ? -1 : 0, eo = t < kPairs - 1 ? 2 : 1;

  const int kin = k * ny_in * nx_in, koff = k * ny * nx;
  const T* pom_k = pom + kin;
  const T* po_k = po + kin;
  const T* qo_k = qo + kin;
  constexpr unsigned kRowB = kLanes * sizeof(T);
  constexpr unsigned kE = sizeof(T);

  // The pair's columns of pom over tile rows 0..kTileH+5 and of po/qo
  // over rows 2..kTileH+3, the row groups taking every kGroups-th row;
  // rows outside the window and columns nowhere load zeros.
  {
    const unsigned shm = static_cast<unsigned>(__cvta_generic_to_shared(
        pom_s + x0));
#pragma unroll
    for (int j = 0; j < group_share(kPomRows); ++j) {
      const int i = grp + j * kGroups;
      if (i >= kPomRows) break;
      const int ri = r0 - kHalo + i + gy;          // input row
      const bool in = ri >= 0 && ri < ny_in;
      const int off = in ? ri * nx_in : 0;
      cp_async(shm + i * kRowB, pom_k + off + cin[0], in && col_ok[0]);
      cp_async(shm + i * kRowB + kE, pom_k + off + cin[1], in && col_ok[1]);
    }
    const unsigned shp = static_cast<unsigned>(__cvta_generic_to_shared(
        po_s + x0));
    const unsigned shq = static_cast<unsigned>(__cvta_generic_to_shared(
        qo_s + x0));
#pragma unroll
    for (int j = 0; j < group_share(kPQRows); ++j) {
      const int i = grp + j * kGroups;
      if (i >= kPQRows) break;
      const int ri = r0 - 1 + i + gy;
      const bool in = ri >= 0 && ri < ny_in;
      const int off = in ? ri * nx_in : 0;
      const bool ok0 = in && col_ok[0], ok1 = in && col_ok[1];
      cp_async(shp + i * kRowB, po_k + off + cin[0], ok0);
      cp_async(shp + i * kRowB + kE, po_k + off + cin[1], ok1);
      cp_async(shq + i * kRowB, qo_k + off + cin[0], ok0);
      cp_async(shq + i * kRowB + kE, qo_k + off + cin[1], ok1);
    }
    cp_async_commit();
  }

  // The pointwise inputs of the group's output rows, into registers
  // (zero where nothing is written).
  const int out_lo = 3 + grp * kOut;               // the group's first row
  T qm[kOut][2], wk[kOut][2], en[kOut][2], rs[kOut][2];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int r = r0 + out_lo + j - kHalo;         // output row
    const bool row_ok = r < ny;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool ok = row_ok && writer[c];
      const int off = ok ? r * nx + gc0 + c : 0;
      qm[j][c] = ok ? qom[koff + off] : T(0);
      wk[j][c] = ok && k == 0 ? wek[off] : T(0);
      en[j][c] = ok && k <= 1 ? ent[off] : T(0);
      rs[j][c] = ok && sponge ? rspl[off] : T(0);
    }
  }

  // A tile whose stencils meet no wall row, no W/E wall column and no
  // padding row (most tiles) takes the interior forms: lap5 for lap_bc,
  // no zonal, padding or wall tests. Its values are lap_bc's and
  // leapfrog's in those cases, bit for bit. Uniform across the block.
  const int gl = prm.col0 + blockIdx.x * kTileW - kHalo;  // lane 0's column
  const bool interior =
      gt >= 0 && gt + kTileH + 5 < ny_total
      && (prm.cyclic != 0 || (gl > 0 && gl + kLanes <= prm.nx_total - 1));

  cp_async_wait<0>();
  __syncthreads();

  auto stages = [&](auto kind) {
    constexpr bool kInterior = decltype(kind)::value;
    auto lap = [&](T c, T s, T n, T w, T e, int g, int col) {
      if constexpr (kInterior) return lap5(c, s, n, w, e, dxm2);
      else return lap_bc(c, s, n, w, e, g, ny_total, wall_w[col],
                         wall_e[col], dxm2, bcfac);
    };

    // del2 at tile rows 1 .. kTileH+4 (d2_s row i-1), as the march forms
    // it: the pair's own values are each other's neighbours
    {
      const int lo = 1 + grp * kD2Share;
      const T* P = pom_s + x0;
      const V s0 = *reinterpret_cast<const V*>(P + (lo - 1) * kLanes);
      const V c0 = *reinterpret_cast<const V*>(P + lo * kLanes);
      T pS[2] = {s0.x, s0.y}, pC[2] = {c0.x, c0.y};
#pragma unroll
      for (int j = 0; j < kD2Share; ++j) {
        const int i = lo + j;
        const T* R = P + i * kLanes;
        const V n = *reinterpret_cast<const V*>(R + kLanes);
        const T w = R[wo], e = R[eo];
        const int g = gt + i;                      // global row
        store_pair(d2_s + (i - 1) * kLanes + x0,
                   lap(pC[0], pS[0], n.x, w, pC[1], g, 0),
                   lap(pC[1], pS[1], n.y, pC[0], e, g, 1));
        pS[0] = pC[0]; pS[1] = pC[1];
        pC[0] = n.x; pC[1] = n.y;
      }
    }
    __syncthreads();

    // del4 at tile rows 2 .. kTileH+3 (d4_s row i-2)
    {
      const int lo = 2 + grp * kD4Share;
      const T* D = d2_s + x0;                      // D[(i-1)*kLanes]: row i
      const V s0 = *reinterpret_cast<const V*>(D + (lo - 2) * kLanes);
      const V c0 = *reinterpret_cast<const V*>(D + (lo - 1) * kLanes);
      T dS[2] = {s0.x, s0.y}, dC[2] = {c0.x, c0.y};
#pragma unroll
      for (int j = 0; j < kD4Share; ++j) {
        const int i = lo + j;
        const T* R = D + (i - 1) * kLanes;
        const V n = *reinterpret_cast<const V*>(R + kLanes);
        const T w = R[wo], e = R[eo];
        const int g = gt + i;
        store_pair(d4_s + (i - 2) * kLanes + x0,
                   lap(dC[0], dS[0], n.x, w, dC[1], g, 0),
                   lap(dC[1], dS[1], n.y, dC[0], e, g, 1));
        dS[0] = dC[0]; dS[1] = dC[1];
        dC[0] = n.x; dC[1] = n.y;
      }
    }
    __syncthreads();

    // the output at tile rows 3 .. kTileH+2, as the march forms it
    {
      const T* D4 = d4_s + x0;                     // D4[(i-2)*kLanes]: row i
      const T* D2 = d2_s + x0;                     // D2[(i-1)*kLanes]: row i
      const T* Q = qo_s + x0;                      // Q[(i-2)*kLanes]: row i
      const T* O = po_s + x0;
      const V s4 = *reinterpret_cast<const V*>(D4 + (out_lo - 3) * kLanes);
      const V c4 = *reinterpret_cast<const V*>(D4 + (out_lo - 2) * kLanes);
      T d4S[2] = {s4.x, s4.y}, d4C[2] = {c4.x, c4.y};
      Quad<T> qS = load_quad(Q + (out_lo - 3) * kLanes, wo, eo);
      Quad<T> qC = load_quad(Q + (out_lo - 2) * kLanes, wo, eo);
      Quad<T> oS = load_quad(O + (out_lo - 3) * kLanes, wo, eo);
      Quad<T> oC = load_quad(O + (out_lo - 2) * kLanes, wo, eo);
      T* out_k = out + koff;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int i = out_lo + j;
        const int r = r0 + i - kHalo;              // output row
        const V n4 = *reinterpret_cast<const V*>(D4 + (i - 1) * kLanes);
        const T v4[2] = {n4.x, n4.y};
        const Quad<T> qN = load_quad(Q + (i - 1) * kLanes, wo, eo);
        const Quad<T> oN = load_quad(O + (i - 1) * kLanes, wo, eo);
        const int gr = row0 + r;                   // global row
        T qnew[2];
        if (!kInterior && gr >= ny_total) {        // padding
          qnew[0] = T(0);
          qnew[1] = T(0);
        } else if (!kInterior && (gr == 0 || gr == ny_total - 1)) {
          qnew[0] = qC.a;                          // keep the old qo
          qnew[1] = qC.b;
        } else {
          const T* D = D4 + (i - 2) * kLanes;
          const T dw = D[wo], de = D[eo];
          const T d6[2] = {lap5(d4C[0], d4S[0], v4[0], dw, d4C[1], dxm2),
                           lap5(d4C[1], d4S[1], v4[1], d4C[0], de, dxm2)};
          const T jac[2] = {
              jacobian(qS.w, qS.a, qS.b, qC.w, qC.b, qN.w, qN.a, qN.b,
                       oS.w, oS.a, oS.b, oC.w, oC.b, oN.w, oN.a, oN.b),
              jacobian(qS.a, qS.b, qS.e, qC.a, qC.e, qN.a, qN.b, qN.e,
                       oS.a, oS.b, oS.e, oC.a, oC.e, oN.a, oN.b, oN.e)};
          const V d2 = *reinterpret_cast<const V*>(D2 + (i - 1) * kLanes);
          const T d2v[2] = {d2.x, d2.y};
          const T betay = cf.beta_y0 + cf.beta_dy * T(gr);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            qnew[c] = leapfrog(jac[c], d2v[c], d4C[c], d6[c], qm[j][c],
                               wk[j][c], en[j][c], rs[j][c], betay,
                               !kInterior && (wall_w[c] || wall_e[c]), k,
                               nl, sponge, ah2f, ah4f, cf);
        }
        if (writer[0] && r < ny)
          out_k[r * nx + gc0] = pad_col[0] ? T(0) : qnew[0];
        if (writer[1] && r < ny)
          out_k[r * nx + gc0 + 1] = pad_col[1] ? T(0) : qnew[1];
        d4S[0] = d4C[0]; d4S[1] = d4C[1];
        d4C[0] = v4[0]; d4C[1] = v4[1];
        qS = qC; qC = qN;
        oS = oC; oC = oN;
      }
    }
  };
  if (interior)
    stages(Flag<true>{});
  else
    stages(Flag<false>{});
}

template <typename T>
int smem_bytes(int sponge) {
  const int fields = sponge ? kStreams : kStreams - 1;
  return (4 + fields * kRing) * kWindow * (int)sizeof(T);
}

// Lets the kernel take `smem` bytes of dynamic shared memory on the
// current device; the limit above 48 KB is raised once per device, not
// per launch.
template <typename T, bool kBatched>
cudaError_t allow_smem(int smem) {
  constexpr int kMaxDevices = 64;
  static int smem_allowed[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > smem_allowed[dev])) {
    e = cudaFuncSetAttribute(qgstep_kernel<T, kBatched>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) smem_allowed[dev] = smem;
  }
  return cudaSuccess;
}

// Blocks of the kernel that the current device holds at once: its SMs
// times the blocks one SM fits (the occupancy calculator).
template <typename Kernel>
int sm_blocks(Kernel kernel, int threads, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *blocks = sms * per_sm;
  return (int)e;
}

template <typename T, bool kBatched>
int resident_blocks(int sponge, int* blocks) {
  const int smem = smem_bytes<T>(sponge);
  const cudaError_t e = allow_smem<T, kBatched>(smem);
  if (e != cudaSuccess) return (int)e;
  return sm_blocks(qgstep_kernel<T, kBatched>, kThreads, smem, blocks);
}

// The window tile's shared memory is static and the same with or without
// the sponge.
template <typename T>
int tile_resident_blocks(int* blocks) {
  return sm_blocks(qgstep_tile_kernel<T>, kPairs * kGroups, 0, blocks);
}

template <typename T>
int launch(const T* pom, const T* po, const T* qo, const T* qom,
           const T* wek, const T* ent, const T* rspl, T* out,
           const QgParams* prm, void* stream) {
  const QgParams& p = *prm;
  const bool full = p.gy == 0 && p.gx == 0;
  const bool rows = p.gy == kHalo && p.gx == 0;
  const bool x_ext = p.gy == kHalo && p.gx == kHalo;
  const bool tiled = p.tiled == 1;
  if (p.nl < 2 || p.nl > kMaxLayers || p.ny < 1 || p.nx < 1
      || (p.tiled != 0 && !tiled) || (tiled && full)
      || !(full || rows || (x_ext && !p.cyclic))
      || p.ny_in != p.ny + 2 * p.gy || p.nx_in != p.nx + 2 * p.gx
      || (full && (p.ny < 3 || p.nx < 3 || p.row0 != 0 || p.col0 != 0
                   || p.ny_total != p.ny || p.nx_total != p.nx))
      || (!x_ext && (p.col0 != 0 || p.nx_total != p.nx))
      || p.ny_total < 3 || p.nx_total < 3 || (p.cyclic && p.nx < 3)
      || (long long)p.nl * p.ny_in * p.nx_in >= (1LL << 31)
      || p.strip_w != (tiled ? kTileW : kStripW) || p.strip_h < 1
      || (tiled && p.strip_h != kTileH)
      || p.strips_x != (p.nx + p.strip_w - 1) / p.strip_w
      || p.strips_y != (p.ny + p.strip_h - 1) / p.strip_h
      || p.strips_y > 65535
      || p.members < 1 || (!full && p.members != 1)
      || (long long)p.members * p.nl > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kStreams; ++i)
    if (p.mstride[i] < 0) return (int)cudaErrorInvalidValue;
  // each product rounded in T, as the plain chain does it
  Coef<T> cf{};
  cf.dxm2 = T(p.c[0]);
  cf.bcfac = T(p.c[1]);
  cf.adfac = T(p.c[2]);
  const T rfnot = T(p.c[3]);
  cf.tdt = T(p.c[4]);
  cf.bdrfac = T(p.c[5]);
  cf.tdt_c1spl = cf.tdt * T(p.c[6]);
  cf.beta_y0 = T(p.c[7]);
  cf.beta_dy = T(p.c[8]);
  cf.fohfac0 = T(p.c[9]);
  cf.fohfac1 = T(p.c[10]);
  for (int k = 0; k < p.nl; ++k) {
    cf.ah2f[k] = T(p.ah2[k]) * rfnot;
    cf.ah4f[k] = T(p.ah4[k]) * rfnot;
  }
  const dim3 grid(p.strips_x, p.strips_y, p.members * p.nl);
  if (tiled) {
    qgstep_tile_kernel<T><<<grid, dim3(kPairs, kGroups), 0,
                            (cudaStream_t)stream>>>(
        pom, po, qo, qom, wek, ent, rspl, out, p, cf);
    return (int)cudaGetLastError();
  }
  const int smem = smem_bytes<T>(p.sponge);
  const cudaError_t e = p.members > 1 ? allow_smem<T, true>(smem)
                                      : allow_smem<T, false>(smem);
  if (e != cudaSuccess) return (int)e;
  if (p.members > 1)
    qgstep_kernel<T, true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        pom, po, qo, qom, wek, ent, rspl, out, p, cf);
  else
    qgstep_kernel<T, false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        pom, po, qo, qom, wek, ent, rspl, out, p, cf);
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

// Blocks of one instance that the current device holds at once: the
// march for one member (instance 0) or several (1), or the window tile
// (2).
int qgstep_resident_blocks(int f64, int sponge, int instance, int* blocks) {
  if (instance == 2)
    return f64 ? tile_resident_blocks<double>(blocks)
               : tile_resident_blocks<float>(blocks);
  if (f64)
    return instance ? resident_blocks<double, true>(sponge, blocks)
                    : resident_blocks<double, false>(sponge, blocks);
  return instance ? resident_blocks<float, true>(sponge, blocks)
                  : resident_blocks<float, false>(sponge, blocks);
}

}  // extern "C"
