// Pressure-stencil kernels of the multigrid: damped-Jacobi sweeps
//     x <- x + omega * (b - A x) / diag,
//     A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x),
// several per launch, on (ny, nx) float32 or bfloat16 fields, or on B
// cases stacked as (B, ny, nx) (blockIdx.z is the case, each computed as
// if alone: a fleet's levels, in one launch for all its cases). A
// neighbour beyond the domain reads as 0.
//
//   jacobi_multisweep  iters <= halo sweeps            -> x
//     replaces tpufoam/ops/stencil.py `jacobi_multisweep_pallas` (l.520,
//     body `_make_multisweep_kernel` l.302)
//   smooth_residual    iters <= halo - 1 sweeps, then r = b - A x -> (x, r)
//     replaces `smooth_residual_pallas` (l.629, body l.578)
//   corr_smooth        x + corr, then iters <= halo sweeps -> x
//     replaces `corr_smooth_pallas` (l.722, body l.672)
// with halo = 8 for float32 and 16 for bfloat16, the TPU kernels' limits.
// All three launch the run kernel (multisweep_run_kernel, below the
// single-pass kernels: every operand read once, 16 bytes at a time, and
// kept on chip for the sweeps; smooth_residual's residual in one more pass
// over a halo one ring deeper; in bfloat16 too the division skips
// __fdiv_rn's slow path on a zero dividend) on aligned planes whose width
// is a whole number of 16-byte runs, and the region kernel
// (pressure_stencil_kernel) elsewhere; one sweep of jacobi_multisweep is
// one pass of the single-pass kernels.
// Two single-pass functions on (ny, nx) fields or on B planes stacked as
// (B, ny, nx) (blockIdx.z is the plane), each in two variants (the vector
// and the cell kernel, below the multisweep kernels):
//
//   stencil_matvec     y = A x                           -> y
//     replaces `stencil_matvec_pallas` (l.221, body `_make_matvec_kernel`
//     l.198, `_stencil` l.173)
//   jacobi_sweep       one sweep x + omega * (b - A x) / diag -> x
//     replaces `jacobi_sweep_pallas` (l.245, body `_make_jacobi_kernel`
//     l.208); the wrapper launches it once per sweep, as the TPU kernel
//     loops one pallas_call per sweep
//
// Bound: bytes. Each reads 7 (corr_smooth 8) fields and writes 1
// (smooth_residual 2): 33.6 MB per jacobi_multisweep call at 512 x 2048
// in float32, 10.0 us at 3.35 TB/s; half that in bfloat16. A few dozen
// operations per cell and sweep stay far below the card's rates.
// stencil_matvec reads 6 fields and writes 1 (29.4 MB at 512 x 2048 in
// float32, 8.8 us; 4.4 us in bfloat16), jacobi_sweep 7 and 1 per sweep.
// On the card (tools/kernel_times.py, L2 flushed as chip_smoke.py does)
// The one-cell kernel alone took 14.4 us in float32 and 11.1 us in bfloat16
// at 512 x 2048; its thread keeps little in flight (ten scalar loads, a
// half-line a warp in bfloat16) and reads x five times through L1. The
// vector variant below moves 16 bytes a load and keeps x's rows in
// registers: 13.9 and 8.8 us (a copy of the same bytes takes 12.0 us
// under that flush, whose dirty lines every timed kernel writes back).
//
// Design of the region kernel (simple and exact; it takes the odd widths,
// such as the Schaefer-Turek levels, and operands off 16 bytes). A block
// owns a square region of REGION x REGION cells: an output tile of
// (REGION - 2h)^2 cells and a halo of h cells on each side, with h = iters
// (smooth_residual: iters + 1, its residual reads one more ring), chosen
// at launch so that the redundant halo work stays small on the paths' 1-2
// sweeps. x lives in shared memory as float (two buffers, ping-pong); the
// coefficients and b are read from global memory, where they stay in
// L1/L2 across the sweeps.
// Cells beyond the domain load x = b = c_* = 0 and diag = 1 (the TPU
// kernels' padding: diag divides), so they stay exactly 0 under every
// sweep; the kernel never reads out of range and never wraps east-west.
// The region's outer ring is never updated: after sweep k a cell is exact
// if it lies at least k cells inside the ring (the trapezoid argument), so
// the tile is exact for iters <= h.
//
// Rounding. Every operation rounds to the operand type in the order the
// plain PyTorch version (and the TPU kernel) computes it: products and
// sums with __fmul_rn/__fsub_rn/__fadd_rn (never contracted into FMAs),
// the division with __fdiv_rn (div_rn in the single-pass and run
// kernels: the same quotient), and for bfloat16 a round to bfloat16 after
// each of them; omega arrives rounded to the operand type. So the kernel
// and the plain version compute the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int REGION = 64;
constexpr int CELLS = REGION * REGION;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_GRID_Z = 65535;   // the cases of one stacked launch

enum Mode { kMultisweep = 0, kSmoothResidual = 1, kCorrSmooth = 2 };

template <typename T> struct Num;

template <> struct Num<float> {
  static constexpr int kHalo = 8;
  static __device__ __forceinline__ float load(const float* p, long g) {
    return __ldg(p + g);
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, long g, float v) {
    p[g] = v;
  }
};

template <> struct Num<__nv_bfloat16> {
  static constexpr int kHalo = 16;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                              long g) {
    return __bfloat162float(p[g]);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long g,
                                              float v) {
    p[g] = __float2bfloat16_rn(v);
  }
};

struct Coef {
  float ce, cw, cn, cs, d, b;
};

// The window launch of jacobi_multisweep (the sharded TPU kernel
// `jacobi_multisweep_pallas_sharded`, l.886: the multisweep per mesh
// block on halo-extended blocks). On a card that holds the global (ny,
// nx) operands one launch sweeps all of that card's blocks of the mesh:
// blockIdx.z is a block, at origin (oy[z], ox[z]) of (nyl, nxl) cells.
// Its tiles cover only the block's interior and read the global operands
// in place (row stride nx). A cell outside the block's haloed window (the
// block extended by hy rows and hx columns, 0 along an axis the mesh does
// not split) or outside the domain loads as 0 and is never updated: the
// content of the haloed block the exchange route builds. The diag of
// every loaded cell is filled as the sharded wrappers fill the haloed
// diag when an axis is split (zero -> 1: the JAX wrapper's guard against
// the halo's zero dividends). A tile stores only its cells inside the
// block, straight into the global output. So the window launch equals
// the kernel on the haloed blocks, cropped, bit for bit, with one launch
// a card and nothing around it. Taken by one sweep (the single-pass
// kernels' two variants) and by the run kernel; the region kernel's
// planes (widths that are no whole number of runs, unaligned operands)
// take the exchange route (ops/sharded.py).
constexpr int MAX_WINDOW_BLOCKS = 64;

struct Window {
  int nyl, nxl, hy, hx;
  int oy[MAX_WINDOW_BLOCKS], ox[MAX_WINDOW_BLOCKS];
};
// the kernels' launches over whole planes take no window (and so keep
// their parameter block as it was)
struct NoWindow {};
template <bool WINDOW>
using WindowOf = std::conditional_t<WINDOW, Window, NoWindow>;

// The cells of one launch's block z: where they load (else 0, frozen),
// where they store, whether diag is filled, and the block's origin.
struct Bounds {
  int oy, ox, y_lo, y_hi, x_lo, x_hi, y_end, x_end;
  bool fill;
};

template <bool WINDOW>
__device__ __forceinline__ Bounds bounds_of(const WindowOf<WINDOW>& win,
                                            int z, int ny, int nx) {
  if constexpr (WINDOW) {
    const int oy = win.oy[z], ox = win.ox[z];
    return Bounds{oy, ox, max(oy - win.hy, 0),
                  min(oy + win.nyl + win.hy, ny), max(ox - win.hx, 0),
                  min(ox + win.nxl + win.hx, nx), oy + win.nyl,
                  ox + win.nxl, (win.hy | win.hx) != 0};
  } else {
    return Bounds{0, 0, 0, ny, 0, nx, ny, nx, false};
  }
}

// the operands of one cell; beyond the domain 0, and diag 1
template <typename T>
__device__ Coef load_coef(const T* __restrict__ b, const T* __restrict__ ce,
                          const T* __restrict__ cw, const T* __restrict__ cn,
                          const T* __restrict__ cs, const T* __restrict__ dg,
                          bool inside, long g) {
  if (!inside) return Coef{0.f, 0.f, 0.f, 0.f, 1.f, 0.f};
  using N = Num<T>;
  return Coef{N::load(ce, g), N::load(cw, g), N::load(cn, g), N::load(cs, g),
              N::load(dg, g), N::load(b, g)};
}

// A x at one cell, from x at the cell (xc) and its four neighbours:
// ((((diag*x - ce*xe) - cw*xw) - cn*xn) - cs*xs), rounded at every step
template <typename T>
__device__ float apply_a(const Coef& k, float xc, float xe, float xw,
                         float xn, float xs) {
  using N = Num<T>;
  float a = N::rnd(__fmul_rn(k.d, xc));
  a = N::rnd(__fsub_rn(a, N::rnd(__fmul_rn(k.ce, xe))));
  a = N::rnd(__fsub_rn(a, N::rnd(__fmul_rn(k.cw, xw))));
  a = N::rnd(__fsub_rn(a, N::rnd(__fmul_rn(k.cn, xn))));
  a = N::rnd(__fsub_rn(a, N::rnd(__fmul_rn(k.cs, xs))));
  return a;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
pressure_stencil_kernel(const T* __restrict__ x0, const T* __restrict__ corr,
                        const T* __restrict__ b, const T* __restrict__ ce,
                        const T* __restrict__ cw, const T* __restrict__ cn,
                        const T* __restrict__ cs, const T* __restrict__ dg,
                        T* __restrict__ x_out, T* __restrict__ r_out,
                        int ny, int nx, int iters, int halo, float omega) {
  using N = Num<T>;
  __shared__ float buf[2][CELLS];
  const int tile = REGION - 2 * halo;
  const int gy0 = blockIdx.y * tile - halo;
  const int gx0 = blockIdx.x * tile - halo;
  const long plane = (long)blockIdx.z * ny * nx;   // the case of a stack

  // load x (x + corr for the up leg) into both buffers: the frozen ring
  // and the cells beyond the domain then hold their value in either
  for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
    const int gy = gy0 + idx / REGION;
    const int gx = gx0 + idx % REGION;
    float v = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const long g = plane + (long)gy * nx + gx;
      v = N::load(x0, g);
      if (MODE == kCorrSmooth) v = N::rnd(__fadd_rn(v, N::load(corr, g)));
    }
    buf[0][idx] = v;
    buf[1][idx] = v;
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < iters; ++s) {
    const float* src = buf[cur];
    float* dst = buf[cur ^ 1];
    for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
      const int r = idx / REGION;
      const int c = idx % REGION;
      if (r == 0 || r == REGION - 1 || c == 0 || c == REGION - 1) continue;
      const int gy = gy0 + r;
      const int gx = gx0 + c;
      const bool inside = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
      const Coef k = load_coef<T>(b, ce, cw, cn, cs, dg, inside,
                                  plane + (long)gy * nx + gx);
      const float xc = src[idx];
      const float ax = apply_a<T>(k, xc, src[idx + 1], src[idx - 1],
                                  src[idx + REGION], src[idx - REGION]);
      float t = N::rnd(__fsub_rn(k.b, ax));
      t = N::rnd(__fmul_rn(omega, t));
      t = N::rnd(__fdiv_rn(t, k.d));
      dst[idx] = N::rnd(__fadd_rn(xc, t));
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* xf = buf[cur];
  for (int idx = threadIdx.x; idx < tile * tile; idx += THREADS) {
    const int r = halo + idx / tile;
    const int c = halo + idx % tile;
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    if (gy >= ny || gx >= nx) continue;
    const long g = plane + (long)gy * nx + gx;
    const int i = r * REGION + c;
    N::store(x_out, g, xf[i]);
    if (MODE == kSmoothResidual) {
      const Coef k = load_coef<T>(b, ce, cw, cn, cs, dg, true, g);
      const float ax = apply_a<T>(k, xf[i], xf[i + 1], xf[i - 1],
                                  xf[i + REGION], xf[i - REGION]);
      N::store(r_out, g, __fsub_rn(k.b, ax));
    }
  }
}

// ---- the single-pass kernels: stencil_matvec and jacobi_sweep ----------
//
//   vector (stencil_run_kernel): a thread owns a run of RUN consecutive
//     cells (16 bytes: 4 in float32, 8 in bfloat16), loaded and stored as
//     one 16-byte vector per field, and walks down a strip of `rows` rows.
//     It keeps x of rows y-1, y and y+1 over its run in registers and
//     rotates them, so each x element is loaded about once (the strip's
//     two edge rows twice), instead of three times through L1. A row
//     issues all its loads (x of the next row, the row's coefficients, the
//     segment-edge scalars) before it computes: 96 bytes a thread in
//     flight, at most 85 registers (three blocks of 256 threads an SM).
//     E/W neighbours come from the run itself and, at its ends, from the
//     neighbouring lanes (__shfl_*_sync within a segment of `seg` lanes
//     that share a row); only a segment's first and last lanes read one
//     scalar each from memory. Taken on large planes whose rows all start
//     16-byte aligned: nx a multiple of RUN, every operand's base 16-byte
//     aligned, at least 2^19 cells (ops/stencil.py `_VECTOR_MIN_CELLS`):
//     the finest level of the hybrid main path, in both dtypes.
//   cell (stencil_cell_kernel): the first port's kernel, one cell a
//     thread, its x neighbours read again through L1. Any width, any
//     alignment (odd widths such as 1375 and 43, offset views), and the
//     smaller planes: there a launch costs about its floor (~1.2-1.6 us
//     on the H100), and the one-cell thread, the shortest, measured
//     fastest (tools/kernel_times.py: the vector variant lost 0.2-0.7 us
//     a launch on the levels of 128 x 512 and below, warm or flushed).
// The launch geometry (variant, cells per thread, rows per thread, block
// and grid) is computed in Python (ops/stencil.py `pass_geometry`) and
// checked here; the grid covers every cell of every plane exactly once.
// Neighbours beyond the plane read as 0 (the zero-padded shifts of the
// plain version): loads are bounded by the row and the plane, so the
// kernels never read out of range and never wrap east-west. In the vector
// variant every lane of a warp runs every row of its strip (rows and runs
// beyond the plane load 0 and store nothing), so the shuffles see whole
// warps.

constexpr int PASS_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// A run of 16 bytes in four 32-bit words: float32 cells one a word,
// bfloat16 cells two a word (the lower cell in the low half), widened to
// float exactly where they are used.
struct Pack {
  unsigned w[4];
};

template <typename T> struct Cell;

template <> struct Cell<float> {
  static constexpr int kRun = 4;
  static __device__ __forceinline__ float get(const Pack& p, int k) {
    return __uint_as_float(p.w[k]);
  }
  static __device__ __forceinline__ void put(Pack& p, int k, float v) {
    p.w[k] = __float_as_uint(v);
  }
  // cells k+1 (E) and k-1 (W) of each word's cells, within the run
  static __device__ __forceinline__ unsigned next(const Pack& p, int j) {
    return j + 1 < 4 ? p.w[j + 1] : 0u;
  }
  static __device__ __forceinline__ unsigned prev(const Pack& p, int j) {
    return j > 0 ? p.w[j - 1] : 0u;
  }
  // the run's last cell followed by the next run's first (E of the last)
  static __device__ __forceinline__ unsigned tail(unsigned last,
                                                  unsigned next_first) {
    return next_first;
  }
  // the previous run's last cell and the run's first (W of the first)
  static __device__ __forceinline__ unsigned head(unsigned prev_last,
                                                  unsigned first) {
    return prev_last;
  }
  // a word with its zero cells (either sign) made 1
  static __device__ __forceinline__ unsigned one_for_zero(unsigned w) {
    return w << 1 ? w : 0x3f800000u;
  }
};

template <> struct Cell<__nv_bfloat16> {
  static constexpr int kRun = 8;
  // bfloat16 -> float is exact: the 16 bits become the float's top half
  static __device__ __forceinline__ float get(const Pack& p, int k) {
    const unsigned w = p.w[k >> 1];
    return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ void put(Pack& p, int k, float v) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    p.w[k >> 1] = k & 1 ? (p.w[k >> 1] & 0xffffu) | b << 16 : b;
  }
  static __device__ __forceinline__ unsigned next(const Pack& p, int j) {
    return __byte_perm(p.w[j], j + 1 < 4 ? p.w[j + 1] : 0u, 0x5432);
  }
  static __device__ __forceinline__ unsigned prev(const Pack& p, int j) {
    return __byte_perm(j > 0 ? p.w[j - 1] : 0u, p.w[j], 0x5432);
  }
  static __device__ __forceinline__ unsigned tail(unsigned last,
                                                  unsigned next_first) {
    return __byte_perm(last, next_first, 0x5432);
  }
  static __device__ __forceinline__ unsigned head(unsigned prev_last,
                                                  unsigned first) {
    return __byte_perm(prev_last, first, 0x5432);
  }
  static __device__ __forceinline__ unsigned one_for_zero(unsigned w) {
    const unsigned lo = w & 0x7fffu ? w & 0xffffu : 0x3f80u;
    const unsigned hi = w & 0x7fff0000u ? w & 0xffff0000u : 0x3f800000u;
    return hi | lo;
  }
};

// diag's run with its zero cells made 1 where `fill`
template <typename T>
__device__ __forceinline__ Pack filled(Pack p, bool fill) {
  if (fill) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p.w[j] = Cell<T>::one_for_zero(p.w[j]);
  }
  return p;
}

// The 16-byte run at `run`, or 0 when it lies beyond the plane (!in).
template <typename T>
__device__ __forceinline__ Pack load_run(const T* run, bool in) {
  Pack p{{0u, 0u, 0u, 0u}};
  if (in) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(run));
    p.w[0] = q.x; p.w[1] = q.y; p.w[2] = q.z; p.w[3] = q.w;
  }
  return p;
}

// t / d rounded to nearest, as __fdiv_rn. __fdiv_rn sends a zero dividend
// down its slow path, and a warp waits for its slowest lane: on a real
// operator the solid cells (b = x = 0) give t = 0 on every sweep. For a
// nonzero d that is not NaN, 0 / d is a zero of sign(t) XOR sign(d), so
// that sign is all that is computed there.
__device__ __forceinline__ float div_rn(float t, float d) {
  const bool zero = t == 0.f && fabsf(d) > 0.f;
  const float q = __fdiv_rn(zero ? 1.f : t, d);
  return zero ? __int_as_float((__float_as_int(t) ^ __float_as_int(d))
                               & 0x80000000)
              : q;
}

// A x at a cell, or one damped-Jacobi sweep there, from its operands.
template <typename T, bool SWEEP>
__device__ __forceinline__ float pass_cell(const Coef& c, float xc, float xe,
                                           float xw, float xn, float xs,
                                           float omega) {
  using N = Num<T>;
  const float ax = apply_a<T>(c, xc, xe, xw, xn, xs);
  if (!SWEEP) return ax;
  float t = N::rnd(__fsub_rn(c.b, ax));
  t = N::rnd(__fmul_rn(omega, t));
  t = N::rnd(div_rn(t, c.d));
  return __fadd_rn(xc, t);
}

// The vector variant: a run of RUN cells a thread. WINDOW: blockIdx.z is
// a block of `win`, and x0, y0 count from its origin; else a plane.
template <typename T, bool SWEEP, bool WINDOW = false>
__global__ void __launch_bounds__(PASS_THREADS, 3)
stencil_run_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ ce, const T* __restrict__ cw,
                   const T* __restrict__ cn, const T* __restrict__ cs,
                   const T* __restrict__ dg, T* __restrict__ out, int ny,
                   int nx, int rows, int seg, float omega,
                   const WindowOf<WINDOW> win) {
  using N = Num<T>;
  using C = Cell<T>;
  constexpr int RUN = C::kRun;
  const Bounds bd = bounds_of<WINDOW>(win, blockIdx.z, ny, nx);
  const long plane = WINDOW ? 0 : (long)blockIdx.z * ny * nx;
  const int lane = threadIdx.x & (seg - 1);
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * rows;
  const int gx = bd.ox + x0;              // the run's first column
  // the run loads (nx and the window's edges are whole runs) and stores
  const bool col_in = WINDOW ? gx >= bd.x_lo && gx < bd.x_hi : x0 < nx;
  const bool col_out = WINDOW ? gx < bd.x_end : col_in;
  const bool last = lane == seg - 1, first = lane == 0;
  auto at = [&](const T* f, int y) {
    return f + plane + (long)(bd.oy + y) * nx + gx;
  };
  // x of row y loads: inside the plane, or the window
  auto row_in = [&](int y) {
    return WINDOW ? bd.oy + y >= bd.y_lo && bd.oy + y < bd.y_hi
                  : y >= 0 && y < ny;
  };

  Pack xs = load_run<T>(at(x, y0 - 1), col_in && row_in(y0 - 1));
  Pack xc = load_run<T>(at(x, y0), col_in && row_in(y0));
  for (int r = 0; r < rows; ++r) {
    const int y = y0 + r;
    const bool in = col_out && (WINDOW ? bd.oy + y < bd.y_end : y < ny);
    const Pack xn = load_run<T>(at(x, y + 1), col_in && row_in(y + 1));
    const Pack k_ce = load_run<T>(at(ce, y), in);
    const Pack k_cw = load_run<T>(at(cw, y), in);
    const Pack k_cn = load_run<T>(at(cn, y), in);
    const Pack k_cs = load_run<T>(at(cs, y), in);
    const Pack k_d = filled<T>(load_run<T>(at(dg, y), in), WINDOW && bd.fill);
    const Pack k_b = SWEEP ? load_run<T>(at(b, y), in) : Pack{{0, 0, 0, 0}};
    const T* xrow = at(x, y);
    const float edge_e = last && in && gx + RUN < bd.x_hi
                         ? N::load(xrow, RUN) : 0.f;
    const float edge_w = first && in && gx > bd.x_lo ? N::load(xrow, -1)
                                                     : 0.f;

    // E/W neighbours as runs: within the run, then the next lane's first
    // cell after it and the previous lane's last before it
    const unsigned e0 = __shfl_down_sync(FULL_MASK, xc.w[0], 1, seg);
    const unsigned w3 = __shfl_up_sync(FULL_MASK, xc.w[3], 1, seg);
    Pack xe, xw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xe.w[j] = C::next(xc, j);
      xw.w[j] = C::prev(xc, j);
    }
    xe.w[3] = C::tail(xc.w[3], e0);
    xw.w[0] = C::head(w3, xc.w[0]);
    Pack o{{0u, 0u, 0u, 0u}};
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
      const float e = k == RUN - 1 && last ? edge_e : C::get(xe, k);
      const float w = k == 0 && first ? edge_w : C::get(xw, k);
      const Coef c{C::get(k_ce, k), C::get(k_cw, k), C::get(k_cn, k),
                   C::get(k_cs, k), C::get(k_d, k),
                   SWEEP ? C::get(k_b, k) : 0.f};
      C::put(o, k, pass_cell<T, SWEEP>(c, C::get(xc, k), e, w,
                                       C::get(xn, k), C::get(xs, k), omega));
    }
    if (in) {
      *reinterpret_cast<uint4*>(out + plane + (long)(bd.oy + y) * nx + gx) =
          make_uint4(o.w[0], o.w[1], o.w[2], o.w[3]);
    }
    xs = xc;
    xc = xn;
  }
}

// The cell variant (the first port's kernel): one cell a thread,
// neighbours read through L1, blocks of CELL_X x CELL_Y threads.
constexpr int CELL_X = 32;   // a warp along x: coalesced rows
constexpr int CELL_Y = 8;

template <typename T, bool SWEEP, bool WINDOW = false>
__global__ void __launch_bounds__(CELL_X * CELL_Y)
stencil_cell_kernel(const T* __restrict__ x, const T* __restrict__ b,
                    const T* __restrict__ ce, const T* __restrict__ cw,
                    const T* __restrict__ cn, const T* __restrict__ cs,
                    const T* __restrict__ dg, T* __restrict__ out, int ny,
                    int nx, float omega, const WindowOf<WINDOW> win) {
  using N = Num<T>;
  if constexpr (WINDOW) {
    const Bounds bd = bounds_of<true>(win, blockIdx.z, ny, nx);
    const int gx = bd.ox + blockIdx.x * CELL_X + threadIdx.x;
    const int gy = bd.oy + blockIdx.y * CELL_Y + threadIdx.y;
    if (gx >= bd.x_end || gy >= bd.y_end) return;
    const long g = (long)gy * nx + gx;
    const float xc = N::load(x, g);
    const float xe = gx + 1 < bd.x_hi ? N::load(x, g + 1) : 0.f;
    const float xw = gx > bd.x_lo ? N::load(x, g - 1) : 0.f;
    const float xn = gy + 1 < bd.y_hi ? N::load(x, g + nx) : 0.f;
    const float xs = gy > bd.y_lo ? N::load(x, g - nx) : 0.f;
    const float d = N::load(dg, g);
    const Coef k{N::load(ce, g), N::load(cw, g), N::load(cn, g),
                 N::load(cs, g), bd.fill && d == 0.f ? 1.f : d,
                 SWEEP ? N::load(b, g) : 0.f};
    N::store(out, g, pass_cell<T, SWEEP>(k, xc, xe, xw, xn, xs, omega));
    return;
  }
  const int gx = blockIdx.x * CELL_X + threadIdx.x;
  const int gy = blockIdx.y * CELL_Y + threadIdx.y;
  if (gx >= nx || gy >= ny) return;
  const long g = (long)blockIdx.z * ny * nx + (long)gy * nx + gx;
  const float xc = N::load(x, g);
  const float xe = gx + 1 < nx ? N::load(x, g + 1) : 0.f;
  const float xw = gx > 0 ? N::load(x, g - 1) : 0.f;
  const float xn = gy + 1 < ny ? N::load(x, g + nx) : 0.f;
  const float xs = gy > 0 ? N::load(x, g - nx) : 0.f;
  const Coef k{N::load(ce, g), N::load(cw, g), N::load(cn, g),
               N::load(cs, g), N::load(dg, g), SWEEP ? N::load(b, g) : 0.f};
  N::store(out, g, pass_cell<T, SWEEP>(k, xc, xe, xw, xn, xs, omega));
}

// The geometry of ops/stencil.py `pass_geometry`, checked: whole warps,
// segments of lanes that share a row, and a grid that covers the planes
// exactly once (the last block along each axis reaches past the edge by
// less than a block).
struct PassGeometry {
  int vector, cells, rows, bx, by, gx, gy;
};

template <typename T>
bool geometry_ok(const PassGeometry& g, int planes, int ny, int nx,
                 const void* const* ptrs, int n_ptrs) {
  const int run = g.vector ? Cell<T>::kRun : 1;
  const int threads = g.bx * g.by;
  const int runs = (nx + run - 1) / run;
  const int strips = g.rows > 0 ? (ny + g.rows - 1) / g.rows : 0;
  if (planes <= 0 || planes > MAX_GRID_Y || ny <= 0 || nx <= 0
      || g.cells != run || g.rows <= 0 || g.bx <= 0 || g.by <= 0
      || (g.bx & (g.bx - 1)) != 0 || threads > PASS_THREADS
      || threads % 32 != 0 || g.gx != (runs + g.bx - 1) / g.bx
      || g.gy != (strips + g.by - 1) / g.by || g.gy > MAX_GRID_Y) {
    return false;
  }
  if (!g.vector && (g.rows != 1 || g.bx != CELL_X || g.by != CELL_Y)) {
    return false;
  }
  if (g.vector) {
    if (nx % run != 0) return false;
    for (int i = 0; i < n_ptrs; ++i) {
      if (reinterpret_cast<unsigned long>(ptrs[i]) % 16 != 0) return false;
    }
  }
  return true;
}

template <typename T, bool SWEEP>
int launch_pass(const T* x, const T* b, const T* ce, const T* cw,
                const T* cn, const T* cs, const T* dg, T* out, int planes,
                int ny, int nx, PassGeometry g, float omega, void* stream) {
  const void* ptrs[] = {x, SWEEP ? (const void*)b : (const void*)x, ce, cw,
                        cn, cs, dg, out};
  if (!geometry_ok<T>(g, planes, ny, nx, ptrs, 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int seg = g.bx < 32 ? g.bx : 32;
  const dim3 grid(g.gx, g.gy, planes), block(g.bx, g.by);
  if (g.vector) {
    stencil_run_kernel<T, SWEEP><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, b, ce, cw, cn, cs, dg, out, ny, nx, g.rows, seg, omega,
        NoWindow{});
  } else {
    stencil_cell_kernel<T, SWEEP><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, b, ce, cw, cn, cs, dg, out, ny, nx, omega, NoWindow{});
  }
  return (int)cudaGetLastError();
}

// The window of `count` blocks of (nyl, nxl) cells of the global (ny, nx)
// operands at the (row, column) pairs of the host array `origins`, each
// reaching hy rows and hx columns beyond its block, checked: every block
// inside the plane, `iters` sweeps within the halo of each split axis
// (hy or hx 0: the axis is whole, and its window is the domain).
bool window_ok(Window& w, int ny, int nx, int nyl, int nxl, int hy, int hx,
               int count, const int* origins, int iters, int max_iters) {
  if (count <= 0 || count > MAX_WINDOW_BLOCKS || nyl <= 0 || nxl <= 0
      || hy < 0 || hx < 0 || iters < 0 || iters > max_iters
      || (hy > 0 && iters > hy) || (hx > 0 && iters > hx)) {
    return false;
  }
  w.nyl = nyl;
  w.nxl = nxl;
  w.hy = hy;
  w.hx = hx;
  for (int k = 0; k < count; ++k) {
    w.oy[k] = origins[2 * k];
    w.ox[k] = origins[2 * k + 1];
    if (w.oy[k] < 0 || w.ox[k] < 0 || w.oy[k] + nyl > ny
        || w.ox[k] + nxl > nx) {
      return false;
    }
  }
  return true;
}

// One sweep of jacobi_multisweep over a window: a single-pass kernel's
// geometry over (count, nyl, nxl) planes, each plane a block.
template <typename T>
int launch_pass_window(const T* x, const T* b, const T* ce, const T* cw,
                       const T* cn, const T* cs, const T* dg, T* out, int ny,
                       int nx, int nyl, int nxl, int hy, int hx, int count,
                       const int* origins, PassGeometry g, float omega,
                       void* stream) {
  const void* ptrs[] = {x, b, ce, cw, cn, cs, dg, out};
  Window win;
  if (!window_ok(win, ny, nx, nyl, nxl, hy, hx, count, origins, 1,
                 Num<T>::kHalo)
      || !geometry_ok<T>(g, count, nyl, nxl, ptrs, 8)
      || (g.vector && nx % Cell<T>::kRun != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int seg = g.bx < 32 ? g.bx : 32;
  const dim3 grid(g.gx, g.gy, count), block(g.bx, g.by);
  if (g.vector) {
    stencil_run_kernel<T, true, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            x, b, ce, cw, cn, cs, dg, out, ny, nx, g.rows, seg, omega, win);
  } else {
    stencil_cell_kernel<T, true, true>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            x, b, ce, cw, cn, cs, dg, out, ny, nx, omega, win);
  }
  return (int)cudaGetLastError();
}

// ---- the multisweep run kernel: all three multisweep functions ----------
//
// What held the region kernel (pressure_stencil_kernel, above) back on the
// H100: its threads walk 16 cells one at a time, each with six scalar
// loads of b and the coefficients (half a line a warp in bfloat16), and
// they read those operands again on every sweep through L1/L2; little is
// in flight per thread. tools/kernel_times.py: 26.4 us for one float32
// sweep at 512 x 2048 against 16.1 us for the single-pass vector kernel,
// which does the same work, and 5-10 us a sweep at every level, the
// coarsest (16 x 64, one block) too: 9.8 us a launch there, where the
// single-pass kernel takes 1.7.
//
// This kernel reads every operand once a call, 16 bytes at a time, and
// keeps it on chip for all the sweeps:
// - A block of `warps` warps (blockDim.x = 32 warps) owns a region of
//   ROWS * warps rows (ROWS = 3, or 1 on the shallow halos: a third of
//   the dependent arithmetic a thread, which the coarse levels' launches,
//   chains of latencies, repaid with 0.7-2.4 us at 2 sweeps) and 32 runs
//   of RUN cells (16 bytes: 4 float32 or 8 bfloat16 cells, packed two to
//   a word and widened where used). Warp w owns region rows ROWS w ..
//   ROWS w + ROWS - 1, lane l the run at region column RUN l. A thread
//   loads x (x + corr, rounded to the operand type), b, c_e, c_w, c_n,
//   c_s and diag of its ROWS runs as one uint4 each, all issued before it
//   computes. x and the four conductances stay in registers; b and diag
//   go to shared memory, one uint4 per thread and row, which the thread
//   alone reads back (conflict-free: a warp's 32 uint4 are contiguous).
// - E/W neighbours come from the run and from the neighbouring lanes
//   (__shfl_*_sync); N/S from the thread's own rows and, at the ends of
//   its strip, from the neighbouring warps' edge rows, published in shared
//   memory (two buffers in turn: one __syncthreads a sweep).
// - Halo: hy rows in y and hx cells in x, the smallest whole number of
//   runs >= hy, so that a run lies wholly inside or beyond the tile and
//   the domain (nx a multiple of RUN); hy = iters, and iters + 1 for
//   smooth_residual, whose residual reads one more ring. The region's
//   outer ring (row 0, the last row, the first lane's first cell, the last
//   lane's last cell) is never updated, nor is any cell beyond the domain
//   (loaded as 0, so it reads as the plain version's zero neighbour; no
//   read leaves the array, nothing wraps east-west). After sweep k a cell
//   is exact if it lies at least k cells inside the ring (the trapezoid
//   argument), so after `iters` sweeps the cells hy - 1 >= iters inside
//   are, and the residual one ring further in (the tile) is too. Which
//   cells are updated is decided once, into a mask.
// - smooth_residual: after the last sweep the edge rows are published
//   once more, every thread passes one more barrier, and the residual
//   r = b - A x of the final x is computed at every word and stored with
//   x at the tile's, row by row (r never holds a register block of its
//   own).
// - The arithmetic (Sweep<T>::word, ::residual) is pass_cell's in float32
//   and its bfloat16 pair form, in the plain version's order and
//   roundings, so one sweep equals jacobi_sweep bit for bit. A word is
//   swept when it holds an updated cell, and a mask keeps its frozen
//   cells. (Sweeping every word, the cells beyond the domain divide 0 by
//   0, which takes __fdiv_rn's slow path for the whole warp: that doubled
//   the time a sweep on the coarse levels.) Both dtypes divide with
//   div_rn, whose zero-dividend guard keeps the solid cells (b = x = 0 on
//   the cylinder's operators) off that slow path too.
// Registers: x and four conductances x ROWS runs of 4 words = 60 words a
// thread at ROWS = 3; __launch_bounds__ caps it at 128 registers (16
// warps, one block an SM; 8 warps, two): 106-126, and 59-64 at ROWS = 1,
// no spills. Shared memory: the edge rows (2 KB a warp) and b and diag
// (ROWS * 1 KB a warp): 40 KB at 8 warps, 80 KB at 16 (48 KB at ROWS =
// 1), dynamic (above 48 KB after cudaFuncSetAttribute). Keeping b
// and diag in registers too (84 words) left no room for div_rn's guard in
// bfloat16: it spilled 76-132 bytes at the cap. The launch geometry
// (rows, warps, halo, tile, grid) is computed in Python (ops/stencil.py
// `multisweep_geometry`) and checked here; unaligned rows and widths that
// are not a whole number of runs take the region kernel, and one sweep
// of jacobi_multisweep the single-pass kernels (faster at every level).

constexpr int MS_MAX_WARPS = 16;    // warps of a block, stacked in y

// One damped-Jacobi sweep of the cells of a 32-bit word of a run (one
// float32 cell, or two bfloat16 cells), from the word's operands and
// neighbours, in the plain version's order and roundings; the residual
// b - A x there; and `mask`, all ones over the word's cells whose bit in
// `live` is set.
template <typename T> struct Sweep;

template <> struct Sweep<float> {
  static __device__ __forceinline__ unsigned omega(float om) {
    return __float_as_uint(om);
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  static __device__ __forceinline__ Coef coef(unsigned ce, unsigned cw,
                                              unsigned cn, unsigned cs,
                                              unsigned d, unsigned b) {
    return Coef{__uint_as_float(ce), __uint_as_float(cw), __uint_as_float(cn),
                __uint_as_float(cs), __uint_as_float(d), __uint_as_float(b)};
  }
  static __device__ __forceinline__ unsigned word(
      unsigned ce, unsigned cw, unsigned cn, unsigned cs, unsigned d,
      unsigned b, unsigned x, unsigned xe, unsigned xw, unsigned xn,
      unsigned xs, unsigned om) {
    return __float_as_uint(pass_cell<float, true>(
        coef(ce, cw, cn, cs, d, b), __uint_as_float(x), __uint_as_float(xe),
        __uint_as_float(xw), __uint_as_float(xn), __uint_as_float(xs),
        __uint_as_float(om)));
  }
  static __device__ __forceinline__ unsigned residual(
      unsigned ce, unsigned cw, unsigned cn, unsigned cs, unsigned d,
      unsigned b, unsigned x, unsigned xe, unsigned xw, unsigned xn,
      unsigned xs) {
    const float ax = apply_a<float>(
        coef(ce, cw, cn, cs, d, b), __uint_as_float(x), __uint_as_float(xe),
        __uint_as_float(xw), __uint_as_float(xn), __uint_as_float(xs));
    return __float_as_uint(__fsub_rn(__uint_as_float(b), ax));
  }
  static __device__ __forceinline__ unsigned mask(unsigned live, int bit) {
    return live >> bit & 1u ? 0xffffffffu : 0u;
  }
};

// bfloat16 pairs: each product, difference and sum is one fma.rn.bf16x2
// with an exact third operand (a*b + -0, b*-1 + a, a*1 + b), the exact
// result rounded once to bfloat16. That equals the plain version's
// float32 operation rounded to bfloat16: float32 holds a product of two
// bfloat16 values exactly, and rounding a sum to float32 first is
// innocuous (24 bits >= 2*8 + 2). The division has no bfloat16 form: in
// float32, div_rn (__fdiv_rn's quotient, a zero dividend's signed zero
// without its slow path) on each half, rounded to bfloat16, as pass_cell
// does. Two cells an instruction, no widening, and a third of the
// instructions the float32 emulation of each rounding takes.
template <> struct Sweep<__nv_bfloat16> {
  static __device__ __forceinline__ unsigned fma2(unsigned a, unsigned b,
                                                  unsigned c) {
    unsigned d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
  }
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    return fma2(a, b, 0x80008000u);            // + (-0, -0)
  }
  static __device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
    return fma2(b, 0xbf80bf80u, a);            // b * (-1, -1) + a
  }
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    return fma2(a, 0x3f803f80u, b);            // a * (1, 1) + b
  }
  static __device__ __forceinline__ unsigned omega(float om) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(om));
    return h | h << 16;
  }
  // A x: ((((diag*x - ce*xe) - cw*xw) - cn*xn) - cs*xs), as apply_a
  static __device__ __forceinline__ unsigned ax(
      unsigned ce, unsigned cw, unsigned cn, unsigned cs, unsigned d,
      unsigned x, unsigned xe, unsigned xw, unsigned xn, unsigned xs) {
    unsigned a = mul(d, x);
    a = sub(a, mul(ce, xe));
    a = sub(a, mul(cw, xw));
    a = sub(a, mul(cn, xn));
    return sub(a, mul(cs, xs));
  }
  static __device__ __forceinline__ unsigned word(
      unsigned ce, unsigned cw, unsigned cn, unsigned cs, unsigned d,
      unsigned b, unsigned x, unsigned xe, unsigned xw, unsigned xn,
      unsigned xs, unsigned om) {
    const unsigned t = mul(om, sub(b, ax(ce, cw, cn, cs, d, x, xe, xw, xn,
                                         xs)));
    const float lo = div_rn(__uint_as_float(t << 16),
                            __uint_as_float(d << 16));
    const float hi = div_rn(__uint_as_float(t & 0xffff0000u),
                            __uint_as_float(d & 0xffff0000u));
    const unsigned q = __bfloat16_as_ushort(__float2bfloat16_rn(lo))
                       | (unsigned)__bfloat16_as_ushort(
                             __float2bfloat16_rn(hi)) << 16;
    return add(x, q);
  }
  static __device__ __forceinline__ unsigned residual(
      unsigned ce, unsigned cw, unsigned cn, unsigned cs, unsigned d,
      unsigned b, unsigned x, unsigned xe, unsigned xw, unsigned xn,
      unsigned xs) {
    return sub(b, ax(ce, cw, cn, cs, d, x, xe, xw, xn, xs));
  }
  static __device__ __forceinline__ unsigned mask(unsigned live, int bit) {
    return (live >> bit & 1u ? 0xffffu : 0u)
           | (live >> (bit + 1) & 1u ? 0xffff0000u : 0u);
  }
};

__device__ __forceinline__ uint4 as_uint4(const Pack& p) {
  return make_uint4(p.w[0], p.w[1], p.w[2], p.w[3]);
}

__device__ __forceinline__ Pack as_pack(const uint4& q) {
  return Pack{{q.x, q.y, q.z, q.w}};
}

// Dynamic shared memory of a block of `warps` warps: the edge rows
// ([buffer][warp][first or last row][lane]), then b and diag
// ([row][thread] each).
template <int ROWS>
constexpr size_t run_smem_bytes(int warps) {
  return (size_t)warps * 32 * (4 + 2 * ROWS) * sizeof(uint4);
}

// WINDOW: blockIdx.z is a block of `win` (jacobi_multisweep only), and
// the tiles count from its origin; else the grid covers the plane, and
// blockIdx.z is the case of a (B, ny, nx) stack.
template <typename T, int MODE, int ROWS, bool WINDOW = false>
__global__ void __launch_bounds__(32 * MS_MAX_WARPS, 1)
multisweep_run_kernel(const T* __restrict__ x0, const T* __restrict__ corr,
                      const T* __restrict__ b, const T* __restrict__ ce,
                      const T* __restrict__ cw, const T* __restrict__ cn,
                      const T* __restrict__ cs, const T* __restrict__ dg,
                      T* __restrict__ out, T* __restrict__ r_out, int ny,
                      int nx, int iters, int hx, int tile_y, int tile_x,
                      float omega, const WindowOf<WINDOW> win) {
  using C = Cell<T>;
  using S = Sweep<T>;
  constexpr int RUN = C::kRun;
  constexpr bool RESIDUAL = MODE == kSmoothResidual;
  static_assert(ROWS * RUN <= 32, "the update mask is one 32-bit word");
  extern __shared__ uint4 smem[];
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* const sb = smem + 4 * threads;         // after the edge rows
  uint4* const sd = sb + ROWS * threads;
  const int hy = iters + RESIDUAL;
  const int height = warps * ROWS;
  const int r0 = warp * ROWS;                   // region row of the first row
  const Bounds bd = bounds_of<WINDOW>(win, blockIdx.z, ny, nx);
  // without a window blockIdx.z is the case of a (B, ny, nx) stack
  const long plane = WINDOW ? 0 : (long)blockIdx.z * ny * nx;
  const int gy0 = bd.oy + blockIdx.y * tile_y - hy + r0;
  const int gx = bd.ox + blockIdx.x * tile_x - hx + lane * RUN;
  // the whole run, or none (nx and a window's edges are whole runs)
  const bool col_in = gx >= bd.x_lo && gx < bd.x_hi;
  // the tile: region rows hy .. height - hy - 1, runs hx/RUN ..
  // 32 - hx/RUN - 1, inside the domain (the block)
  const bool col_out = col_in && gx < bd.x_end && lane * RUN >= hx
                       && lane * RUN < 32 * RUN - hx;

  Pack xr[ROWS], ke[ROWS], kw[ROWS], kn[ROWS], ks[ROWS];
  unsigned live = 0;                            // bit i*RUN+k: updated
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gy = gy0 + i;
    const bool in = col_in && gy >= bd.y_lo && gy < bd.y_hi;
    const long g = plane + (long)gy * nx + gx;
    xr[i] = load_run<T>(x0 + g, in);
    const Pack kb = load_run<T>(b + g, in);
    ke[i] = load_run<T>(ce + g, in);
    kw[i] = load_run<T>(cw + g, in);
    kn[i] = load_run<T>(cn + g, in);
    ks[i] = load_run<T>(cs + g, in);
    const Pack kd = filled<T>(load_run<T>(dg + g, in), WINDOW && bd.fill);
    if (MODE == kCorrSmooth) {
      const Pack c = load_run<T>(corr + g, in);
#pragma unroll
      for (int j = 0; j < 4; ++j) xr[i].w[j] = S::add(xr[i].w[j], c.w[j]);
    }
    sb[i * threads + threadIdx.x] = as_uint4(kb);
    sd[i * threads + threadIdx.x] = as_uint4(kd);
    const bool ring_row = r0 + i == 0 || r0 + i == height - 1;
    if (in && !ring_row) {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        if (!(lane == 0 && k == 0) && !(lane == 31 && k == RUN - 1)) {
          live |= 1u << (i * RUN + k);
        }
      }
    }
  }
  // the neighbouring warps' edge rows: below this warp's first row, above
  // its last (the ring rows never read theirs)
  const int below = warp > 0 ? warp - 1 : 0;
  const int above = warp < warps - 1 ? warp + 1 : warps - 1;
  const unsigned om = S::omega(omega);

  // `iters` sweeps, and for smooth_residual one pass more: the residual
  for (int s = 0; s < iters + RESIDUAL; ++s) {
    const bool res = RESIDUAL && s == iters;
    uint4* const ex = smem + (s & 1) * 2 * threads;   // [warp][row][lane]
    ex[(warp * 2) * 32 + lane] = as_uint4(xr[0]);
    ex[(warp * 2 + 1) * 32 + lane] = as_uint4(xr[ROWS - 1]);
    __syncthreads();
    Pack south = as_pack(ex[(below * 2 + 1) * 32 + lane]);  // old row below
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const Pack north = i + 1 < ROWS ? xr[i + 1]
                                      : as_pack(ex[(above * 2) * 32 + lane]);
      // E/W neighbours as runs: within the run, then the next lane's
      // first cell after it and the previous lane's last before it (the
      // first and last lanes' outer cells are the ring: never updated)
      const unsigned e0 = __shfl_down_sync(FULL_MASK, xr[i].w[0], 1);
      const unsigned w3 = __shfl_up_sync(FULL_MASK, xr[i].w[3], 1);
      Pack xe, xw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xe.w[j] = C::next(xr[i], j);
        xw.w[j] = C::prev(xr[i], j);
      }
      xe.w[3] = C::tail(xr[i].w[3], e0);
      xw.w[0] = C::head(w3, xr[i].w[0]);
      const Pack kb = as_pack(sb[i * threads + threadIdx.x]);
      const Pack kd = as_pack(sd[i * threads + threadIdx.x]);
      if (res) {
        // every word (no division), stored at the tile's with x
        Pack r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r.w[j] = S::residual(ke[i].w[j], kw[i].w[j], kn[i].w[j],
                               ks[i].w[j], kd.w[j], kb.w[j], xr[i].w[j],
                               xe.w[j], xw.w[j], north.w[j], south.w[j]);
        }
        const int gy = gy0 + i;
        if (col_out && r0 + i >= hy && r0 + i < height - hy && gy >= 0
            && gy < bd.y_end) {
          const long g = plane + (long)gy * nx + gx;
          *reinterpret_cast<uint4*>(out + g) = as_uint4(xr[i]);
          *reinterpret_cast<uint4*>(r_out + g) = as_uint4(r);
        }
        south = xr[i];
        continue;
      }
      // the words that hold an updated cell are swept, the frozen cells
      // kept by the mask; the words beyond the domain are not (there
      // 0 / 0 would take __fdiv_rn's slow path, in the whole warp)
      Pack o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned m = S::mask(live, i * RUN + j * (RUN / 4));
        o.w[j] = xr[i].w[j];
        if (m) {
          const unsigned v = S::word(ke[i].w[j], kw[i].w[j], kn[i].w[j],
                                     ks[i].w[j], kd.w[j], kb.w[j],
                                     xr[i].w[j], xe.w[j], xw.w[j],
                                     north.w[j], south.w[j], om);
          o.w[j] = (v & m) | (o.w[j] & ~m);
        }
      }
      south = xr[i];
      xr[i] = o;
    }
  }
  if (RESIDUAL) return;                          // x is stored with r
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gy = gy0 + i;
    if (col_out && r0 + i >= hy && r0 + i < height - hy && gy >= 0
        && gy < bd.y_end) {
      *reinterpret_cast<uint4*>(out + plane + (long)gy * nx + gx) =
          as_uint4(xr[i]);
    }
  }
}

// The geometry of ops/stencil.py `multisweep_geometry`, checked: the
// region kernel's square regions (run 0: tile = REGION - 2 hy, block
// THREADS), or the run kernel's (run 1: ROWS rows a thread, whole warps,
// hx a whole number of runs >= hy, tiles of the region less the halos); a
// grid that covers the plane exactly once, and 16-byte aligned operands
// for the run kernel. hy = iters, and iters + 1 for smooth_residual.
struct MultisweepGeometry {
  int run, rows, warps, hx, tile_y, tile_x, gx, gy;
};

template <typename T, int MODE>
bool multisweep_ok(const MultisweepGeometry& g, int planes, int ny, int nx,
                   int iters, const void* const* ptrs, int n_ptrs) {
  constexpr int RUN = Cell<T>::kRun;
  const int hy = iters + (MODE == kSmoothResidual);
  if (planes <= 0 || planes > MAX_GRID_Z || ny <= 0 || nx <= 0 || iters < 0
      || hy > Num<T>::kHalo
      || g.tile_y <= 0 || g.tile_x <= 0
      || g.gy != (ny + g.tile_y - 1) / g.tile_y
      || g.gx != (nx + g.tile_x - 1) / g.tile_x || g.gy > MAX_GRID_Y) {
    return false;
  }
  if (!g.run) {
    return g.rows == 1 && g.warps == THREADS / 32 && g.hx == hy
           && g.tile_y == REGION - 2 * hy && g.tile_x == g.tile_y;
  }
  if ((g.rows != 1 && g.rows != 3) || g.warps <= 0
      || g.warps > MS_MAX_WARPS || nx % RUN != 0 || g.hx % RUN != 0
      || g.hx < hy || g.tile_x != 32 * RUN - 2 * g.hx
      || g.tile_y != g.warps * g.rows - 2 * hy) {
    return false;
  }
  for (int i = 0; i < n_ptrs; ++i) {
    if (reinterpret_cast<unsigned long>(ptrs[i]) % 16 != 0) return false;
  }
  return true;
}

// `count` along z: the window's blocks, or the cases of a stack
template <typename T, int MODE, int ROWS, bool WINDOW = false>
cudaError_t launch_run(const T* x0, const T* corr, const T* b, const T* ce,
                       const T* cw, const T* cn, const T* cs, const T* dg,
                       T* x_out, T* r_out, int ny, int nx, int iters,
                       const MultisweepGeometry& g, float omega,
                       cudaStream_t stream,
                       const WindowOf<WINDOW>& win = {}, int count = 1) {
  const auto kernel = multisweep_run_kernel<T, MODE, ROWS, WINDOW>;
  const size_t smem = run_smem_bytes<ROWS>(g.warps);
  if (smem > 48 * 1024) {     // the default cap of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(g.gx, g.gy, count), 32 * g.warps, smem, stream>>>(
      x0, corr, b, ce, cw, cn, cs, dg, x_out, r_out, ny, nx, iters, g.hx,
      g.tile_y, g.tile_x, omega, win);
  return cudaGetLastError();
}

// `planes` cases of (ny, nx) stacked: blockIdx.z is the case, each case's
// operands and outputs at (long)z * ny * nx, each computed as if alone
template <typename T, int MODE>
int launch_multisweep(const T* x0, const T* corr, const T* b, const T* ce,
                      const T* cw, const T* cn, const T* cs, const T* dg,
                      T* x_out, T* r_out, int planes, int ny, int nx,
                      int iters, MultisweepGeometry g, float omega,
                      void* stream) {
  const void* ptrs[] = {x0, b, ce, cw, cn, cs, dg, x_out,
                        MODE == kCorrSmooth ? (const void*)corr
                                            : (const void*)x0,
                        MODE == kSmoothResidual ? (const void*)r_out
                                                : (const void*)x0};
  if (!multisweep_ok<T, MODE>(g, planes, ny, nx, iters, ptrs, 10)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (!g.run) {
    pressure_stencil_kernel<T, MODE>
        <<<dim3(g.gx, g.gy, planes), THREADS, 0, s>>>(
            x0, corr, b, ce, cw, cn, cs, dg, x_out, r_out, ny, nx, iters,
            g.hx, omega);
    return (int)cudaGetLastError();
  }
  return (int)(g.rows == 1
      ? launch_run<T, MODE, 1>(x0, corr, b, ce, cw, cn, cs, dg, x_out, r_out,
                               ny, nx, iters, g, omega, s, {}, planes)
      : launch_run<T, MODE, 3>(x0, corr, b, ce, cw, cn, cs, dg, x_out, r_out,
                               ny, nx, iters, g, omega, s, {}, planes));
}

// Two or more sweeps of jacobi_multisweep over a window: the run kernel's
// geometry over one (nyl, nxl) block, `count` blocks along z (the region
// kernel takes no window).
template <typename T>
int launch_multisweep_window(const T* x0, const T* b, const T* ce,
                             const T* cw, const T* cn, const T* cs,
                             const T* dg, T* x_out, int ny, int nx, int nyl,
                             int nxl, int hy, int hx, int count,
                             const int* origins, int iters,
                             MultisweepGeometry g, float omega,
                             void* stream) {
  const void* ptrs[] = {x0, b, ce, cw, cn, cs, dg, x_out};
  Window win;
  if (!g.run || nx % Cell<T>::kRun != 0
      || !window_ok(win, ny, nx, nyl, nxl, hy, hx, count, origins, iters,
                    Num<T>::kHalo)
      || !multisweep_ok<T, kMultisweep>(g, 1, nyl, nxl, iters, ptrs, 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g.rows == 1
      ? launch_run<T, kMultisweep, 1, true>(
            x0, nullptr, b, ce, cw, cn, cs, dg, x_out, nullptr, ny, nx, iters,
            g, omega, s, win, count)
      : launch_run<T, kMultisweep, 3, true>(
            x0, nullptr, b, ce, cw, cn, cs, dg, x_out, nullptr, ny, nx, iters,
            g, omega, s, win, count));
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define PRESSURE_STENCIL_ENTRIES(SUFFIX, T)                                  \
  extern "C" int jacobi_multisweep_##SUFFIX(                                 \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* x_out, int planes, int ny, int nx,        \
      int iters, int run, int rows, int warps, int hx, int tile_y,           \
      int tile_x, int gx, int gy, float omega, void* stream) {               \
    return launch_multisweep<T, kMultisweep>(                                \
        x, nullptr, b, ce, cw, cn, cs, dg, x_out, nullptr, planes, ny, nx,   \
        iters, {run, rows, warps, hx, tile_y, tile_x, gx, gy}, omega,        \
        stream);                                                             \
  }                                                                          \
  extern "C" int smooth_residual_##SUFFIX(                                   \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* x_out, T* r_out, int planes, int ny,      \
      int nx, int iters, int run, int rows, int warps, int hx, int tile_y,   \
      int tile_x, int gx, int gy, float omega, void* stream) {               \
    return launch_multisweep<T, kSmoothResidual>(                            \
        x, nullptr, b, ce, cw, cn, cs, dg, x_out, r_out, planes, ny, nx,     \
        iters, {run, rows, warps, hx, tile_y, tile_x, gx, gy}, omega,        \
        stream);                                                             \
  }                                                                          \
  extern "C" int corr_smooth_##SUFFIX(                                       \
      const T* x, const T* corr, const T* b, const T* ce, const T* cw,       \
      const T* cn, const T* cs, const T* dg, T* x_out, int planes, int ny,   \
      int nx, int iters, int run, int rows, int warps, int hx, int tile_y,   \
      int tile_x, int gx, int gy, float omega, void* stream) {               \
    return launch_multisweep<T, kCorrSmooth>(                                \
        x, corr, b, ce, cw, cn, cs, dg, x_out, nullptr, planes, ny, nx,      \
        iters, {run, rows, warps, hx, tile_y, tile_x, gx, gy}, omega,        \
        stream);                                                             \
  }                                                                          \
  extern "C" int stencil_matvec_##SUFFIX(                                    \
      const T* x, const T* ce, const T* cw, const T* cn, const T* cs,        \
      const T* dg, T* out, int planes, int ny, int nx, int vector,           \
      int cells, int rows, int bx, int by, int gx, int gy, void* stream) {   \
    return launch_pass<T, false>(x, nullptr, ce, cw, cn, cs, dg, out,        \
                                 planes, ny, nx,                             \
                                 {vector, cells, rows, bx, by, gx, gy}, 0.f, \
                                 stream);                                    \
  }                                                                          \
  extern "C" int jacobi_sweep_##SUFFIX(                                      \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* out, int planes, int ny, int nx,          \
      int vector, int cells, int rows, int bx, int by, int gx, int gy,       \
      float omega, void* stream) {                                           \
    return launch_pass<T, true>(x, b, ce, cw, cn, cs, dg, out, planes, ny,   \
                                nx, {vector, cells, rows, bx, by, gx, gy},   \
                                omega, stream);                              \
  }                                                                          \
  extern "C" int jacobi_sweep_window_##SUFFIX(                               \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* out, int ny, int nx, int nyl, int nxl,    \
      int hy, int hx, int count, const int* origins, int vector, int cells,  \
      int rows, int bx, int by, int gx, int gy, float omega, void* stream) { \
    return launch_pass_window<T>(x, b, ce, cw, cn, cs, dg, out, ny, nx, nyl, \
                                 nxl, hy, hx, count, origins,                \
                                 {vector, cells, rows, bx, by, gx, gy},      \
                                 omega, stream);                             \
  }                                                                          \
  extern "C" int jacobi_multisweep_window_##SUFFIX(                          \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* x_out, int ny, int nx, int nyl, int nxl,  \
      int hy, int hx, int count, const int* origins, int iters, int run,     \
      int rows, int warps, int hxr, int tile_y, int tile_x, int gx, int gy,  \
      float omega, void* stream) {                                           \
    return launch_multisweep_window<T>(                                      \
        x, b, ce, cw, cn, cs, dg, x_out, ny, nx, nyl, nxl, hy, hx, count,    \
        origins, iters, {run, rows, warps, hxr, tile_y, tile_x, gx, gy},     \
        omega, stream);                                                      \
  }

PRESSURE_STENCIL_ENTRIES(f32, float)
PRESSURE_STENCIL_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* pressure_stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
