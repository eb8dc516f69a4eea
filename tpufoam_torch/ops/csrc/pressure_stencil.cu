// Pressure-stencil kernels of the multigrid: damped-Jacobi sweeps
//     x <- x + omega * (b - A x) / diag,
//     A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x),
// several per launch, on (ny, nx) float32 or bfloat16 fields. A neighbour
// beyond the domain reads as 0.
//
//   jacobi_multisweep  iters <= halo sweeps            -> x
//     replaces tpufoam/ops/stencil.py `jacobi_multisweep_pallas` (l.520,
//     body `_make_multisweep_kernel` l.302)
//   smooth_residual    iters <= halo - 1 sweeps, then r = b - A x -> (x, r)
//     replaces `smooth_residual_pallas` (l.629, body l.578)
//   corr_smooth        x + corr, then iters <= halo sweeps -> x
//     replaces `corr_smooth_pallas` (l.722, body l.672)
// with halo = 8 for float32 and 16 for bfloat16, the TPU kernels' limits.
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
// Design of the multisweep kernels (simple and exact). A block owns a square
// region of REGION x REGION cells: an output tile of (REGION - 2h)^2 cells
// and a halo of h cells on each side, with h = iters (smooth_residual:
// iters + 1, its residual reads one more ring), chosen at launch so that
// the redundant halo work stays small on the paths' 1-2 sweeps. x lives in
// shared memory as float (two buffers, ping-pong); the coefficients and b
// are read from global memory, where they stay in L1/L2 across the sweeps.
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
// the division with __fdiv_rn, and for bfloat16 a round to bfloat16 after
// each of them; omega arrives rounded to the operand type. So the kernel
// and the plain version compute the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int REGION = 64;
constexpr int CELLS = REGION * REGION;
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

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

  // load x (x + corr for the up leg) into both buffers: the frozen ring
  // and the cells beyond the domain then hold their value in either
  for (int idx = threadIdx.x; idx < CELLS; idx += THREADS) {
    const int gy = gy0 + idx / REGION;
    const int gx = gx0 + idx % REGION;
    float v = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const long g = (long)gy * nx + gx;
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
                                  (long)gy * nx + gx);
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
    const long g = (long)gy * nx + gx;
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

template <typename T, int MODE>
int launch(const T* x0, const T* corr, const T* b, const T* ce, const T* cw,
           const T* cn, const T* cs, const T* dg, T* x_out, T* r_out,
           int ny, int nx, int iters, float omega, void* stream) {
  const int max_iters = Num<T>::kHalo - (MODE == kSmoothResidual ? 1 : 0);
  if (ny <= 0 || nx <= 0 || iters < 0 || iters > max_iters) {
    return (int)cudaErrorInvalidValue;
  }
  const int halo = MODE == kSmoothResidual ? iters + 1 : iters;
  const int tile = REGION - 2 * halo;
  const dim3 grid((nx + tile - 1) / tile, (ny + tile - 1) / tile);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  pressure_stencil_kernel<T, MODE><<<grid, THREADS, 0,
                                     (cudaStream_t)stream>>>(
      x0, corr, b, ce, cw, cn, cs, dg, x_out, r_out, ny, nx, iters, halo,
      omega);
  return (int)cudaGetLastError();
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
};

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
  t = N::rnd(__fdiv_rn(t, c.d));
  return __fadd_rn(xc, t);
}

// The vector variant: a run of RUN cells a thread.
template <typename T, bool SWEEP>
__global__ void __launch_bounds__(PASS_THREADS, 3)
stencil_run_kernel(const T* __restrict__ x, const T* __restrict__ b,
                   const T* __restrict__ ce, const T* __restrict__ cw,
                   const T* __restrict__ cn, const T* __restrict__ cs,
                   const T* __restrict__ dg, T* __restrict__ out, int ny,
                   int nx, int rows, int seg, float omega) {
  using N = Num<T>;
  using C = Cell<T>;
  constexpr int RUN = C::kRun;
  const long plane = (long)blockIdx.z * ny * nx;
  const int lane = threadIdx.x & (seg - 1);
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * RUN;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * rows;
  const bool col_in = x0 < nx;            // nx is a multiple of RUN
  const bool last = lane == seg - 1, first = lane == 0;
  auto at = [&](const T* f, int y) { return f + plane + (long)y * nx + x0; };

  Pack xs = load_run<T>(at(x, y0 - 1), col_in && y0 >= 1 && y0 - 1 < ny);
  Pack xc = load_run<T>(at(x, y0), col_in && y0 < ny);
  for (int r = 0; r < rows; ++r) {
    const int y = y0 + r;
    const bool in = col_in && y < ny;
    const Pack xn = load_run<T>(at(x, y + 1), col_in && y + 1 < ny);
    const Pack k_ce = load_run<T>(at(ce, y), in);
    const Pack k_cw = load_run<T>(at(cw, y), in);
    const Pack k_cn = load_run<T>(at(cn, y), in);
    const Pack k_cs = load_run<T>(at(cs, y), in);
    const Pack k_d = load_run<T>(at(dg, y), in);
    const Pack k_b = SWEEP ? load_run<T>(at(b, y), in) : Pack{{0, 0, 0, 0}};
    const T* xrow = at(x, y);
    const float edge_e = last && in && x0 + RUN < nx ? N::load(xrow, RUN)
                                                     : 0.f;
    const float edge_w = first && in && x0 > 0 ? N::load(xrow, -1) : 0.f;

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
      *reinterpret_cast<uint4*>(out + plane + (long)y * nx + x0) =
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

template <typename T, bool SWEEP>
__global__ void __launch_bounds__(CELL_X * CELL_Y)
stencil_cell_kernel(const T* __restrict__ x, const T* __restrict__ b,
                    const T* __restrict__ ce, const T* __restrict__ cw,
                    const T* __restrict__ cn, const T* __restrict__ cs,
                    const T* __restrict__ dg, T* __restrict__ out, int ny,
                    int nx, float omega) {
  using N = Num<T>;
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
        x, b, ce, cw, cn, cs, dg, out, ny, nx, g.rows, seg, omega);
  } else {
    stencil_cell_kernel<T, SWEEP><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, b, ce, cw, cn, cs, dg, out, ny, nx, omega);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
#define PRESSURE_STENCIL_ENTRIES(SUFFIX, T)                                  \
  extern "C" int jacobi_multisweep_##SUFFIX(                                 \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* x_out, int ny, int nx, int iters,         \
      float omega, void* stream) {                                           \
    return launch<T, kMultisweep>(x, nullptr, b, ce, cw, cn, cs, dg, x_out,  \
                                  nullptr, ny, nx, iters, omega, stream);    \
  }                                                                          \
  extern "C" int smooth_residual_##SUFFIX(                                   \
      const T* x, const T* b, const T* ce, const T* cw, const T* cn,         \
      const T* cs, const T* dg, T* x_out, T* r_out, int ny, int nx,          \
      int iters, float omega, void* stream) {                                \
    return launch<T, kSmoothResidual>(x, nullptr, b, ce, cw, cn, cs, dg,     \
                                      x_out, r_out, ny, nx, iters, omega,    \
                                      stream);                               \
  }                                                                          \
  extern "C" int corr_smooth_##SUFFIX(                                       \
      const T* x, const T* corr, const T* b, const T* ce, const T* cw,       \
      const T* cn, const T* cs, const T* dg, T* x_out, int ny, int nx,       \
      int iters, float omega, void* stream) {                                \
    return launch<T, kCorrSmooth>(x, corr, b, ce, cw, cn, cs, dg, x_out,     \
                                  nullptr, ny, nx, iters, omega, stream);    \
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
  }

PRESSURE_STENCIL_ENTRIES(f32, float)
PRESSURE_STENCIL_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* pressure_stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
