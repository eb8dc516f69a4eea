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
//
// Bound: bytes. Each reads 7 (corr_smooth 8) fields and writes 1
// (smooth_residual 2): 33.6 MB per jacobi_multisweep call at 512 x 2048
// in float32, 10.0 us at 3.35 TB/s; half that in bfloat16. A few dozen
// operations per cell and sweep stay far below the card's rates.
//
// Design (simple and exact; speed is later work). A block owns a square
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
  }

PRESSURE_STENCIL_ENTRIES(f32, float)
PRESSURE_STENCIL_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* pressure_stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
