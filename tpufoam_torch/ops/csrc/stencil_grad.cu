// Reverse mode of the pressure matvec (ops/stencil.py `stencil_matvec`,
// whose forward is pressure_stencil.cu's stencil_matvec):
//     y = A x,  A x = diag*x - c_e*E(x) - c_w*W(x) - c_n*N(x) - c_s*S(x),
// a neighbour beyond the domain read as 0. For the upstream gradient g:
//     dx     = diag*g - W(c_e*g) - E(c_w*g) - S(c_n*g) - N(c_s*g)  (A^T g)
//     d c_e  = -(g*E(x))    d c_w = -(g*W(x))
//     d c_n  = -(g*N(x))    d c_s = -(g*S(x))    d diag = g*x
// on (ny, nx) float32 or bfloat16 fields, or on B planes stacked as
// (B, ny, nx) (blockIdx.z is the plane; nothing wraps across planes).
// A is not taken to be symmetric (coarse levels and cut cells need not
// be), so dx reads each neighbour's own coefficient toward this cell.
// A null output pointer is a gradient not asked for, and is not computed.
//
// It replaces no TPU kernel: the JAX package differentiates its plain
// matvec (tpufoam/fv/pressure.py:65-69) through XLA, and its Pallas
// matvec has no reverse mode. It is the backward of the port's row-2
// kernel, so that a differentiated rollout runs on the card.
//
// Bound: bytes. With every gradient it reads 7 fields (g, x, the four
// conductances, diag) and writes 6: 13 x 4 MiB = 54.5 MB at 512 x 2048
// in float32, 16.3 us at 3.35 TB/s; dx alone reads 6 (not x) and writes
// 1: 29.4 MB, 8.8 us; bfloat16 half of each. 9 operations a cell for dx
// and 2 for each other gradient stay far below the card's rates.
//
// Design: the first port's one-cell-a-thread form (as pressure_stencil.cu
// `stencil_cell_kernel`): blocks of 32 x 8 threads, a warp along a row so
// that each field's loads coalesce, neighbours read through L1. Simple
// and exact; its redesign for the card is later work.
//
// Rounding: every operation rounds to the operand type in the order the
// plain version (ops/stencil.py `stencil_matvec_grad_plain`) evaluates
// it, left to right: __fmul_rn/__fsub_rn (never contracted into FMAs),
// and for bfloat16 a round to bfloat16 after each. So the kernel and the
// plain version compute the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CELL_X = 32;
constexpr int CELL_Y = 8;
constexpr int MAX_GRID = 65535;   // grid y (rows of blocks) and z (planes)

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float load(const float* p, long g) {
    return __ldg(p + g);
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, long g, float v) {
    p[g] = v;
  }
};

template <> struct Num<__nv_bfloat16> {
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

// c * g rounded, for a neighbour inside the domain; 0 beyond it
template <typename T>
__device__ __forceinline__ float term(const T* c, const T* g, long i,
                                      bool in) {
  using N = Num<T>;
  return in ? N::rnd(__fmul_rn(N::load(c, i), N::load(g, i))) : 0.f;
}

// -(g * x_nb) rounded, x_nb 0 beyond the domain
template <typename T>
__device__ __forceinline__ void coef_grad(T* out, long i, float g,
                                          const T* x, long j, bool in) {
  using N = Num<T>;
  if (out) N::store(out, i, -N::rnd(__fmul_rn(g, in ? N::load(x, j) : 0.f)));
}

template <typename T>
__global__ void __launch_bounds__(CELL_X * CELL_Y)
stencil_matvec_grad_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const T* __restrict__ ce, const T* __restrict__ cw,
                           const T* __restrict__ cn, const T* __restrict__ cs,
                           const T* __restrict__ dg, T* __restrict__ d_x,
                           T* __restrict__ d_ce, T* __restrict__ d_cw,
                           T* __restrict__ d_cn, T* __restrict__ d_cs,
                           T* __restrict__ d_dg, int ny, int nx) {
  using N = Num<T>;
  const int gx = blockIdx.x * CELL_X + threadIdx.x;
  const int gy = blockIdx.y * CELL_Y + threadIdx.y;
  if (gx >= nx || gy >= ny) return;
  const long i = (long)blockIdx.z * ny * nx + (long)gy * nx + gx;
  const bool e = gx + 1 < nx, w = gx > 0, n = gy + 1 < ny, s = gy > 0;
  const float gc = N::load(g, i);
  if (d_x) {
    float a = N::rnd(__fmul_rn(N::load(dg, i), gc));
    a = N::rnd(__fsub_rn(a, term(ce, g, i - 1, w)));    // W(c_e*g)
    a = N::rnd(__fsub_rn(a, term(cw, g, i + 1, e)));    // E(c_w*g)
    a = N::rnd(__fsub_rn(a, term(cn, g, i - nx, s)));   // S(c_n*g)
    a = N::rnd(__fsub_rn(a, term(cs, g, i + nx, n)));   // N(c_s*g)
    N::store(d_x, i, a);
  }
  coef_grad(d_ce, i, gc, x, i + 1, e);
  coef_grad(d_cw, i, gc, x, i - 1, w);
  coef_grad(d_cn, i, gc, x, i + nx, n);
  coef_grad(d_cs, i, gc, x, i - nx, s);
  if (d_dg) N::store(d_dg, i, __fmul_rn(gc, N::load(x, i)));
}

template <typename T>
int launch_grad(const T* g, const T* x, const T* ce, const T* cw,
                const T* cn, const T* cs, const T* dg, T* d_x, T* d_ce,
                T* d_cw, T* d_cn, T* d_cs, T* d_dg, int planes, int ny,
                int nx, void* stream) {
  const int gy = (ny + CELL_Y - 1) / CELL_Y;
  const bool coef = d_ce || d_cw || d_cn || d_cs || d_dg;
  if (planes <= 0 || planes > MAX_GRID || ny <= 0 || nx <= 0
      || gy > MAX_GRID || !g || (d_x && (!ce || !cw || !cn || !cs || !dg))
      || (coef && !x)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!d_x && !coef) return 0;
  const dim3 grid((nx + CELL_X - 1) / CELL_X, gy, planes);
  stencil_matvec_grad_kernel<T>
      <<<grid, dim3(CELL_X, CELL_Y), 0, (cudaStream_t)stream>>>(
          g, x, ce, cw, cn, cs, dg, d_x, d_ce, d_cw, d_cn, d_cs, d_dg, ny,
          nx);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
#define STENCIL_GRAD_ENTRY(SUFFIX, T)                                       \
  extern "C" int stencil_matvec_grad_##SUFFIX(                              \
      const T* g, const T* x, const T* ce, const T* cw, const T* cn,        \
      const T* cs, const T* dg, T* d_x, T* d_ce, T* d_cw, T* d_cn,          \
      T* d_cs, T* d_dg, int planes, int ny, int nx, void* stream) {         \
    return launch_grad<T>(g, x, ce, cw, cn, cs, dg, d_x, d_ce, d_cw, d_cn,  \
                          d_cs, d_dg, planes, ny, nx, stream);              \
  }

STENCIL_GRAD_ENTRY(f32, float)
STENCIL_GRAD_ENTRY(bf16, __nv_bfloat16)

extern "C" const char* stencil_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
