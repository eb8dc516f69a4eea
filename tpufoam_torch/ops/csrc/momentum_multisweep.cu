// Coupled momentum multisweep: S <= 8 plain Jacobi sweeps of
//     u <- (a_e E(u) + a_w W(u) + a_n N(u) + a_s S(u) + b_u) * ap_inv
//     v <- (a_e E(v) + a_w W(v) + a_n N(v) + a_s S(v) + b_v) * ap_inv
// on (ny, nx) float32 fields, or on B such planes stacked as (B, ny, nx),
// in one launch.
//
// Replaces the TPU kernel tpufoam/ops/stencil.py `_make_momentum_kernel`
// (launched by `momentum_multisweep_pallas`, pallas_call in
// `_momentum_multisweep_impl`). It equals the plain sweep loop of
// tpufoam/fv/momentum.py `jacobi_momentum`: a neighbour beyond the domain
// reads as 0, and ap_inv = fluid / a_P carries the solid mask, so solid
// cells stay 0.
//
// The batched launch replaces the TPU kernel's custom_vmap rule
// (tpufoam/ops/stencil.py `_msp_custom` / `_msp_batched`), which folds B
// cases into the rows of one pallas_call with 2*halo zero separator rows.
// Here blockIdx.z is the case: a block works inside one case's plane, and
// its reads are bounded by the plane, so cases stay apart without
// separator rows. The per-cell arithmetic is the single-plane kernel's,
// so a launch over B planes equals B launches over one plane bit for bit.
//
// Bound at 512 x 2048 f32: 9 operand reads + 2 output writes of 4 MiB
// each = 46.1 MB, 13.8 us at 3.35 TB/s: memory-bound. It runs once per
// PISO step; the fleet of B cases moves B times that in its one launch
// per lockstep (4 x 512 x 2048: 184.5 MB, 55.1 us at the same published
// 3.35 TB/s of the H100 SXM at its 700 W limit).
//
// Design. What held the first port of this kernel back (32 x 32 tiles in
// 48 x 48 regions, u and v in shared memory, the coefficients read from
// global memory at every cell of every sweep): the seven coefficient
// fields were re-read on each of the 8 sweeps, about 0.5 GB per call
// through L2 against 46 MB of compulsory traffic, and its time grew by
// 10-11 us a sweep from a ~27 us floor (tools/kernel_times.py on the
// H100). This kernel reads every operand once per call (36.9 us at 8
// sweeps, 25.8 us at 1, on the same tool and card):
//
// - Each block owns a TILE_Y x TILE_X = 32 x 48 tile of outputs inside a
//   REG_Y x REG_X = 48 x 64 region (HALO = 8 cells per side: 2.0x the
//   tile's cells, against 2.25x for 32 x 32 tiles). Its 8 warps stand on
//   top of each other: warp w owns region rows 6w .. 6w+5, and lane l the
//   two adjacent columns 2l and 2l+1. So a thread owns 12 cells for the
//   whole call, and holds their seven coefficients, u and v in registers
//   (9 x 12 = 108 values; __launch_bounds__(256, 2) keeps it at 128
//   registers, two blocks resident per SM). The loads are coalesced
//   across the warp's lanes, one pass over each field.
// - A sweep moves only u and v between threads. E/W: a thread's two
//   columns are each other's neighbours; the right column's east is the
//   next lane's left column and the left column's west the previous
//   lane's right column (__shfl_*_sync). N/S: within a warp's six rows
//   from the thread's own registers; across a warp boundary each warp
//   publishes its lowest and highest rows in shared memory (two buffers
//   in turn, so one __syncthreads a sweep suffices).
// - Whether a cell is frozen (the region's outer ring, or beyond the
//   domain, loaded as 0) is decided once, before the sweeps, into a mask;
//   a sweep only computes and selects. No division, no index arithmetic
//   per cell in the sweep loop.
//
// Exactness: the ring is never updated, so after sweep k a cell is exact
// if it lies at least k cells inside it (the trapezoid argument) and the
// tile, HALO cells inside, is exact for sweeps <= HALO. A cell beyond the
// domain loads as 0 and stays 0, the zero-padded neighbour of the plain
// version; the kernel never reads out of range. Each cell's update is one
// fixed expression,
//     u' = ((((a_e E) + a_w W) + a_n N) + a_s S + b_u) * ap_inv
// with the three inner sums contracted into fmaf (fmaf(a_w, W, a_e E),
// ...), the add of b_u and the multiply by ap_inv rounded alone; so the
// batched launch equals B single launches, and the sharded launch the
// single one, bit for bit. It differs from the plain version (which
// rounds every product) by a few float32 roundings per sweep.

#include <cuda_runtime.h>

namespace {

constexpr int HALO = 8;
constexpr int COLS = 2;                    // adjacent columns per thread
constexpr int REG_X = 32 * COLS;           // 64
constexpr int TILE_X = REG_X - 2 * HALO;   // 48
constexpr int ROWS = 6;                    // rows per thread (and warp)
constexpr int WARPS = 8;                   // warps of a block, stacked
constexpr int THREADS = 32 * WARPS;
constexpr int REG_Y = ROWS * WARPS;        // 48
constexpr int TILE_Y = REG_Y - 2 * HALO;   // 32
static_assert(ROWS * COLS <= 32, "the frozen mask is one 32-bit word");
constexpr unsigned FULL_MASK = 0xffffffffu;

// one Jacobi update of a cell from its four neighbours
__device__ __forceinline__ float update(float ae, float aw, float an,
                                        float as, float bb, float api,
                                        float e, float w, float n, float s) {
  float t = __fmul_rn(ae, e);
  t = __fmaf_rn(aw, w, t);
  t = __fmaf_rn(an, n, t);
  t = __fmaf_rn(as, s, t);
  return __fmul_rn(__fadd_rn(t, bb), api);
}

__global__ void __launch_bounds__(THREADS, 2)
momentum_multisweep_kernel(const float* __restrict__ a_e,
                           const float* __restrict__ a_w,
                           const float* __restrict__ a_n,
                           const float* __restrict__ a_s,
                           const float* __restrict__ ap_inv,
                           const float* __restrict__ b_u,
                           const float* __restrict__ b_v,
                           const float* __restrict__ u0,
                           const float* __restrict__ v0,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out,
                           int ny, int nx, int sweeps) {
  // [buffer][u or v][warp][its lowest or highest row][column][lane]
  __shared__ float edge[2][2][WARPS][2][COLS][32];
  // this block's case: offset every plane to it
  const long plane = (long)blockIdx.z * ny * nx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * ROWS;              // region row of the first row
  const int c0 = lane * COLS;              // region column of the first
  const int gy0 = blockIdx.y * TILE_Y - HALO + r0;
  const int gx0 = blockIdx.x * TILE_X - HALO + c0;

  float ae[ROWS][COLS], aw[ROWS][COLS], an[ROWS][COLS], as[ROWS][COLS];
  float api[ROWS][COLS], bu[ROWS][COLS], bv[ROWS][COLS];
  float u[ROWS][COLS], v[ROWS][COLS];
  unsigned live = 0;                       // bit i*COLS+j: updated
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int gy = gy0 + i, gx = gx0 + j;
      const bool inside = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
      const bool ring = r0 + i == 0 || r0 + i == REG_Y - 1 || c0 + j == 0
                        || c0 + j == REG_X - 1;
      ae[i][j] = aw[i][j] = an[i][j] = as[i][j] = 0.f;
      api[i][j] = bu[i][j] = bv[i][j] = u[i][j] = v[i][j] = 0.f;
      if (inside) {
        const long g = plane + (long)gy * nx + gx;
        ae[i][j] = __ldg(a_e + g);
        aw[i][j] = __ldg(a_w + g);
        an[i][j] = __ldg(a_n + g);
        as[i][j] = __ldg(a_s + g);
        api[i][j] = __ldg(ap_inv + g);
        bu[i][j] = __ldg(b_u + g);
        bv[i][j] = __ldg(b_v + g);
        u[i][j] = __ldg(u0 + g);
        v[i][j] = __ldg(v0 + g);
        if (!ring) live |= 1u << (i * COLS + j);
      }
    }
  }
  // the neighbouring warps' rows: below this warp's first row, above its
  // last (the ring rows 0 and REG_Y - 1 never read theirs)
  const int below = warp > 0 ? warp - 1 : 0;
  const int above = warp < WARPS - 1 ? warp + 1 : WARPS - 1;

  for (int s = 0; s < sweeps; ++s) {
    float (*ex)[WARPS][2][COLS][32] = edge[s & 1];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      ex[0][warp][0][j][lane] = u[0][j];
      ex[0][warp][1][j][lane] = u[ROWS - 1][j];
      ex[1][warp][0][j][lane] = v[0][j];
      ex[1][warp][1][j][lane] = v[ROWS - 1][j];
    }
    __syncthreads();
    float su[COLS], sv[COLS];              // the old row below
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      su[j] = ex[0][below][1][j][lane];
      sv[j] = ex[1][below][1][j][lane];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float ue = __shfl_down_sync(FULL_MASK, u[i][0], 1);
      const float uw = __shfl_up_sync(FULL_MASK, u[i][COLS - 1], 1);
      const float ve = __shfl_down_sync(FULL_MASK, v[i][0], 1);
      const float vw = __shfl_up_sync(FULL_MASK, v[i][COLS - 1], 1);
      float nu[COLS], nv[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float e_u = j + 1 < COLS ? u[i][j + 1] : ue;
        const float w_u = j > 0 ? u[i][j - 1] : uw;
        const float e_v = j + 1 < COLS ? v[i][j + 1] : ve;
        const float w_v = j > 0 ? v[i][j - 1] : vw;
        const float n_u = i + 1 < ROWS ? u[i + 1][j]
                                       : ex[0][above][0][j][lane];
        const float n_v = i + 1 < ROWS ? v[i + 1][j]
                                       : ex[1][above][0][j][lane];
        nu[j] = update(ae[i][j], aw[i][j], an[i][j], as[i][j], bu[i][j],
                       api[i][j], e_u, w_u, n_u, su[j]);
        nv[j] = update(ae[i][j], aw[i][j], an[i][j], as[i][j], bv[i][j],
                       api[i][j], e_v, w_v, n_v, sv[j]);
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        su[j] = u[i][j];
        sv[j] = v[i][j];
        if (live >> (i * COLS + j) & 1u) {
          u[i][j] = nu[j];
          v[i][j] = nv[j];
        }
      }
    }
  }

  // the tile: region rows and columns HALO .. HALO + TILE - 1
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int gy = gy0 + i, gx = gx0 + j;
      if (r0 + i >= HALO && r0 + i < HALO + TILE_Y && c0 + j >= HALO
          && c0 + j < HALO + TILE_X && gy < ny && gx < nx) {
        const long g = plane + (long)gy * nx + gx;
        u_out[g] = u[i][j];
        v_out[g] = v[i][j];
      }
    }
  }
}

}  // namespace

// Launches on `stream` over `planes` contiguous (ny, nx) planes of every
// operand and returns cudaGetLastError() (0 on success).
extern "C" int momentum_multisweep_f32(
    const float* a_e, const float* a_w, const float* a_n, const float* a_s,
    const float* ap_inv, const float* b_u, const float* b_v,
    const float* u0, const float* v0, float* u_out, float* v_out,
    int planes, int ny, int nx, int sweeps, void* stream) {
  if (planes <= 0 || planes > 65535 || ny <= 0 || nx <= 0 || sweeps < 0
      || sweeps > HALO || (ny + TILE_Y - 1) / TILE_Y > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y,
                  planes);
  momentum_multisweep_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a_e, a_w, a_n, a_s, ap_inv, b_u, b_v, u0, v0, u_out, v_out, ny, nx,
      sweeps);
  return (int)cudaGetLastError();
}

extern "C" const char* momentum_multisweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
