// Coupled momentum multisweep: S <= 8 plain Jacobi sweeps of
//     u <- (a_e E(u) + a_w W(u) + a_n N(u) + a_s S(u) + b_u) * ap_inv
//     v <- (a_e E(v) + a_w W(v) + a_n N(v) + a_s S(v) + b_v) * ap_inv
// on (ny, nx) float32 fields, in one launch.
//
// Replaces the TPU kernel tpufoam/ops/stencil.py `_make_momentum_kernel`
// (launched by `momentum_multisweep_pallas`, pallas_call in
// `_momentum_multisweep_impl`). It equals the plain sweep loop of
// tpufoam/fv/momentum.py `jacobi_momentum`: a neighbour beyond the domain
// reads as 0, and ap_inv = fluid / a_P carries the solid mask, so solid
// cells stay 0.
//
// Bound at 512 x 2048 f32: 9 operand reads + 2 output writes of 4 MiB
// each = 46.1 MB, 13.8 us at 3.35 TB/s: memory-bound. It runs once per
// PISO step.
//
// Design (simple and exact; speed is later work). Each block owns a
// TILE_Y x TILE_X tile of outputs and loads u and v over the tile plus a
// halo of HALO cells on all four sides into shared memory, where they
// ping-pong between two buffers. The coefficients are read from global
// memory (they stay in L1/L2 across the sweeps). The loaded region's outer
// ring is never updated: after sweep k a cell is exact if it lies at least
// k cells inside the ring (the trapezoid argument), so the tile, HALO
// cells inside it, is exact for sweeps <= HALO. Cells outside the domain
// load as 0 and are never updated, which is the zero-padded neighbour of
// the plain version; the kernel never reads out of range.

#include <cuda_runtime.h>

namespace {

constexpr int HALO = 8;
constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int REG_X = TILE_X + 2 * HALO;
constexpr int REG_Y = TILE_Y + 2 * HALO;
constexpr int REG = REG_X * REG_Y;
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = 4 * REG * sizeof(float);
static_assert(SMEM_BYTES <= 48 * 1024, "above 48 KB needs an opt-in");

__global__ void __launch_bounds__(THREADS)
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
  extern __shared__ float smem[];
  float* u_src = smem;
  float* u_dst = smem + REG;
  float* v_src = smem + 2 * REG;
  float* v_dst = smem + 3 * REG;

  const int gy0 = blockIdx.y * TILE_Y - HALO;
  const int gx0 = blockIdx.x * TILE_X - HALO;

  // load the haloed region into both buffers (the frozen ring and the
  // out-of-domain cells then hold their value in either buffer)
  for (int idx = threadIdx.x; idx < REG; idx += THREADS) {
    const int gy = gy0 + idx / REG_X;
    const int gx = gx0 + idx % REG_X;
    float u = 0.f, v = 0.f;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const long g = (long)gy * nx + gx;
      u = u0[g];
      v = v0[g];
    }
    u_src[idx] = u;
    u_dst[idx] = u;
    v_src[idx] = v;
    v_dst[idx] = v;
  }
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    for (int idx = threadIdx.x; idx < REG; idx += THREADS) {
      const int r = idx / REG_X;
      const int c = idx % REG_X;
      const int gy = gy0 + r;
      const int gx = gx0 + c;
      if (r == 0 || r == REG_Y - 1 || c == 0 || c == REG_X - 1) continue;
      if (gy < 0 || gy >= ny || gx < 0 || gx >= nx) continue;
      const long g = (long)gy * nx + gx;
      const float ae = a_e[g], aw = a_w[g], an = a_n[g], as = a_s[g];
      const float api = ap_inv[g];
      u_dst[idx] = (ae * u_src[idx + 1] + aw * u_src[idx - 1]
                    + an * u_src[idx + REG_X] + as * u_src[idx - REG_X]
                    + b_u[g]) * api;
      v_dst[idx] = (ae * v_src[idx + 1] + aw * v_src[idx - 1]
                    + an * v_src[idx + REG_X] + as * v_src[idx - REG_X]
                    + b_v[g]) * api;
    }
    __syncthreads();
    float* t = u_src; u_src = u_dst; u_dst = t;
    t = v_src; v_src = v_dst; v_dst = t;
  }

  for (int idx = threadIdx.x; idx < TILE_X * TILE_Y; idx += THREADS) {
    const int r = HALO + idx / TILE_X;
    const int c = HALO + idx % TILE_X;
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    if (gy < ny && gx < nx) {
      const long g = (long)gy * nx + gx;
      u_out[g] = u_src[r * REG_X + c];
      v_out[g] = v_src[r * REG_X + c];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int momentum_multisweep_f32(
    const float* a_e, const float* a_w, const float* a_n, const float* a_s,
    const float* ap_inv, const float* b_u, const float* b_v,
    const float* u0, const float* v0, float* u_out, float* v_out,
    int ny, int nx, int sweeps, void* stream) {
  if (ny <= 0 || nx <= 0 || sweeps < 0 || sweeps > HALO) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y);
  momentum_multisweep_kernel<<<grid, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(
      a_e, a_w, a_n, a_s, ap_inv, b_u, b_v, u0, v0, u_out, v_out,
      ny, nx, sweeps);
  return (int)cudaGetLastError();
}

extern "C" const char* momentum_multisweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
