// Skip-field ray march (sphere-trace walk) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this walk to XLA
// (focnerf_tpu/ops/marching.py::march_rays_skip, a lax.while_loop that its
// fused K-step chunk holds inside its lax.scan). The port's plain version,
// focnerf_tpu_torch/ops/marching.py::march_rays_skip, moves every ray one
// step per iteration and asks the host every 4 iterations whether a ray is
// still marching. That host read is what a CUDA graph cannot hold, and it
// left the device idle for most of a training step; this kernel walks each
// ray to its end on the device, in one launch.
//
// One thread per ray. From its start t0 (the jittered near, computed by the
// wrapper with the plain version's torch expression) the thread loops: at
// t it takes dt = clamp(t * gamma, dt_min, dt_max), the point's mip level
// (frexp exponents of the point's max-norm and of dt * H / 2) and its cell
// in that level's H^3 grid, and reads the uint8 skip code there. Code 0
// (occupied) records the sample (t, dt) and steps by dt; code v >= 1 leaps
// past the cell exit plus v - 2 safe cells by a whole number of recurrence
// steps, stopping at the first lattice point past a dt phase boundary. The
// ray ends with `slab` samples, past `far`, or after `max_iters` iterations:
// the plain walk runs every live ray once per iteration under a global cap
// of the same size, so the per-ray cap is the same cap.
//
// The result must equal the plain walk's bit for bit (a 1-ulp change in t
// flips a later leap's floor and moves the ray to another lattice), so the
// arithmetic is the plain version's, op for op, as torch's CUDA kernels
// compute it:
//   - every add, multiply and divide is an explicit __f*_rn intrinsic, so
//     nothing is contracted into an FMA (torch runs each op as its own
//     kernel, rounding after each);
//   - where the plain version divides a tensor by a Python float, torch
//     multiplies by the reciprocal computed on the host (1 / x in double,
//     rounded to fp32); the wrapper passes those factors, and the kernel
//     multiplies. Division by a tensor (x / mip_bound, the axis exits,
//     s_want / dt) is true division; `t_hi / t_pos` (a float over a
//     tensor) is torch's reciprocal of the tensor times the float;
//   - log1pf, logf, powf and exp2f are the device library's functions that
//     torch's kernels call, in float; frexpf gives _mip_level's exponents.
//
// Outputs: ts, dts [N, slab] (0 past the ray's count), valid [N, slab],
// count [N] int64, the ray's iteration count [N] int32, and the longest
// ray's count (atomicMax into one int32) for MarchResult.iters.
//
// Bound: bytes. Per ray it reads its origin, direction, t0 and far (32 B),
// one byte of the skip field per iteration, and writes 9 * slab + 12 B of
// output; at the -O training shape (4096 rays, slab 128) that is ~5 MB,
// ~1.5 us at 3.35 TB/s. What holds it far above that is latency: each
// iteration's byte read depends on the last iteration's t, the walk is
// ~slab + a few dozen iterations long, and 4096 threads fill a few warps a
// SM. A warp-per-ray or persistent design is later work; this one is the
// plain walk made whole on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct MarchParams {
  float bound;
  float dt_gamma;
  float dt_min;
  float dt_max;
  float inv_grid;     // fp32(1 / grid_size), as torch's x / grid_size
  float inv_dt_min;   // fp32(1 / dt_min), as torch's x / dt_min
  float inv_log_g;    // fp32(1 / log(1 + gamma)), as torch's x / math.log(g)
  float g;            // float(1 + gamma)
  float t_lo;         // float(dt_min / gamma)
  float t_hi;         // float(dt_max / gamma)
  float grid_f;       // float(grid_size)
  float sqrt3;        // float(sqrt(3))
  float cell_eps;     // float(1e-3)
  float dir_eps;      // float(1e-12)
  float t_pos_min;    // float(1e-6)
  int grid_size;
  int cascades;
  int slab;
  int max_iters;
  int geometric;      // gamma > 0
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp(x, lo, hi) = min(max(x, lo), hi) (no NaNs reach it here)
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ int frexp_exp(float x) {
  int e;
  frexpf(x, &e);
  return e;
}

__global__ void march_skip_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                                  const float* __restrict__ t0, const float* __restrict__ fars,
                                  const uint8_t* __restrict__ skip, MarchParams p, int n,
                                  float* __restrict__ out_t, float* __restrict__ out_dt,
                                  bool* __restrict__ valid, long long* __restrict__ count_out,
                                  int* __restrict__ iters_out, int* __restrict__ iters_max) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};
  // torch.where(|d| < 1e-12, sign(d) + 1e-12, d)
  float d_safe[3];
  int step_dir[3];
  for (int i = 0; i < 3; ++i) {
    const float s = d[i] > 0.f ? 1.f : (d[i] < 0.f ? -1.f : 0.f);
    d_safe[i] = fabsf(d[i]) < p.dir_eps ? __fadd_rn(s, p.dir_eps) : d[i];
    step_dir[i] = d[i] > 0.f ? 1 : 0;
  }
  const float far = fars[r];
  const long long G = p.grid_size;
  const long long G3 = G * G * G;
  float* ts_row = out_t + (size_t)r * p.slab;
  float* dts_row = out_dt + (size_t)r * p.slab;

  float t = t0[r];
  int count = 0;
  int it = 0;
  while (it < p.max_iters && t < far && count < p.slab) {
    ++it;
    const float dt = clampf(__fmul_rn(t, p.dt_gamma), p.dt_min, p.dt_max);
    float x[3];
    float amax = 0.f;
    for (int i = 0; i < 3; ++i) {
      x[i] = clampf(__fadd_rn(o[i], __fmul_rn(d[i], t)), -p.bound, p.bound);
      amax = fmaxf(amax, fabsf(x[i]));
    }
    // _mip_level: max(frexp(|x|max).e, frexp(dt * H * 0.5).e) in [0, CAS - 1]
    int level = max(frexp_exp(amax), frexp_exp(__fmul_rn(__fmul_rn(dt, p.grid_f), 0.5f)));
    level = min(max(level, 0), p.cascades - 1);
    const float mip_bound = fminf(exp2f((float)level), p.bound);
    const float cs = __fmul_rn(__fmul_rn(2.0f, mip_bound), p.inv_grid);
    long long cell[3];
    for (int i = 0; i < 3; ++i) {
      // 0.5 * (x / mip_bound + 1.0) * grid_size
      const float cf = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(x[i], mip_bound), 1.0f), 0.5f), p.grid_f);
      long long c = (long long)cf;
      cell[i] = c < 0 ? 0 : (c > G - 1 ? G - 1 : c);
    }
    const long long flat = (long long)level * G3 + cell[0] * G * G + cell[1] * G + cell[2];
    const int v = skip[flat];
    const bool occupied = v == 0;
    if (occupied) {
      ts_row[count] = t;
      dts_row[count] = dt;
      ++count;
      t = __fadd_rn(t, dt);
      continue;
    }
    // leap: past the cell exit (+ v - 2 safe cells), in whole dt steps
    float t_exit = INFINITY;
    for (int i = 0; i < 3; ++i) {
      const float corner = (float)(cell[i] + step_dir[i]);
      const float world_next =
          __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(corner, p.inv_grid), 2.0f), 1.0f), mip_bound);
      const float ta = __fdiv_rn(__fsub_rn(world_next, x[i]), d_safe[i]);
      const float cand = ta > 0.f ? ta : INFINITY;
      t_exit = cand < t_exit ? cand : t_exit;
    }
    const float guard = __fmul_rn(cs, p.sqrt3);
    t_exit = t_exit < guard ? t_exit : guard;
    const float extra = __fmul_rn(fmaxf(__fsub_rn((float)v, 2.0f), 0.0f), cs);
    const float s_want = __fadd_rn(__fadd_rn(t_exit, __fmul_rn(cs, p.cell_eps)), extra);
    float adv;
    if (!p.geometric) {
      adv = __fmul_rn(__fadd_rn(floorf(__fmul_rn(s_want, p.inv_dt_min)), 1.0f), p.dt_min);
    } else {
      const float m_lin = __fadd_rn(floorf(__fdiv_rn(s_want, dt)), 1.0f);
      const float m_lo_b = fmaxf(__fadd_rn(floorf(__fmul_rn(__fsub_rn(p.t_lo, t), p.inv_dt_min)), 1.0f), 1.0f);
      const float t_pos = fmaxf(t, p.t_pos_min);
      const float m_geo = ceilf(__fmul_rn(log1pf(__fdiv_rn(s_want, t_pos)), p.inv_log_g));
      const float ratio = fmaxf(__fmul_rn(__fdiv_rn(1.0f, t_pos), p.t_hi), 1.0f);
      const float m_geo_b = ceilf(__fmul_rn(logf(ratio), p.inv_log_g));
      const float m_g = fminf(fmaxf(m_geo, 1.0f), fmaxf(m_geo_b, 1.0f));
      const float tg = __fmul_rn(t, p.dt_gamma);
      if (tg <= p.dt_min) {
        adv = __fmul_rn(fminf(m_lin, m_lo_b), dt);
      } else if (tg >= p.dt_max) {
        adv = __fmul_rn(m_lin, dt);
      } else {
        adv = __fsub_rn(__fmul_rn(t, powf(p.g, m_g)), t);
      }
    }
    t = __fadd_rn(t, adv);
  }
  for (int k = 0; k < p.slab; ++k) {
    const bool keep = k < count;
    valid[(size_t)r * p.slab + k] = keep;
    if (!keep) {
      ts_row[k] = 0.f;
      dts_row[k] = 0.f;
    }
  }
  count_out[r] = count;
  iters_out[r] = it;
  atomicMax(iters_max, it);
}

}  // namespace

extern "C" int focnerf_march_skip(const void* rays_o, const void* rays_d, const void* t0, const void* fars,
                                  const void* skip, float bound, float dt_gamma, float dt_min, float dt_max,
                                  float inv_grid, float inv_dt_min, float inv_log_g, float g, float t_lo,
                                  float t_hi, float grid_f, float sqrt3, float cell_eps, float dir_eps,
                                  float t_pos_min, int grid_size, int cascades, int slab, int max_iters,
                                  int geometric, int n, void* out_t, void* out_dt, void* valid, void* count,
                                  void* iters, void* iters_max, void* stream) {
  MarchParams p{bound,  dt_gamma, dt_min,   dt_max,  inv_grid,  inv_dt_min, inv_log_g, g,        t_lo,      t_hi,
                grid_f, sqrt3,    cell_eps, dir_eps, t_pos_min, grid_size,  cascades,  slab,     max_iters, geometric};
  if (n > 0) {
    constexpr int kThreads = 128;
    march_skip_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays_o), static_cast<const float*>(rays_d), static_cast<const float*>(t0),
        static_cast<const float*>(fars), static_cast<const uint8_t*>(skip), p, n, static_cast<float*>(out_t),
        static_cast<float*>(out_dt), static_cast<bool*>(valid), static_cast<long long*>(count),
        static_cast<int*>(iters), static_cast<int*>(iters_max));
  }
  return static_cast<int>(cudaGetLastError());
}
