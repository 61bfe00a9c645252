// Skip-field ray march (sphere-trace walk) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this walk to XLA
// (focnerf_tpu/ops/marching.py::march_rays_skip, a lax.while_loop that its
// fused K-step chunk holds inside its lax.scan). The port's plain version,
// focnerf_tpu_torch/ops/marching.py::march_skip_plain, moves every ray one
// step per iteration and asks the host every 4 iterations whether a ray is
// still marching. That host read is what a CUDA graph cannot hold; this
// kernel walks each ray to its end on the device, in one launch.
//
// The walk. From its start t0 (the jittered near, computed by the wrapper
// with the plain version's torch expression) a ray iterates: at t it takes
// dt = clamp(t * gamma, dt_min, dt_max), the point's mip level (frexp
// exponents of the point's max-norm and of dt * H / 2) and its cell in that
// level's H^3 grid, and reads the uint8 skip code there. Code 0 (occupied)
// records the sample (t, dt) and steps by dt; code v >= 1 leaps past the
// cell exit plus v - 2 safe cells by a whole number of recurrence steps,
// stopping at the first lattice point past a dt phase boundary. The ray ends
// with `slab` samples, past `far`, or after `max_iters` iterations (the
// plain walk's global cap, which every live ray reaches at the same count).
//
// The design: a group of L lanes (1 to 32, a template parameter; the
// wrapper's march_lanes picks it per shape) walks one ray. A run of
// occupied samples advances by the recurrence alone, with no memory read, so
// each round lane k chains k recurrence steps from the ray's t to the
// round's k-th lattice point, computes its level and cell and issues its
// skip-byte read: the round's W <= L reads are in flight together, one L2
// latency instead of W. While they are in flight each lane computes the
// terms of its point's leap that do not depend on the code (the cell exit,
// and per dt phase the step count to the phase boundary). A ballot finds the
// first lane that takes no sample (its code is not 0, or its point fails the
// loop's own test: it + k < max_iters, t_k < far, count + k < slab); the
// lanes before it write their samples to ts/dts[count + k], coalesced. If
// that lane failed only on its code, it finishes its leap (one iteration;
// powf(g, m) comes from a per-block table of the same calls) and the group
// goes on from the landing; otherwise the ray is done. A round after a leap
// starts `ramp` lanes wide and each round that samples all its lanes doubles
// the width up to L, so a stretch of leaps does not pay for chains that the
// next code throws away. Every lane of a warp stays in the loop until the
// warp's last ray is done, so ballots and shuffles are whole-warp ones
// (per-group masks made the warp's groups wait on each other). The group
// then writes the row's tail (ts, dts = 0 and valid) lane-strided. Blocks
// shrink from 128 threads to a warp until the grid has two blocks an SM.

// The result must equal the plain walk's bit for bit (a 1-ulp change in t
// flips a later leap's floor and moves the ray to another lattice), so the
// arithmetic is the plain version's, op for op, as torch's CUDA kernels
// compute it, and each lane's chain is the serial walk's sequence of
// rounded ops:
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
// count [N] int64, the ray's iteration count [N] int32 (one per sample and
// one per leap), and the longest ray's count (atomicMax into one int32) for
// MarchResult.iters.
//
// Bound. Bytes: per ray its origin, direction, t0 and far (32 B), one byte
// of the skip field per iteration, 9 * slab + 12 B of output; at the -O
// training shape (4096 rays, slab 128) ~5 MB, ~1.6 us at 3.35 TB/s. Latency:
// a leap's landing depends on the code it read, so a ray's leaps form a
// chain of dependent reads of the L2-resident field that no design shortens;
// (the longest ray's leaps + 1) x the card's dependent-load latency
// (focnerf_load_chase below) is the walk's latency bound, the larger of the
// two at the main path's shapes. What holds the kernel above it is the
// arithmetic between two reads: a round's cell lookup before its read and
// the leap's division and log1pf after it are one dependent chain of
// exactly rounded ops, several times a read's latency; the lane groups cut
// the rounds a run of samples takes, not that chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

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

constexpr int kMaxThreads = 128;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp(x, lo, hi) = min(max(x, lo), hi). It differs from torch's
  // only at a NaN, which no point takes: a NaN t fails t < far, as in the
  // plain walk, and whatever follows it in a chain is NaN either way
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float step_dt(float t, const MarchParams& p) {
  return clampf(__fmul_rn(t, p.dt_gamma), p.dt_min, p.dt_max);
}

__device__ __forceinline__ int frexp_exp(float x) {
  int e;
  frexpf(x, &e);
  return e;
}

// A lattice point's place in the skip field: its clamped position, mip
// level's half-extent and cell size, and its cell.
struct Point {
  float x[3];
  float mip_bound;
  float cs;
  int cell[3];
  int flat;
};

__device__ __forceinline__ Point locate(const float o[3], const float d[3], float t, float dt,
                                        const MarchParams& p) {
  Point q;
  float amax = 0.f;
  for (int i = 0; i < 3; ++i) {
    q.x[i] = clampf(__fadd_rn(o[i], __fmul_rn(d[i], t)), -p.bound, p.bound);
    amax = fmaxf(amax, fabsf(q.x[i]));
  }
  // _mip_level: max(frexp(|x|max).e, frexp(dt * H * 0.5).e) in [0, CAS - 1]
  int level = max(frexp_exp(amax), frexp_exp(__fmul_rn(__fmul_rn(dt, p.grid_f), 0.5f)));
  level = min(max(level, 0), p.cascades - 1);
  const float scale = exp2f((float)level);
  q.mip_bound = fminf(scale, p.bound);
  q.cs = __fmul_rn(__fmul_rn(2.0f, q.mip_bound), p.inv_grid);
  // x / 2^level is x * 2^-level exactly (both round the same real number)
  const bool pow2 = scale <= p.bound;
  const float inv_scale = exp2f((float)-level);
  const int G = p.grid_size;
  for (int i = 0; i < 3; ++i) {
    // 0.5 * (x / mip_bound + 1.0) * grid_size, truncated as .to(int64)
    const float u = pow2 ? __fmul_rn(q.x[i], inv_scale) : __fdiv_rn(q.x[i], q.mip_bound);
    const float cf = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), p.grid_f);
    const int c = (int)cf;
    q.cell[i] = c < 0 ? 0 : (c > G - 1 ? G - 1 : c);
  }
  q.flat = ((level * G + q.cell[0]) * G + q.cell[1]) * G + q.cell[2];
  return q;
}

// The leap's terms that do not depend on the skip code: computed while the
// code's read is in flight. The plain walk computes every term and selects
// by dt's phase; each phase's terms alone give the same value.
struct LeapPrep {
  float base;     // t_exit + cs * 1e-3: the advance that clears the cell
  float m_lo_b;   // below the geometric phase: steps to t_lo
  float m_geo_b;  // in it: steps to t_hi
  float t_pos;
  int phase;      // 0 linear (gamma 0), 1 below (dt = dt_min), 2 above (dt_max), 3 geometric
};

__device__ __forceinline__ LeapPrep leap_prep(const Point& q, float t, const float d_safe[3],
                                              const int step_dir[3], const MarchParams& p) {
  LeapPrep l;
  float t_exit = INFINITY;
  for (int i = 0; i < 3; ++i) {
    const float corner = (float)(q.cell[i] + step_dir[i]);
    const float world_next =
        __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(corner, p.inv_grid), 2.0f), 1.0f), q.mip_bound);
    const float ta = __fdiv_rn(__fsub_rn(world_next, q.x[i]), d_safe[i]);
    const float cand = ta > 0.f ? ta : INFINITY;
    t_exit = cand < t_exit ? cand : t_exit;
  }
  const float guard = __fmul_rn(q.cs, p.sqrt3);
  t_exit = t_exit < guard ? t_exit : guard;
  l.base = __fadd_rn(t_exit, __fmul_rn(q.cs, p.cell_eps));
  l.m_lo_b = l.m_geo_b = l.t_pos = 0.f;
  if (!p.geometric) {
    l.phase = 0;
    return l;
  }
  const float tg = __fmul_rn(t, p.dt_gamma);
  if (tg <= p.dt_min) {
    l.phase = 1;
    l.m_lo_b = fmaxf(__fadd_rn(floorf(__fmul_rn(__fsub_rn(p.t_lo, t), p.inv_dt_min)), 1.0f), 1.0f);
  } else if (tg >= p.dt_max) {
    l.phase = 2;
  } else {
    l.phase = 3;
    l.t_pos = fmaxf(t, p.t_pos_min);
    const float ratio = fmaxf(__fmul_rn(__fdiv_rn(1.0f, l.t_pos), p.t_hi), 1.0f);
    l.m_geo_b = ceilf(__fmul_rn(logf(ratio), p.inv_log_g));
  }
  return l;
}

// The advance of a leap from t over an empty cell with code v >= 1 (cell
// size cs). pow_g[m - 1] holds powf(g, m) for m <= pow_n.
__device__ __forceinline__ float leap_advance(const LeapPrep& l, float cs, int v, float t, float dt,
                                              const float* pow_g, int pow_n, const MarchParams& p) {
  const float extra = __fmul_rn(fmaxf(__fsub_rn((float)v, 2.0f), 0.0f), cs);
  const float s_want = __fadd_rn(l.base, extra);
  if (l.phase == 0) return __fmul_rn(__fadd_rn(floorf(__fmul_rn(s_want, p.inv_dt_min)), 1.0f), p.dt_min);
  if (l.phase < 3) {
    const float m_lin = __fadd_rn(floorf(__fdiv_rn(s_want, dt)), 1.0f);
    return __fmul_rn(l.phase == 1 ? fminf(m_lin, l.m_lo_b) : m_lin, dt);
  }
  const float m_geo = ceilf(__fmul_rn(log1pf(__fdiv_rn(s_want, l.t_pos)), p.inv_log_g));
  const float m_g = fminf(fmaxf(m_geo, 1.0f), fmaxf(l.m_geo_b, 1.0f));
  const float power = m_g <= (float)pow_n ? pow_g[(int)m_g - 1] : powf(p.g, m_g);
  return __fsub_rn(__fmul_rn(t, power), t);
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
    march_skip_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                      const float* __restrict__ t0, const float* __restrict__ fars,
                      const uint8_t* __restrict__ skip, MarchParams p, int ramp, int pow_n, int n,
                      float* __restrict__ out_t, float* __restrict__ out_dt, bool* __restrict__ valid,
                      long long* __restrict__ count_out, int* __restrict__ iters_out,
                      int* __restrict__ iters_max) {
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "a lane group is 1, 2, 4, 8, 16 or 32 lanes");
  // powf(g, m) for the geometric leap's whole step counts m = 1..pow_n: the
  // same calls, once a block, off the leaps' dependent chain
  extern __shared__ float pow_g[];
  for (int i = threadIdx.x; i < pow_n; i += blockDim.x) pow_g[i] = powf(p.g, (float)(i + 1));
  __syncthreads();
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / L;  // the group's ray
  const int k = threadIdx.x % L;                             // lane in the group
  constexpr unsigned kFull = 0xffffffffu >> (32 - L);
  const int base = (threadIdx.x & 31) - k;  // the group's first lane in the warp
  // Every lane of a warp runs the loop until the warp's last ray is done,
  // so the ballots and shuffles below are whole-warp ones; the lanes of a
  // ray past n (reading ray n - 1) and of a finished ray take no part.
  const bool live = r < n;
  const int rr = live ? r : n - 1;

  const float o[3] = {rays_o[3 * rr], rays_o[3 * rr + 1], rays_o[3 * rr + 2]};
  const float d[3] = {rays_d[3 * rr], rays_d[3 * rr + 1], rays_d[3 * rr + 2]};
  // torch.where(|d| < 1e-12, sign(d) + 1e-12, d)
  float d_safe[3];
  int step_dir[3];
  for (int i = 0; i < 3; ++i) {
    const float s = d[i] > 0.f ? 1.f : (d[i] < 0.f ? -1.f : 0.f);
    d_safe[i] = fabsf(d[i]) < p.dir_eps ? __fadd_rn(s, p.dir_eps) : d[i];
    step_dir[i] = d[i] > 0.f ? 1 : 0;
  }
  const float far = fars[rr];
  float* ts_row = out_t + (size_t)rr * p.slab;
  float* dts_row = out_dt + (size_t)rr * p.slab;

  float t = t0[rr];
  int count = 0;
  int it = 0;
  int width = ramp;  // lanes that take part in this round
  bool done = !live;
  while (__any_sync(0xffffffffu, !done)) {
    // lane k's lattice point: k steps of the recurrence from t
    float tk = t;
    const int steps = k < width && !done ? k : 0;
    for (int i = 0; i < steps; ++i) tk = __fadd_rn(tk, step_dt(tk, p));
    const float dtk = step_dt(tk, p);
    // the serial loop's test at this lane's iteration
    const bool ok = !done && k < width && it + k < p.max_iters && tk < far && count + k < p.slab;
    Point q;
    LeapPrep l;
    int v = 1;
    if (ok) {
      q = locate(o, d, tk, dtk, p);
      v = __ldg(skip + q.flat);
      l = leap_prep(q, tk, d_safe, step_dir, p);
    }
    const unsigned sampled = (__ballot_sync(0xffffffffu, ok && v == 0) >> base) & kFull;
    const unsigned passed = (__ballot_sync(0xffffffffu, ok) >> base) & kFull;
    const int j = sampled == kFull ? L : __ffs(~sampled) - 1;  // the first lane without a sample
    if (k < j) {
      ts_row[count + k] = tk;
      dts_row[count + k] = dtk;
    }
    // lane j stopped on its code alone: it leaps; on a cap: the walk ends
    const bool leaps = j < width && ((passed >> j) & 1u);
    const bool ends = !leaps && j < width;
    // the landing: lane j - 1's next step after j samples, or lane j's leap
    float next = __fadd_rn(tk, dtk);
    if (leaps && k == j) next = __fadd_rn(tk, leap_advance(l, q.cs, v, tk, dtk, pow_g, pow_n, p));
    const float landing = __shfl_sync(0xffffffffu, next, leaps ? j : max(j - 1, 0), L);
    if (!done) {
      count += j;
      it += j + (leaps ? 1 : 0);
      t = landing;
      width = leaps ? ramp : min(2 * width, L);
      done = ends;
    }
  }
  if (!live) return;
  for (int s = k; s < p.slab; s += L) {
    const bool keep = s < count;
    valid[(size_t)r * p.slab + s] = keep;
    if (!keep) {
      ts_row[s] = 0.f;
      dts_row[s] = 0.f;
    }
  }
  if (k == 0) {
    count_out[r] = count;
    iters_out[r] = it;
    atomicMax(iters_max, it);
  }
}

template <int L>
void launch(const void* rays_o, const void* rays_d, const void* t0, const void* fars, const void* skip,
           const MarchParams& p, int ramp, int n, void* out_t, void* out_dt, void* valid, void* count, void* iters,
           void* iters_max, cudaStream_t stream) {
  // the geometric leap's largest step count: log(dt_max / dt_min) / log(g)
  // steps span the phase; a larger one (or a table past the shared memory
  // of a launch without opt-in) calls powf in the leap
  int pow_n = 0;
  if (p.geometric) {
    const double steps = std::ceil(std::log((double)p.dt_max / p.dt_min) / std::log((double)p.g)) + 2.0;
    pow_n = steps < 0.0 ? 0 : (int)std::fmin(steps, 12288.0);
  }
  // blocks of 128 threads, or smaller (down to a warp) until the grid
  // puts two blocks on every SM
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long threads = (long long)n * L;
  int block = kMaxThreads;
  while (block > 32 && (threads + block - 1) / block < 2LL * sms) block /= 2;
  const int blocks = (int)((threads + block - 1) / block);
  march_skip_kernel<L><<<blocks, block, pow_n * sizeof(float), stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d), static_cast<const float*>(t0),
      static_cast<const float*>(fars), static_cast<const uint8_t*>(skip), p, ramp, pow_n, n,
      static_cast<float*>(out_t), static_cast<float*>(out_dt), static_cast<bool*>(valid),
      static_cast<long long*>(count), static_cast<int*>(iters), static_cast<int*>(iters_max));
}

// One thread follows `steps` links of a cyclic index chain through an
// L2-resident buffer (ld.global.cg: cached in L2, not L1): each load's
// address is the last load's value, so the run takes steps x the card's
// dependent-load latency.
__global__ void load_chase_kernel(const unsigned* __restrict__ next, int steps, unsigned* __restrict__ out) {
  unsigned i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}

}  // namespace

// lanes: the group width L (1, 2, 4, 8, 16 or 32); ramp: a round's width after a
// leap (1 <= ramp <= lanes), doubled up to L by each round of samples only.
extern "C" int focnerf_march_skip(const void* rays_o, const void* rays_d, const void* t0, const void* fars,
                                  const void* skip, float bound, float dt_gamma, float dt_min, float dt_max,
                                  float inv_grid, float inv_dt_min, float inv_log_g, float g, float t_lo,
                                  float t_hi, float grid_f, float sqrt3, float cell_eps, float dir_eps,
                                  float t_pos_min, int grid_size, int cascades, int slab, int max_iters,
                                  int geometric, int lanes, int ramp, int n, void* out_t, void* out_dt,
                                  void* valid, void* count, void* iters, void* iters_max, void* stream) {
  MarchParams p{bound,  dt_gamma, dt_min,   dt_max,  inv_grid,  inv_dt_min, inv_log_g, g,        t_lo,      t_hi,
                grid_f, sqrt3,    cell_eps, dir_eps, t_pos_min, grid_size,  cascades,  slab,     max_iters, geometric};
  if (ramp < 1 || ramp > lanes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
#define FOCNERF_MARCH_CASE(L)                                                                               \
  case L:                                                                                                   \
    launch<L>(rays_o, rays_d, t0, fars, skip, p, ramp, n, out_t, out_dt, valid, count, iters, iters_max, s); \
    break;
    switch (lanes) {
      FOCNERF_MARCH_CASE(1)
      FOCNERF_MARCH_CASE(2)
      FOCNERF_MARCH_CASE(4)
      FOCNERF_MARCH_CASE(8)
      FOCNERF_MARCH_CASE(16)
      FOCNERF_MARCH_CASE(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FOCNERF_MARCH_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int focnerf_load_chase(const void* next, int steps, void* out, void* stream) {
  load_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const unsigned*>(next), steps,
                                                                     static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
