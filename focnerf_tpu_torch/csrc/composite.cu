// Fused transmittance compositing, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel focnerf_tpu/ops/composite_pallas.py::
// composite_rays_fused (pl.pallas_call(_composite_kernel); its custom VJP
// differentiates the jnp reference). It computes the same function as the
// plain version in focnerf_tpu_torch/ops/composite.py, in the form of
// focnerf_tpu/ops/composite.py (not the log(1-a+1e-15) form of the Pallas
// kernel):
//
//   s_i      = dt_i * density_scale * sigma_i          (optical depth)
//   T_in_i   = exp(-(od0 + sum_{j<i} s_j))             (shifted exclusive prefix)
//   w_i      = (1 - exp(-s_i)) * T_in_i, zeroed where T_in_i < T_thresh
//   image    = sum_i w_i * rgb_i  +  (1 - weights_sum) * bg
//   weights_sum = sum_i w_i,  depth = sum_i w_i * ts_i
//
// od0 is the optical depth the ray carries in (0 for a whole ray: training
// and serving). The iterative eval renderer composites a ray one sub-slab
// per round and passes the carry of the rounds before; the forward can
// write the carry at which it stopped (od_out), which the next round reads.
//
// Work split (both kernels): a group of G lanes per ray, G = min(32, the
// power of two >= T) (the wrapper passes it; each kernel is compiled for
// every G, so the group's loops unroll), in blocks of 256 threads. The
// group walks its ray in chunks of G samples; lane i takes sample c*G + i of
// chunk c, so the group's loads of sigma, dt and ts are one contiguous run
// per chunk, and those of rgb three (a thread per ray would read addresses
// T*4 B apart across a warp and walk its T samples serially). A [4096, 128]
// chunk is 131,072 threads, a [4096, 16] chunk 65,536.
//
// Optical-depth prefix (prefix_in_sample_order): the group's s values are
// broadcast one by one and every lane adds them in sample order, from the
// carry of the chunks before. Forward and backward call the same helper, so
// T_in and the T_thresh mask are the same bits in both (a tree-ordered scan
// rounds the prefix differently and can move a sample across T_thresh). The
// prefix is built by shifting (a sample's own s is added after its T_in), so
// a sigma spike to inf keeps the spiked sample's finite T_in and zeroes
// everything behind it. Since s >= 0, T_in never rises along the ray: once
// the carried T_in at a chunk's start is below T_thresh, no later sample can
// contribute, and the group stops there (the forward) or writes the rest of
// its row as zeros with contiguous stores (the backward). That is exact.
//
// Forward: each lane keeps fp32 partial sums of w, w*t and w*rgb over its
// samples; a shuffle-xor tree sums them over the group at the end, and the
// group's first lane blends the background (none, [3] at stride 0 or [n, 3]
// at stride 3) and writes image, weights_sum, depth and od_out.
//
// Backward (the training step's). With the cotangents gI [3], gW, gD of
// (image, weights_sum, depth) and gw_i = gI.rgb_i + gD*ts_i + gW - gI.bg
// (image depends on weights_sum through the background blend):
//
//   dL/drgb_i = w_i * gI
//   dL/ds_k   = T_in_k * exp(-s_k) * gw_k - sum_{i>k} w_i * gw_i
//   dL/dsigma_k = dL/ds_k * dt_k * density_scale
//
// The suffix sum is the total sum_i w_i*gw_i less the inclusive prefix, and
// the total comes from the saved outputs:
// gI.(image - (1 - W)*bg) + gD*depth + gW*W - (gI.bg)*W. This is the form of
// composite_rays_train_backward in torch-ngp's raymarching.cu. A sample
// with T_in < T_thresh gets gradient 0, as autodiff of the mask gives. ts
// and dt get no gradient (the marcher made them). The prefix of w*gw, which
// decides nothing, is a shuffle-tree scan. The backward always starts at
// od0 = 0 (training composites whole rays).
//
// Bound: bytes, and latency. Forward: about 24 B read per sample (sigma, dt,
// ts, rgb: 6 floats) plus 20 B written per ray; at the serving chunk
// [4096, 128] that is ~12.6 MB, ~3.8 us at 3.35 TB/s when every sample is
// read (T_thresh 0). With early exit a ray reads only its chunks up to the
// first whose carried T_in is below T_thresh, so the bytes shrink to ~0.4 us
// and what remains is one load's latency and the G dependent broadcasts of
// each chunk. Backward: the same reads plus 16 B written per sample (dsigma
// and drgb are dense [N, T]), most of them the zeros past the early exit.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Lane groups: G consecutive lanes of a warp (G a power of two, 1..32),
// aligned to G, so a group never straddles two warps. Each group names only
// its own lanes in the shuffles' masks: groups of one warp may leave their
// loops at different times.

// The mask of the G-lane group that holds this thread.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G >= 32) return 0xffffffffu;
  const int first = (threadIdx.x & 31) & ~(G - 1);
  return ((1u << G) - 1u) << first;
}

// Inclusive prefix sum over the group's lanes (lane = index inside the
// group): lane i gets x_0 + ... + x_i, summed as a tree, log2(G) shuffles.
template <int G>
__device__ __forceinline__ float group_inclusive_sum(float x, unsigned mask, int lane) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const float y = __shfl_up_sync(mask, x, d, G);
    if (lane >= d) x += y;
  }
  return x;
}

// The sum of x over the group's lanes, in every lane (shuffle-xor tree).
template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int d = G >> 1; d > 0; d >>= 1) x += __shfl_xor_sync(mask, x, d, G);
  return x;
}

// The optical depth entering this lane's sample of the chunk, summed in
// sample order from `carry` (the sum over every sample before the chunk):
// the group's s values are broadcast one by one and every lane adds them in
// order, so every lane ends with the same bits. `carry` becomes the sum
// through the chunk's last sample. A lane past the row's end holds s = 0,
// which changes nothing. Unrolled, the G broadcasts do not wait on the adds.
template <int G>
__device__ __forceinline__ float prefix_in_sample_order(float s, float& carry, unsigned mask,
                                                        int lane) {
  float acc = carry, acc_in = 0.f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float sk = __shfl_sync(mask, s, k, G);
    if (k == lane) acc_in = acc;
    acc += sk;
  }
  carry = acc;
  return acc_in;
}

template <int G>
__global__ void __launch_bounds__(256) composite_forward_kernel(
    const float* __restrict__ sigmas,  // [n, T]
    const float* __restrict__ rgbs,    // [n, T, 3]
    const float* __restrict__ deltas,  // [n, T]
    const float* __restrict__ ts,      // [n, T]
    const float* __restrict__ bg,      // nullptr, [3] (stride 0) or [n, 3] (stride 3)
    int bg_stride,
    const float* __restrict__ od0,  // nullptr (0) or [n]: the optical depth carried in
    float* __restrict__ image,        // [n, 3]
    float* __restrict__ weights_sum,  // [n]
    float* __restrict__ depth,        // [n]
    float* __restrict__ od_out,       // nullptr or [n]: the carry where the group stopped
    int n, int T, float density_scale, float T_thresh) {
  const int ray = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  if (ray >= n) return;  // a whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = group_mask<G>();
  const size_t base = static_cast<size_t>(ray) * T;
  const float* sig = sigmas + base;
  const float* dt = deltas + base;
  const float* tt = ts + base;
  const float* rgb = rgbs + base * 3;

  float carry = od0 != nullptr ? od0[ray] : 0.f;  // the same in every lane of the group
  float ws = 0.f, d = 0.f, r = 0.f, g = 0.f, b = 0.f;
  for (int c0 = 0; c0 < T; c0 += G) {
    if (expf(-carry) < T_thresh) break;
    const int i = c0 + lane;
    const bool in = i < T;
    float s = 0.f, t = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
    if (in) {
      s = dt[i] * density_scale * sig[i];
      t = tt[i];
      cr = rgb[3 * i];
      cg = rgb[3 * i + 1];
      cb = rgb[3 * i + 2];
    }
    const float trans = expf(-prefix_in_sample_order<G>(s, carry, mask, lane));
    if (in && !(trans < T_thresh)) {
      const float w = (1.f - expf(-s)) * trans;
      ws += w;
      d += w * t;
      r += w * cr;
      g += w * cg;
      b += w * cb;
    }
  }
  ws = group_sum<G>(ws, mask);
  d = group_sum<G>(d, mask);
  r = group_sum<G>(r, mask);
  g = group_sum<G>(g, mask);
  b = group_sum<G>(b, mask);
  if (lane != 0) return;
  if (bg != nullptr) {
    const float* c = bg + static_cast<size_t>(ray) * bg_stride;
    const float rest = 1.f - ws;
    r += rest * c[0];
    g += rest * c[1];
    b += rest * c[2];
  }
  image[3 * ray] = r;
  image[3 * ray + 1] = g;
  image[3 * ray + 2] = b;
  weights_sum[ray] = ws;
  depth[ray] = d;
  if (od_out != nullptr) od_out[ray] = carry;
}

template <int G>
__global__ void __launch_bounds__(256) composite_backward_kernel(
    const float* __restrict__ sigmas,  // [n, T]
    const float* __restrict__ rgbs,    // [n, T, 3]
    const float* __restrict__ deltas,  // [n, T]
    const float* __restrict__ ts,      // [n, T]
    const float* __restrict__ bg,      // nullptr, [3] (stride 0) or [n, 3] (stride 3)
    int bg_stride,
    const float* __restrict__ image,        // [n, 3] saved forward outputs
    const float* __restrict__ weights_sum,  // [n]
    const float* __restrict__ depth,        // [n]
    const float* __restrict__ g_image,        // [n, 3] cotangents
    const float* __restrict__ g_weights_sum,  // [n]
    const float* __restrict__ g_depth,        // [n]
    float* __restrict__ d_sigmas,  // [n, T]
    float* __restrict__ d_rgbs,    // [n, T, 3]
    int n, int T, float density_scale, float T_thresh) {
  const int ray = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  if (ray >= n) return;  // a whole group leaves together
  const int lane = threadIdx.x & (G - 1);
  const unsigned mask = group_mask<G>();
  const size_t base = static_cast<size_t>(ray) * T;
  const float* sig = sigmas + base;
  const float* dt = deltas + base;
  const float* tt = ts + base;
  const float* rgb = rgbs + base * 3;
  float* dsig = d_sigmas + base;
  float* drgb = d_rgbs + base * 3;

  const float gr = g_image[3 * ray], gg = g_image[3 * ray + 1], gb = g_image[3 * ray + 2];
  const float gW = g_weights_sum[ray], gD = g_depth[ray];
  float br = 0.f, bgg = 0.f, bb = 0.f;
  if (bg != nullptr) {
    const float* c = bg + static_cast<size_t>(ray) * bg_stride;
    br = c[0];
    bgg = c[1];
    bb = c[2];
  }
  const float g_bg = gr * br + gg * bgg + gb * bb;
  const float W = weights_sum[ray];
  const float rest = 1.f - W;
  const float total = gr * (image[3 * ray] - rest * br) + gg * (image[3 * ray + 1] - rest * bgg) +
                      gb * (image[3 * ray + 2] - rest * bb) + gD * depth[ray] + gW * W - g_bg * W;

  float carry_s = 0.f;  // the forward's carry: the sum of s up to this chunk
  float carry_p = 0.f;  // sum of w * gw over the chunks before this one
  int c0 = 0;
  for (; c0 < T; c0 += G) {
    if (expf(-carry_s) < T_thresh) break;  // the same carry in every lane of the group
    const int i = c0 + lane;
    const bool in = i < T;
    float s = 0.f, d = 0.f, t = 0.f, r = 0.f, g = 0.f, b = 0.f;
    if (in) {
      d = dt[i];
      s = d * density_scale * sig[i];
      t = tt[i];
      r = rgb[3 * i];
      g = rgb[3 * i + 1];
      b = rgb[3 * i + 2];
    }
    const float trans = expf(-prefix_in_sample_order<G>(s, carry_s, mask, lane));
    const bool live = in && !(trans < T_thresh);
    const float e = expf(-s);
    const float w = live ? (1.f - e) * trans : 0.f;
    const float gw = gr * r + gg * g + gb * b + gD * t + gW - g_bg;
    const float incl_p = group_inclusive_sum<G>(w * gw, mask, lane);
    if (in) {
      const float d_s = live ? trans * e * gw - (total - (carry_p + incl_p)) : 0.f;
      dsig[i] = d_s * (d * density_scale);
      drgb[3 * i] = w * gr;
      drgb[3 * i + 1] = w * gg;
      drgb[3 * i + 2] = w * gb;
    }
    carry_p += __shfl_sync(mask, incl_p, G - 1, G);
  }
  for (int i = c0 + lane; i < T; i += G) dsig[i] = 0.f;
  for (int k = 3 * c0 + lane; k < 3 * T; k += G) drgb[k] = 0.f;
}

constexpr int kThreads = 256;  // 256 / G rays per block

unsigned int group_blocks(int n, int G) {
  return static_cast<unsigned int>((static_cast<long long>(n) * G + kThreads - 1) / kThreads);
}

// Calls launch(std::integral_constant<int, G>) for G in {1, 2, 4, ..., 32};
// returns the launch's error, or cudaErrorInvalidValue for another G.
template <typename Launch>
int with_group_width(int G, Launch&& launch) {
  switch (G) {
    case 1: launch(std::integral_constant<int, 1>{}); break;
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    case 8: launch(std::integral_constant<int, 8>{}); break;
    case 16: launch(std::integral_constant<int, 16>{}); break;
    case 32: launch(std::integral_constant<int, 32>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int focnerf_composite_forward(
    const float* sigmas, const float* rgbs, const float* deltas, const float* ts,
    const float* bg, int bg_stride, const float* od0, float* image, float* weights_sum,
    float* depth, float* od_out, int n, int T, int G, float density_scale, float T_thresh,
    void* stream) {
  return with_group_width(G, [&](auto g) {
    if (n == 0) return;
    composite_forward_kernel<decltype(g)::value>
        <<<group_blocks(n, G), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            sigmas, rgbs, deltas, ts, bg, bg_stride, od0, image, weights_sum, depth, od_out, n, T,
            density_scale, T_thresh);
  });
}

extern "C" int focnerf_composite_backward(
    const float* sigmas, const float* rgbs, const float* deltas, const float* ts,
    const float* bg, int bg_stride, const float* image, const float* weights_sum,
    const float* depth, const float* g_image, const float* g_weights_sum, const float* g_depth,
    float* d_sigmas, float* d_rgbs, int n, int T, int G, float density_scale, float T_thresh,
    void* stream) {
  return with_group_width(G, [&](auto g) {
    if (n == 0 || T == 0) return;
    composite_backward_kernel<decltype(g)::value>
        <<<group_blocks(n, G), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            sigmas, rgbs, deltas, ts, bg, bg_stride, image, weights_sum, depth, g_image,
            g_weights_sum, g_depth, d_sigmas, d_rgbs, n, T, density_scale, T_thresh);
  });
}
