// Hash-grid table gradient, all levels in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel focnerf_tpu/ops/hashgrid_pallas.py::
// hashgrid_bwd_level (pl.pallas_call(_bwd_level_kernel)) and the XLA forms
// of the same sum in focnerf_tpu/ops/hashgrid.py::_encode_bwd ("mxu" one-hot
// matmuls, "sort" sorted scatter). The TPU recast the segment sum as one-hot
// matrix products because its scatter serialises; on Hopper the scatter
// itself is the kernel. It computes, from the encode's residuals,
//
//   d_table[rows[n, j], c] += weights[n, j] * g[n, col_level[j] * C + c]
//
// for every point n, packed column j (one (level, corner) entry of the
// encode) and channel c: the same function as the plain version in
// focnerf_tpu_torch/ops/hashgrid.py (index_add_). The wrapper zeroes
// d_table first, so rows no entry touches stay exactly 0. Entries of weight
// 0 (points outside the unit cube) add nothing. Rows are int32: tables stay
// below 2^31 rows. Atomics add in no fixed order, so the sums are not
// bitwise reproducible.
//
// Bound: bytes. Per entry it reads a row (4 B) and a weight (4 B), per
// point the cotangent (L*C*4 B), and the whole d_table (rows*C*4 B) is
// written; at the -O training shape (4096 rays x 128 samples, 16 levels,
// K = 1, a 6.33M-row table) that is ~185 MB, ~55 us at 3.35 TB/s. What
// holds it above that is the atomics: ~8M float2 reductions, the hashed
// levels' to random rows of a 50.6 MB table that does not stay in L2.
//
// Design, and what each step does about what held the one-thread-per-entry
// kernel back (7x its bound, slower than index_add_ alone):
//   1. A block takes a tile of consecutive points and a group of 8 columns
//      (one 32-byte sector of each point's rows and weights) and copies the
//      tile's rows, weights and the cotangent words of the group's levels
//      into shared memory with coalesced 16-byte streaming loads, into rows
//      padded to an odd stride so the reads below hit 32 distinct banks.
//      Then each thread takes one point and walks the group's columns, so a
//      warp holds one column of 32 consecutive points: consecutive samples of
//      one ray, which land on the same coarse rows. The cotangent is no
//      longer read at a stride of L*C*4 B.
//   2. Column groups run one after another, last group first, so the card's
//      atomics at any time fall in half the table's levels, and the first
//      ones in the rows the zero fill left in L2.
//   3. On every column, __match_any_sync finds the lanes of the warp that
//      hold the same row; the lowest of them adds its peers' values by
//      shuffles and alone issues the atomic. Duplicates occur on the dense
//      levels; on the hashed ones, whose rows are nearly all distinct, the
//      match costs about what it saves there, so there is one path.
//   4. Vector atomics: one float2 reduction per pair of channels instead of
//      two scalar ones when C is even; scalar otherwise.
//   5. The zero fill stays in the wrapper (torch.zeros): Adam needs the
//      dense gradient, and untouched rows must be exactly 0.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;  // a block's shared memory without an opt-in
// Columns per block: one 32-byte sector of a point's rows and of its weights.
constexpr int kGroup = 8;

// Vector reduction of CV floats into global memory (the result is unused,
// so it compiles to a fire-and-forget reduction).
template <int CV>
__device__ __forceinline__ void add_to(float* dst, const float* v) {
  if constexpr (CV == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

// Copies a tile of `n` rows of `width` 4-byte words from global `src` (row
// stride src_stride) into shared `dst` (row stride dst_stride, padded).
// 16-byte loads when the rows allow it, 4-byte loads otherwise; either way
// neighbouring threads read neighbouring addresses. The loads are marked
// streaming (evict first), so the tiles do not push the table gradient out
// of L2.
__device__ __forceinline__ void stage(void* dst, const void* src, int n, int width, int src_stride,
                                      int dst_stride) {
  int* out = static_cast<int*>(dst);
  const int* in = static_cast<const int*>(src);
  if (width % 4 == 0 && src_stride % 4 == 0 && (reinterpret_cast<size_t>(in) & 15) == 0) {
    const int w4 = width / 4;
    for (int q = threadIdx.x; q < n * w4; q += blockDim.x) {
      const int r = q / w4, k = 4 * (q - r * w4);
      const int4 x = __ldcs(reinterpret_cast<const int4*>(in + static_cast<long long>(r) * src_stride + k));
      int* o = out + r * dst_stride + k;
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
  } else {
    for (int q = threadIdx.x; q < n * width; q += blockDim.x) {
      const int r = q / width, k = q - r * width;
      out[r * dst_stride + k] = __ldcs(in + static_cast<long long>(r) * src_stride + k);
    }
  }
}

// One block: a tile of blockDim.x consecutive points x one group of
// kGroup columns. Blocks start in the order of their linear index, tiles
// fastest, so at any time the card works on one column group and its
// atomics stay in that group's levels of the table. The groups run last to
// first: the zero fill writes the table in row order, so the finest levels
// are still in L2 when the kernel starts.
template <int CV>
__global__ void table_grad_kernel(
    const int* __restrict__ rows,       // [N, J] flat table rows
    const float* __restrict__ weights,  // [N, J]
    const float* __restrict__ g,        // [N, GC] output cotangent, GC = L*C
    const int* __restrict__ col_level,  // [J] level of each packed column
    float* __restrict__ d_table,        // [table_rows, C], zeroed by the caller
    int n_points, int J, int C, int GC) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int j0 = (gridDim.y - 1 - blockIdx.y) * kGroup;
  const int nj = min(kGroup, J - j0);
  int l0 = __ldg(col_level + j0), l1 = l0;  // the group's levels
  for (int j = 1; j < nj; ++j) {
    l0 = min(l0, __ldg(col_level + j0 + j));
    l1 = max(l1, __ldg(col_level + j0 + j));
  }
  const int gw = (l1 - l0 + 1) * C;  // the group's cotangent words, at most GC
  const int SJ = nj | 1, SG = gw | 1;  // odd strides: lane p reads bank (p * S + j) % 32
  int* s_rows = reinterpret_cast<int*>(smem);
  float* s_w = smem + P * SJ;
  float* s_g = s_w + P * SJ;

  const long long n0 = static_cast<long long>(blockIdx.x) * P;
  const int count = static_cast<int>(min(static_cast<long long>(P), n_points - n0));
  stage(s_rows, rows + n0 * J + j0, count, nj, J, SJ);
  stage(s_w, weights + n0 * J + j0, count, nj, J, SJ);
  stage(s_g, g + n0 * GC + l0 * C, count, gw, GC, SG);
  __syncthreads();

  const int p = threadIdx.x;
  const bool valid = p < count;
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  for (int j = 0; j < nj; ++j) {
    const float w = valid ? s_w[p * SJ + j] : 0.f;
    const int row = w != 0.f ? s_rows[p * SJ + j] : -1;  // -1: nothing to add
    const float* gp = s_g + p * SG + (__ldg(col_level + j0 + j) - l0) * C;
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    const bool leader = row >= 0 && (peers & (lane_bit - 1u)) == 0;
    for (int c = 0; c < C; c += CV) {
      float v[CV];
#pragma unroll
      for (int k = 0; k < CV; ++k) v[k] = row >= 0 ? w * gp[c + k] : 0.f;
      // each leader adds its peers' values, one peer a round; the rounds run
      // as long as the warp's largest group, none where every row of the
      // column is distinct
      unsigned todo = leader ? peers & ~lane_bit : 0u;
      while (__any_sync(0xffffffffu, todo != 0)) {
        const int src = todo != 0 ? __ffs(todo) - 1 : static_cast<int>(threadIdx.x & 31);
#pragma unroll
        for (int k = 0; k < CV; ++k) {
          const float o = __shfl_sync(0xffffffffu, v[k], src);
          if (todo != 0) v[k] += o;
        }
        todo &= todo - 1;
      }
      if (leader) add_to<CV>(d_table + static_cast<long long>(row) * C + c, v);
    }
  }
}

// Shared bytes of a tile of P points: rows and weights of kGroup columns,
// and at most all GC cotangent words.
size_t tile_bytes(int P, int GC) {
  return static_cast<size_t>(P) * (2 * (kGroup | 1) + (GC | 1)) * 4;
}

template <int CV>
cudaError_t launch(const int* rows, const float* weights, const float* g, const int* col_level,
                   float* d_table, int n_points, int J, int C, int GC, cudaStream_t stream) {
  // points per block: the largest power of two up to 128 whose tile fits
  // the static shared-memory limit, at least one warp (a larger tile is
  // refused at launch, and the wrapper raises)
  int P = 128;
  while (P > 32 && tile_bytes(P, GC) > kMaxSharedBytes) P /= 2;
  const size_t smem = tile_bytes(P, GC);
  const dim3 grid((n_points + P - 1) / P, (J + kGroup - 1) / kGroup);
  table_grad_kernel<CV><<<grid, P, smem, stream>>>(rows, weights, g, col_level, d_table, n_points,
                                                   J, C, GC);
  return cudaGetLastError();
}

}  // namespace

extern "C" int focnerf_hashgrid_table_grad(
    const int* rows, const float* weights, const float* g, const int* col_level, float* d_table,
    int n_points, int J, int C, int GC, void* stream) {
  if (n_points <= 0 || J <= 0) return static_cast<int>(cudaGetLastError());
  if (C < 1 || GC % C != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = C % 2 == 0
                              ? launch<2>(rows, weights, g, col_level, d_table, n_points, J, C, GC, s)
                              : launch<1>(rows, weights, g, col_level, d_table, n_points, J, C, GC, s);
  return static_cast<int>(err);
}
