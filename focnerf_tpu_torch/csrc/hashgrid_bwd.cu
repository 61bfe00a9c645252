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
// focnerf_tpu_torch/ops/hashgrid.py (index_add_).
//
// Work split: one thread per (point, column) entry; each adds its C
// contributions with fp32 atomicAdd (the result is unused, so they compile
// to fire-and-forget reductions). The wrapper zeroes d_table first, so rows
// no entry touches stay exactly 0. Entries of weight 0 (points outside the
// unit cube) are skipped. Rows are int32: tables stay below 2^31 rows.
// Atomics add in no fixed order, so the sums are not bitwise reproducible.
//
// Bound: bytes. Per entry it reads a row (4 B) and a weight (4 B), per
// point the cotangent (L*C*4 B), and the whole d_table (rows*C*4 B) is
// written; at the -O training shape (4096 rays x 128 samples, 16 levels,
// K = 1, a 6.33M-row table) that is ~185 MB, ~55 us at 3.35 TB/s. Duplicate rows (coarse
// levels are hit by many points) serialise their atomics in L2; sorting or
// warp aggregation of duplicates is the known next step.

#include <cuda_runtime.h>

namespace {

__global__ void table_grad_kernel(
    const int* __restrict__ rows,       // [n_entries] = [N, J] flat table rows
    const float* __restrict__ weights,  // [N, J]
    const float* __restrict__ g,        // [N, g_cols] output cotangent, g_cols = L*C
    const int* __restrict__ col_level,  // [J] level of each packed column
    float* __restrict__ d_table,        // [table_rows, C], zeroed by the caller
    long long n_entries, int J, int C, int g_cols) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const float w = weights[e];
  if (w == 0.f) return;
  const long long n = e / J;
  const int j = static_cast<int>(e - n * J);
  const float* gp = g + n * g_cols + col_level[j] * C;
  float* dst = d_table + static_cast<long long>(rows[e]) * C;
  for (int c = 0; c < C; ++c) atomicAdd(dst + c, w * gp[c]);
}

}  // namespace

extern "C" int focnerf_hashgrid_table_grad(
    const int* rows, const float* weights, const float* g, const int* col_level,
    float* d_table, long long n_entries, int J, int C, int g_cols, void* stream) {
  constexpr int kThreads = 256;
  if (n_entries > 0) {
    const long long blocks = (n_entries + kThreads - 1) / kThreads;
    table_grad_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rows, weights, g, col_level, d_table, n_entries, J, C, g_cols);
  }
  return static_cast<int>(cudaGetLastError());
}
