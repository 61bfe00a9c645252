// Hash-grid encode forward and its position gradient for Hopper (sm_90a).
//
// Replaces no TPU kernel: no Pallas kernel stood here. The JAX package
// leaves both functions to XLA. Kernel A, focnerf_hashgrid_encode, computes
// focnerf_tpu/ops/hashgrid.py::_encode_impl (with _level_corner_indices,
// _level_sampled_indices and _coords_to_rows), which XLA fuses into one
// program of gathers and arithmetic. Kernel B, focnerf_hashgrid_input_grad,
// computes the gradient that JAX takes by autodiff of that function for
// hashgrid_encode(..., input_grads=True) (the D-NeRF fields). The port's
// plain versions, encode_plain and input_grad_plain in
// focnerf_tpu_torch/ops/hashgrid.py, run ~15 separate torch ops for each
// level. The two kernels are ordered as the original gridencoder.cu's
// kernel_grid and kernel_input_backward.
//
// Kernel A, per (point n, level l): the point is moved to the origin when
// any coordinate lies outside [0, 1] (its weights are then 0). Then
//   pos_d = x_d * scale_l + 0.5,  cell_d = floor(pos_d),  frac_d = pos_d - cell_d;
// a corner's row is the XOR-prime uint32 hash of its vertex masked to the
// level's size (hashed levels; a hashed level's size is a power of two, so
// the mask gives the plain version's modulo) or its dense index with strides
// (R_l + 1)^d, plus the level's offset. An exact level blends its 2^D
// corners by the D-linear weights prod_d (bit_d ? frac_d : 1 - frac_d); a
// stochastic level draws K corners, corner bit d being u[n, s, k, d] <
// frac_d, each of weight fp32(1 / K). out[n, l * C + c] = sum over the
// level's corners of weight * table[row, c]. With residuals on, the rows
// (int32) and weights go to the level's columns of rows/weights [N, J] (the
// order of col_levels), which the table-gradient kernel
// (csrc/hashgrid_bwd.cu) reads.
//
// Kernel B, per point: dL/dx_d = sum over levels of scale_l * sum over the
// corner pairs (j, j | 1 << d) with bit d of j clear of
// (gv_{j | 1 << d} - gv_j) * prod_{e != d} f_je, where gv_j = g_l . table[row_j]
// and f_je = bit_e ? frac_e : 1 - frac_e; 0 outside the unit cube. The pair
// shares its product over the other axes, so a level takes D * 2^(D-1)
// such products, half of what each corner's own would. The rows are
// recomputed from x (a few integer products a corner; reading the
// forward's, a point's 512 B at D = 3 and 2 KB at D = 5, was 14-16% slower
// on the card), and a level's 2^D gathers are all issued before any
// arithmetic uses them.
//
// Matching the plain version. The rows must equal the plain version's bit
// for bit: a point on a cell face must land in the same cell, or the
// scatter credits another row. torch computes pos as two rounded fp32 ops
// (x * scale, then + 0.5; the scale is an fp32 value, so torch's scalar
// multiply rounds once); nvcc would contract them into one FMA and floor
// would then differ at a face, so every add, subtract and multiply here is
// an explicit __f*_rn intrinsic, as in csrc/march_skip.cu. The hash is
// uint32 arithmetic, which the plain version's int64 products masked with
// 0xFFFFFFFF give exactly. Kernel A multiplies the weights' D factors in
// index order and sums the corners in index order; torch's prod and sum
// may reduce in another order on the card, so weights and out agree to a
// few ulp, not to the bit. Kernel B adds each point's level terms in level
// order, so two runs are equal bit for bit (no float atomics).
//
// Tiles. A block takes a tile of P consecutive points (P a multiple of 32)
// and all their levels. The tile's inputs, x [P, D], the draws u [P,
// n_stoch * K * D] and, for kernel B, the cotangent [P, L * C], are
// contiguous spans of global memory: the block copies each into shared
// memory with 16-byte loads (scalar ones where a span is not 16-byte
// aligned). Kernel A builds the tile's out [P, L * C] in shared memory and
// writes it as one contiguous span with 16-byte stores. Its rows and
// weights [P, J] go the same way, a chunk of levels at a time where all J
// columns do not fit (D-NeRF's exact encodes: 128 columns at D = 3, 512 at
// D = 5): each point's columns of a chunk are one contiguous span of its
// row. Written straight from the threads, a warp's 32 points each wrote
// its own columns a row apart, 32 scattered stores an instruction: the
// parent kernel spent 0.16 of its 0.40 ms at -O, and 2.3 of 2.8 ms at
// D-NeRF deform, on those stores. Each tile in shared memory keeps a
// point's row at an odd word stride, so a warp's 32 points read or write
// one column of it without bank conflicts. The work is (32-point group,
// level) items: a warp takes 32 consecutive points of one level, so on the
// coarse levels its rows share cache lines of the table, and on the hashed
// levels its 32 gathers are in flight together. Kernel B writes each
// item's D level terms to shared memory; then every thread takes a
// (point, d) of the tile and adds its L terms in level order.
//
// The host chooses the tile, its warps and chunk, and lays out the shared
// memory (ops/hashgrid.py::encode_tile, input_grad_tile) from the kernel's
// registers (focnerf_hashgrid_kernel_regs) and the SM's limits: the warps
// share each chunk's items evenly, and the blocks an SM holds take at most
// 176 KB of its shared memory, leaving L1 at least 80 KB, where the coarse
// levels' gathers hit (tiles that left less ran up to 2x slower).
//
// Bound. Kernel A reads each point's D coordinates (and its draws) and the
// table rows it gathers, and writes out (L * C * 4 B) and, with residuals,
// 8 B a column: at the -O training shape (524,288 points, 16 levels, K = 1,
// residuals on) ~271 MB, ~0.08 ms at 3.35 TB/s. But a gather on a hashed
// level reads 8 random bytes, which moves a whole 32-byte sector through L2:
// 524,288 x 11 hashed levels of sectors at -O, and at D-NeRF's deform field
// (D = 3, 16 levels, 11 of them hashed, 8 corners) kernel B's 46M sectors
// (1.48 GB) take longer through L2 than its ~129 MB of bytes take from
// memory. tools/time_encode_kernels.py prints both bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

constexpr int kMaxLevels = 32;

// The level table, passed by value (kernel parameter space: no host copy,
// and a CUDA graph captures it with the launch). Mirrors the ctypes
// Structure _LevelTable in focnerf_tpu_torch/ops/hashgrid.py field for field.
// It lies outside the anonymous namespace: the C entry points take it by
// value, and a type with internal linkage would give them internal linkage
// too (no exported symbol).
struct LevelTable {
  int num_levels;
  int input_dim;
  int level_dim;
  int k;            // corners drawn on a stochastic level
  int n_stoch;      // u's axis 1
  int total_cols;   // J: residual columns a point
  float inv_k;      // a drawn corner's weight: fp32(1 / k), as torch.full(..., 1.0 / k)
  float scale[kMaxLevels];     // fp32(exp2(l * log2 s) * base - 1), as _level_scale
  uint32_t offset[kMaxLevels];  // first table row of the level
  uint32_t mask[kMaxLevels];    // a hashed level's rows - 1 (a power of two less 1); 0 on a dense level
  uint32_t res1[kMaxLevels];    // R_l + 1: the dense stride's base
  int hashed[kMaxLevels];
  int stoch[kMaxLevels];  // the level's index on u's axis 1, or -1 (exact)
  int col[kMaxLevels];    // the level's first residual column
};

// A block's tile and its shared-memory layout, chosen by the host
// (ops/hashgrid.py::encode_tile, input_grad_tile) and passed by value.
// Mirrors the ctypes Structure _Tile field for field. Strides are in words
// between consecutive points' rows of a tile; offsets are word offsets into
// the block's dynamic shared memory (x's tile starts at 0).
struct Tile {
  int points;       // P, a multiple of 32
  int warps;        // the block's warps
  int smem_bytes;   // its dynamic shared memory
  int x_stride;
  int u_stride;
  int cols_stride;  // the [P, L * C] tile: out (kernel A) or the cotangent (kernel B)
  int res_stride;   // the rows and weights tiles: [P, the residual columns of res_levels levels]
  int res_levels;   // levels whose residuals kernel A stages at a time (a chunk)
  int u_off;
  int cols_off;
  int rows_off;
  int weights_off;
  int terms_off;    // kernel B's level terms [L, D, P]
};

namespace {

constexpr int kMaxDim = 7;      // _PRIMES has 7 entries
constexpr int kMaxChannels = 8;
// A block's most warps. A bound of 512 threads made nvcc give the encode
// 56 registers a thread at D = 3 instead of 48, and its 8-warp tiles ran
// 7-20% slower on the card; 16-warp tiles won only at the exact D = 5 encode.
constexpr int kMaxWarps = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB: a block's most on sm_90

__device__ __forceinline__ uint32_t prime(int d) {
  switch (d) {
    case 0: return 1u;
    case 1: return 2654435761u;
    case 2: return 805459861u;
    case 3: return 3674653429u;
    case 4: return 2097192037u;
    case 5: return 1434869437u;
    default: return 2165219737u;
  }
}

// One level's cell of one point: the fractions, and the two row terms a
// corner picks per dimension (bit 0 and bit 1).
template <int D>
struct Cell {
  float frac[D];
  uint32_t term0[D];
  uint32_t term1[D];
};

template <int D>
__device__ __forceinline__ Cell<D> locate(const float (&x)[D], const LevelTable& lt, int l) {
  Cell<D> c;
  const float scale = lt.scale[l];
  const bool hashed = lt.hashed[l] != 0;
  uint32_t stride = 1;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
    const float cell = floorf(pos);
    c.frac[d] = __fsub_rn(pos, cell);
    const uint32_t v = static_cast<uint32_t>(cell);  // pos >= 0.5: x lies in [0, 1] here
    if (hashed) {
      c.term0[d] = v * prime(d);
      c.term1[d] = (v + 1u) * prime(d);
    } else {
      c.term0[d] = v * stride;
      c.term1[d] = c.term0[d] + stride;
      stride *= lt.res1[l];
    }
  }
  return c;
}

// The flat table row of the corner whose bit d is (bits >> d) & 1.
template <int D>
__device__ __forceinline__ uint32_t corner_row(const Cell<D>& c, unsigned bits, const LevelTable& lt, int l) {
  uint32_t idx = 0;
  if (lt.hashed[l]) {
#pragma unroll
    for (int d = 0; d < D; ++d) idx ^= ((bits >> d) & 1u) ? c.term1[d] : c.term0[d];
    idx &= lt.mask[l];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) idx += ((bits >> d) & 1u) ? c.term1[d] : c.term0[d];
  }
  return idx + lt.offset[l];
}

// A point's coordinates from the x tile; out-of-range points move to the
// origin. Returns whether it lay outside the unit cube.
template <int D>
__device__ __forceinline__ bool load_point(const float* xs, float (&p)[D]) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p[d] = xs[d];
    oob |= p[d] < 0.f || p[d] > 1.f;
  }
  if (oob) {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = 0.f;
  }
  return oob;
}

// (row, column) of the elements e, e + step, ... of a row-major [rows, len]
// span, advanced without a division in the loop.
struct RowWalk {
  int p, c, dp, dc, len;
  __device__ RowWalk(int e, int step, int len_) : p(e / len_), c(e % len_), dp(step / len_), dc(step % len_), len(len_) {}
  __device__ __forceinline__ void next() {
    p += dp;
    c += dc;
    if (c >= len) {
      c -= len;
      ++p;
    }
  }
  __device__ __forceinline__ void step1() {
    if (++c == len) {
      c = 0;
      ++p;
    }
  }
};

// dst[p * stride + c] = src[p * len + c] for the tile's np points: the
// block's threads read src (read once: evict-first) as float4s where it is
// 16-byte aligned, as floats elsewhere.
__device__ void stage_in(float* dst, const float* __restrict__ src, int np, int len, int stride) {
  const int total = np * len;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = total >> 2;
    RowWalk w(4 * threadIdx.x, 4 * blockDim.x, len);
    for (int i = threadIdx.x; i < n4; i += blockDim.x, w.next()) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + i);
      RowWalk at = w;
      dst[at.p * stride + at.c] = v.x;
      at.step1();
      dst[at.p * stride + at.c] = v.y;
      at.step1();
      dst[at.p * stride + at.c] = v.z;
      at.step1();
      dst[at.p * stride + at.c] = v.w;
    }
    done = n4 * 4;
  }
  RowWalk w(done + threadIdx.x, blockDim.x, len);
  for (int e = done + threadIdx.x; e < total; e += blockDim.x, w.next()) dst[w.p * stride + w.c] = __ldcs(src + e);
}

// dst[p * len + c] = src[p * stride + c]: the tile written back as one
// contiguous span, with float4 stores where dst is 16-byte aligned.
__device__ void stage_out(float* __restrict__ dst, const float* src, int np, int len, int stride) {
  const int total = np * len;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = total >> 2;
    RowWalk w(4 * threadIdx.x, 4 * blockDim.x, len);
    for (int i = threadIdx.x; i < n4; i += blockDim.x, w.next()) {
      RowWalk at = w;
      float4 v;
      v.x = src[at.p * stride + at.c];
      at.step1();
      v.y = src[at.p * stride + at.c];
      at.step1();
      v.z = src[at.p * stride + at.c];
      at.step1();
      v.w = src[at.p * stride + at.c];
      reinterpret_cast<float4*>(dst)[i] = v;
    }
    done = n4 * 4;
  }
  RowWalk w(done + threadIdx.x, blockDim.x, len);
  for (int e = done + threadIdx.x; e < total; e += blockDim.x, w.next()) dst[e] = src[w.p * stride + w.c];
}

// acc[c] += w * table[row, c]. Channel loops run to kMaxChannels, unrolled
// and guarded by c < C, so acc stays in registers.
__device__ __forceinline__ void blend(float (&acc)[kMaxChannels], const float* __restrict__ table, uint32_t row,
                                      float w, int C) {
  if (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(table) + row);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(w, t.x));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(w, t.y));
    return;
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < C) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(table + static_cast<size_t>(row) * C + c)));
}

// dst[p * dst_stride + c] = src[p * src_stride + c] for c < width: a
// chunk's columns of the tile's np points back to their rows.
__device__ void put_columns(float* __restrict__ dst, int dst_stride, const float* src, int np, int width,
                            int src_stride) {
  if (width == dst_stride) {
    stage_out(dst, src, np, width, src_stride);
    return;
  }
  RowWalk w(threadIdx.x, blockDim.x, width);
  for (int e = threadIdx.x; e < np * width; e += blockDim.x, w.next())
    dst[w.p * dst_stride + w.c] = src[w.p * src_stride + w.c];
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    encode_kernel(const float* __restrict__ table, const float* __restrict__ x, const float* __restrict__ u,
                  LevelTable lt, Tile tile, long long n_points, float* __restrict__ out, int* __restrict__ rows,
                  float* __restrict__ weights) {
  extern __shared__ float smem[];
  const int P = tile.points;
  const long long n0 = static_cast<long long>(blockIdx.x) * P;
  const int np = static_cast<int>(n_points - n0 < P ? n_points - n0 : P);
  const int C = lt.level_dim;
  const int L = lt.num_levels;
  const int J = lt.total_cols;
  const int ulen = lt.n_stoch * lt.k * D;
  float* const xs = smem;
  float* const us = smem + tile.u_off;
  float* const os = smem + tile.cols_off;
  float* const rs = smem + tile.rows_off;
  float* const ws = smem + tile.weights_off;
  stage_in(xs, x + n0 * D, np, D, tile.x_stride);
  if (ulen > 0) stage_in(us, u + n0 * ulen, np, ulen, tile.u_stride);
  __syncthreads();

  const int groups = P / 32;
  const int chunk = rows != nullptr ? tile.res_levels : L;
  for (int l0 = 0; l0 < L; l0 += chunk) {
    const int l1 = l0 + chunk < L ? l0 + chunk : L;
    const int c0 = lt.col[l0];
    for (int item = threadIdx.x >> 5; item < groups * (l1 - l0); item += tile.warps) {
      const int l = l0 + item / groups;
      const int p = (item % groups) * 32 + (threadIdx.x & 31);
      if (p >= np) continue;
      float pt[D];
      const float keep = load_point<D>(xs + p * tile.x_stride, pt) ? 0.f : 1.f;
      const Cell<D> cell = locate<D>(pt, lt, l);
      float acc[kMaxChannels];
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.f;
      const int s = lt.stoch[l];
      float* const rp = rs + p * tile.res_stride + lt.col[l] - c0;  // the level's residual columns in the chunk
      float* const wp = ws + p * tile.res_stride + lt.col[l] - c0;
      if (s < 0) {
#pragma unroll
        for (unsigned j = 0; j < (1u << D); ++j) {
          float w = 1.f;
#pragma unroll
          for (int d = 0; d < D; ++d) w = __fmul_rn(w, ((j >> d) & 1u) ? cell.frac[d] : __fsub_rn(1.f, cell.frac[d]));
          w = __fmul_rn(w, keep);
          const uint32_t row = corner_row<D>(cell, j, lt, l);
          blend(acc, table, row, w, C);
          if (rows != nullptr) {
            rp[j] = __int_as_float(static_cast<int>(row));
            wp[j] = w;
          }
        }
      } else {
        const float w = __fmul_rn(lt.inv_k, keep);
        const float* ud = us + p * tile.u_stride + s * lt.k * D;
        for (int k = 0; k < lt.k; ++k) {
          unsigned bits = 0;
#pragma unroll
          for (int d = 0; d < D; ++d) bits |= (ud[k * D + d] < cell.frac[d] ? 1u : 0u) << d;
          const uint32_t row = corner_row<D>(cell, bits, lt, l);
          blend(acc, table, row, w, C);
          if (rows != nullptr) {
            rp[k] = __int_as_float(static_cast<int>(row));
            wp[k] = w;
          }
        }
      }
      float* o = os + p * tile.cols_stride + l * C;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) o[c] = acc[c];
    }
    if (rows != nullptr) {
      __syncthreads();
      const int width = (l1 < L ? lt.col[l1] : J) - c0;
      put_columns(reinterpret_cast<float*>(rows) + n0 * J + c0, J, rs, np, width, tile.res_stride);
      put_columns(weights + n0 * J + c0, J, ws, np, width, tile.res_stride);
      __syncthreads();  // the next chunk reuses the residual tiles
    }
  }
  __syncthreads();
  stage_out(out + n0 * L * C, os, np, L * C, tile.cols_stride);
}

// The position gradient.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    input_grad_kernel(const float* __restrict__ table, const float* __restrict__ x, const float* __restrict__ g,
                      LevelTable lt, Tile tile, long long n_points, float* __restrict__ gx) {
  constexpr int kCorners = 1 << D;
  extern __shared__ float smem[];
  const int P = tile.points;
  const long long n0 = static_cast<long long>(blockIdx.x) * P;
  const int np = static_cast<int>(n_points - n0 < P ? n_points - n0 : P);
  const int C = lt.level_dim;
  const int L = lt.num_levels;
  float* const xs = smem;
  float* const gs = smem + tile.cols_off;
  float* const terms = smem + tile.terms_off;
  stage_in(xs, x + n0 * D, np, D, tile.x_stride);
  stage_in(gs, g + n0 * L * C, np, L * C, tile.cols_stride);
  __syncthreads();

  const int groups = P / 32;
  for (int item = threadIdx.x >> 5; item < groups * L; item += tile.warps) {
    const int l = item / groups;
    const int p = (item - l * groups) * 32 + (threadIdx.x & 31);
    if (p >= np) continue;
    float pt[D];
    if (load_point<D>(xs + p * tile.x_stride, pt)) continue;  // outside the cube: gx is 0, its terms unread
    const Cell<D> cell = locate<D>(pt, lt, l);
    const float* gl = gs + p * tile.cols_stride + l * C;
    // gv_j = (table[row_j] * g_l).sum(-1), every gather issued first
    float gv[kCorners];
    if (C == 2) {
      float2 t[kCorners];
#pragma unroll
      for (int j = 0; j < kCorners; ++j) t[j] = __ldg(reinterpret_cast<const float2*>(table) + corner_row<D>(cell, j, lt, l));
      const float g0 = gl[0], g1 = gl[1];
#pragma unroll
      for (int j = 0; j < kCorners; ++j) gv[j] = __fadd_rn(__fmul_rn(t[j].x, g0), __fmul_rn(t[j].y, g1));
    } else {
#pragma unroll
      for (int j = 0; j < kCorners; ++j) {
        const uint32_t row = corner_row<D>(cell, j, lt, l);
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < C) v = __fadd_rn(v, __fmul_rn(__ldg(table + static_cast<size_t>(row) * C + c), gl[c]));
        gv[j] = v;
      }
    }
    float f0[D];
#pragma unroll
    for (int e = 0; e < D; ++e) f0[e] = __fsub_rn(1.f, cell.frac[e]);
    const float scale = lt.scale[l];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kCorners / 2; ++q) {
        const int lo = ((q >> d) << (d + 1)) | (q & ((1 << d) - 1));  // q with a 0 bit inserted at d
        float others = 1.f;
#pragma unroll
        for (int e = 0; e < D; ++e)
          if (e != d) others = __fmul_rn(others, ((lo >> e) & 1) ? cell.frac[e] : f0[e]);
        acc = __fadd_rn(acc, __fmul_rn(__fsub_rn(gv[lo | (1 << d)], gv[lo]), others));
      }
      terms[(l * D + d) * P + p] = __fmul_rn(scale, acc);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * D; i += blockDim.x) {
    const int p = i / D, d = i - p * D;
    bool oob = false;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const float v = xs[p * tile.x_stride + e];
      oob |= v < 0.f || v > 1.f;
    }
    float acc = 0.f;
    if (!oob)
      for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, terms[(l * D + d) * P + p]);
    gx[n0 * D + i] = acc;
  }
}

bool valid(const LevelTable& lt, const Tile& tile) {
  return lt.num_levels >= 1 && lt.num_levels <= kMaxLevels && lt.input_dim >= 1 && lt.input_dim <= kMaxDim &&
         lt.level_dim >= 1 && lt.level_dim <= kMaxChannels && tile.points >= 32 && tile.points % 32 == 0 &&
         tile.warps >= 1 && tile.warps <= kMaxWarps && tile.smem_bytes > 0 &&
         tile.smem_bytes <= kMaxSmemBytes &&
         tile.res_levels >= 1;
}

#define FOCNERF_DIM_SWITCH(D_VAR, CALL) \
  switch (D_VAR) {                      \
    case 1: CALL(1); break;             \
    case 2: CALL(2); break;             \
    case 3: CALL(3); break;             \
    case 4: CALL(4); break;             \
    case 5: CALL(5); break;             \
    case 6: CALL(6); break;             \
    case 7: CALL(7); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Lets every kernel of this file take up to kMaxSmemBytes of dynamic shared
// memory on the current device, once a device: at the first launch, which
// the port makes before it captures any CUDA graph.
std::atomic<unsigned long long> g_smem_allowed{0};

int allow_large_tiles() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (g_smem_allowed.load() & bit) return 0;
  for (int d = 1; d <= kMaxDim && err == cudaSuccess; ++d) {
#define FOCNERF_ALLOW(D)                                                                                         \
  err = cudaFuncSetAttribute(encode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);       \
  if (err == cudaSuccess)                                                                                        \
    err = cudaFuncSetAttribute(input_grad_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes)
    FOCNERF_DIM_SWITCH(d, FOCNERF_ALLOW)
#undef FOCNERF_ALLOW
  }
  if (err == cudaSuccess) g_smem_allowed.fetch_or(bit);
  return static_cast<int>(err);
}

// Reads buf (n4 float4s) reps times, grid-strided, cached in L2 only: with a
// buffer that fits in L2, its time gives the card's L2 read rate, which
// bounds the encodes' scattered gathers (a 32-byte sector a corner read).
__global__ void l2_read_kernel(const float4* __restrict__ buf, long long n4, int reps, float* __restrict__ out) {
  float acc = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int r = 0; r < reps; ++r) {
#pragma unroll 4
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  if (acc != 0.f) out[blockIdx.x] = acc;  // a zero buffer writes nothing; the reads stay live
}

}  // namespace

// out [N, L * C]; rows/weights [N, J] or both null (no residuals); u
// [N, n_stoch, K, D] or null when no level is stochastic.
extern "C" int focnerf_hashgrid_encode(const void* table, const void* x, const void* u, LevelTable lt, Tile tile,
                                       long long n_points, void* out, void* rows, void* weights, void* stream) {
  if (!valid(lt, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  if (const int err = allow_large_tiles()) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_points + tile.points - 1) / tile.points));
#define FOCNERF_ENCODE(D)                                                                                   \
  encode_kernel<D><<<grid, tile.warps * 32, tile.smem_bytes, s>>>(                                         \
      static_cast<const float*>(table), static_cast<const float*>(x), static_cast<const float*>(u), lt, tile, \
      n_points, static_cast<float*>(out), static_cast<int*>(rows), static_cast<float*>(weights))
  FOCNERF_DIM_SWITCH(lt.input_dim, FOCNERF_ENCODE)
#undef FOCNERF_ENCODE
  return static_cast<int>(cudaGetLastError());
}

// gx [N, D]; g [N, L * C], the exact encode's output cotangent.
extern "C" int focnerf_hashgrid_input_grad(const void* table, const void* x, const void* g, LevelTable lt, Tile tile,
                                           long long n_points, void* gx, void* stream) {
  if (!valid(lt, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  if (const int err = allow_large_tiles()) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_points + tile.points - 1) / tile.points));
#define FOCNERF_INPUT_GRAD(D)                                                                             \
  input_grad_kernel<D><<<grid, tile.warps * 32, tile.smem_bytes, s>>>(                                   \
      static_cast<const float*>(table), static_cast<const float*>(x), static_cast<const float*>(g), lt, tile, \
      n_points, static_cast<float*>(gx))
  FOCNERF_DIM_SWITCH(lt.input_dim, FOCNERF_INPUT_GRAD)
#undef FOCNERF_INPUT_GRAD
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread of encode_kernel<D> (kernel 0) or input_grad_kernel<D>
// (kernel 1) uses, which the host's tile choice needs; -1 on an error.
extern "C" int focnerf_hashgrid_kernel_regs(int kernel, int input_dim) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (input_dim) {
#define FOCNERF_REGS(D)                                                                                        \
  case D:                                                                                                      \
    err = kernel == 0 ? cudaFuncGetAttributes(&attr, encode_kernel<D>) : cudaFuncGetAttributes(&attr, input_grad_kernel<D>); \
    break;
    FOCNERF_REGS(1)
    FOCNERF_REGS(2)
    FOCNERF_REGS(3)
    FOCNERF_REGS(4)
    FOCNERF_REGS(5)
    FOCNERF_REGS(6)
    FOCNERF_REGS(7)
#undef FOCNERF_REGS
    default: break;
  }
  return err == cudaSuccess && (kernel == 0 || kernel == 1) ? attr.numRegs : -1;
}

// out: blocks floats. Launches blocks x 512 threads.
extern "C" int focnerf_l2_read(const void* buf, long long n4, int reps, int blocks, void* out, void* stream) {
  if (n4 <= 0 || reps <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  l2_read_kernel<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float4*>(buf), n4, reps,
                                                                        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

#undef FOCNERF_DIM_SWITCH
