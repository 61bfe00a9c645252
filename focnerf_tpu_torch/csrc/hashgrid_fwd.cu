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
// a corner's row is the XOR-prime uint32 hash of its vertex modulo the
// level's size (hashed levels) or its dense index with strides (R_l + 1)^d,
// plus the level's offset. An exact level blends its 2^D corners by the
// D-linear weights prod_d (bit_d ? frac_d : 1 - frac_d); a stochastic level
// draws K corners, corner bit d being u[n, s, k, d] < frac_d, each of weight
// fp32(1 / K). out[n, l * C + c] = sum over the level's corners of
// weight * table[row, c]. With residuals on, the rows (int32) and weights go
// to the level's columns of rows/weights [N, J] (the order of col_levels),
// which the table-gradient kernel (csrc/hashgrid_bwd.cu) reads.
//
// Kernel B, per point: dL/dx_d = sum over levels and corners of
// (g_l . table[row_j]) * scale_l * (+-1) * prod_{e != d} f_je, 0 outside the
// unit cube. Each (point, level) thread recomputes its level's rows from x
// (a few integer products a corner; reading the forward's rows instead, a
// point's 512 B at D = 3 and 2 KB at D = 5, was 14-16% slower on the card)
// and computes its level's term; the block then adds the levels in order,
// so the sum is deterministic (no float atomics).
//
// Matching the plain version. The rows must equal the plain version's bit
// for bit: a point on a cell face must land in the same cell, or the
// scatter credits another row. torch computes pos as two rounded fp32 ops
// (x * scale, then + 0.5; the scale is an fp32 value, so torch's scalar
// multiply rounds once); nvcc would contract them into one FMA and floor
// would then differ at a face, so every add, subtract and multiply here is
// an explicit __f*_rn intrinsic, as in csrc/march_skip.cu. The hash is
// uint32 arithmetic, which the plain version's int64 products masked with
// 0xFFFFFFFF give exactly. Weights multiply the D factors in index order
// and the corners are summed in index order; torch's prod and sum may
// reduce in another order on the card, so weights and out agree to a few
// ulp, not to the bit.
//
// Why a thread per (point, level). A level's rows of neighbouring points
// are near each other on the dense and coarse levels (the points of a ray
// are consecutive), so a warp on 32 consecutive points of one level shares
// cache lines of the table, and on the hashed levels its 32 independent
// gathers are in flight together. A block holds 32 points and all their
// levels (threadIdx.y walks the levels), so each point's out row and
// residual columns are written by one block at about the same time and
// reach L2 as whole lines.
//
// Bound: bytes. Kernel A reads each point's D coordinates (and its draws)
// and the table rows it gathers (C * 4 B a corner: a random 8-byte read on
// the hashed levels, which the 32-byte sector makes 32 B of traffic), and
// writes out (L * C * 4 B) and, with residuals, 8 B a column. At the -O
// training shape (524,288 points, 16 levels, K = 1, residuals on) that is
// 524,288 x (12 + 192 + 128 + 128) B ~ 241 MB for the points, their draws,
// out and the residuals, plus 8 B for each table row touched once (~30 MB
// on rays through the box): ~0.08 ms at 3.35 TB/s. Kernel B reads x, the
// cotangent (L * C * 4 B a point) and the table rows it touches, and writes
// D floats a point: at D-NeRF's deform field (524,288 points, D = 3) ~129 MB,
// ~0.04 ms.

#include <cuda_runtime.h>
#include <stdint.h>

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
  uint32_t size[kMaxLevels];    // rows of the level
  uint32_t res1[kMaxLevels];    // R_l + 1: the dense stride's base
  int hashed[kMaxLevels];
  int stoch[kMaxLevels];  // the level's index on u's axis 1, or -1 (exact)
  int col[kMaxLevels];    // the level's first residual column
};

namespace {

constexpr int kMaxDim = 7;      // _PRIMES has 7 entries
constexpr int kMaxChannels = 8;
constexpr int kLevelsPerBlock = 16;  // threadIdx.y; a block is 32 points x up to 16 levels at a time

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

// One level's cell of one point: cell coordinates, fractions, and the two
// row terms a corner picks per dimension (bit 0 and bit 1).
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
    idx %= lt.size[l];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) idx += ((bits >> d) & 1u) ? c.term1[d] : c.term0[d];
  }
  return idx + lt.offset[l];
}

// Reads a point's coordinates; out-of-range points move to the origin.
template <int D>
__device__ __forceinline__ bool load_point(const float* __restrict__ x, long long n, float (&p)[D]) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p[d] = x[n * D + d];
    oob |= p[d] < 0.f || p[d] > 1.f;
  }
  if (oob) {
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = 0.f;
  }
  return oob;
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

template <int D>
__global__ void encode_kernel(const float* __restrict__ table, const float* __restrict__ x,
                              const float* __restrict__ u, LevelTable lt, long long n_points,
                              float* __restrict__ out, int* __restrict__ rows, float* __restrict__ weights) {
  const long long n = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  if (n >= n_points) return;
  float p[D];
  const float keep = load_point<D>(x, n, p) ? 0.f : 1.f;
  const int C = lt.level_dim;
  const int J = lt.total_cols;
  for (int l = threadIdx.y; l < lt.num_levels; l += blockDim.y) {
    const Cell<D> cell = locate<D>(p, lt, l);
    float acc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.f;
    const int s = lt.stoch[l];
    const long long col = n * J + lt.col[l];
    if (s < 0) {
      for (unsigned j = 0; j < (1u << D); ++j) {
        float w = 1.f;
#pragma unroll
        for (int d = 0; d < D; ++d) w = __fmul_rn(w, ((j >> d) & 1u) ? cell.frac[d] : __fsub_rn(1.f, cell.frac[d]));
        w = __fmul_rn(w, keep);
        const uint32_t row = corner_row<D>(cell, j, lt, l);
        blend(acc, table, row, w, C);
        if (rows != nullptr) {
          rows[col + j] = static_cast<int>(row);
          weights[col + j] = w;
        }
      }
    } else {
      const float w = __fmul_rn(lt.inv_k, keep);
      const float* ud = u + ((n * lt.n_stoch + s) * lt.k) * D;
      for (int k = 0; k < lt.k; ++k) {
        unsigned bits = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) bits |= (__ldg(ud + k * D + d) < cell.frac[d] ? 1u : 0u) << d;
        const uint32_t row = corner_row<D>(cell, bits, lt, l);
        blend(acc, table, row, w, C);
        if (rows != nullptr) {
          rows[col + k] = static_cast<int>(row);
          weights[col + k] = w;
        }
      }
    }
    float* o = out + n * (lt.num_levels * C) + l * C;
    if (C == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
    } else {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < C) o[c] = acc[c];
    }
  }
}

// The position gradient. Dynamic shared memory: num_levels x 32 x D floats,
// one level's term of each point of the block.
template <int D>
__global__ void input_grad_kernel(const float* __restrict__ table, const float* __restrict__ x,
                                  const float* __restrict__ g, LevelTable lt, long long n_points,
                                  float* __restrict__ gx) {
  extern __shared__ float terms[];
  const int p_local = threadIdx.x;
  const long long n = static_cast<long long>(blockIdx.x) * 32 + p_local;
  const bool live = n < n_points;
  const int C = lt.level_dim;
  const int L = lt.num_levels;
  float p[D];
  bool oob = true;
  if (live) oob = load_point<D>(x, n, p);
  for (int l = threadIdx.y; l < L; l += blockDim.y) {
    float term[D];
#pragma unroll
    for (int d = 0; d < D; ++d) term[d] = 0.f;
    if (live) {
      const Cell<D> cell = locate<D>(p, lt, l);
      const float* gl = g + n * (L * C) + l * C;
      for (unsigned j = 0; j < (1u << D); ++j) {
        const uint32_t row = corner_row<D>(cell, j, lt, l);
        // (table[row] * g_l).sum(-1)
        float gv = 0.f;
        if (C == 2) {
          const float2 t = __ldg(reinterpret_cast<const float2*>(table) + row);
          gv = __fadd_rn(__fmul_rn(t.x, __ldg(gl)), __fmul_rn(t.y, __ldg(gl + 1)));
        } else {
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) gv = __fadd_rn(gv, __fmul_rn(__ldg(table + static_cast<size_t>(row) * C + c), __ldg(gl + c)));
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          // the product of the other axes' factors, in index order
          float others = 1.f;
#pragma unroll
          for (int e = 0; e < D; ++e) {
            if (e == d) continue;
            others = __fmul_rn(others, ((j >> e) & 1u) ? cell.frac[e] : __fsub_rn(1.f, cell.frac[e]));
          }
          const float v = __fmul_rn(gv, others);
          term[d] = ((j >> d) & 1u) ? __fadd_rn(term[d], v) : __fsub_rn(term[d], v);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) term[d] = __fmul_rn(lt.scale[l], term[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) terms[(l * 32 + p_local) * D + d] = term[d];
  }
  __syncthreads();
  if (threadIdx.y != 0 || !live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, terms[(l * 32 + p_local) * D + d]);
    gx[n * D + d] = oob ? 0.f : acc;
  }
}

dim3 block_shape(int levels) { return dim3(32, levels < kLevelsPerBlock ? levels : kLevelsPerBlock); }

bool valid(const LevelTable& lt) {
  return lt.num_levels >= 1 && lt.num_levels <= kMaxLevels && lt.input_dim >= 1 && lt.input_dim <= kMaxDim &&
         lt.level_dim >= 1 && lt.level_dim <= kMaxChannels;
}

}  // namespace

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

// out [N, L * C]; rows/weights [N, J] or both null (no residuals); u
// [N, n_stoch, K, D] or null when no level is stochastic.
extern "C" int focnerf_hashgrid_encode(const void* table, const void* x, const void* u, LevelTable lt,
                                       long long n_points, void* out, void* rows, void* weights, void* stream) {
  if (!valid(lt)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_points + 31) / 32));
  const dim3 block = block_shape(lt.num_levels);
#define FOCNERF_ENCODE(D)                                                                                      \
  encode_kernel<D><<<grid, block, 0, s>>>(static_cast<const float*>(table), static_cast<const float*>(x),       \
                                          static_cast<const float*>(u), lt, n_points, static_cast<float*>(out), \
                                          static_cast<int*>(rows), static_cast<float*>(weights))
  FOCNERF_DIM_SWITCH(lt.input_dim, FOCNERF_ENCODE)
#undef FOCNERF_ENCODE
  return static_cast<int>(cudaGetLastError());
}

// gx [N, D]; g [N, L * C], the exact encode's output cotangent.
extern "C" int focnerf_hashgrid_input_grad(const void* table, const void* x, const void* g, LevelTable lt,
                                           long long n_points, void* gx, void* stream) {
  if (!valid(lt)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_points + 31) / 32));
  const dim3 block = block_shape(lt.num_levels);
  const size_t smem = static_cast<size_t>(lt.num_levels) * 32 * lt.input_dim * sizeof(float);
#define FOCNERF_INPUT_GRAD(D)                                                                       \
  input_grad_kernel<D><<<grid, block, smem, s>>>(static_cast<const float*>(table),                  \
                                                 static_cast<const float*>(x),                      \
                                                 static_cast<const float*>(g), lt, n_points,        \
                                                 static_cast<float*>(gx))
  FOCNERF_DIM_SWITCH(lt.input_dim, FOCNERF_INPUT_GRAD)
#undef FOCNERF_INPUT_GRAD
  return static_cast<int>(cudaGetLastError());
}

#undef FOCNERF_DIM_SWITCH
