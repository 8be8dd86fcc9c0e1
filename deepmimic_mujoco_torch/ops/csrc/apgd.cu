// Batched APGD dual contact solve on Hopper (sm_90a), one warp per env.
//
// Replaces the two Pallas TPU kernels of deepmimic_mujoco_tpu/ops/apgd.py:
//   apgd_solve       -> _apgd_kernel        (a: (B, ne, ne), batch-major)
//   apgd_solve_lanes -> _apgd_kernel_lanes  (a: (ne, ne, B), env axis last)
// Both compute the same function and differ only in layout, so one kernel
// serves both through element strides.
//
// Per env, in the grouped row layout [fn(nc) | ft1(nc) | ft2(nc) | lim(nl)]:
//   f = y = proj(f0), t = 1, step = 1/max(L, 1e-8) with L = max_i sum_j |A_ij|
//   repeat `iterations` times:
//     g = A y + b;  f' = proj(y - step g);  t' = (1 + sqrt(1 + 4 t^2)) / 2
//     y = f' + ((t - 1)/t') (f' - f);  f = f';  t = t'
// proj maps each contact triple onto the elliptic friction cone and clamps
// limit rows to >= 0.
//
// Design: lane i of the env's warp owns row i of A (ne <= 32), converted to
// f32 on load and kept in registers for every iteration, so A is read from
// device memory once per solve, as the Pallas kernels keep it in VMEM.  The
// matvec broadcasts y_j with __shfl_sync; the Lipschitz row sums accumulate
// in f32 and reduce with a warp max; the cone projection gathers each
// contact triple (c, nc+c, 2nc+c) through shuffles.  Envs past the batch
// end are masked, so any B is taken without padding.  sqrtf and the
// divisions stay IEEE (no --use_fast_math), so the t > 1e-12 and +1e-20
// branches behave as in the reference.
//
// Bound on an H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores), per solve: bytes = B*ne^2*2 (bf16 A) + 4*B*(3*ne + nc), each read
// or written once; flops = 2*B*ne^2*iterations.  At the main path's
// B = 4096, ne = 32 that is ~10 MB (3 us) and 0.13 GFLOP at 15 iterations
// (2 us): the kernel is launch- and latency-bound there (one dependent
// shuffle chain per iteration per warp), which later work can address.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_a(const float* p) { return *p; }

__device__ __forceinline__ float load_a(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Projection of this lane's row value x; every lane of the warp must call
// it (it shuffles).  mu is the friction of this lane's contact.
__device__ __forceinline__ float project(float x, float mu, int lane, int ne,
                                         int nc) {
  const int c = (lane < 3 * nc) ? lane % nc : 0;
  const float fn = __shfl_sync(kFull, x, c);
  const float f1 = __shfl_sync(kFull, x, nc + c);
  const float f2 = __shfl_sync(kFull, x, 2 * nc + c);
  if (lane >= ne) return 0.f;
  if (lane >= 3 * nc) return fmaxf(x, 0.f);  // limit row
  const float t = sqrtf(f1 * f1 + f2 * f2 + 1e-20f);
  const bool inside = t <= mu * fn;
  const bool below = mu * t <= -fn;
  if (below) return 0.f;  // polar cone
  const int comp = lane / nc;  // 0 normal, 1 tangent 1, 2 tangent 2
  if (inside) return comp == 0 ? fmaxf(fn, 0.f) : (comp == 1 ? f1 : f2);
  const float fn_p = fmaxf((fn + mu * t) / (1.f + mu * mu), 0.f);
  if (comp == 0) return fn_p;
  const float scale = t > 1e-12f ? mu * fn_p / fmaxf(t, 1e-12f) : 0.f;
  return (comp == 1 ? f1 : f2) * scale;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
apgd_kernel(const T* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ mu, const float* __restrict__ f0,
            float* __restrict__ out, long long batch, int ne, int nc,
            int iterations, long long a_se, long long a_si, long long a_sj,
            long long v_se, long long v_si, long long m_se, long long m_sc) {
  __shared__ float tile[kWarpsPerBlock][kWarp][kWarp + 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long env = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (env >= batch) return;  // the whole warp leaves together
  const bool row = lane < ne;

  // A (ne x ne) through shared memory: consecutive lanes read consecutive
  // elements of the flattened matrix, then lane i takes row i.
  float(*t_w)[kWarp + 1] = tile[warp];
  for (int k = lane; k < ne * ne; k += kWarp) {
    const int i = k / ne;
    const int j = k - i * ne;
    t_w[i][j] = load_a(a + env * a_se + i * a_si + j * a_sj);
  }
  __syncwarp();
  float arow[kWarp];
  float rowsum = 0.f;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) {
    arow[j] = (row && j < ne) ? t_w[lane][j] : 0.f;
    rowsum += fabsf(arow[j]);
  }
  float lip = rowsum;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    lip = fmaxf(lip, __shfl_xor_sync(kFull, lip, o));
  const float step = 1.f / fmaxf(lip, 1e-8f);

  const float bi = row ? b[env * v_se + lane * v_si] : 0.f;
  const float mui =
      (lane < 3 * nc) ? mu[env * m_se + (lane % nc) * m_sc] : 0.f;
  float f = project(row ? f0[env * v_se + lane * v_si] : 0.f, mui, lane, ne,
                    nc);
  float y = f;
  float t = 1.f;
  for (int it = 0; it < iterations; ++it) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kWarp; ++j)
      acc = fmaf(arow[j], __shfl_sync(kFull, y, j), acc);
    const float f_new = project(y - step * (acc + bi), mui, lane, ne, nc);
    const float t_new = 0.5f * (1.f + sqrtf(1.f + 4.f * t * t));
    y = f_new + ((t - 1.f) / t_new) * (f_new - f);
    f = f_new;
    t = t_new;
  }
  if (row) out[env * v_se + lane * v_si] = f;
}

}  // namespace

// Launches the solve on `stream` and returns cudaGetLastError() as an int.
// Pointers are device pointers; a is f32 (a_is_bf16 = 0) or bf16.  Element
// strides: a[e, i, j] at e*a_se + i*a_si + j*a_sj; b, f0 and out share
// (v_se, v_si); mu[e, c] at e*m_se + c*m_sc.  Requires 3*nc <= ne <= 32.
extern "C" int apgd_launch(const void* a, int a_is_bf16, const void* b,
                           const void* mu, const void* f0, void* out,
                           long long batch, int ne, int nc, int iterations,
                           long long a_se, long long a_si, long long a_sj,
                           long long v_se, long long v_si, long long m_se,
                           long long m_sc, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid(
      static_cast<unsigned>((batch + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(b);
  const float* mp = static_cast<const float*>(mu);
  const float* fp = static_cast<const float*>(f0);
  float* op = static_cast<float*>(out);
  if (a_is_bf16) {
    apgd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), bp, mp, fp, op, batch, ne, nc,
        iterations, a_se, a_si, a_sj, v_se, v_si, m_se, m_sc);
  } else {
    apgd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), bp, mp, fp, op, batch, ne, nc,
        iterations, a_se, a_si, a_sj, v_se, v_si, m_se, m_sc);
  }
  return static_cast<int>(cudaGetLastError());
}
