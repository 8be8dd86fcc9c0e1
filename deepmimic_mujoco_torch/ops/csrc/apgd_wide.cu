// Batched APGD dual contact solve on Hopper (sm_90a) for dual systems too
// large for the tensor-core kernel of apgd.cu (ne > 32): one block per env,
// one thread per row, A staged in shared memory.
//
// Replaces the XLA route of deepmimic_mujoco_tpu/ops/apgd.py: make_apgd
// (:216) hands every ne to _apgd_scan (:181), and only ne <= 32 has a
// Hopper kernel in apgd.cu.  No Pallas kernel of the JAX package computes
// this: the dual systems of build_humanoid(contact_cap=16, limit_cap=16)
// (ne = 64) and of the uncapped model (37 contacts, 28 limits: ne = 139)
// take this kernel on the card.
//
// Per env, rows in the solver's interleaved order [n, t1, t2]*nc + lim(nl):
//   f = y = proj(f0), step = 1/max(L, 1e-8) with L = max_i sum_j |A_ij|
//   for k < iterations:
//     g = A y + b;  f' = proj(y - step g);  y = f' + m_k (f' - f);  f = f'
// with the data-independent Nesterov coefficients m_k from the host (the
// table of apgd.cu).  proj maps contact c's triple (rows 3c, 3c+1, 3c+2)
// onto the elliptic friction cone and clamps limit rows to >= 0; the
// formulas and branch predicates are those of the plain version.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor cores),
// per solve: bytes = B*ne^2*sizeof(A) + 4*B*(3*ne + nc); flops =
// 2*B*ne^2*iterations.  At B = 4096, ne = 139, bf16 A, 15 iterations:
// 158 MB (47 us) against 2.4 GFLOP (35 us): bytes.  The design is the
// simple one, right first:
//
// * A is read once from device memory (consecutive threads on consecutive
//   elements) and kept transposed in shared memory, at[j*ld + i] = A[i][j]
//   with an odd row stride ld, so that in the matvec the threads of a warp
//   read consecutive words (no bank conflicts) and y[j] is a broadcast.
//   bf16 A stays bf16 there (38.6 KB at ne = 139; f32 77 KB, above the
//   48 KB default, so the launcher raises the dynamic shared-memory limit).
// * Thread i owns row i: its b, f and y in registers, its row of A y as a
//   chain of ne FMAs in f32.  L is its row's |A| sum in f32, maximized over
//   the block by shuffles and a shared-memory step.
// * The iterate passes through shared memory twice per iteration: z = y -
//   step g for the projection (the thread of row 3c reads and writes its
//   contact's triple in place), y for the next matvec.  Three barriers per
//   iteration.
//
// What bounds it: shared-memory reads.  Each FMA reads one word of A and
// the broadcast y[j]: 2*ne wavefronts per warp and iteration, about 20,000
// cycles per env at ne = 139 and 15 iterations, several times the bytes
// bound at 4096 envs.  Faster designs (A in registers across a warpgroup,
// several envs per block, the tensor cores) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxNe = 192;  // threads per block <= 192; f32 A <= 148 KB
constexpr int kVecWords = 2 * kMaxNe + kWarp;  // y, z, block reduction
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* a;       // (B, ne, ne), f32 or bf16
  const float* b;      // (B, ne)
  const float* mu;     // (B, nc)
  const float* f0;     // (B, ne)
  float* out;          // (B, ne)
  const float* coef;   // (iterations,) momentum coefficients
  int ne, nc, iterations, ld;
};

// Projects z in place: the thread of row 3c maps contact c's triple onto
// the elliptic cone |t| <= mu*fn, the thread of a limit row clamps it.
__device__ __forceinline__ void project(float* z, int i, int nc, int ne,
                                        float mu) {
  if (i < 3 * nc) {
    if (i % 3 != 0) return;
    const float fn = z[i], f1 = z[i + 1], f2 = z[i + 2];
    const float t = sqrtf(f1 * f1 + f2 * f2 + 1e-20f);
    const bool inside = t <= mu * fn;
    const bool below = mu * t <= -fn;
    const float fn_p = fmaxf((fn + mu * t) / (1.0f + mu * mu), 0.0f);
    const float scale = t > 1e-12f ? mu * fn_p / fmaxf(t, 1e-12f) : 0.0f;
    float n_out = inside ? fmaxf(fn, 0.0f) : fn_p;
    float t1_out = inside ? f1 : f1 * scale;
    float t2_out = inside ? f2 : f2 * scale;
    if (below) n_out = t1_out = t2_out = 0.0f;
    z[i] = n_out;
    z[i + 1] = t1_out;
    z[i + 2] = t2_out;
  } else if (i < ne) {
    z[i] = fmaxf(z[i], 0.0f);
  }
}

template <typename T>
__global__ void apgd_wide_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);  // y, read by every row
  float* z = ys + kMaxNe;                      // y - step g, projected
  float* red = z + kMaxNe;                     // one word per warp
  T* at = reinterpret_cast<T*>(red + kWarp);   // at[j*ld + i] = A[i][j]
  const int ne = p.ne, ld = p.ld, i = threadIdx.x;
  const long long env = blockIdx.x;
  const T* a = static_cast<const T*>(p.a) + env * ne * ne;
  for (int k = i; k < ne * ne; k += blockDim.x) {
    const int r = k / ne;
    at[(k - r * ne) * ld + r] = a[k];
  }
  const bool row = i < ne;
  const float bi = row ? p.b[env * ne + i] : 0.0f;
  const float mu =
      (i < 3 * p.nc && i % 3 == 0) ? p.mu[env * p.nc + i / 3] : 0.0f;
  float f = row ? p.f0[env * ne + i] : 0.0f;
  if (row) z[i] = f;
  __syncthreads();

  // L = max_i sum_j |A_ij|, in f32 whatever A's type
  float s = 0.0f;
  if (row)
    for (int j = 0; j < ne; ++j) s += fabsf(to_f32(at[j * ld + i]));
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, o));
  if (i % kWarp == 0) red[i / kWarp] = s;
  project(z, i, p.nc, ne, mu);
  __syncthreads();
  float lip = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w)
    lip = fmaxf(lip, red[w]);
  const float step = 1.0f / fmaxf(lip, 1e-8f);
  f = row ? z[i] : 0.0f;
  float y = f;
  if (row) ys[i] = y;
  __syncthreads();

  for (int k = 0; k < p.iterations; ++k) {
    float acc = 0.0f;
    if (row) {
#pragma unroll 4
      for (int j = 0; j < ne; ++j) acc = fmaf(to_f32(at[j * ld + i]), ys[j], acc);
    }
    if (row) z[i] = y - step * (acc + bi);
    __syncthreads();  // z complete; every row has read ys
    project(z, i, p.nc, ne, mu);
    __syncthreads();  // z projected
    const float fn = row ? z[i] : 0.0f;
    y = fn + p.coef[k] * (fn - f);
    f = fn;
    if (row) ys[i] = y;
    __syncthreads();  // y complete; every row has read its z
  }
  if (row) p.out[env * ne + i] = f;
}

int smem_bytes(int ne, int es) {
  const int ld = ne | 1;
  return kVecWords * 4 + ne * ld * es;
}

template <typename T>
int launch(const Params& p, long long batch, int smem, cudaStream_t s) {
  const auto kernel = apgd_wide_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (p.ne + kWarp - 1) / kWarp * kWarp;
  kernel<<<static_cast<unsigned>(batch), threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int apgd_wide_max_ne() { return kMaxNe; }

// Dynamic shared memory bytes of one block (one env).
extern "C" int apgd_wide_smem(int ne, int a_is_bf16) {
  return smem_bytes(ne, a_is_bf16 ? 2 : 4);
}

// Launches the solve on `stream` and returns the first CUDA error as an int
// (cudaFuncSetAttribute's or cudaGetLastError()'s).  Device pointers, all
// contiguous and batch-major: a (B, ne, ne) f32 (a_is_bf16 = 0) or bf16,
// b, f0, out (B, ne), mu (B, nc), rows interleaved; coef holds
// `iterations` momentum coefficients.  Requires 3*nc <= ne <= kMaxNe.
extern "C" int apgd_wide_launch(const void* a, int a_is_bf16, const void* b,
                                const void* mu, const void* f0, void* out,
                                const void* coef, long long batch, int ne,
                                int nc, int iterations, void* stream) {
  if (ne < 1 || ne > kMaxNe || nc < 0 || 3 * nc > ne)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.a = a;
  p.b = static_cast<const float*>(b);
  p.mu = static_cast<const float*>(mu);
  p.f0 = static_cast<const float*>(f0);
  p.out = static_cast<float*>(out);
  p.coef = static_cast<const float*>(coef);
  p.ne = ne;
  p.nc = nc;
  p.iterations = iterations;
  p.ld = ne | 1;
  const int smem = smem_bytes(ne, a_is_bf16 ? 2 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_is_bf16 ? launch<__nv_bfloat16>(p, batch, smem, s)
                   : launch<float>(p, batch, smem, s);
}
