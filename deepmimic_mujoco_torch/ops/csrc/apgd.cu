// Batched APGD dual contact solve on Hopper (sm_90a): one or two envs per
// warp, the matvec on the tensor cores.
//
// Replaces the two Pallas TPU kernels of deepmimic_mujoco_tpu/ops/apgd.py:
//   apgd_solve       -> _apgd_kernel        (a: (B, ne, ne), "blocks")
//   apgd_solve_lanes -> _apgd_kernel_lanes  (a: (ne, ne, B), "lanes")
// Both compute the same function and differ only in layout; one kernel
// serves both, and takes the rows in the grouped order
// [fn(nc) | ft1(nc) | ft2(nc) | lim(nl)] of the Pallas kernels or in the
// solver's interleaved order [n, t1, t2]*nc + lim(nl), so the solver's
// dispatch launches it on its own tensors with no gather, copy or scatter.
//
// Per env:
//   f = y = proj(f0), step = 1/max(L, 1e-8) with L = max_i sum_j |A_ij|
//   for k < iterations:
//     g = A y + b;  f' = proj(y - step g);  y = f' + m_k (f' - f);  f = f'
// with the data-independent Nesterov coefficients m_k from the host.  proj
// maps each contact triple onto the elliptic friction cone and clamps limit
// rows to >= 0.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor cores),
// per solve: bytes = B*ne^2*sizeof(A) + 4*B*(3*ne + nc), each read or
// written once; flops = 2*B*ne^2*iterations.  At the main path's B = 4096,
// ne = 32, bf16 A, 15 iterations: ~10 MB (3.0 us) against 0.13 GFLOP
// (1.9 us): bytes.  What held the first port's kernel (one warp per env,
// y broadcast by shuffles) at a tenth of that: 35 shuffles and a chain of
// 32 dependent FMAs per iteration, IEEE divisions and square roots on every
// lane, A read in 2-byte pieces (strided by B in the lanes layout), and
// gathers of A around every launch.  The design:
//
// * Slots.  Each input row r maps to one of 32 slots; for nc <= 8, nl <= 8
//   normal c -> slot c, tangent 1 -> 8+c, tangent 2 -> 16+c, limit l ->
//   24+l (otherwise slot = grouped row, and the projection goes through
//   shared memory).  Unused slots have zero rows, columns, b and f.
// * Tensor cores.  g = A y is four mma.m16n8k16 per env (bf16 in, f32
//   sums): A (exact as bf16 on the main path) stays in 16 registers per
//   lane for the whole solve; y enters as three bf16 pieces hi + mid + lo
//   (24 bits, as much as f32) in columns 0-2 of B.  f32 A is split into
//   three bf16 pieces as well (12 mma per matvec).  In the accumulator,
//   lanes 4c and 4c+1 hold rows c, c+8, c+16, c+24 - contact c's triple and
//   limit c - so one xor-shuffle per row sums the pieces and the cone
//   projection needs no shuffle.  With bf16 A and the slot map a warp
//   solves two envs: the shuffle leaves env 0's sums in lane 4c and env
//   1's in lane 4c+1, and the split, projection and momentum serve both.
//   y returns to the B operand through 3 shared stores and one 16-byte
//   load per env and lane.
// * Less per-iteration arithmetic: 1/(1+mu^2) once per contact, the
//   momentum table from the host, t = x*rsqrt(x) and an approximate
//   reciprocal; the branch predicates stay those of the reference.
// * Loads: blocks copies each env's contiguous A with 16-byte cp.async;
//   lanes has a block of E consecutive envs read rows A[i, j, e0:e0+E] with
//   8- or 16-byte loads.  Both fill one tile per env whose rows are padded
//   by 16 bytes, so building the fragments reads shared memory without bank
//   conflicts.  b, f0 and mu are loaded before the staging barrier.
// * Grid: 2 warps per block (blocks), E in {16, 8, 4} envs per block
//   (lanes), E chosen so that the grid covers the 132 SMs; at 4096 envs
//   every warp is resident in one wave.
//
// What bounds it now (timed on the card, PERF.md): each iteration costs
// about 0.48 us at 4096 envs, where the instruction throughput (~67
// instructions per env and iteration) and one warp's dependent chain
// (~500 cycles: split, shared-memory exchange, two dependent mma, shuffle,
// projection) bound it together; and the ~6 us spent reading A and
// launching is not overlapped with the iterations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBlockWarps = 2;  // blocks layout: warps per block
constexpr int kMaxThreads = 512;
constexpr int kNumSms = 132;
constexpr unsigned kFull = 0xffffffffu;
// y pieces of one env, double-buffered: [buffer][piece 0..7][writer c][2 u32]
// (pieces 3..7 stay zero: columns 3..7 of the mma's B operand)
constexpr int kPieceWords = 8 * 8 * 2;

struct Params {
  const void* a;
  const float* b;
  const float* mu;
  const float* f0;
  float* out;
  const float* coef;  // momentum table, `iterations` floats
  long long batch, v_se, v_si, m_se, m_sc;
  int ne, nc, iterations, lanes, interleaved, vec, envs, tile_elems,
      stage_bytes;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Envs per warp: two for bf16 A with the 8-slot map (lanes 4c and 4c+1
// then project one env each), else one.
__host__ __device__ constexpr int envs_per_warp(bool slots8, int es) {
  return slots8 && es == 2 ? 2 : 1;
}

// Row stride of a staged A tile, in elements: 16 bytes of padding make the
// fragment build's reads free of bank conflicts at ne = 32.
__host__ __device__ constexpr int tile_stride(int ne, int es) {
  return ne + 16 / es;
}

// Elements of one env's tile; lanes tiles are 8 bytes apart more, which
// spreads the staging's stores over the banks.
__host__ __device__ constexpr int tile_elems(int ne, int es, int lanes) {
  return round16(ne * tile_stride(ne, es) * es) / es + (lanes ? 8 / es : 0);
}

// Per warp: the envs' y pieces, the general path's slot buffer, and a sink
// for the stores of the lanes that write no pieces.
constexpr int kSinkWords = 48;
__host__ __device__ constexpr int exchange_bytes(int envs_per_warp) {
  return (2 * kPieceWords * envs_per_warp + kWarp + kSinkWords) * 4;
}

// Input row of slot s, or -1 for an unused slot.
template <bool kSlots8>
__device__ __forceinline__ int slot_row(int s, int ne, int nc,
                                        bool interleaved) {
  int comp, c;
  if constexpr (kSlots8) {
    if (s >= 24) return s - 24 < ne - 3 * nc ? 3 * nc + (s - 24) : -1;
    comp = s >> 3;
    c = s & 7;
    if (c >= nc) return -1;
  } else {
    if (s >= ne) return -1;
    if (s >= 3 * nc) return s;
    comp = s / nc;
    c = s - comp * nc;
  }
  return interleaved ? 3 * c + comp : comp * nc + c;
}

// bf16x2 of (lo, hi) rounded to nearest; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float lo_f(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// (x0, x1) = p[0] + p[1] + p[2] in bf16x2 pieces, to 2^-24 relative.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t p[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = pack_bf16x2(x0, x1);
    x0 -= lo_f(p[k]);
    x1 -= hi_f(p[k]);
  }
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Cone projection of one contact (fn, f1, f2) with inv = 1/(1 + mu^2); the
// predicates are the reference's.
__device__ __forceinline__ void cone(float& fn, float& f1, float& f2,
                                     float mu, float inv) {
  const float x = f1 * f1 + f2 * f2 + 1e-20f;
  const float t = x * rsqrt_approx(x);
  const bool inside = t <= mu * fn;
  const bool below = mu * t <= -fn;
  const float fn_p = fmaxf((fn + mu * t) * inv, 0.f);
  const float scale = t > 1e-12f ? mu * fn_p * rcp_approx(t) : 0.f;
  fn = below ? 0.f : (inside ? fmaxf(fn, 0.f) : fn_p);
  f1 = below ? 0.f : (inside ? f1 : f1 * scale);
  f2 = below ? 0.f : (inside ? f2 : f2 * scale);
}

// lanes: loads of V (8 or 16 bytes: kVec envs of one row (i, j)) through
// registers into the envs' tiles.
template <typename T, typename V>
__device__ __forceinline__ void stage_lanes_vec(const Params& p, T* st,
                                                long long e0) {
  constexpr int kVec = sizeof(V) / sizeof(T);
  const T* a = static_cast<const T*>(p.a);
  const int ne = p.ne, nn = ne * ne, S = tile_stride(ne, sizeof(T));
  const int per_row = p.envs / kVec;
  for (int q = threadIdx.x; q < nn * per_row; q += blockDim.x) {
    const int ij = q / per_row, part = q - ij * per_row;
    const long long env = e0 + part * kVec;
    if (env >= p.batch) continue;
    const V v = *reinterpret_cast<const V*>(a + ij * p.batch + env);
    const T* x = reinterpret_cast<const T*>(&v);
    T* dst = st + part * kVec * p.tile_elems + (ij / ne) * S + ij % ne;
#pragma unroll
    for (int k = 0; k < kVec; ++k) dst[k * p.tile_elems] = x[k];
  }
}

// Copies the block's A into one padded tile per env (see tile_elems).
template <typename T>
__device__ __forceinline__ void stage_a(const Params& p, T* st, int kenvs) {
  const T* a = static_cast<const T*>(p.a);
  constexpr int es = sizeof(T);
  const int ne = p.ne, nn = ne * ne, S = tile_stride(ne, es);
  const long long e0 = (long long)blockIdx.x * p.envs;
  if (!p.lanes) {  // each warp copies its envs' contiguous A
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    for (int e = 0; e < kenvs; ++e) {
      const long long env = e0 + warp * kenvs + e;
      if (env >= p.batch) return;
      T* tile = st + (warp * kenvs + e) * p.tile_elems;
      const T* src = a + env * nn;
      if (p.vec) {  // rows of ne*es bytes, a multiple of 16
        const int per_row = ne * es / 16;
        for (int k = lane; k < ne * per_row; k += kWarp) {
          const int r = k / per_row, c = k - r * per_row;
          cp_async16(reinterpret_cast<char*>(tile + r * S) + 16 * c,
                     reinterpret_cast<const char*>(src + r * ne) + 16 * c);
        }
      } else {
        for (int k = lane; k < nn; k += kWarp)
          tile[(k / ne) * S + k % ne] = src[k];
      }
    }
    return;
  }
  // lanes: row (i, j) holds the block's envs side by side in device memory
  if (p.vec && p.envs * es >= 16) {
    stage_lanes_vec<T, uint4>(p, st, e0);
  } else if (p.vec) {
    stage_lanes_vec<T, uint2>(p, st, e0);
  } else {
    for (int q = threadIdx.x; q < nn * p.envs; q += blockDim.x) {
      const int ij = q / p.envs, el = q - ij * p.envs;
      const long long env = e0 + el;
      if (env < p.batch)
        st[el * p.tile_elems + (ij / ne) * S + ij % ne] =
            a[ij * p.batch + env];
    }
  }
}

template <typename T, bool kSlots8>
__global__ void __launch_bounds__(kMaxThreads)
apgd_kernel(const Params p) {
  constexpr int es = sizeof(T);
  constexpr int kAPieces = es == 2 ? 1 : 3;  // bf16 pieces of A
  constexpr int kEnvs = envs_per_warp(kSlots8, es);
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2;  // mma group: accumulator rows g, g+8, g+16, g+24
  const int t = lane & 3;   // thread in group
  const int my = kEnvs == 2 ? (t & 1) : 0;  // the env this lane projects
  const bool writer = t < kEnvs;            // ... and writes back
  const long long env0 = (long long)blockIdx.x * p.envs + warp * kEnvs;
  const long long env = env0 + my;
  const int ne = p.ne, nc = p.nc, nl = p.ne - 3 * p.nc;
  const bool il = p.interleaved != 0;

  const bool live = env < p.batch;
  int rin[4], cin[8];  // input rows of the lane's row and column slots
#pragma unroll
  for (int q = 0; q < 4; ++q)
    rin[q] = slot_row<kSlots8>(g + 8 * q, ne, nc, il);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    cin[q] = slot_row<kSlots8>(16 * (q >> 2) + 8 * ((q >> 1) & 1) + 2 * t +
                                   (q & 1), ne, nc, il);
  // this lane's env, slots g, g+8, g+16, g+24: loaded before A's staging
  // barrier, so their latency hides under it
  float bv[4], f[4], y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool ok = live && rin[q] >= 0;
    bv[q] = ok ? p.b[env * p.v_se + rin[q] * p.v_si] : 0.f;
    f[q] = ok ? p.f0[env * p.v_se + rin[q] * p.v_si] : 0.f;
  }
  // kSlots8: group g projects contact g and limit g in registers; else
  // lane i projects contact i (i < nc) or limit i - nc through zbuf
  const int pc = kSlots8 ? g : lane;
  const float mu = live && pc < nc ? p.mu[env * p.m_se + pc * p.m_sc] : 0.f;

  stage_a<T>(p, st, kEnvs);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // the last barrier of the block: warps may leave now
  if (env0 >= p.batch) return;
  const float inv = 1.f / (1.f + mu * mu);

  uint32_t* pieces = reinterpret_cast<uint32_t*>(
      smem + p.stage_bytes + warp * exchange_bytes(kEnvs));
  float* zbuf = reinterpret_cast<float*>(pieces + 2 * kPieceWords * kEnvs);
  uint32_t* sink = reinterpret_cast<uint32_t*>(zbuf + kWarp);
  for (int k = lane; k < 2 * kPieceWords * kEnvs; k += kWarp) pieces[k] = 0u;

  // A fragments: fr[env][piece][m tile][k tile][reg]; reg r holds rows
  // 16 mt + g + 8 (r & 1), columns 16 kt + 2t + 8 (r >> 1) + {0, 1}.
  const int S = tile_stride(ne, es);
  uint32_t fr[kEnvs][kAPieces][2][2][4];
  float step = 0.f;
#pragma unroll
  for (int e = 0; e < kEnvs; ++e) {
    const T* tile = st + (warp * kEnvs + e) * p.tile_elems;
    float rowsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rin[2 * mt + (r & 1)];
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = cin[4 * kt + 2 * (r >> 1) + h];
            v[h] = (row >= 0 && col >= 0) ? to_f(tile[row * S + col]) : 0.f;
            rowsum[2 * mt + (r & 1)] += fabsf(v[h]);
          }
          if constexpr (kAPieces == 1) {
            fr[e][0][mt][kt][r] = pack_bf16x2(v[0], v[1]);  // exact: bf16
          } else {
            uint32_t s[3];
            split3(v[0], v[1], s);
#pragma unroll
            for (int k = 0; k < kAPieces; ++k) fr[e][k][mt][kt][r] = s[k];
          }
        }
    // Lipschitz bound: row sums over the group's 4 lanes, then the max
    float lip = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = rowsum[q];
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      lip = fmaxf(lip, s);
    }
#pragma unroll
    for (int o = 4; o < kWarp; o <<= 1)
      lip = fmaxf(lip, __shfl_xor_sync(kFull, lip, o));
    if (e == my) step = 1.f / fmaxf(lip, 1e-8f);
  }


  auto project = [&](float z[4]) {
    if constexpr (kSlots8) {
      cone(z[0], z[1], z[2], mu, inv);
      const bool contact = g < nc;
      z[0] = contact ? z[0] : 0.f;
      z[1] = contact ? z[1] : 0.f;
      z[2] = contact ? z[2] : 0.f;
      z[3] = g < nl ? fmaxf(z[3], 0.f) : 0.f;
    } else {
      if (t == 0)
#pragma unroll
        for (int q = 0; q < 4; ++q) zbuf[g + 8 * q] = z[q];
      __syncwarp();
      if (lane < nc) {
        float fn = zbuf[lane], f1 = zbuf[nc + lane], f2 = zbuf[2 * nc + lane];
        cone(fn, f1, f2, mu, inv);
        zbuf[lane] = fn;
        zbuf[nc + lane] = f1;
        zbuf[2 * nc + lane] = f2;
      } else if (lane < nc + nl) {
        zbuf[2 * nc + lane] = fmaxf(zbuf[2 * nc + lane], 0.f);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] = rin[q] >= 0 ? zbuf[g + 8 * q] : 0.f;
    }
  };

  project(f);
#pragma unroll
  for (int q = 0; q < 4; ++q) y[q] = f[q];
#pragma unroll 2
  for (int it = 0; it < p.iterations; ++it) {
    const float m = __ldg(p.coef + it);
    // y -> B operand: writer (g, my) stores the pieces of its env's 4
    // slots; lane (g, t) loads piece g of writers 2t and 2t+1 of each env
    // (zero for g >= 3)
    uint32_t* pb = pieces + (it & 1) * kPieceWords;
    uint32_t* dst = writer ? pb + my * 2 * kPieceWords : sink;
    uint32_t lo[3], hi[3];
    split3(y[0], y[1], lo);  // slots g, g+8
    split3(y[2], y[3], hi);  // slots g+16, g+24
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(dst + (8 * k + g) * 2) =
          make_uint2(lo[k], hi[k]);
    __syncwarp();
    float d[kEnvs][2][4];
#pragma unroll
    for (int e = 0; e < kEnvs; ++e) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          pb + e * 2 * kPieceWords + (8 * g + 2 * t) * 2);
      const uint32_t b00 = __byte_perm(w.x, w.z, 0x5410);  // slots 2t, 2t+1
      const uint32_t b01 = __byte_perm(w.x, w.z, 0x7632);  // 2t+8, 2t+9
      const uint32_t b10 = __byte_perm(w.y, w.w, 0x5410);  // 2t+16, 2t+17
      const uint32_t b11 = __byte_perm(w.y, w.w, 0x7632);  // 2t+24, 2t+25
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) d[e][mt][r] = 0.f;
#pragma unroll
        for (int k = 0; k < kAPieces; ++k) {
          mma_bf16(d[e][mt], fr[e][k][mt][0], b00, b01);
          mma_bf16(d[e][mt], fr[e][k][mt][1], b10, b11);
        }
      }
    }
    // columns 0, 1 (hi, mid) sit in lane 4c, column 2 (lo) in lane 4c+1;
    // with two envs each lane sends its partner the other env's part
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mt = q >> 1, c = 2 * (q & 1);
      const float p0 = d[0][mt][c] + d[0][mt][c + 1];
      const float p1 = d[kEnvs - 1][mt][c] + d[kEnvs - 1][mt][c + 1];
      const float keep = my ? p1 : p0;  // selects, not a local array
      const float send = my ? p0 : p1;
      const float s = keep + __shfl_xor_sync(kFull, send, 1);
      z[q] = y[q] - step * (s + bv[q]);
    }
    project(z);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      y[q] = z[q] + m * (z[q] - f[q]);
      f[q] = z[q];
    }
  }
  if (writer && live)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (rin[q] >= 0) p.out[env * p.v_se + rin[q] * p.v_si] = f[q];
}

struct Plan {
  int envs, threads, smem, slots8, vec, tile_elems, stage_bytes;
  long long blocks;
};

Plan plan(const void* a, int es, long long batch, int ne, int nc, int lanes) {
  Plan pl;
  pl.slots8 = nc <= 8 && ne - 3 * nc <= 8;
  const int kenvs = envs_per_warp(pl.slots8, es);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (lanes) {
    pl.envs = 16;
    while (pl.envs > 4 && (batch + pl.envs - 1) / pl.envs < kNumSms)
      pl.envs /= 2;
    const int load = pl.envs * es < 16 ? pl.envs * es : 16;  // bytes
    pl.vec = aligned && load >= 8 && (batch * es) % load == 0;
  } else {
    pl.envs = kBlockWarps * kenvs;
    pl.vec = aligned && (ne * es) % 16 == 0;
  }
  pl.threads = pl.envs / kenvs * kWarp;
  pl.tile_elems = tile_elems(ne, es, lanes);
  pl.stage_bytes = round16(pl.envs * pl.tile_elems * es);
  pl.smem = pl.stage_bytes + pl.threads / kWarp * exchange_bytes(kenvs);
  pl.blocks = (batch + pl.envs - 1) / pl.envs;
  return pl;
}

template <typename T, bool kSlots8>
int launch(const Params& p, const Plan& pl, cudaStream_t s) {
  const auto kernel = apgd_kernel<T, kSlots8>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(pl.blocks), pl.threads, pl.smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch configuration of a solve: out = {envs per block, threads per
// block, dynamic shared memory bytes, slot map (1 = nc, nl <= 8), vector
// loads (1) or element loads (0)}.
extern "C" void apgd_plan(const void* a, int a_is_bf16, long long batch,
                          int ne, int nc, int lanes, int* out) {
  const Plan pl = plan(a, a_is_bf16 ? 2 : 4, batch, ne, nc, lanes);
  out[0] = pl.envs;
  out[1] = pl.threads;
  out[2] = pl.smem;
  out[3] = pl.slots8;
  out[4] = pl.vec;
}

// Launches the solve on `stream` and returns the first CUDA error as an int
// (cudaFuncSetAttribute's or cudaGetLastError()'s).  Device pointers; a is
// f32 (a_is_bf16 = 0) or bf16, contiguous (B, ne, ne) (lanes = 0) or
// (ne, ne, B) (lanes = 1); rows grouped (interleaved = 0) or interleaved.
// b, f0, out share the element strides (v_se, v_si); mu[e, c] at
// e*m_se + c*m_sc; coef holds `iterations` momentum coefficients.
// Requires 3*nc <= ne <= 32.
extern "C" int apgd_launch(const void* a, int a_is_bf16, const void* b,
                           const void* mu, const void* f0, void* out,
                           const void* coef, long long batch, int ne, int nc,
                           int iterations, int lanes, int interleaved,
                           long long v_se, long long v_si, long long m_se,
                           long long m_sc, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const Plan pl = plan(a, a_is_bf16 ? 2 : 4, batch, ne, nc, lanes);
  Params p;
  p.a = a;
  p.b = static_cast<const float*>(b);
  p.mu = static_cast<const float*>(mu);
  p.f0 = static_cast<const float*>(f0);
  p.out = static_cast<float*>(out);
  p.coef = static_cast<const float*>(coef);
  p.batch = batch;
  p.v_se = v_se;
  p.v_si = v_si;
  p.m_se = m_se;
  p.m_sc = m_sc;
  p.ne = ne;
  p.nc = nc;
  p.iterations = iterations;
  p.lanes = lanes;
  p.interleaved = interleaved;
  p.vec = pl.vec;
  p.envs = pl.envs;
  p.tile_elems = pl.tile_elems;
  p.stage_bytes = pl.stage_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_is_bf16)
    return pl.slots8 ? launch<__nv_bfloat16, true>(p, pl, s)
                     : launch<__nv_bfloat16, false>(p, pl, s);
  return pl.slots8 ? launch<float, true>(p, pl, s)
                   : launch<float, false>(p, pl, s);
}
