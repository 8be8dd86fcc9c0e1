// Batched APGD dual contact solve on Hopper (sm_90a) for dual systems too
// large for apgd.cu (33 <= ne <= 192): A held in registers across a team
// of warps per env, the matvec on the tensor cores (on the FMA pipe for f32
// A at ne 49-64), persistent blocks that stage the next envs' A while they
// iterate on the current ones.
//
// Replaces the XLA route of deepmimic_mujoco_tpu/ops/apgd.py: make_apgd
// (:216) hands every ne to _apgd_scan (:181), and only ne <= 32 has a
// Hopper kernel in apgd.cu.  No Pallas kernel of the JAX package computes
// this: the dual systems of build_humanoid(contact_cap=16, limit_cap=16)
// (ne = 64; README's exact-cold configuration stores its A in f32) and of
// the uncapped model (37 contacts, 28 limits: ne = 139) take this kernel.
//
// Per env, rows in the solver's interleaved order [n, t1, t2]*nc + lim(nl):
//   f = y = proj(f0), step = 1/max(L, 1e-8) with L = max_i sum_j |A_ij|
//   for k < iterations:
//     g = A y + b;  f' = proj(y - step g);  y = f' + m_k (f' - f);  f = f'
// with the data-independent Nesterov coefficients m_k from the host.  proj
// maps contact c's triple (rows 3c, 3c+1, 3c+2) onto the elliptic friction
// cone and clamps limit rows to >= 0, with the reference's predicates.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor cores,
// 989 bf16 on them), per solve: bytes = B*ne^2*sizeof(A) + 4*B*(3*ne + nc);
// flops = 2*B*ne^2*iterations.  At B = 4096: ne 139, bf16 A, 15 iterations:
// 158 MB (47 us) against 2.4 GFLOP (35 us f32): bytes.  ne 64, bf16, 15:
// 34 MB (10 us): bytes.  ne 64, f32 A, 50 iterations: 67 MB (20 us)
// against 1.68 GFLOP (25 us at the f32 rate, 1.7 us at the tensor rate).
//
// What held the first version of this kernel (one thread per row, A
// transposed in shared memory) at a tenth of that: every FMA read one
// element of A and one word of y from shared memory (2*ne wavefronts per
// warp and iteration), three block barriers per iteration, A loaded with
// scalar transposing stores that did not overlap the iterations, 2 blocks
// of 5 warps per SM at ne 139 with f32 A.
//
// Two designs were weighed, per lane registers for A at ne 139 (144 padded):
// (a) register-blocked f32 FMA: a 12x12 tile per thread, 144 threads, 72
//     registers of packed bf16 A, 12 words of y per iteration; each bf16
//     element costs an FMA and an integer unpack (64/clk/SM), ~320 cycles
//     per env and iteration on one SM, and the row sums need shuffles
//     across 12 column groups;
// (b) mma.m16n8k16 with A in fragment registers and y in three bf16
//     pieces: 81 tiles, 324 registers per env, 108 a lane over 3 warps;
//     ~81 mma (~130 cycles at the ~0.6 mma/clk/SM that mma.sync reaches)
//     per env and iteration, no unpacking.  f32 A takes three bf16 pieces
//     (3x the registers and mma), which brings (b) to ~(a)'s FMA count.
// (b) is taken for bf16 A (as apgd.cu does for ne <= 32) and for f32 A
// above 64 rows; for f32 A at ne 49-64 (kt = 4: README's exact-cold
// configuration) the card measured (a) faster, 0.125 against 0.209 ms at
// 50 iterations: its f32 A needs no pieces (64 registers a lane against
// 96), y travels in f32 with no split, and the FMA pipe is not the tensor
// pipe that three pieces of mma kept busy.
//
// * Tiles.  Rows and columns pad to kt = ceil(ne/16) tiles in the input
//   order (no permutation: the projection is by owner threads, below).
//   Warp w of an env's team holds the fragments of row tiles wR..wR+R-1
//   against all kt column tiles: fr[piece][r][k][4] (apgd.cu's fragment
//   layout), exact for bf16, three bf16 pieces for f32 A.  y enters the
//   B operand as three bf16 pieces hi + mid + lo in columns 0-2 (rows 3+
//   of the piece buffer stay zero), read with one conflict-free 8-byte
//   shared load per column tile and lane; the lane's accumulator columns
//   0+1 (lane 4g) and 2 (lane 4g+1) meet in one xor-shuffle.  One
//   instantiation per tile count (kt = 3..12): no tile is predicated (a
//   predicated mma.sync carries a WARPSYNC).
//   Row tiles per warp (R), warps per env and registers of A per lane:
//     bf16  kt 3-4: R = kt, 1 warp, 4 envs per block (36-64)
//           kt 5-6: R 3, 2 warps (60-72)   kt 7-8: R 2, 4 warps (56-64)
//           kt 9: R 3, 3 warps (108)       kt 10-12: R 2, 5-6 warps (80-96)
//     f32   kt 3: R 2, 2 warps (72)        kt 5-9: R 1, 5-9 warps (60-108)
//           kt 10-12: R 1, 10-12 warps, A kept as f32 (80-96) and split
//           into pieces per iteration: three pieces would need 56,000 of
//           the SM's 65,536 registers.
//   f32 at kt 4 takes design (a) in the same team of 2 warps: thread
//   (rg, cg) holds rows 4rg..4rg+3, columns 16cg..16cg+15 of A in f32
//   (64 registers), reads its 16 values of y with four 16-byte loads,
//   and a reduce-scatter over the 4 column groups (2 shuffle rounds)
//   leaves row 4rg + cg in each thread.
//   Threads get 128 registers (16 warps per SM) where A takes <= 64 of
//   them, else 168 (12 warps).
// * Projection.  Thread i of the team owns rows 3i..3i+2: contact i's
//   triple (i < nc) or up to three limits.  It keeps their b, f, y (and
//   mu) in registers, reads A y from a shared row buffer, projects (t =
//   x*rsqrt(x), an approximate reciprocal, 1/(1+mu^2) once) and writes the
//   pieces of y back.  Two team barriers per iteration (A y complete; y
//   complete), a __syncwarp each for one-warp teams, against the first
//   version's three block barriers.
// * Loads.  Blocks are persistent (the grid is what stays resident).  A
//   block stages its next group's A, b, f0 and mu with 16-byte cp.async
//   from the 16-byte boundary below each range (A's rows need no
//   alignment: ne 139 rows are 278 bytes); rows whose stride is a multiple
//   of 32 bytes get 16 bytes of padding per 128, so that reading them does
//   not fall on a few banks.  It builds the fragments - one ldmatrix per
//   tile where bf16 rows fill whole tiles (ne % 16 == 0), else element by
//   element - then issues the next group's copies and iterates on
//   registers while they land.
//
// What bounds it now (B = 4096, timed on an H100 80GB HBM3 at 700 W with
// chip_smoke.py; PERF.md has the figures): the iterations, each a chain of
// ~200 dependent instructions per warp (B-fragment loads, mma chains of kt
// deep, shuffles, the owner's cone and piece split, two barriers) that a
// few warps per SM scheduler cannot hide, and the SM's registers, which
// bound how many envs are resident: 16 of the 31 per SM at ne 64 bf16
// (2 rounds), 8 for exact-cold (4 rounds), 4 at ne 139 bf16 (8 rounds,
// where the element-by-element fragment build of odd rows adds a third).
// A's load, the bytes bound, is hidden under the iterations but for the
// first group of each block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxNe = 192;
constexpr int kMinTiles = 3;  // smaller systems pad to 3 tiles
constexpr unsigned kFull = 0xffffffffu;

// Row tiles per warp for kt column tiles, A in bf16 (pieces == 1) or f32.
__host__ __device__ constexpr int row_tiles(int kt, int pieces) {
  return pieces == 1 ? (kt == 4 ? 4 : (kt <= 6 || kt == 9) ? 3 : 2)
                     : (kt <= 4 ? 2 : 1);
}
__host__ __device__ constexpr int team_warps(int kt, int r) {
  return (kt + r - 1) / r;
}
__host__ __device__ constexpr int block_envs(int kt, int r) {
  return team_warps(kt, r) >= 3 ? 1 : 4 / team_warps(kt, r);
}
// Blocks per SM the registers must allow: 16 warps (128 registers a
// thread) where A takes <= 64 registers a lane (the one-warp bf16 teams,
// the f32 FMA teams at kt = 4), else 12 (168 registers).
__host__ __device__ constexpr int min_blocks(int kt, int r) {
  return (kt <= 4 && r >= 3) || (kt == 4 && r == 2) ? 4
         : 12 / (team_warps(kt, r) * block_envs(kt, r)) > 1
             ? 12 / (team_warps(kt, r) * block_envs(kt, r))
             : 1;
}

struct Params {
  const void* a;
  const float* b;
  const float* mu;
  const float* f0;
  float* out;
  const float* coef;  // momentum table, `iterations` floats
  long long batch, groups;
  int ne, nc, iterations, envs;
  int skew;  // A staged with 16 bytes of padding per 128 (rows of 32k bytes)
  int stage_a, stage_v, stage_mu;  // staged bytes of A, of b and f0, of mu
};

__host__ __device__ constexpr int round16(long long n) {
  return static_cast<int>((n + 15) / 16 * 16);
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


// Cone projection of one contact (fn, f1, f2) with inv = 1/(1 + mu^2): the
// arithmetic of apgd.cu, the predicates of the reference.
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

// Byte offset of the staged A element at stream offset o (bytes from the
// 16-byte boundary the copy started at): 16 bytes of padding per 128.
__device__ __forceinline__ unsigned skewed(unsigned o) {
  return o + ((o >> 7) << 4);
}

// Issues 16-byte cp.async copies of src's bytes [lo, hi), from the 16-byte
// boundary at or below src + lo up to the one at or above src + hi, into
// dst (skewed when `skew`).  The bytes outside [lo, hi) share the range's
// 16-byte chunks and are never read.
__device__ __forceinline__ void stage(unsigned char* dst, const void* src,
                                      long long lo, long long hi, bool skew) {
  if (hi <= lo) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = (s + lo) & ~uintptr_t(15);
  const int n = static_cast<int>((((s + hi + 15) & ~uintptr_t(15)) - a0) >> 4);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    cp_async16(dst + 16 * k + (skew ? 16 * (k >> 3) : 0),
               reinterpret_cast<const void*>(a0 + 16 * k));
}

__device__ __forceinline__ unsigned shift16(const void* src, long long lo) {
  return static_cast<unsigned>((reinterpret_cast<uintptr_t>(src) + lo) & 15);
}

// The block's group of envs [group*envs, ...): A, b, f0, mu into the stage.
template <int es>
__device__ __forceinline__ void stage_group(const Params& p,
                                            unsigned char* smem,
                                            long long group) {
  const long long e0 = group * p.envs;
  const long long e1 = e0 + p.envs < p.batch ? e0 + p.envs : p.batch;
  const long long nn = static_cast<long long>(p.ne) * p.ne;
  stage(smem, p.a, e0 * nn * es, e1 * nn * es, p.skew != 0);
  unsigned char* v = smem + p.stage_a;
  stage(v, p.b, e0 * p.ne * 4, e1 * p.ne * 4, false);
  stage(v + p.stage_v, p.f0, e0 * p.ne * 4, e1 * p.ne * 4, false);
  stage(v + 2 * p.stage_v, p.mu, e0 * p.nc * 4, e1 * p.nc * 4, false);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The team's barrier: a named barrier per env of the block (id 0 is
// __syncthreads'), or __syncwarp for a one-warp team.
template <int kW>
__device__ __forceinline__ void team_sync(int el) {
  if constexpr (kW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + el), "n"(kWarp * kW)
                 : "memory");
  }
}

// Half-word position of row r in a piece row of a y buffer: rows 16j +
// {2t, 2t+1, 2t+8, 2t+9} side by side (column tile j, lane t: the B
// fragment's b0, b1).
__device__ __forceinline__ int y_pos(int r) {
  const int w = r & 15;
  return (r >> 4) * 16 + ((w & 7) >> 1) * 4 + (w >> 3) * 2 + (w & 1);
}

// Stores the three bf16 pieces of y at half-word pos of piece rows 0-2 of
// a y buffer (rows of ys words).
template <int ys>
__device__ __forceinline__ void put_y(uint32_t* yb, int pos, float y) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(yb) + pos;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat16 piece = __float2bfloat16_rn(y);
    h[k * 2 * ys] = piece;
    y -= __bfloat162float(piece);
  }
}

// Byte offset in the stage of stream offset o: skewed or as it is.
template <bool kSkew>
__device__ __forceinline__ unsigned at(unsigned o) {
  return kSkew ? skewed(o) : o;
}

// A's fragments (and |A| row sums) from the staged rows of one env, element
// by element: lane (g, t) of a warp whose row tiles start at m0; o0 is the
// env's stream offset.  Rows and columns past ne read as zero.
template <typename T, int KT, int R, bool kLate, bool kSkew>
__device__ __forceinline__ void build_fragments(
    const unsigned char* st_a, unsigned o0, int ne, int m0, int g, int t,
    uint32_t (&fr)[kLate ? 1 : (sizeof(T) == 2 ? 1 : 3)][kLate ? 1 : R]
                  [kLate ? 1 : KT][4],
    float (&fv)[kLate ? R : 1][kLate ? KT : 1][8], float (&rs)[R][2]) {
  constexpr int es = sizeof(T);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rs[r][0] = rs[r][1] = 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8 of tile m0 + r
      const int row = 16 * (m0 + r) + g + 8 * hr;
      const bool row_in = row < ne;
      const unsigned base = o0 + (row * ne + 2 * t) * es;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const bool full = 16 * (k + 1) <= ne;  // uniform
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {  // columns 2t, 2t+1 (+ 8)
          const int q = hr + 2 * hc;
          const int col = 16 * k + 2 * t + 8 * hc;
          const unsigned o = base + (16 * k + 8 * hc) * es;
          const bool in0 = row_in && (full || col < ne);
          const bool in1 = row_in && (full || col + 1 < ne);
          if constexpr (es == 2) {
            // raw bf16 bits: packed as they are, widened for the sum
            const unsigned u0 =
                in0 ? *reinterpret_cast<const unsigned short*>(
                          st_a + at<kSkew>(o))
                    : 0u;
            const unsigned u1 =
                in1 ? *reinterpret_cast<const unsigned short*>(
                          st_a + at<kSkew>(o + 2))
                    : 0u;
            rs[r][hr] += fabsf(__uint_as_float(u0 << 16));
            rs[r][hr] += fabsf(__uint_as_float(u1 << 16));
            fr[0][r][k][q] = u0 | (u1 << 16);
          } else {
            const float v0 =
                in0 ? *reinterpret_cast<const float*>(st_a + at<kSkew>(o))
                    : 0.f;
            const float v1 = in1 ? *reinterpret_cast<const float*>(
                                       st_a + at<kSkew>(o + 4))
                                 : 0.f;
            rs[r][hr] += fabsf(v0);
            rs[r][hr] += fabsf(v1);
            if constexpr (kLate) {
              fv[r][k][2 * q] = v0;
              fv[r][k][2 * q + 1] = v1;
            } else {
              uint32_t sp[3];
              split3(v0, v1, sp);
#pragma unroll
              for (int c = 0; c < 3; ++c) fr[c][r][k][q] = sp[c];
            }
          }
        }
      }
    }
  }
}

// T: A's storage; KT: 16-row tiles (rows and columns, zero-padded); R: row
// tiles per warp; kLate: A kept as f32 and split into pieces per iteration.
// Every count is a constant of the instantiation: no tile is predicated.
template <typename T, int KT, int R, bool kLate>
__global__ void __launch_bounds__(kWarp * team_warps(KT, R) *
                                      block_envs(KT, R),
                                  min_blocks(KT, R))
    apgd_wide_kernel(const Params p) {
  constexpr int es = sizeof(T);
  constexpr int kP = es == 2 ? 1 : 3;   // bf16 pieces of A in the products
  // f32 A at kt = 4 (ne 49-64): an f32 FMA matvec, no pieces (below)
  constexpr bool kFma = es == 4 && KT == 4;
  constexpr int W = team_warps(KT, R);  // warps per env
  constexpr int kEnvs = block_envs(KT, R);
  constexpr int ys = 8 * (KT | 1);      // words per piece row of y
  extern __shared__ __align__(16) unsigned char smem[];
  const int ne = p.ne, nc = p.nc;
  constexpr int team = kWarp * W;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int el = warp / W;             // env of the block
  const int tid = threadIdx.x - el * team;  // thread of the team
  const int w = tid / kWarp;           // warp of the team

  const unsigned char* st_a = smem;
  const float* st_b = reinterpret_cast<const float*>(smem + p.stage_a);
  const float* st_f = st_b + p.stage_v / 4;
  const float* st_m = st_f + p.stage_v / 4;
  uint32_t* ybase = reinterpret_cast<uint32_t*>(smem + p.stage_a +
                                                2 * p.stage_v + p.stage_mu);
  // y: [buffer 2][piece row 4][ys] (f32 y at the same offsets for kFma)
  uint32_t* ybuf = ybase + el * 8 * ys;
  float* gall = reinterpret_cast<float*>(ybase + kEnvs * 8 * ys);
  float* gbuf = gall + el * 16 * KT;     // A y, one word per row
  float* lipbuf = gall + kEnvs * 16 * KT;  // one word per warp of the block

  // piece rows 3 and the padded rows stay zero for the whole kernel
  for (int k = threadIdx.x; k < kEnvs * 8 * ys; k += blockDim.x) ybase[k] = 0u;
  long long group = blockIdx.x;
  stage_group<es>(p, smem, group);

  for (; group < p.groups; group += gridDim.x) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // the group is staged; last group's readers are done
    const long long e0 = group * kEnvs;
    const long long env = e0 + el;
    const bool live = env < p.batch;
    const long long nn = static_cast<long long>(ne) * ne;

    // A's fragments, and L from f32 row sums of |A|
    constexpr bool kFrag = !kLate && !kFma;  // pieces held in registers
    uint32_t fr[kFrag ? kP : 1][kFrag ? R : 1][kFrag ? KT : 1][4];
    float fv[kLate ? R : 1][kLate ? KT : 1][8];
    // kFma: thread (rg, cg) = (tid / 4, tid % 4) holds rows 4rg..4rg+3,
    // columns 16cg..16cg+15 of A in f32
    const int rg = tid >> 2, cg = tid & 3;
    float fa[kFma ? 4 : 1][kFma ? 16 : 1];
    float lip = 0.f;
    if (live) {
      const unsigned o0 = shift16(p.a, e0 * nn * es) +
                          static_cast<unsigned>(el * nn * es);
      if constexpr (kFma) {
        // 16-byte loads where the rows are whole (ne 64: 256-byte rows,
        // skewed, staged from a 16-byte boundary)
        const bool vec = ne == 64 && (o0 & 15) == 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * rg + i;
          const unsigned ob = o0 + (row * ne + 16 * cg) * es;
          if (vec) {
#pragma unroll
            for (int j = 0; j < 16; j += 4) {
              const float4 v = *reinterpret_cast<const float4*>(
                  st_a + skewed(ob + 4 * j));
              fa[i][j] = v.x;
              fa[i][j + 1] = v.y;
              fa[i][j + 2] = v.z;
              fa[i][j + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const unsigned o = ob + 4 * j;
              fa[i][j] = row < ne && 16 * cg + j < ne
                             ? *reinterpret_cast<const float*>(
                                   st_a + (p.skew ? skewed(o) : o))
                             : 0.f;
            }
          }
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) x += fabsf(fa[i][j]);
          x += __shfl_xor_sync(kFull, x, 1);  // the row's 4 column groups
          x += __shfl_xor_sync(kFull, x, 2);
          lip = fmaxf(lip, x);
        }
      } else {
        float rs[R][2];  // |A| row sums of rows g, g + 8 of each row tile
        // bf16 rows of whole tiles (skewed), staged from a 16-byte boundary:
        // every 8-element row piece is 16-byte aligned, one ldmatrix per tile
        bool tiled = false;
        if constexpr (es == 2) tiled = (ne & 15) == 0 && (o0 & 15) == 0;
        if (tiled) {
          if constexpr (es == 2) {
            // lane L addresses row (L & 7) + 8 ((L >> 3) & 1), column
            // 8 (L >> 4) of the tile: matrices 0-3 are registers a0-a3
            const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
            const unsigned lane_o = o0 + (lrow * ne + 8 * (lane >> 4)) * es;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int m = w * R + r;  // m >= KT: a padded tile of zeros
              rs[r][0] = rs[r][1] = 0.f;
#pragma unroll
              for (int k = 0; k < KT; ++k) {
                if (m < KT) {
                  const unsigned o = lane_o + (16 * m * ne + 16 * k) * es;
                  const unsigned sa =
                      static_cast<unsigned>(__cvta_generic_to_shared(st_a)) +
                      skewed(o);
                  uint32_t* d = fr[0][r][k];
                  asm volatile(
                      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                      "{%0,%1,%2,%3}, [%4];"
                      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                      : "r"(sa));
                } else {
#pragma unroll
                  for (int q = 0; q < 4; ++q) fr[0][r][k][q] = 0u;
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const uint32_t u = fr[0][r][k][q];
                  rs[r][q & 1] += fabsf(__uint_as_float(u << 16));
                  rs[r][q & 1] += fabsf(__uint_as_float(u & 0xffff0000u));
                }
              }
            }
          }
        } else if (p.skew) {
          build_fragments<T, KT, R, kLate, true>(st_a, o0, ne, w * R, g, t,
                                                  fr, fv, rs);
        } else {
          build_fragments<T, KT, R, kLate, false>(st_a, o0, ne, w * R, g, t,
                                                   fr, fv, rs);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = rs[r][h];
            x += __shfl_xor_sync(kFull, x, 1);
            x += __shfl_xor_sync(kFull, x, 2);
            lip = fmaxf(lip, x);
          }
      }
#pragma unroll
      for (int o = 4; o < kWarp; o <<= 1)
        lip = fmaxf(lip, __shfl_xor_sync(kFull, lip, o));
    }
    if (lane == 0) lipbuf[warp] = lip;

    // the thread's rows 3*tid .. 3*tid + 2: contact tid's triple (tid < nc)
    // or up to three limits; b, f0, mu from the stage
    const int r0 = 3 * tid;
    const int nrow = ne - r0 < 3 ? ne - r0 : 3;
    const bool own = live && nrow > 0;
    const bool con = tid < nc;
    float ob[3], of[3], oy[3];
    const float omu =
        own && con ? st_m[shift16(p.mu, e0 * nc * 4) / 4 + el * nc + tid]
                   : 0.f;
    const float oinv = 1.f / (1.f + omu * omu);
    int ypos[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ypos[c] = y_pos(r0 + c);
    {
      const unsigned sb = shift16(p.b, e0 * ne * 4) / 4 + el * ne + r0;
      const unsigned sf = shift16(p.f0, e0 * ne * 4) / 4 + el * ne + r0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ob[c] = own && c < nrow ? st_b[sb + c] : 0.f;
        of[c] = own && c < nrow ? st_f[sf + c] : 0.f;
      }
    }
    __syncthreads();  // fragments built, b/f0/mu read: the stage is free
    if (group + gridDim.x < p.groups)
      stage_group<es>(p, smem, group + gridDim.x);
    if (!live) continue;

#pragma unroll
    for (int k = 0; k < W; ++k) lip = fmaxf(lip, lipbuf[el * W + k]);
    const float step = 1.f / fmaxf(lip, 1e-8f);

    // f = y = proj(f0) -> y buffer 0
    if (own) {
      if (con) {
        cone(of[0], of[1], of[2], omu, oinv);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) of[c] = fmaxf(of[c], 0.f);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        oy[c] = of[c];
        if (c >= nrow) continue;
        if constexpr (kFma) {
          reinterpret_cast<float*>(ybuf)[r0 + c] = oy[c];
        } else {
          put_y<ys>(ybuf, ypos[c], oy[c]);
        }
      }
    }
    team_sync<W>(el);

    const int pr = g < 3 ? g : 3;  // the piece this lane's B column carries
    for (int it = 0; it < p.iterations; ++it) {
      if constexpr (kFma) {
        // y in f32 (buffer it & 1): columns 16cg..16cg+15, then a
        // reduce-scatter over the 4 column groups leaves row 4rg + cg here
        const float4* yv =
            reinterpret_cast<const float4*>(ybuf + (it & 1) * 4 * ys) + 4 * cg;
        float y[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = yv[j];
          y[4 * j] = v.x;
          y[4 * j + 1] = v.y;
          y[4 * j + 2] = v.z;
          y[4 * j + 3] = v.w;
        }
        float sum[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[i] = fa[i][0] * y[0];
#pragma unroll
          for (int j = 1; j < 16; ++j) sum[i] = fmaf(fa[i][j], y[j], sum[i]);
        }
        const bool hi2 = cg & 2, hi1 = cg & 1;
        float k0 = hi2 ? sum[2] : sum[0], k1 = hi2 ? sum[3] : sum[1];
        k0 += __shfl_xor_sync(kFull, hi2 ? sum[0] : sum[2], 2);
        k1 += __shfl_xor_sync(kFull, hi2 ? sum[1] : sum[3], 2);
        const float keep = (hi1 ? k1 : k0) +
                           __shfl_xor_sync(kFull, hi1 ? k0 : k1, 1);
        if (4 * rg + cg < ne) gbuf[4 * rg + cg] = keep;
      } else {
        const uint32_t* yb = ybuf + (it & 1) * 4 * ys + pr * ys + 2 * t;
        float acc[R][kP][4];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < kP; ++c)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][c][q] = 0.f;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const uint2 bw = *reinterpret_cast<const uint2*>(yb + 8 * k);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if constexpr (kLate) {
              uint32_t pa[3][4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                uint32_t s[3];
                split3(fv[r][k][2 * q], fv[r][k][2 * q + 1], s);
#pragma unroll
                for (int c = 0; c < 3; ++c) pa[c][q] = s[c];
              }
#pragma unroll
              for (int c = 0; c < 3; ++c)
                mma_bf16(acc[r][c], pa[c], bw.x, bw.y);
            } else {
#pragma unroll
              for (int c = 0; c < kP; ++c)
                mma_bf16(acc[r][c], fr[c][r][k], bw.x, bw.y);
            }
          }
        }
        // pieces of A, then columns hi + mid (lane 4g) and lo (lane 4g+1)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int m = w * R + r;
          float d[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            d[q] = acc[r][0][q];
#pragma unroll
            for (int c = 1; c < kP; ++c) d[q] += acc[r][c][q];
          }
          float s0 = d[0] + d[1], s1 = d[2] + d[3];
          s0 += __shfl_xor_sync(kFull, s0, 1);  // row 16m + g
          s1 += __shfl_xor_sync(kFull, s1, 1);  // row 16m + g + 8
          const int row = 16 * m + g + 8 * t;
          if (t < 2 && row < ne) gbuf[row] = t ? s1 : s0;
        }
      }
      team_sync<W>(el);  // A y complete; every warp has read y

      const float mk = __ldg(p.coef + it);
      if (own) {
        uint32_t* yn = ybuf + ((it + 1) & 1) * 4 * ys;
        float z[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          z[c] = c < nrow ? oy[c] - step * (gbuf[r0 + c] + ob[c]) : 0.f;
        if (con) {
          cone(z[0], z[1], z[2], omu, oinv);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) z[c] = fmaxf(z[c], 0.f);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          oy[c] = z[c] + mk * (z[c] - of[c]);
          of[c] = z[c];
          if (c >= nrow) continue;
          if constexpr (kFma) {
            reinterpret_cast<float*>(yn)[r0 + c] = oy[c];
          } else {
            put_y<ys>(yn, ypos[c], oy[c]);
          }
        }
      }
      team_sync<W>(el);  // y complete; every owner has read A y
    }
    if (own) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < nrow) p.out[env * ne + r0 + c] = of[c];
    }
  }
}

struct Plan {
  int kt, row_tiles, warps, envs, threads, stage_a, stage_v, stage_mu, smem;
  long long groups;
};

Plan plan(int ne, int nc, int es, long long batch) {
  Plan pl;
  pl.kt = (ne + 15) / 16 < kMinTiles ? kMinTiles : (ne + 15) / 16;
  pl.row_tiles = row_tiles(pl.kt, es == 2 ? 1 : 3);
  pl.warps = team_warps(pl.kt, pl.row_tiles);
  pl.envs = block_envs(pl.kt, pl.row_tiles);
  pl.threads = kWarp * pl.warps * pl.envs;
  const int raw = round16(static_cast<long long>(pl.envs) * ne * ne * es) + 32;
  pl.stage_a = raw + 16 * (raw / 128 + 1);
  pl.stage_v = round16(pl.envs * ne * 4) + 32;
  pl.stage_mu = round16(pl.envs * nc * 4) + 32;
  pl.smem = pl.stage_a + 2 * pl.stage_v + pl.stage_mu +
            4 * (pl.envs * (8 * 8 * (pl.kt | 1) + 16 * pl.kt) +
                 pl.threads / kWarp);
  pl.groups = (batch + pl.envs - 1) / pl.envs;
  return pl;
}

int num_sms() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// The instantiation for (A's type, kt): f32 A at kt >= 10 is kept as f32.
template <typename T, int KT>
constexpr auto kernel_of() {
  constexpr int pieces = sizeof(T) == 2 ? 1 : 3;
  return apgd_wide_kernel<T, KT, row_tiles(KT, pieces),
                          pieces == 3 && KT >= 10>;
}

// Blocks of this shape that stay resident on an SM (0 on an error, whose
// code goes to *err), with the kernel's shared-memory limit raised first.
template <typename T, int KT>
int resident(const Plan& pl, int* err) {
  const auto kernel = kernel_of<T, KT>();
  static int limit = 48 * 1024;  // per instantiation
  static int key_smem = 0, blocks = 0;
  *err = 0;
  if (pl.smem > limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return 0;
    }
    limit = pl.smem;
  }
  if (key_smem != pl.smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, pl.threads, pl.smem);
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return 0;
    }
    key_smem = pl.smem;
  }
  return blocks;
}

template <typename T, int KT>
int launch(const Params& p, const Plan& pl, cudaStream_t s) {
  int err = 0;
  const int per_sm = resident<T, KT>(pl, &err);
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long cap = static_cast<long long>(per_sm) * num_sms();
  const long long grid = pl.groups < cap ? pl.groups : cap;
  const auto kernel = kernel_of<T, KT>();
  kernel<<<static_cast<unsigned>(grid), pl.threads, pl.smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per tile count and type of A.
#define APGD_WIDE_TILES(X) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

template <typename T>
int resident_any(const Plan& pl, int* err) {
  switch (pl.kt) {
#define X(K) \
  case K:    \
    return resident<T, K>(pl, err);
    APGD_WIDE_TILES(X)
#undef X
  }
  *err = static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int launch_any(const Params& p, const Plan& pl, cudaStream_t s) {
  switch (pl.kt) {
#define X(K) \
  case K:    \
    return launch<T, K>(p, pl, s);
    APGD_WIDE_TILES(X)
#undef X
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int apgd_wide_max_ne() { return kMaxNe; }

// Launch configuration of a solve: out = {tiles (kt), row tiles per warp,
// warps per env, envs per block, threads per block, dynamic shared memory
// bytes, blocks resident per SM, grid}; returns the CUDA error of the
// occupancy query (0 when none).
extern "C" int apgd_wide_plan(int ne, int nc, int a_is_bf16, long long batch,
                              long long* out) {
  const Plan pl = plan(ne, nc, a_is_bf16 ? 2 : 4, batch);
  int err = 0;
  const int per_sm = a_is_bf16 ? resident_any<__nv_bfloat16>(pl, &err)
                               : resident_any<float>(pl, &err);
  const long long cap = static_cast<long long>(per_sm) * num_sms();
  const long long v[8] = {pl.kt,      pl.row_tiles, pl.warps,
                          pl.envs,    pl.threads,   pl.smem,
                          per_sm,     pl.groups < cap ? pl.groups : cap};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return err;
}

// Launches the solve on `stream` and returns the first CUDA error as an int
// (cudaFuncSetAttribute's, the occupancy query's or cudaGetLastError()'s).
// Device pointers, all contiguous and batch-major: a (B, ne, ne) f32
// (a_is_bf16 = 0) or bf16, b, f0, out (B, ne), mu (B, nc), rows
// interleaved; coef holds `iterations` momentum coefficients.  Requires
// 3*nc <= ne <= kMaxNe.
extern "C" int apgd_wide_launch(const void* a, int a_is_bf16, const void* b,
                                const void* mu, const void* f0, void* out,
                                const void* coef, long long batch, int ne,
                                int nc, int iterations, void* stream) {
  if (ne < 1 || ne > kMaxNe || nc < 0 || 3 * nc > ne)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  const Plan pl = plan(ne, nc, a_is_bf16 ? 2 : 4, batch);
  Params p;
  p.a = a;
  p.b = static_cast<const float*>(b);
  p.mu = static_cast<const float*>(mu);
  p.f0 = static_cast<const float*>(f0);
  p.out = static_cast<float*>(out);
  p.coef = static_cast<const float*>(coef);
  p.batch = batch;
  p.groups = pl.groups;
  p.ne = ne;
  p.nc = nc;
  p.iterations = iterations;
  p.envs = pl.envs;
  p.skew = (ne * (a_is_bf16 ? 2 : 4)) % 32 == 0;  // else the banks spread
  p.stage_a = pl.stage_a;
  p.stage_v = pl.stage_v;
  p.stage_mu = pl.stage_mu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_is_bf16 ? launch_any<__nv_bfloat16>(p, pl, s)
                   : launch_any<float>(p, pl, s);
}
