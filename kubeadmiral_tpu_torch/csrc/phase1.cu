// Phase 1 of the scheduling tick as hand-written CUDA kernels (sm_90a).
//
// Replaces: kubeadmiral_tpu/ops/pallas_slab.py:_phase1_kernel (the
// Pallas TPU kernel, launched by phase1_slab), itself a fused copy of
// kubeadmiral_tpu/ops/pipeline.py:_phase1.  Per (object, cluster) cell:
// resources_fit, the five filter reason bits plus the webhook-filter and
// cluster-invalid bits, feasibility, the five score plugins gated by
// score_enabled (taint and affinity normalised by the row's max over
// feasible columns), and webhook scores added on feasible columns.
// Outputs feasible u8/bool[B,C], reasons i32[B,C], totals i64[B,C],
// bit-identical to ops/phase1.py:phase1_plain.
//
// Bound on an H100: bytes, at both of the main path's chunks (c5: 4096 x
// 5120 x 3, 21.35 B per cell, 13 of them output; c3: 4096 x 512 x 2).
// chip_smoke.py works out both sides from each run's inputs; PERF.md has
// the figures.
//
// Design.
// - columns_kernel copies alloc and used [C, R] resource-major, so that
//   four consecutive columns of one resource are 32 consecutive bytes, and
//   derives per column what the resource plugins need (reciprocals of the
//   clamped capacities, the balanced score's range shifts, shifted-
//   capacity product and its reciprocal): once a call, not once a block.
//   phase1_kernel is launched as its programmatic dependent, so its blocks
//   start while it finishes and wait for it before the column planes.
// - A block covers kRows rows (a template count) over the whole cluster
//   axis, so each row's two maxima stay in the block.  Each thread owns
//   quads of four consecutive columns and walks them twice.
// - Pass 1, per quad: first every load that does not wait on feasibility,
//   so that they are in flight together (the quad's cpu and mem alloc/used
//   for the block's rows, each mask plane four bytes at a time, the webhook
//   scores 16 B at a time); the reason bits built four cells to a word; the
//   fit test; feasible and reasons stored four cells at a time; the
//   resource plugins, from the quad's column values, once for the block's
//   rows, computed on all four cells without a branch and selected by
//   feasibility; the taint and affinity planes, 16 B at a time, only where
//   the quad has a feasible cell; the webhook score added.  A row that normalises
//   nothing stores its totals (32 B a quad).  A row that does keeps each
//   cell's partial total, taint and affinity value and the quad's
//   feasibility in shared memory, in the thread's own slots, and folds the
//   two masked maxima.
// - One block reduction of the rows' maxima.  Pass 2, rows that
//   normalise: the normalised terms from the kept values; it reads no
//   global plane.
// - Two rows a block while two such blocks fit in an SM's shared memory
//   (C up to about 3,350: c3); one row past that (c5: 87 KB a block, two
//   blocks an SM), up to about 13,600 columns; beyond, one row with the
//   partial totals waiting in the totals output and the score planes read
//   again in pass 2.  At c5, two one-row blocks an SM, each loading while
//   the other computes or reduces, measured faster than one two-row block
//   (174 KB) an SM (PERF.md, PR 4).
// - Where C is not a multiple of 4 or a plane is not 16-byte aligned,
//   quads load and store cell by cell.  Every branch on the filter and
//   plugin flags is block-uniform.
// - Registers, shared memory, spills: ptxas's figures print on every
//   chip_smoke.py run (PERF.md): at most 320 threads a block; the one-row
//   kernels bounded to 96 registers (two blocks an SM), with no spills
//   where quads are single accesses (c3, c5) and 16 bytes where they load
//   cell by cell; the two-row kernels 150 registers, no spills.
//
// Division.  Every kept quotient is floor(num / den) with den clamped to
// [1, ...): num an int64 that may have wrapped (x100 products), den a
// column's capacity (MostAllocated, LeastAllocated), a column's shifted-
// capacity product (BalancedAllocation), or a row's maximum (normalising,
// int32).  short_div takes f = (float)num * rcp with rcp within 2 ulp of
// 1/(float)den (__fdividef; computed once a column or a row) and
// q = floor(f) as an int32 (F2I.FLOOR).  num's and den's conversions and
// the product round to within 2^-24 each, so |f - num/den| <=
// |num/den| * 2^-21.2.  When |q| < 2^20, |num/den| < 2^20 + 2, so f is
// within 0.45 of num/den and q within one of the floor; one correction
// against the remainder r = num - q*den (in [-den, 2*den), so exact in
// 32-bit arithmetic when den <= 2^30 and in 64-bit when den < 2^62) lands
// on floor(num/den).  The short path is thus exact for every int64 num
// and den in [1, 2^62) with |q| < 2^20, and for num = 0 (0 * inf, NaN,
// floors to 0); rcp = +inf from 2^62 on sends the rest out of range.
// A kept lane outside it (a large quotient, as from a wrapped x100
// numerator or a negative row maximum) is divided again exactly, with
// the 64-bit '/' and '%' out of line.  Kept quotients are at most 100 on
// feasible cells of sane inputs (capacities at least the request,
// feasible values at most their row's maximum), as in
// kubeadmiral_tpu/ops/scores.py:_floordiv_smallq, which divides the same
// way in f64; tests/test_torch_division.py holds the claim in numpy for
// any reciprocal within 2 ulp.  floor(x / 2) for the least/most average
// is an arithmetic shift.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 320;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPlugins = 5;  // filter and score plugin counts
constexpr uint32_t kOnes = 0x01010101u;  // one flag bit per byte of a quad
constexpr int kReasonWebhookFilter = 5;   // bit positions
constexpr int kReasonClusterInvalid = 6;
constexpr long long kMaxScore = 100;
// ops/filters.py resource columns.
constexpr int kCpu = 0;
constexpr int kMem = 1;
constexpr int kFixedResources = 2;
// ops/filters.py filter and ops/scores.py plugin indices.
constexpr int kApi = 0, kTaintFilter = 1, kFit = 2, kPlacement = 3, kSelector = 4;
constexpr int kTaint = 0, kBalanced = 1, kLeast = 2, kAffinity = 3, kMost = 4;

// Two's-complement int64 arithmetic, wrapping as torch's does.
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

// Out of line: one copy for every site, taken only outside the short
// path's range.
__device__ __noinline__ long long floor_div_exact(long long num, long long den) {
  const long long q = num / den;  // den >= 1; '/' truncates toward zero
  return (num % den < 0) ? q - 1 : q;
}

// The reciprocal short_div takes for a divisor already clamped to >= 1:
// within 2 ulp of 1/(float)den (__fdividef), or +inf from 2^62 on, which
// sends every lane to the exact path.
__device__ __forceinline__ float div_rcp(long long den) {
  return den < (1LL << 62) ? __fdividef(1.0f, __ll2float_rn(den)) : __int_as_float(0x7f800000);
}

// floor(num / den) for den >= 1 and rcp = div_rcp(den), without a
// branch on the lane's value: exact wherever `ok` comes back true (file
// note); elsewhere the caller divides again with floor_div_exact.  The
// remainder's correction runs in 32 bits where den <= 2^30 (the true
// remainder then lies in [-2^30, 2^31)), else in 64.
__device__ __forceinline__ int32_t short_div(long long num, long long den, float rcp, bool& ok) {
  // Rounds down and saturates; NaN (num = 0 over rcp = inf) gives 0.
  const int32_t q = __float2int_rd(__fmul_rn(__ll2float_rn(num), rcp));
  ok = uint32_t(q) + uint32_t((1 << 20) - 1) < uint32_t((1 << 21) - 1);  // |q| < 2^20
  uint32_t up, down;
  if (den <= (1LL << 30)) {
    const int32_t r = int32_t(uint32_t(num) - uint32_t(q) * uint32_t(den));
    up = r >= int32_t(den), down = r < 0;
  } else {
    const long long r = wsub(num, wmul(q, den));
    up = r >= den, down = r < 0;
  }
  return int32_t(uint32_t(q) + up - down);
}

// A score's integer type: int32 on the short path (every short quotient
// is below 2^20 in size, so the plugins' sums stay below 2^22), int64 on
// the exact one.
template <bool kExact>
using Score = typename std::conditional<kExact, long long, int32_t>::type;

// One kept division of a score: the short one, flagging `bad` where a
// kept lane falls outside its range; or, with kExact, the exact one.
template <bool kExact>
__device__ __forceinline__ Score<kExact> divide(long long num, long long den, float rcp, bool keep,
                                                bool& bad) {
  if (kExact) return keep ? floor_div_exact(num, den) : 0;
  bool ok;
  const int32_t q = short_div(num, den, rcp, ok);
  bad |= keep && !ok;
  return q;
}

__device__ __forceinline__ int range_shift(long long cap) {
  // ops/scores.py:_balanced_range_shift.
  int s = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) s += cap >= (1LL << (26 + 8 * k)) ? 8 : 0;
  return s;
}

// What the resource plugins derive from one column's cpu and mem values.
struct Column {
  long long alloc_cpu, alloc_mem, used_cpu, used_mem;
  long long den_cpu, den_mem;  // clamped capacities (least/most)
  float rcp_cpu, rcp_mem;
  int s_cpu, s_mem;            // balanced: range shifts,
  long long ac, am, total;     // shifted capacities and their product
  float rcp_total;
};

// ops/scores.py:_ratio_score on one cell; 0 unless `cell` (a feasible
// cell of a row that scores it) and the guards pass.
template <bool kExact>
__device__ __forceinline__ Score<kExact> ratio(long long req, long long alloc, long long den,
                                               float rcp, bool least, bool cell, bool& bad) {
  const bool keep = cell && alloc != 0 && req <= alloc;
  const Score<kExact> q =
      divide<kExact>(wmul(least ? wsub(alloc, req) : req, kMaxScore), den, rcp, keep, bad);
  return keep ? q : 0;
}

// Sum of the row's enabled resource plugins on one cell (0 unless `cell`).
// Computed whatever the cell, so that the plugins' divisions carry no
// branch; the guards select.  Sums wrap in int64 as torch's; on the short
// path they cannot leave int32.
template <bool kExact>
__device__ __forceinline__ Score<kExact> resource_score(const Column& k, long long rq_cpu,
                                                        long long rq_mem, bool balanced,
                                                        bool least, bool most, bool cell,
                                                        bool& bad) {
  using S = Score<kExact>;
  const long long req_cpu = wadd(k.used_cpu, rq_cpu);
  const long long req_mem = wadd(k.used_mem, rq_mem);
  S s = 0;
  if (balanced) {
    const bool keep = cell && !(k.alloc_cpu == 0 || k.alloc_mem == 0 ||
                                req_cpu >= k.alloc_cpu || req_mem >= k.alloc_mem);
    const long long rc = req_cpu >> k.s_cpu, rm = req_mem >> k.s_mem;
    long long diff = wsub(wmul(rc, k.am), wmul(rm, k.ac));
    diff = diff < 0 ? wsub(0, diff) : diff;
    const S q =
        divide<kExact>(wmul(kMaxScore, wsub(k.total, diff)), k.total, k.rcp_total, keep, bad);
    s = keep ? q : 0;
  }
  if (least) {
    const S a = ratio<kExact>(req_cpu, k.alloc_cpu, k.den_cpu, k.rcp_cpu, true, cell, bad);
    const S b = ratio<kExact>(req_mem, k.alloc_mem, k.den_mem, k.rcp_mem, true, cell, bad);
    s = S(wadd(s, wadd(a, b) >> 1));
  }
  if (most) {
    const S a = ratio<kExact>(req_cpu, k.alloc_cpu, k.den_cpu, k.rcp_cpu, false, cell, bad);
    const S b = ratio<kExact>(req_mem, k.alloc_mem, k.den_mem, k.rcp_mem, false, cell, bad);
    s = S(wadd(s, wadd(a, b) >> 1));
  }
  return s;
}

// The same, exactly, for the rare cell whose short division fell out of
// range: out of line.
__device__ __noinline__ long long resource_score_exact(const Column& k, long long rq_cpu,
                                                       long long rq_mem, bool balanced, bool least,
                                                       bool most) {
  bool unused = false;
  return resource_score<true>(k, rq_cpu, rq_mem, balanced, least, most, true, unused);
}

// ops/scores.py:normalize on a feasible lane, in the plane's int32
// (products wrap as they do in the torch and JAX versions).
template <bool kExact>
__device__ __forceinline__ int32_t normalize(int32_t v, int32_t row_max, long long den, float rcp,
                                             bool reverse, bool& bad) {
  if (row_max == 0) return reverse ? int32_t(kMaxScore) : v;  // block-uniform
  const int32_t num = int32_t(uint32_t(v) * uint32_t(kMaxScore));
  const int32_t scaled = int32_t(divide<kExact>(num, den, rcp, true, bad));
  return reverse ? int32_t(uint32_t(kMaxScore) - uint32_t(scaled)) : scaled;
}

// Quad loads and stores: four consecutive cells from flat index i, of
// which the first n exist.  `vec`: every row starts 16-byte aligned in
// every plane (C % 4 == 0, aligned bases), so a quad is one access.
// Cells past n load as 0 and are never stored.
__device__ __forceinline__ uint32_t ld_mask4(const uint8_t* __restrict__ p, size_t i, int n,
                                             bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const unsigned int*>(p + i));
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) x |= uint32_t(p[i + j]) << (8 * j);
  return x;
}

__device__ __forceinline__ void ld_i32x4(const int32_t* __restrict__ p, size_t i, int n, bool vec,
                                         int32_t (&v)[4]) {
  if (vec) {
    const int4 t = __ldcs(reinterpret_cast<const int4*>(p + i));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? p[i + j] : 0;
}

// The column planes' quads, through the read-only cache (every block
// reads them).
__device__ __forceinline__ void ld_i64x4(const int64_t* __restrict__ p, size_t i, int n, bool vec,
                                         long long (&v)[4]) {
  if (vec) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + i));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + i) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? __ldg(p + i + j) : 0;
}

template <typename T>
__device__ __forceinline__ void ld_ro32x4(const T* __restrict__ p, size_t i, int n, bool vec,
                                          T (&v)[4]) {
  static_assert(sizeof(T) == 4, "a 4-byte plane");
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    const float w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) memcpy(&v[j], &w[j], 4);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? __ldg(p + i + j) : T(0);
}

__device__ __forceinline__ void st_u8x4(uint8_t* __restrict__ p, size_t i, int n, bool vec,
                                        uint32_t x) {
  if (vec) {
    __stcs(reinterpret_cast<unsigned int*>(p + i), x);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[i + j] = uint8_t(x >> (8 * j));
}

__device__ __forceinline__ void st_reasons4(int32_t* __restrict__ p, size_t i, int n, bool vec,
                                            uint32_t r4) {
  const int32_t v[4] = {int32_t(r4 & 0xff), int32_t((r4 >> 8) & 0xff),
                        int32_t((r4 >> 16) & 0xff), int32_t(r4 >> 24)};
  if (vec) {
    __stcs(reinterpret_cast<int4*>(p + i), make_int4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[i + j] = v[j];
}

__device__ __forceinline__ void st_i64x4(int64_t* __restrict__ p, size_t i, int n, bool vec,
                                         const long long (&v)[4]) {
  if (vec) {
    longlong2* q = reinterpret_cast<longlong2*>(p + i);
    __stcs(q, make_longlong2(v[0], v[1]));
    __stcs(q + 1, make_longlong2(v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) p[i + j] = v[j];
}

__device__ __forceinline__ bool cell(uint32_t quad_flags, int j) {
  return (quad_flags >> (8 * j)) & 1u;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

struct Planes {
  const uint8_t* filter_enabled;  // [B, 5]
  const uint8_t* score_enabled;   // [B, 5]
  const int64_t* request;         // [B, R]
  const uint8_t* placement_has;   // [B]
  const uint8_t* api_ok;          // [B, C] (bool storage: bytes are 0 or 1)
  const uint8_t* taint_ok_new;
  const uint8_t* taint_ok_cur;
  const uint8_t* selector_ok;
  const uint8_t* placement_ok;
  const uint8_t* current_mask;
  const uint8_t* webhook_ok;
  const int32_t* webhook_scores;  // [B, C]
  const int32_t* taint_counts;
  const int32_t* affinity_scores;
  int64_t* cols;                  // the column planes (columns_kernel)
  const uint8_t* cluster_valid;   // [C]
  uint8_t* feasible;              // [B, C]
  int32_t* reasons;
  int64_t* totals;
};

// The column planes: alloc and used [C, R] resource-major, then what the
// resource plugins derive from each column (the balanced score's
// shifted-capacity product, the reciprocals of the clamped capacities
// and of that product, the range shifts), once a call for all blocks.  cols
// [2R + 3, C] int64: alloc [R][C], used [R][C], total [C], then as float
// rcp_cpu [C], rcp_mem [C], rcp_total [C], and as int32 shifts [C]
// (s_cpu | s_mem << 8).
struct ColumnPlanes {
  int64_t *alloc, *used, *total;
  float *rcp_cpu, *rcp_mem, *rcp_total;
  int32_t* shifts;
};

__host__ __device__ inline ColumnPlanes column_planes(int64_t* cols, int C, int R) {
  float* f = reinterpret_cast<float*>(cols + (size_t)(2 * R + 1) * C);
  return ColumnPlanes{cols, cols + (size_t)R * C, cols + (size_t)2 * R * C,
                      f, f + C, f + 2 * (size_t)C, reinterpret_cast<int32_t*>(f + 3 * (size_t)C)};
}

__global__ void columns_kernel(const int64_t* __restrict__ alloc, const int64_t* __restrict__ used,
                               int64_t* __restrict__ cols, int C, int R) {
  // Let phase1_kernel's blocks start now; they wait for this grid to
  // finish before they read what it writes.
  asm volatile("griddepcontrol.launch_dependents;");
  const ColumnPlanes k = column_planes(cols, C, R);
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C; c += gridDim.x * blockDim.x) {
    for (int r = 0; r < R; ++r) {
      k.alloc[(size_t)r * C + c] = alloc[(size_t)c * R + r];
      k.used[(size_t)r * C + c] = used[(size_t)c * R + r];
    }
    const long long a_cpu = alloc[(size_t)c * R + kCpu], a_mem = alloc[(size_t)c * R + kMem];
    const int s_cpu = range_shift(a_cpu), s_mem = range_shift(a_mem);
    const long long t = wmul(a_cpu >> s_cpu, a_mem >> s_mem);
    k.total[c] = t < 1 ? 1 : t;
    k.rcp_cpu[c] = div_rcp(a_cpu < 1 ? 1 : a_cpu);
    k.rcp_mem[c] = div_rcp(a_mem < 1 ? 1 : a_mem);
    k.rcp_total[c] = div_rcp(t < 1 ? 1 : t);
    k.shifts[c] = s_cpu | s_mem << 8;
  }
}

// One column of a quad, from the quad's loaded column values.
__device__ __forceinline__ Column quad_column(const long long (&ac)[4], const long long (&am)[4],
                                              const long long (&uc)[4], const long long (&um)[4],
                                              const float (&rc)[4], const float (&rm)[4],
                                              const long long (&tot)[4], const float (&rt)[4],
                                              const int32_t (&sh)[4], int j) {
  Column k;
  k.alloc_cpu = ac[j];
  k.alloc_mem = am[j];
  k.used_cpu = uc[j];
  k.used_mem = um[j];
  k.den_cpu = ac[j] < 1 ? 1 : ac[j];
  k.den_mem = am[j] < 1 ? 1 : am[j];
  k.rcp_cpu = rc[j];
  k.rcp_mem = rm[j];
  k.s_cpu = sh[j] & 0xff;
  k.s_mem = sh[j] >> 8;
  k.ac = ac[j] >> k.s_cpu;
  k.am = am[j] >> k.s_mem;
  k.total = tot[j];
  k.rcp_total = rt[j];
  return k;
}

// Per-row flags, block-uniform, one word a row.
constexpr uint32_t kPresent = 1u << 0, kRowFit = 1u << 1, kRowPlacement = 1u << 2,
                   kRowApi = 1u << 3, kRowTaintFilter = 1u << 4, kRowSelector = 1u << 5,
                   kRowTaint = 1u << 6, kRowAffinity = 1u << 7, kRowBalanced = 1u << 8,
                   kRowLeast = 1u << 9, kRowMost = 1u << 10;
constexpr uint32_t kRowResources = kRowBalanced | kRowLeast | kRowMost;
constexpr uint32_t kRowNorm = kRowTaint | kRowAffinity;

// kRows rows per block; kShared: keep pass 2's state in shared memory
// (else in the totals output, with the score planes read again); kVec:
// every quad is one aligned access (C % 4 == 0, 16-byte aligned planes).
template <int kRows, bool kShared, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kRows == 1 ? 2 : 1)
    phase1_kernel(const Planes p, int B, int C, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_flags[kRows];
  __shared__ int32_t red[kMaxWarps][2 * kRows];
  __shared__ int32_t row_max[2 * kRows];  // [i]: taint, [kRows + i]: affinity

  const int quads = (C + 3) / 4;
  int64_t* req = reinterpret_cast<int64_t*>(smem);  // [kRows][R]
  const size_t req_bytes = ((size_t)kRows * R * sizeof(int64_t) + 15) & ~size_t(15);
  // Pass 2's state, [row][cell of the quad][quad] so a warp's accesses are
  // consecutive: partial totals, taint and affinity values; then the
  // quads' feasibility words.
  int64_t* s_part = reinterpret_cast<int64_t*>(smem + req_bytes);
  int32_t* s_taint = reinterpret_cast<int32_t*>(s_part + (size_t)kRows * 4 * quads);
  int32_t* s_aff = s_taint + (size_t)kRows * 4 * quads;
  uint32_t* s_feas = reinterpret_cast<uint32_t*>(s_aff + (size_t)kRows * 4 * quads);

  const int row0 = blockIdx.x * kRows;
  for (int k = threadIdx.x; k < kRows * R; k += blockDim.x) {
    const int i = k / R, r = k % R;
    req[k] = row0 + i < B ? p.request[(size_t)(row0 + i) * R + r] : 0;
  }
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    uint32_t f = 0;
    if (row < B) {
      const uint8_t* fe = p.filter_enabled + row * kPlugins;
      const uint8_t* se = p.score_enabled + row * kPlugins;
      bool no_request = true;
      for (int r = 0; r < R; ++r) no_request &= p.request[(size_t)row * R + r] <= 0;
      f = kPresent | (fe[kApi] ? kRowApi : 0) | (fe[kTaintFilter] ? kRowTaintFilter : 0) |
          (fe[kFit] && !no_request ? kRowFit : 0) |
          (fe[kPlacement] && p.placement_has[row] ? kRowPlacement : 0) |
          (fe[kSelector] ? kRowSelector : 0) | (se[kTaint] ? kRowTaint : 0) |
          (se[kAffinity] ? kRowAffinity : 0) | (se[kBalanced] ? kRowBalanced : 0) |
          (se[kLeast] ? kRowLeast : 0) | (se[kMost] ? kRowMost : 0);
    }
    s_flags[threadIdx.x] = f;
  }
  __syncthreads();

  // Registers from here on: the flags, and the cpu/mem requests.
  uint32_t rf[kRows], any = 0;
  long long rq_cpu[kRows], rq_mem[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    rf[i] = s_flags[i];
    any |= rf[i];
    rq_cpu[i] = req[i * R + kCpu];
    rq_mem[i] = req[i * R + kMem];
  }
  const bool any_ratio = any & (kRowLeast | kRowMost), any_balanced = any & kRowBalanced;
  const ColumnPlanes cp = column_planes(p.cols, C, R);

  int32_t tmax[kRows], amax[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) tmax[i] = amax[i] = INT32_MIN;  // identity

  // The column planes are columns_kernel's output.
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // Pass 1.
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int c0 = 4 * q;
    const int n = C - c0 < 4 ? C - c0 : 4;

    // Every load that does not wait on feasibility is issued here, so that
    // they are in flight together: the quad's cpu and mem column values
    // (for the fit test and the resource plugins), then each row's masks
    // and webhook scores.  A disabled filter's plane is not read and
    // passes.
    long long ac[4] = {0, 0, 0, 0}, am[4] = {0, 0, 0, 0};
    long long uc[4] = {0, 0, 0, 0}, um[4] = {0, 0, 0, 0};
    if (any & (kRowFit | kRowResources)) {
      ld_i64x4(cp.alloc, (size_t)kCpu * C + c0, n, kVec, ac);
      ld_i64x4(cp.alloc, (size_t)kMem * C + c0, n, kVec, am);
      ld_i64x4(cp.used, (size_t)kCpu * C + c0, n, kVec, uc);
      ld_i64x4(cp.used, (size_t)kMem * C + c0, n, kVec, um);
    }
    uint32_t wok[kRows], api[kRows], cur[kRows], t_new[kRows], sel[kRows], plc[kRows];
    int32_t wh[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const size_t base = (size_t)(row0 + i) * C + c0;
      wok[i] = api[i] = t_new[i] = sel[i] = plc[i] = kOnes;
      cur[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) wh[i][j] = 0;
      if (!(rf[i] & kPresent)) continue;
      wok[i] = ld_mask4(p.webhook_ok, base, n, kVec);
      ld_i32x4(p.webhook_scores, base, n, kVec, wh[i]);
      if (rf[i] & kRowApi) api[i] = ld_mask4(p.api_ok, base, n, kVec);
      if (rf[i] & kRowTaintFilter) {
        cur[i] = ld_mask4(p.current_mask, base, n, kVec);
        t_new[i] = ld_mask4(p.taint_ok_new, base, n, kVec);
      }
      if (rf[i] & kRowPlacement) plc[i] = ld_mask4(p.placement_ok, base, n, kVec);
      if (rf[i] & kRowSelector) sel[i] = ld_mask4(p.selector_ok, base, n, kVec);
    }
    const uint32_t valid4 = ld_mask4(p.cluster_valid, c0, n, kVec);

    // Fit: each column's alloc/used once, for every row that checks it.
    uint32_t fit_fail[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) fit_fail[i] = 0;
    if (any & kRowFit) {
      for (int r = 0; r < R; ++r) {
        bool need = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          need |= (rf[i] & kRowFit) && (r < kFixedResources || req[i * R + r] > 0);
        if (!need) continue;
        long long a[4], u[4];
        if (r < kFixedResources) {  // cpu and mem: already loaded
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j] = r == kCpu ? ac[j] : am[j];
            u[j] = r == kCpu ? uc[j] : um[j];
          }
        } else {
          ld_i64x4(cp.alloc, (size_t)r * C + c0, n, kVec, a);
          ld_i64x4(cp.used, (size_t)r * C + c0, n, kVec, u);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const long long rq = req[i * R + r];
          if (!((rf[i] & kRowFit) && (r < kFixedResources || rq > 0))) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            fit_fail[i] |= (a[j] >= wadd(rq, u[j]) ? 0u : 1u) << (8 * j);
        }
      }
    }

    // Reason bits and feasibility, four cells to a word.
    uint32_t feas4[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      feas4[i] = 0;
      if (!(rf[i] & kPresent)) continue;
      const size_t base = (size_t)(row0 + i) * C + c0;
      uint32_t r4 = ((wok[i] ^ kOnes) << kReasonWebhookFilter) |
                    ((valid4 ^ kOnes) << kReasonClusterInvalid) | ((api[i] ^ kOnes) << kApi) |
                    ((plc[i] ^ kOnes) << kPlacement) | ((sel[i] ^ kOnes) << kSelector) |
                    (fit_fail[i] << kFit);
      if (rf[i] & kRowTaintFilter) {
        // The current-cluster plane only where a cell of the quad is current.
        const uint32_t t_cur = cur[i] != 0 ? ld_mask4(p.taint_ok_cur, base, n, kVec) : 0;
        r4 |= (((cur[i] & t_cur) | ((cur[i] ^ kOnes) & t_new[i])) ^ kOnes) << kTaintFilter;
      }
      // Every reason byte is below 0x80: adding 0x7f sets its top bit iff
      // it is nonzero.
      feas4[i] = (((r4 + 0x7f7f7f7fu) & 0x80808080u) ^ 0x80808080u) >> 7;
      st_u8x4(p.feasible, base, n, kVec, feas4[i]);
      st_reasons4(p.reasons, base, n, kVec, r4);
    }

    // Resource plugins: the quad's cpu/mem values, and what the plugins
    // derive from each column, once for every row that scores the cell.
    long long part[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0;
    bool score_any = false;
#pragma unroll
    for (int i = 0; i < kRows; ++i) score_any |= (rf[i] & kRowResources) && feas4[i] != 0;
    if (score_any) {
      long long tot[4] = {1, 1, 1, 1};
      float rc[4] = {}, rm[4] = {}, rt[4] = {};
      int32_t sh[4] = {};
      if (any_ratio) {
        ld_ro32x4(cp.rcp_cpu, c0, n, kVec, rc);
        ld_ro32x4(cp.rcp_mem, c0, n, kVec, rm);
      }
      if (any_balanced) {
        ld_i64x4(cp.total, c0, n, kVec, tot);
        ld_ro32x4(cp.rcp_total, c0, n, kVec, rt);
        ld_ro32x4(cp.shifts, c0, n, kVec, sh);
      }
      bool bad = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Column k = quad_column(ac, am, uc, um, rc, rm, tot, rt, sh, j);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (rf[i] & kRowResources)
            part[i][j] = resource_score<false>(k, rq_cpu[i], rq_mem[i], rf[i] & kRowBalanced,
                                               rf[i] & kRowLeast, rf[i] & kRowMost,
                                               cell(feas4[i], j), bad);
      }
      if (bad) {  // rare: a kept quotient past the short division's range
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Column k = quad_column(ac, am, uc, um, rc, rm, tot, rt, sh, j);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            if ((rf[i] & kRowResources) && cell(feas4[i], j))
              part[i][j] = resource_score_exact(k, rq_cpu[i], rq_mem[i], rf[i] & kRowBalanced,
                                                rf[i] & kRowLeast, rf[i] & kRowMost);
        }
      }
    }

    // The normalised score planes of quads with a feasible cell, loaded
    // once the resource plugins' registers are free.
    int32_t vt[kRows][4], va[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) vt[i][j] = va[i][j] = 0;
      if (feas4[i] == 0) continue;
      const size_t base = (size_t)(row0 + i) * C + c0;
      if (rf[i] & kRowTaint) ld_i32x4(p.taint_counts, base, n, kVec, vt[i]);
      if (rf[i] & kRowAffinity) ld_i32x4(p.affinity_scores, base, n, kVec, va[i]);
    }

    // Webhook scores; then totals, or pass 2's state and the maxima.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!(rf[i] & kPresent)) continue;
      const size_t base = (size_t)(row0 + i) * C + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cell(feas4[i], j)) part[i][j] = wadd(part[i][j], wh[i][j]);
      if (!(rf[i] & kRowNorm)) {
        st_i64x4(p.totals, base, n, kVec, part[i]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n) break;
        const bool f = cell(feas4[i], j);
        const int32_t mt = f ? vt[i][j] : 0, ma = f ? va[i][j] : 0;
        tmax[i] = mt > tmax[i] ? mt : tmax[i];
        amax[i] = ma > amax[i] ? ma : amax[i];
      }
      if (kShared) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t s = (size_t)(i * 4 + j) * quads + q;
          s_part[s] = part[i][j];
          if (rf[i] & kRowTaint) s_taint[s] = vt[i][j];
          if (rf[i] & kRowAffinity) s_aff[s] = va[i][j];
        }
        s_feas[(size_t)i * quads + q] = feas4[i];
      } else {
        st_i64x4(p.totals, base, n, kVec, part[i]);
      }
    }
  }
  if (!(any & kRowNorm)) return;  // block-uniform

  // The rows' maxima over their C >= 1 masked values.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = (blockDim.x + 31) / 32;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    tmax[i] = warp_max(tmax[i]);
    amax[i] = warp_max(amax[i]);
    if (lane == 0) {
      red[warp][i] = tmax[i];
      red[warp][kRows + i] = amax[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kRows) {
    int32_t m = red[0][threadIdx.x];
    for (int k = 1; k < warps; ++k) m = red[k][threadIdx.x] > m ? red[k][threadIdx.x] : m;
    row_max[threadIdx.x] = m;
  }
  __syncthreads();

  // Pass 2: the normalised terms, on rows that normalise.
  int32_t t_max[kRows], a_max[kRows];
  long long t_den[kRows], a_den[kRows];
  float t_rcp[kRows], a_rcp[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    t_max[i] = row_max[i];
    a_max[i] = row_max[kRows + i];
    t_den[i] = t_max[i] < 1 ? 1 : t_max[i];
    a_den[i] = a_max[i] < 1 ? 1 : a_max[i];
    t_rcp[i] = div_rcp(t_den[i]);
    a_rcp[i] = div_rcp(a_den[i]);
  }
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const int c0 = 4 * q;
    const int n = C - c0 < 4 ? C - c0 : 4;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!(rf[i] & kRowNorm)) continue;
      const size_t base = (size_t)(row0 + i) * C + c0;
      long long tot[4] = {0, 0, 0, 0};
      uint32_t f4;
      long long part[4];
      int32_t vt[4] = {0, 0, 0, 0}, va[4] = {0, 0, 0, 0};
      if (kShared) {
        f4 = s_feas[(size_t)i * quads + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t s = (size_t)(i * 4 + j) * quads + q;
          part[j] = s_part[s];
          if (rf[i] & kRowTaint) vt[j] = s_taint[s];
          if (rf[i] & kRowAffinity) va[j] = s_aff[s];
        }
      } else {
        // This thread's own stores of pass 1.
        f4 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < n) {
            f4 |= uint32_t(p.feasible[base + j]) << (8 * j);
            part[j] = p.totals[base + j];
          } else {
            part[j] = 0;
          }
        }
        if (f4 != 0) {
          if (rf[i] & kRowTaint) ld_i32x4(p.taint_counts, base, n, kVec, vt);
          if (rf[i] & kRowAffinity) ld_i32x4(p.affinity_scores, base, n, kVec, va);
        }
      }
      if (f4 != 0) {
        bool bad = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool b = false;
          long long t = part[j];
          if (rf[i] & kRowTaint)
            t = wadd(t, normalize<false>(vt[j], t_max[i], t_den[i], t_rcp[i], true, b));
          if (rf[i] & kRowAffinity)
            t = wadd(t, normalize<false>(va[j], a_max[i], a_den[i], a_rcp[i], false, b));
          tot[j] = cell(f4, j) ? t : 0;
          bad |= b && cell(f4, j);
        }
        if (bad) {  // rare: a quotient past the short division's range
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!cell(f4, j)) continue;
            bool b = false;
            long long t = part[j];
            if (rf[i] & kRowTaint)
              t = wadd(t, normalize<true>(vt[j], t_max[i], t_den[i], t_rcp[i], true, b));
            if (rf[i] & kRowAffinity)
              t = wadd(t, normalize<true>(va[j], a_max[i], a_den[i], a_rcp[i], false, b));
            tot[j] = t;
          }
        }
      }
      st_i64x4(p.totals, base, n, kVec, tot);
    }
  }
}

template <int kRows, bool kShared, bool kVec>
cudaError_t launch(const Planes& p, int B, int C, int R, size_t smem, int threads,
                   cudaStream_t stream) {
  auto kernel = phase1_kernel<kRows, kShared, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // Programmatic dependent launch: the blocks start, and read their rows'
  // flags, while columns_kernel finishes; they wait for it before reading
  // the column planes.
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((B + kRows - 1) / kRows);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, p, B, C, R);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

}  // namespace

// Plain C interface (bound with ctypes from ops/phase1.py).  Launches
// columns_kernel and phase1_kernel on `stream` without synchronising;
// returns the first launch error (0 = launched).  The three per-cell
// score planes are int32, as every featurizer emits them; `cols` is the
// caller's int64 scratch of [2R + 3, C] for the column planes.
extern "C" int kt_phase1(
    const void* filter_enabled, const void* score_enabled, const void* request,
    const void* placement_has, const void* api_ok, const void* taint_ok_new,
    const void* taint_ok_cur, const void* selector_ok, const void* placement_ok,
    const void* current_mask, const void* webhook_ok, const void* webhook_scores,
    const void* taint_counts, const void* affinity_scores, const void* alloc, const void* used,
    const void* cluster_valid, void* feasible, void* reasons, void* totals, void* cols, int B,
    int C, int R, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (R < kFixedResources) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int col_blocks = (C + 255) / 256;
  columns_kernel<<<col_blocks, 256, 0, s>>>((const int64_t*)alloc, (const int64_t*)used,
                                            (int64_t*)cols, C, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Planes p{
      (const uint8_t*)filter_enabled, (const uint8_t*)score_enabled, (const int64_t*)request,
      (const uint8_t*)placement_has,  (const uint8_t*)api_ok,        (const uint8_t*)taint_ok_new,
      (const uint8_t*)taint_ok_cur,   (const uint8_t*)selector_ok,   (const uint8_t*)placement_ok,
      (const uint8_t*)current_mask,   (const uint8_t*)webhook_ok,    (const int32_t*)webhook_scores,
      (const int32_t*)taint_counts,   (const int32_t*)affinity_scores, (int64_t*)cols,
      (const uint8_t*)cluster_valid,  (uint8_t*)feasible,            (int32_t*)reasons,
      (int64_t*)totals};
  const void* planes[] = {api_ok, taint_ok_new, taint_ok_cur, selector_ok, placement_ok,
                          current_mask, webhook_ok, webhook_scores, taint_counts,
                          affinity_scores, cluster_valid, cols, feasible, reasons, totals};
  int vec = C % 4 == 0;
  for (const void* x : planes) vec &= aligned16(x);
  // Threads: an even share of the quads, at most kMaxThreads.
  const int quads = (C + 3) / 4;
  const int per_thread = (quads + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((quads + per_thread - 1) / per_thread + 31) / 32 * 32;
  // Dynamic shared memory: the requests, and pass 2's state where it is
  // kept there.  An SM's 227 KB, less each block's static part and the
  // 1 KB the card reserves for it, holds one block or two half as large.
  const size_t max_smem = 232448 - 1024, half_smem = 232448 / 2 - 2048;
  auto requests = [&](int rows) {
    return ((size_t)rows * R * sizeof(int64_t) + 15) & ~size_t(15);
  };
  auto state = [&](int rows) {
    return requests(rows) + (size_t)rows * quads * (4 * (8 + 4 + 4) + 4);
  };
  // Two rows a block while two such blocks fit on an SM; past that, one
  // row: two one-row blocks on an SM, each loading while the other
  // computes or reduces, beat one two-row block (PERF.md, PR 4).
  if (state(2) <= half_smem)
    err = vec ? launch<2, true, true>(p, B, C, R, state(2), threads, s)
              : launch<2, true, false>(p, B, C, R, state(2), threads, s);
  else if (state(1) <= max_smem)
    err = vec ? launch<1, true, true>(p, B, C, R, state(1), threads, s)
              : launch<1, true, false>(p, B, C, R, state(1), threads, s);
  else
    err = vec ? launch<1, false, true>(p, B, C, R, requests(1), threads, s)
              : launch<1, false, false>(p, B, C, R, requests(1), threads, s);
  return (int)err;
}
