// Phase 1 of the scheduling tick as one hand-written CUDA kernel (sm_90a).
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
// Bound on an H100: bytes and int32-pipe instructions come close.  Each
// cell writes 1 + 4 + 8 bytes and reads the mask bytes of its row's
// enabled filters, the webhook mask, and the int32 score planes only on
// feasible cells of rows that enable the plugin.  The arithmetic is a few
// dozen instructions per cell plus up to seven 64-bit floor divisions on
// feasible cells: about 20 instructions each when both operands fit in 32
// bits, about 100 through the 64-bit routine (memory in bytes does not).
// chip_smoke.py works out both sides from each run's inputs; PERF.md has
// the figures at the main path's chunks.
//
// Design: one block per object row, threads striding over the cluster
// axis so every per-cell plane is read with neighbouring threads on
// neighbouring bytes.  The filter and plugin flags are per row, so every
// branch on them is block-uniform: a disabled filter or plugin reads no
// plane and does no work.  Pass 1 computes the reason bits and
// feasibility, stores feasible and reasons, keeps the row's feasibility
// in shared memory, and block-reduces the two masked maxima that
// normalisation needs before any score can be written.  Pass 2 computes
// the enabled plugins on feasible cells, normalises, adds the webhook
// scores and stores totals.  The shared [C, R] alloc/used planes (~245 KB
// at C = 5120, R = 3) are read from global memory, where L2 keeps them
// resident across rows.  Divisions are exact 64-bit floor divisions
// (C++ '/' truncates toward zero; masked-out lanes may carry negative
// numerators).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlugins = 5;  // filter and score plugin counts
constexpr int kReasonWebhookFilter = 1 << 5;
constexpr int kReasonClusterInvalid = 1 << 6;
constexpr long long kMaxScore = 100;
// ops/filters.py resource columns.
constexpr int kCpu = 0;
constexpr int kMem = 1;
constexpr int kFixedResources = 2;
// ops/scores.py plugin indices.
constexpr int kTaint = 0, kBalanced = 1, kLeast = 2, kAffinity = 3, kMost = 4;

__device__ __forceinline__ long long floor_div(long long num, long long den) {
  // The _floordiv_smallq contract: the divisor is clamped to >= 1.
  den = den < 1 ? 1 : den;
  long long q = num / den;
  return (num % den < 0) ? q - 1 : q;
}

__device__ __forceinline__ int range_shift(long long cap) {
  // ops/scores.py:_balanced_range_shift.
  int s = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) s += cap >= (1LL << (26 + 8 * k)) ? 8 : 0;
  return s;
}

__device__ __forceinline__ long long balanced(long long alloc_cpu, long long alloc_mem,
                                              long long req_cpu, long long req_mem) {
  if (alloc_cpu == 0 || alloc_mem == 0 || req_cpu >= alloc_cpu || req_mem >= alloc_mem)
    return 0;
  const int s_cpu = range_shift(alloc_cpu), s_mem = range_shift(alloc_mem);
  const long long ac = alloc_cpu >> s_cpu, rc = req_cpu >> s_cpu;
  const long long am = alloc_mem >> s_mem, rm = req_mem >> s_mem;
  long long total = ac * am;
  total = total < 1 ? 1 : total;
  long long diff = rc * am - rm * ac;
  diff = diff < 0 ? -diff : diff;
  return floor_div(kMaxScore * (total - diff), total);
}

__device__ __forceinline__ long long ratio(long long req, long long alloc, bool least) {
  if (alloc == 0 || req > alloc) return 0;
  return floor_div((least ? alloc - req : req) * kMaxScore, alloc);
}

// ops/scores.py:normalize on a feasible lane, in the plane's int32
// (products wrap as they do in the torch and JAX versions).
__device__ __forceinline__ int32_t normalize(int32_t v, int32_t row_max, bool reverse) {
  if (row_max == 0) return reverse ? int32_t(kMaxScore) : v;
  const int32_t scaled = int32_t(floor_div(int32_t(kMaxScore * (long long)v), row_max));
  return reverse ? int32_t(kMaxScore - scaled) : scaled;
}

__device__ __forceinline__ int32_t block_max(int32_t v, int32_t* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int32_t m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = scratch[w] > m ? scratch[w] : m;
  __syncthreads();  // scratch may be reused by the caller
  return m;
}

__global__ void __launch_bounds__(kThreads) phase1_kernel(
    const uint8_t* __restrict__ filter_enabled,  // [B, 5]
    const uint8_t* __restrict__ score_enabled,   // [B, 5]
    const int64_t* __restrict__ request,         // [B, R]
    const uint8_t* __restrict__ placement_has,   // [B]
    const uint8_t* __restrict__ api_ok,          // [B, C]
    const uint8_t* __restrict__ taint_ok_new,
    const uint8_t* __restrict__ taint_ok_cur,
    const uint8_t* __restrict__ selector_ok,
    const uint8_t* __restrict__ placement_ok,
    const uint8_t* __restrict__ current_mask,
    const uint8_t* __restrict__ webhook_ok,
    const int32_t* __restrict__ webhook_scores,  // [B, C]
    const int32_t* __restrict__ taint_counts,
    const int32_t* __restrict__ affinity_scores,
    const int64_t* __restrict__ alloc,           // [C, R]
    const int64_t* __restrict__ used,            // [C, R]
    const uint8_t* __restrict__ cluster_valid,   // [C]
    uint8_t* __restrict__ feasible_out,          // [B, C]
    int32_t* __restrict__ reasons_out,
    int64_t* __restrict__ totals_out,
    int C, int R) {
  extern __shared__ int64_t smem[];
  int64_t* req = smem;                                  // [R]
  uint8_t* feas_row = reinterpret_cast<uint8_t*>(smem + R);  // [C]
  __shared__ int32_t scratch[kWarps];

  const int row = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += kThreads) req[r] = request[(size_t)row * R + r];
  bool fe[kPlugins], se[kPlugins];
#pragma unroll
  for (int p = 0; p < kPlugins; ++p) {
    fe[p] = filter_enabled[row * kPlugins + p] != 0;
    se[p] = score_enabled[row * kPlugins + p] != 0;
  }
  const bool has_placement = placement_has[row] != 0;
  __syncthreads();
  bool no_request = true;
  for (int r = 0; r < R; ++r) no_request &= req[r] <= 0;

  const size_t base = (size_t)row * C;
  int32_t taint_max = 0, aff_max = 0;
  bool first = true;

  // Pass 1: fit, reason bits, feasibility; masked maxima for normalisation.
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const size_t i = base + c;
    // Each plane is read only where its filter needs it (the flags are
    // per row, so these branches are block-uniform).
    int reasons = 0;
    if (fe[0] && api_ok[i] == 0) reasons |= 1;
    if (fe[1] && (current_mask[i] ? taint_ok_cur[i] : taint_ok_new[i]) == 0) reasons |= 2;
    if (fe[2] && !no_request) {
      bool fit = true;
      for (int r = 0; r < R; ++r) {
        const bool free_ok = alloc[(size_t)c * R + r] >= req[r] + used[(size_t)c * R + r];
        if (r < kFixedResources || req[r] > 0) fit &= free_ok;
      }
      if (!fit) reasons |= 4;
    }
    if (fe[3] && has_placement && placement_ok[i] == 0) reasons |= 8;
    if (fe[4] && selector_ok[i] == 0) reasons |= 16;
    const bool wok = webhook_ok[i] != 0;
    const bool valid = cluster_valid[c] != 0;
    const bool feasible = reasons == 0 && wok && valid;
    reasons |= (wok ? 0 : kReasonWebhookFilter) | (valid ? 0 : kReasonClusterInvalid);
    feasible_out[i] = feasible;
    reasons_out[i] = reasons;
    feas_row[c] = feasible;
    const int32_t tv = (se[kTaint] && feasible) ? taint_counts[i] : 0;
    const int32_t av = (se[kAffinity] && feasible) ? affinity_scores[i] : 0;
    taint_max = (first || tv > taint_max) ? tv : taint_max;
    aff_max = (first || av > aff_max) ? av : aff_max;
    first = false;
  }
  // Threads without a column hold INT32_MIN, so the block maximum is the
  // row's maximum over its C >= 1 masked values.
  if (first) {
    taint_max = INT32_MIN;
    aff_max = INT32_MIN;
  }
  if (se[kTaint]) taint_max = block_max(taint_max, scratch);
  if (se[kAffinity]) aff_max = block_max(aff_max, scratch);
  __syncthreads();  // feas_row complete

  // Pass 2: enabled plugins, normalisation, webhook scores, totals.
  const bool resource_scores = se[kBalanced] || se[kLeast] || se[kMost];
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const size_t i = base + c;
    long long total = 0;
    if (feas_row[c]) {
      if (se[kTaint]) total += normalize(taint_counts[i], taint_max, true);
      if (se[kAffinity]) total += normalize(affinity_scores[i], aff_max, false);
      if (resource_scores) {
        const long long alloc_cpu = alloc[(size_t)c * R + kCpu];
        const long long alloc_mem = alloc[(size_t)c * R + kMem];
        const long long req_cpu = used[(size_t)c * R + kCpu] + req[kCpu];
        const long long req_mem = used[(size_t)c * R + kMem] + req[kMem];
        if (se[kBalanced]) total += balanced(alloc_cpu, alloc_mem, req_cpu, req_mem);
        if (se[kLeast])
          total += floor_div(ratio(req_cpu, alloc_cpu, true) + ratio(req_mem, alloc_mem, true), 2);
        if (se[kMost])
          total += floor_div(ratio(req_cpu, alloc_cpu, false) + ratio(req_mem, alloc_mem, false), 2);
      }
      total += (long long)webhook_scores[i];
    }
    totals_out[i] = total;
  }
}

}  // namespace

// Plain C interface (bound with ctypes from ops/phase1.py).  Launches on
// `stream` without synchronising; returns cudaGetLastError() after the
// launch (0 = launched).  The three per-cell score planes are int32, as
// every featurizer emits them.
extern "C" int kt_phase1(
    const void* filter_enabled, const void* score_enabled, const void* request,
    const void* placement_has, const void* api_ok, const void* taint_ok_new,
    const void* taint_ok_cur, const void* selector_ok, const void* placement_ok,
    const void* current_mask, const void* webhook_ok, const void* webhook_scores,
    const void* taint_counts, const void* affinity_scores, const void* alloc, const void* used,
    const void* cluster_valid, void* feasible, void* reasons, void* totals, int B, int C, int R,
    void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (R < kFixedResources) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * sizeof(int64_t) + (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        phase1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  phase1_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)filter_enabled, (const uint8_t*)score_enabled, (const int64_t*)request,
      (const uint8_t*)placement_has, (const uint8_t*)api_ok, (const uint8_t*)taint_ok_new,
      (const uint8_t*)taint_ok_cur, (const uint8_t*)selector_ok, (const uint8_t*)placement_ok,
      (const uint8_t*)current_mask, (const uint8_t*)webhook_ok, (const int32_t*)webhook_scores,
      (const int32_t*)taint_counts, (const int32_t*)affinity_scores, (const int64_t*)alloc,
      (const int64_t*)used, (const uint8_t*)cluster_valid, (uint8_t*)feasible,
      (int32_t*)reasons, (int64_t*)totals, C, R);
  return (int)cudaGetLastError();
}
