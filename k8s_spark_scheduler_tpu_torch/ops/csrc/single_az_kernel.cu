// Whole-FIFO-queue single-AZ gang solve for Hopper.
//
// Replaces the Pallas TPU kernel k8s_spark_scheduler_tpu/ops/pallas_queue.py:
// _singleaz_kernel (with _solve_tightly and _solve_min_frag), reached from
// pallas_solve_queue_single_az.  Same function, same int32 and float32
// semantics.  Per app, in FIFO order, against the carried availability:
//
//   for each zone z in order: the gang solve on the nodes with zone_id == z
//     (tightly-pack fill, or the min-frag drain when kMinFrag), and for a
//     feasible zone its fixed-point score Q = sum over occupied nodes of
//     w * floor(eff * 2^18 + 0.5), w = executors + driver indicator, eff the
//     node's largest of the cpu, memory and gpu reserved ratios computed in
//     float32 (min-frag under strict parity reserves only the driver), and
//     nz = some occupied node reserves a positive amount of a counted
//     dimension;
//   the first feasible zone with nz, then any later feasible zone with a
//     strictly larger Q, is chosen; `uncertain` marks an app where a later
//     feasible zone's Q differs from the best so far by at most 2(k+1)+2;
//   kAzAware: no zone chosen -> the tightly-pack solve over all nodes, zone
//     index n_zones;
//   valid apps with a placement subtract one executor on each node with an
//     executor, else the driver on its node.  `uncertain` is reported for
//     every app, valid or not, as the reference does.
//
// Exactness of the score.  The float32 ratios must round exactly as the
// reference's: every product, sum and quotient is an IEEE round-to-nearest
// intrinsic (__fmul_rn, __fsub_rn, __fadd_rn, __fdiv_rn), which nvcc never
// contracts into a fused multiply-add, and integers convert with
// __int2float_rn.
//
// Design.  As queue_kernel.cu: one block of 1024 threads walks the queue.
// The zones are disjoint, so the per-node work plane holds, for each node,
// its own zone's capacities and then executor counts: after the zone loop
// the chosen zone's placement is still there, and the cross-zone solve runs
// only when no zone was chosen.  The carry, work plane, ranks and exec_ok
// take 21 bytes a node of shared memory while they fit, planar global
// scratch above that.  Int8 zone ids take one more byte a node there
// (225,280 bytes in all at the 10,240-node bucket); when they do not fit
// beside the nodes, or there are more zones than int8 holds, a second
// instantiation reads the int32 ids in place from global memory.  The
// schedulable columns are read from global memory for occupied nodes only.
//
// Bound.  Per app and zone: 4 block reductions in sequence for tightly-pack
// (gang core 2, fill scan, score), some 39 for the min-frag drain (its 31
// probes), each a few barriers on one SM; the kernel is bound by that serial
// chain.

#include "gang_common.cuh"

namespace {

using namespace gang;

// the most zones whose ids the kernel keeps as int8 in shared memory
constexpr int kMaxInt8Zones = 127;

struct Schedulable {
  const int* s_cpu;      // [N] schedulable cpu, base milli units
  const int* s_gpu;      // [N] schedulable gpu, base milli units
  const float* inv_mem;  // [N] scale_mem / schedulable memory bytes
  const int* th_mem;     // [N] ceil(schedulable memory bytes / scale_mem)
  int scale_cpu, scale_gpu;
};

// The zone's fixed-point score and nonzero indicator (batch_solver.
// _zone_score) for the placement in `work` with the driver on didx;
// driver_only: the efficiency numerators reserve only the driver (min-frag
// under strict parity), while the occurrences still weight every executor.
template <typename In>
__device__ int2 zone_score(const Nodes& s, const App& a, int didx, In in, const Schedulable& sc,
                           bool driver_only, const Red& red) {
  int q_sum = 0, nonzero = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const bool drv = i == didx;
    const int x = s.work[i];
    const int w = x + drv;
    if (w <= 0) continue;
    const int res = driver_only ? 0 : x;
    const int m_c = s.cpu[i] - (res * a.ec + (drv ? a.dc : 0));
    const int m_m = s.mem[i] - (res * a.em + (drv ? a.dm : 0));
    const int m_g = s.gpu[i] - (res * a.eg + (drv ? a.dg : 0));
    const int s_cpu = sc.s_cpu[i], s_gpu = sc.s_gpu[i];
    const int num_cq = s_cpu - m_c * sc.scale_cpu;
    const int num_gq = s_gpu - m_g * sc.scale_gpu;
    const bool has_gpu = s_gpu > 0;
    // value() semantics: ceil to whole cores, truncating like lax.div
    const int num_cores = (num_cq + 999) / 1000;
    const int num_gcores = (num_gq + 999) / 1000;
    const int den_cores = max((s_cpu + 999) / 1000, 1);
    const int den_gcores = max((s_gpu + 999) / 1000, 1);
    const float ratio_c = __fdiv_rn(__int2float_rn(num_cores), __int2float_rn(den_cores));
    const float ratio_g =
        has_gpu ? __fdiv_rn(__int2float_rn(num_gcores), __int2float_rn(den_gcores)) : 0.0f;
    const float ratio_m =
        fmaxf(__fsub_rn(1.0f, __fmul_rn(__int2float_rn(m_m), sc.inv_mem[i])), 0.0f);
    const float eff = fmaxf(fmaxf(ratio_c, ratio_m), ratio_g);
    const int q = static_cast<int>(floorf(__fadd_rn(__fmul_rn(eff, 262144.0f), 0.5f)));
    q_sum += w * q;
    nonzero += num_cq > 0 || m_m < sc.th_mem[i] || (has_gpu && num_gq > 0);
  }
  return block_sum2(make_int2(q_sum, nonzero), red);
}

// kInt8Zones: the zone ids are staged as int8 in shared memory (the nodes
// fit there and n_zones <= kMaxInt8Zones), else read as int32 in place.
template <bool kMinFrag, bool kAzAware, bool kInt8Zones>
__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_single_az_kernel(const int* __restrict__ avail_in,      // [N, 3]
                            const int* __restrict__ rank_in,       // [N]
                            const uint8_t* __restrict__ ok_in,     // [N]
                            const int* __restrict__ zone_in,       // [N], -1 = no zone
                            const int* __restrict__ drivers,       // [A, 3]
                            const int* __restrict__ executors,     // [A, 3]
                            const int* __restrict__ counts,        // [A]
                            const uint8_t* __restrict__ valid,     // [A]
                            Schedulable sc, int n, int n_apps, int n_zones, int strict,
                            uint8_t* __restrict__ feasible_out,    // [A]
                            int* __restrict__ zone_idx_out,        // [A]
                            int* __restrict__ driver_idx_out,      // [A]
                            uint8_t* __restrict__ uncertain_out,   // [A]
                            int* __restrict__ avail_out,           // [N, 3]
                            int* __restrict__ scratch,             // [4N] when not in shared memory
                            int in_shared) {
  static_assert(!(kMinFrag && kAzAware), "the az-aware fallback has no min-frag variant");
  extern __shared__ int4 smem_raw[];
  __shared__ int red_i[kWarps];
  __shared__ int2 red_i2[kWarps];
  __shared__ unsigned long long red_u[kWarps];
  const Red red{red_i, red_i2, red_u};

  Nodes s;
  uint8_t* rest = init_nodes(&s, reinterpret_cast<int*>(smem_raw), scratch, in_shared, avail_in,
                             rank_in, ok_in, n);
  const auto all = [](int) { return true; };

  // The queue walk over the zone ids `zone` (int8 in shared memory or
  // int32 in global memory); an id outside [0, n_zones) matches no zone.
  const auto walk = [&](const auto* zone) {
    for (int a = 0; a < n_apps; ++a) {
      const App app = load_app(drivers, executors, counts, a);
      const bool app_valid = valid[a] != 0;
      const int band = 2 * (app.k + 1) + 2;
      int best_q = 0, best_zone = -1, best_didx = n;
      bool uncertain = false;
      for (int z = 0; z < n_zones; ++z) {
        const auto in_zone = [&](int i) { return zone[i] == z; };
        const int didx = gang_core(s, app, in_zone, red);
        if (didx == n) continue;
        if constexpr (kMinFrag) {
          min_frag_drain(s, app, didx, in_zone, red);
        } else {
          tightly_fill(s, app, in_zone, red);
        }
        const int2 score = zone_score(s, app, didx, in_zone, sc, kMinFrag && strict, red);
        const bool first = best_zone < 0;
        if (!first && score.x != best_q && abs(score.x - best_q) <= band) uncertain = true;
        if (first ? score.y > 0 : score.x > best_q) {
          best_q = score.x;
          best_zone = z;
          best_didx = didx;
        }
      }
      bool cross = false;
      if constexpr (kAzAware) {
        if (app_valid && best_zone < 0) {
          const int didx = gang_core(s, app, all, red);
          if (didx < n) {
            tightly_fill(s, app, all, red);
            cross = true;
            best_zone = n_zones;
            best_didx = didx;
          }
        }
      }
      const bool placed = app_valid && best_zone >= 0;
      if (threadIdx.x == 0) {
        feasible_out[a] = placed ? 1 : 0;
        zone_idx_out[a] = placed ? best_zone : -1;
        driver_idx_out[a] = placed ? best_didx : n;
        uncertain_out[a] = uncertain ? 1 : 0;
      }
      if (placed) {
        subtract_usage(s, app, best_didx,
                       [&](int i) { return (cross || zone[i] == best_zone) && s.work[i] > 0; });
      }
    }
  };

  if constexpr (kInt8Zones) {
    int8_t* zone_s = reinterpret_cast<int8_t*>(rest);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int z = zone_in[i];
      zone_s[i] = z >= 0 && z < n_zones ? static_cast<int8_t>(z) : -1;
    }
    __syncthreads();
    walk(static_cast<const int8_t*>(zone_s));
  } else {
    walk(zone_in);
  }
  store_avail(s, avail_out);
}

using Kernel = void (*)(const int*, const int*, const uint8_t*, const int*, const int*,
                        const int*, const int*, const uint8_t*, Schedulable, int, int, int, int,
                        uint8_t*, int*, int*, uint8_t*, int*, int*, int);

// [variant][int8 zone ids]; variant 0 tightly, 1 az-aware, 2 min-frag
// (az-aware min-frag does not exist in the reference)
const Kernel kKernels[3][2] = {
    {fifo_queue_single_az_kernel<false, false, false>, fifo_queue_single_az_kernel<false, false, true>},
    {fifo_queue_single_az_kernel<false, true, false>, fifo_queue_single_az_kernel<false, true, true>},
    {fifo_queue_single_az_kernel<true, false, false>, fifo_queue_single_az_kernel<true, false, true>},
};

SharedLimit g_limit[3][2];

// Dynamic shared memory the kernel kKernels[variant][int8_zones] takes for
// n nodes, 0 when they do not fit, or a negated CUDA error code.
long long shared_bytes_of(int n, int variant, bool int8_zones) {
  long long limit = 0;
  cudaError_t err = g_limit[variant][int8_zones].get(
      reinterpret_cast<const void*>(kKernels[variant][int8_zones]), &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long bytes = node_shared_bytes(n, int8_zones ? 1 : 0);
  return n > 0 && bytes <= limit ? bytes : 0;
}

// The kernel for n nodes in n_zones zones: int8 zone ids in shared memory
// when they fit there beside the nodes, else int32 ones read in place.
// Sets *int8_zones and returns its shared bytes as shared_bytes_of does.
long long choose_kernel(int n, int n_zones, int variant, bool* int8_zones) {
  *int8_zones = false;
  if (n_zones <= kMaxInt8Zones) {
    const long long bytes = shared_bytes_of(n, variant, true);
    if (bytes != 0) {
      *int8_zones = bytes > 0;
      return bytes;
    }
  }
  return shared_bytes_of(n, variant, false);
}

}  // namespace

// Dynamic shared memory the kernel's `variant` takes for n nodes in
// n_zones zones on the current device, or 0 when they do not fit and it
// works from global scratch.  A negative value is a CUDA error code,
// negated.
extern "C" long long fifo_queue_single_az_shared_bytes(int n, int n_zones, int variant) {
  if (variant < 0 || variant > 2) return -static_cast<long long>(cudaErrorInvalidValue);
  bool int8_zones = false;
  return choose_kernel(n, n_zones, variant, &int8_zones);
}

// Launches the kernel's `variant` (0 tightly, 1 az-aware, 2 min-frag; `strict`:
// the min-frag scores reserve only the driver) on `stream` on the current
// device; `scratch` ([4N] int32) is needed only when the shared bytes are
// 0.  Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_single_az_launch(
    const int* avail, const int* rank, const uint8_t* exec_ok, const int* zone_id,
    const int* drivers, const int* executors, const int* counts, const uint8_t* valid,
    const int* s_cpu, const int* s_gpu, const float* inv_mem, const int* th_mem, int scale_cpu,
    int scale_gpu, int n, int n_apps, int n_zones, int variant, int strict, uint8_t* feasible_out,
    int* zone_idx_out, int* driver_idx_out, uint8_t* uncertain_out, int* avail_out,
    int* scratch, void* stream) {
  if (variant < 0 || variant > 2) return cudaErrorInvalidValue;
  bool int8_zones = false;
  const long long smem = choose_kernel(n, n_zones, variant, &int8_zones);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0 && scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  const Schedulable sc{s_cpu, s_gpu, inv_mem, th_mem, scale_cpu, scale_gpu};
  kKernels[variant][int8_zones]<<<1, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      avail, rank, exec_ok, zone_id, drivers, executors, counts, valid, sc, n, n_apps, n_zones,
      strict, feasible_out, zone_idx_out, driver_idx_out, uncertain_out, avail_out, scratch,
      smem > 0 ? 1 : 0);
  return cudaGetLastError();
}
