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
// Bound.  The apps depend on each other through the carry, so the kernel is
// a serial chain of per-app steps.  The zones of one app are disjoint and
// independent until the zone choice, and only the chosen zone's nodes
// change the carry; solving them one after another in one block, each over
// every node with a zone predicate, cost Z times the walks and Z zones'
// reduction chains in sequence (12 reductions an app for tightly-pack at 3
// zones, about 115 for min-frag).  With one zone a block, as below, an app
// costs its largest block's chain: per zone 4 block reductions and 5 walks
// (tightly-pack; min-frag 6 and 7 when the pass's largest capacity reaches
// k), then one cluster barrier.  At the main path's 3,400 nodes a zone, the
// walks over a thread's 6.7 nodes and the reductions take about half the
// time each (PERF.md: the kernel at 1,024 nodes).

// Design.  The wrapper (single_az_kernel.zone_layout) orders the nodes
// zone-major, stable within a zone (zone 0's nodes in node order, then zone
// 1's, ..., then the nodes of no zone), and gives each block of a cluster of
// C = min(max(zones, 1), 8) blocks a contiguous run of zones, balanced by
// node count; the last block also holds the nodes of no zone.  A block
// keeps its segment (carry, work plane, ranks, exec_ok: 21 bytes a node) in
// shared memory while it fits, else in planar global scratch.  Per app:
//   1. each block solves its own zones on its own segment, one after
//      another, each zone's range split over the block's threads (gang
//      core, fill or the short min-frag drain of gang_common.cuh, score:
//      4 block reductions for tightly-pack, 6 for min-frag when the pass's
//      largest capacity reaches k);
//   2. it writes each zone's result (driver position and input index, Q,
//      nz) into every block's zone table through distributed shared memory
//      (global memory above 3,600 zones), double-buffered by app parity, so
//      one cluster barrier an app orders them;
//   3. every thread applies the zone-order choice and the `uncertain` band
//      to the same table and gets the same answer;
//   4. only the block that owns the chosen zone subtracts usage.
// The permutation is stable within a zone, so the fill's prefix, the
// drain's "first t* in node order" and every tie still see node order;
// results carry the input node index.
//
// The az-aware cross-zone solve runs only for a valid app that no zone
// takes.  It walks every block's whole segment (the nodes of no zone
// included) with cluster reductions, keys the driver by input index, and
// forms the fill's prefix in input order: the blocks publish capacities in
// input order to global memory, and each block scans them all and keeps
// its own nodes' fills.

#include "gang_common.cuh"

namespace {

using namespace gang;

struct Schedulable {
  const int* s_cpu;      // [N] schedulable cpu, base milli units
  const int* s_gpu;      // [N] schedulable gpu, base milli units
  const float* inv_mem;  // [N] scale_mem / schedulable memory bytes
  const int* th_mem;     // [N] ceil(schedulable memory bytes / scale_mem)
  int scale_cpu, scale_gpu;
};

// The zone's fixed-point score and nonzero indicator (batch_solver.
// _zone_score) for the placement in `work` over this thread's chunk, the
// driver on local node `driver`; input(i) is local node i's input index;
// driver_only: the efficiency numerators reserve only the driver (min-frag
// under strict parity), while the occurrences still weight every executor.
template <class R, class Input>
__device__ int2 zone_score(const Nodes& s, const App& a, int driver, Input input,
                           const Schedulable& sc, bool driver_only, const R& red) {
  int q_sum = 0, nonzero = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    const bool drv = i == driver;
    const int x = s.work[i];
    const int w = x + drv;
    if (w <= 0) continue;
    const int o = input(i);
    const int res = driver_only ? 0 : x;
    const int m_c = s.cpu[i] - (res * a.ec + (drv ? a.dc : 0));
    const int m_m = s.mem[i] - (res * a.em + (drv ? a.dm : 0));
    const int m_g = s.gpu[i] - (res * a.eg + (drv ? a.dg : 0));
    const int s_cpu = sc.s_cpu[o], s_gpu = sc.s_gpu[o];
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
        fmaxf(__fsub_rn(1.0f, __fmul_rn(__int2float_rn(m_m), sc.inv_mem[o])), 0.0f);
    const float eff = fmaxf(fmaxf(ratio_c, ratio_m), ratio_g);
    const int q = static_cast<int>(floorf(__fadd_rn(__fmul_rn(eff, 262144.0f), 0.5f)));
    q_sum += w * q;
    nonzero += num_cq > 0 || m_m < sc.th_mem[o] || (has_gpu && num_gq > 0);
  }
  return red.sum2(make_int2(q_sum, nonzero));
}

// 512 threads a block: a zone of the main path (~3,400 nodes) gives 6.7
// nodes a thread, the register cap is 128 (no spills; 1,024 threads cap it
// at 64 and spill), and a block reduction combines 16 warps, not 32.
constexpr int kThreads = 512;

template <bool kMinFrag, bool kAzAware>
__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_single_az_kernel(const int* __restrict__ avail_in,      // [N, 3]
                            const int* __restrict__ rank_in,       // [N]
                            const uint8_t* __restrict__ ok_in,     // [N]
                            const int* __restrict__ perm,          // [N] input node at each position
                            const int* __restrict__ pos_of,        // [N] position of each input node
                            const int* __restrict__ layout,        // zone starts [Z+1], blocks' first zones [C+1]
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
                            int* __restrict__ scratch,             // [5N] int32 + [N] bytes
                            int* __restrict__ cross_caps,          // [N] (az-aware)
                            int4* __restrict__ zone_table_global,  // [2Z], or null: in shared memory
                            int node_capacity) {                   // nodes a block keeps in shared memory
  static_assert(!(kMinFrag && kAzAware), "the az-aware fallback has no min-frag variant");
  extern __shared__ int4 smem_raw[];
  __shared__ typename BlockRed<kThreads>::Storage block_storage;
  __shared__ typename ClusterRed<kThreads>::Storage cluster_storage;
  const BlockRed<kThreads> blk(&block_storage);
  ClusterRed<kThreads> cl(&cluster_storage);
  cg::cluster_group cluster = cg::this_cluster();

  const int* zone_start = layout;
  const int* block_zone = layout + n_zones + 1;
  const int z_lo = block_zone[cl.rank], z_hi = block_zone[cl.rank + 1];
  const int seg_lo = zone_start[z_lo];
  const int seg_hi = cl.rank == cl.size - 1 ? n : zone_start[z_hi];
  const bool global_table = zone_table_global != nullptr;
  int4* table = global_table ? zone_table_global : smem_raw;
  uint8_t* planes = reinterpret_cast<uint8_t*>(global_table ? smem_raw : smem_raw + 2 * n_zones);
  const auto input_of = [&](int j) { return perm[j]; };

  Nodes s;
  init_nodes<kThreads, false>(&s, seg_hi - seg_lo <= node_capacity ? planes : nullptr, scratch,
                              input_of, avail_in, rank_in, ok_in, n, seg_lo, seg_hi - seg_lo);
  cluster.sync();  // every block runs before DSMEM writes
  const bool writer = cl.rank == 0 && threadIdx.x == 0;
  const auto position = [&](int i) { return s.base + i; };
  const auto input = [&](int i) { return perm[s.base + i]; };

  for (int a = 0; a < n_apps; ++a) {
    const App app = load_app(drivers, executors, counts, a);
    const bool app_valid = valid[a] != 0;
    const int band = 2 * (app.k + 1) + 2;
    int4* row = table + (a & 1) * n_zones;

    // 1-2: this block's zones, each result into every block's table
    for (int z = z_lo; z < z_hi; ++z) {
      set_range<kThreads>(&s, zone_start[z] - seg_lo, zone_start[z + 1] - seg_lo);
      const Driver drv = gang_core<kMinFrag>(s, app, blk, position);
      int4 res = make_int4(-1, 0, 0, n);  // driver position, Q, nz, driver input index
      if (drv.idx < n) {
        if constexpr (kMinFrag) {
          min_frag_drain(s, app, blk);
        } else {
          tightly_fill(s, app, blk);
        }
        const int2 score = zone_score(s, app, drv.local, input, sc, kMinFrag && strict, blk);
        res = make_int4(drv.idx, score.x, score.y, 0);
      }
      if (threadIdx.x == 0) {
        if (res.x >= 0) res.w = perm[res.x];
        if (global_table) {
          __stcg(row + z, res);
        } else {
          for (int b = 0; b < cl.size; ++b) *cluster.map_shared_rank(row + z, b) = res;
        }
      }
    }
    cluster.sync();

    // 3: the choice in zone order, the same in every thread
    int best_q = 0, best_zone = -1, best_pos = -1, best_node = n;
    bool uncertain = false;
    for (int z = 0; z < n_zones; ++z) {
      const int4 r = global_table ? __ldcg(row + z) : row[z];
      if (r.x < 0) continue;
      const bool first = best_zone < 0;
      if (!first && r.y != best_q && abs(r.y - best_q) <= band) uncertain = true;
      if (first ? r.z > 0 : r.y > best_q) {
        best_q = r.y;
        best_zone = z;
        best_pos = r.x;
        best_node = r.w;
      }
    }
    bool cross = false;
    int cross_driver = -1;
    if constexpr (kAzAware) {
      if (app_valid && best_zone < 0) {  // uniform across the cluster
        set_range<kThreads>(&s, 0, s.len);
        const Driver drv = gang_core<false>(s, app, cl, input);
        if (drv.idx < n) {
          // the fill's prefix in input order: publish, then every block
          // scans all capacities and keeps its own nodes' fills
          for (int i = s.lo; i < s.hi; ++i) __stcg(cross_caps + perm[s.base + i], s.work[i]);
          cluster.sync();
          const int chunk = (n + kThreads - 1) / kThreads;
          const int olo = min(static_cast<int>(threadIdx.x) * chunk, n);
          const int ohi = min(olo + chunk, n);
          int part = 0;
          for (int j = olo; j < ohi; ++j) part += __ldcg(cross_caps + j);
          int run = blk.exclusive_scan(part);
          for (int j = olo; j < ohi; ++j) {
            const int c = __ldcg(cross_caps + j);
            const int p = pos_of[j] - s.base;
            if (p >= 0 && p < s.len) s.work[p] = min(max(app.k - run, 0), c);
            run += c;
          }
          __syncthreads();
          cross = true;
          cross_driver = drv.local;
          best_zone = n_zones;
          best_node = drv.idx;
        }
      }
    }
    const bool placed = app_valid && best_zone >= 0;
    if (writer) {
      feasible_out[a] = placed ? 1 : 0;
      zone_idx_out[a] = placed ? best_zone : -1;
      driver_idx_out[a] = placed ? best_node : n;
      uncertain_out[a] = uncertain ? 1 : 0;
    }
    // 4: the usage subtraction on the chosen nodes' owners
    if (cross) {
      subtract_usage(s, app, cross_driver);
      __syncthreads();  // the next app's zone walks split the segment otherwise
    } else if (placed && best_zone >= z_lo && best_zone < z_hi) {
      set_range<kThreads>(&s, zone_start[best_zone] - seg_lo, zone_start[best_zone + 1] - seg_lo);
      subtract_usage(s, app, best_pos - s.base);
    }
  }
  store_avail<kThreads>(s, input_of, avail_out);
  cluster.sync();
}

using Kernel = void (*)(const int*, const int*, const uint8_t*, const int*, const int*, const int*,
                        const int*, const int*, const int*, const uint8_t*, Schedulable, int, int,
                        int, int, uint8_t*, int*, int*, uint8_t*, int*, int*, int*, int4*, int);

// by variant: 0 tightly, 1 az-aware, 2 min-frag (az-aware min-frag does not
// exist in the reference)
const Kernel kKernels[3] = {
    fifo_queue_single_az_kernel<false, false>,
    fifo_queue_single_az_kernel<false, true>,
    fifo_queue_single_az_kernel<true, false>,
};

SharedLimit g_limit[3];

}  // namespace

// Launches the kernel's `variant` (0 tightly, 1 az-aware, 2 min-frag;
// `strict`: the min-frag scores reserve only the driver) as one cluster of
// `cluster` blocks (1..8)
// over the zone-major layout of single_az_kernel.zone_layout, on `stream`
// on the current device.  `scratch` is [5N] int32 and [N] bytes,
// `cross_caps` [N] int32, `zone_table` [2 n_zones] int4 (used when the
// table does not fit in shared memory).  Returns the CUDA error code (0 =
// ok); a refused launch returns its error and nothing runs.
extern "C" int fifo_queue_single_az_launch(
    const int* avail, const int* rank, const uint8_t* exec_ok, const int* perm, const int* pos_of,
    const int* layout, const int* drivers, const int* executors, const int* counts,
    const uint8_t* valid, const int* s_cpu, const int* s_gpu, const float* inv_mem,
    const int* th_mem, int scale_cpu, int scale_gpu, int n, int n_apps, int n_zones, int cluster,
    int variant, int strict, uint8_t* feasible_out, int* zone_idx_out,
    int* driver_idx_out, uint8_t* uncertain_out, int* avail_out, int* scratch, int* cross_caps,
    void* zone_table, void* stream) {
  if (variant < 0 || variant > 2 || cluster < 1 ||
      cluster > kMaxCluster || n_zones < 0 || (n > 0 && (scratch == nullptr || cross_caps == nullptr)) ||
      (n_zones > 0 && zone_table == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Kernel kernel = kKernels[variant];
  long long limit = 0;
  cudaError_t err = g_limit[variant].get(reinterpret_cast<const void*>(kernel), &limit);
  if (err != cudaSuccess) return err;
  // the zone table in shared memory while it takes at most half of it
  const long long table_bytes = 2ll * 16 * n_zones;
  const bool table_shared = 2 * table_bytes <= limit;
  const long long capacity = (limit - (table_shared ? table_bytes : 0)) / kNodeBytes;
  const Schedulable sc{s_cpu, s_gpu, inv_mem, th_mem, scale_cpu, scale_gpu};
  return launch_cluster(kernel, cluster, kThreads, limit, stream, avail, rank, exec_ok, perm,
                        pos_of, layout, drivers, executors, counts, valid, sc, n, n_apps, n_zones,
                        strict, feasible_out, zone_idx_out, driver_idx_out, uncertain_out,
                        avail_out, scratch, cross_caps,
                        table_shared ? nullptr : static_cast<int4*>(zone_table),
                        static_cast<int>(capacity));
}
