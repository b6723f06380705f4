// Whole-FIFO-queue gang solve under the minimal-fragmentation policy, for
// Hopper.
//
// Replaces the Pallas TPU kernel k8s_spark_scheduler_tpu/ops/pallas_queue.py:
// _minfrag_queue_kernel (with _solve_min_frag, _mf_run and _mf_caps), reached
// from pallas_solve_queue_min_frag.  Same function, same int32 semantics:
// feasibility and the driver as in the tightly-pack queue kernel (the drain
// is work-conserving), the placement by the min-frag drain
// (gang_common.cuh: min_frag_drain), then the reference's usage subtraction
// (executor on every node with an executor, else the driver on its node).
// Invalid apps are infeasible and subtract nothing; infeasible ->
// driver_idx = N.  The caller guards batch_solver.mf_sentinel_safe, so no
// real capacity reaches the unbounded sentinel.  The optional probe flags
// and usage output are the queue kernel's (queue_kernel.cu): a probed app
// gets its verdict and subtracts nothing, and usage[a] is 2 x the nodes
// given executors + 1 when the driver's node got none.  The checkpoint
// buffer is the queue kernel's too: the delta-solve session's carries, one
// store of each block's segment before every chk_stride-th queue position.
//
// Bound.  The apps depend on each other through the carry, so the kernel
// is a serial chain of per-app steps; each step is a few walks over a
// thread's nodes and reductions across the threads that hold them.  The
// reference's drain takes 31 binary-search probes for v*, each a walk and a
// reduction (some 38 reductions and 35 walks a feasible app).  This drain
// (gang_common.cuh) takes none when the placing pass's largest capacity m
// reaches k, the common case for gangs of up to 32 on nodes of up to 96
// cores, and ceil(log2 m) otherwise: a feasible app then takes 5 reductions
// (gang core 2, the maximum, the passes' totals and maximum, the final
// minimum) and 7 walks.  The gang core keeps the unclamped capacities, so
// the drain divides again only on the driver's node.
//
// Design.  A cluster of 8 blocks of 512 threads splits the node axis into 8
// segments (1,280 nodes a block, 2.5 a thread, at the 10,240-node bucket),
// each in its block's shared memory (the carry, work plane, ranks and
// exec_ok in 21 bytes a node; planar global scratch when a segment does not
// fit).  A reduction is a block reduction whose partial goes to every block
// through distributed shared memory, announced on each block's mbarrier
// (gang_common.cuh: ClusterRed); the scans' cross-block offsets come from
// the same exchange.  At the main path's inputs this launch took 11.8 ms
// against 26.1 ms for one block of 1,024 threads (PERF.md).

#include "gang_common.cuh"

namespace {

using namespace gang;

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_min_frag_kernel(const int* __restrict__ avail_in,    // [N, 3]
                           const int* __restrict__ rank_in,     // [N]
                           const uint8_t* __restrict__ ok_in,   // [N]
                           const int* __restrict__ drivers,     // [A, 3]
                           const int* __restrict__ executors,   // [A, 3]
                           const int* __restrict__ counts,      // [A]
                           const uint8_t* __restrict__ valid,   // [A]
                           const uint8_t* __restrict__ probe,   // [A] or null
                           int n, int n_apps,
                           uint8_t* __restrict__ feasible_out,  // [A]
                           int* __restrict__ driver_idx_out,    // [A]
                           int* __restrict__ usage_out,         // [A], zeroed, or null
                           int* __restrict__ avail_out,         // [N, 3]
                           int* __restrict__ scratch,           // [4N] when not in shared memory
                           int in_shared,
                           Checkpoints chk) {                   // the session's checkpoints, or out null
  extern __shared__ int4 smem_raw[];
  __shared__ typename ClusterRed<kThreads>::Storage red_storage;
  ClusterRed<kThreads> red(&red_storage);

  const int rank = red.rank, size = red.size;
  const int chunk = (n + size - 1) / size;
  const int base = min(rank * chunk, n);
  Nodes s;
  init_nodes<kThreads, true>(&s, in_shared ? reinterpret_cast<uint8_t*>(smem_raw) : nullptr,
                             scratch, Identity{}, avail_in, rank_in, ok_in, n, base,
                             min(base + chunk, n) - base);
  cg::this_cluster().sync();  // every block runs before DSMEM writes
  const bool writer = rank == 0 && threadIdx.x == 0;
  const auto node = [&](int i) { return s.base + i; };

  for (int a = 0; a < n_apps; ++a) {
    store_checkpoint<kThreads>(s, chk, a);
    if (!valid[a]) {  // uniform across the cluster
      if (writer) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }
    const App app = load_app(drivers, executors, counts, a);
    const Driver drv = gang_core<true>(s, app, red, node);
    if (writer) {
      feasible_out[a] = drv.idx < n ? 1 : 0;
      driver_idx_out[a] = drv.idx;
    }
    if (drv.idx == n || (probe != nullptr && probe[a])) continue;  // uniform
    min_frag_drain(s, app, red);
    if (usage_out != nullptr) add_usage(s, drv.local, usage_out + a);
    subtract_usage(s, app, drv.local);
  }
  store_avail<kThreads>(s, Identity{}, avail_out);
  cg::this_cluster().sync();
}

constexpr int kBlocks = kMaxCluster;
constexpr int kThreads = 512;
const auto kKernel = fifo_queue_min_frag_kernel<kThreads>;

SharedLimit g_limit;

}  // namespace

// Launches the kernel on `stream` on the current device as one cluster of 8
// blocks; `scratch` is [4N] int32; `probe` ([A] bytes) and `usage_out` ([A]
// int32, zeroed by the caller) may each be null; `chk_out` ([chk_slots, N,
// 3] int32, or null) gets the checkpoints of queue_kernel.cu's launch.
// Returns the CUDA error code (0 = ok); a refused launch returns its error
// and nothing runs.
extern "C" int fifo_queue_min_frag_launch(const int* avail, const int* rank,
                                          const uint8_t* exec_ok, const int* drivers,
                                          const int* executors, const int* counts,
                                          const uint8_t* valid, const uint8_t* probe, int n,
                                          int n_apps, uint8_t* feasible_out,
                                          int* driver_idx_out, int* usage_out, int* avail_out,
                                          int* scratch, int chk_base, int chk_stride,
                                          int chk_slots, int* chk_out, void* stream) {
  if (scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  if (chk_out != nullptr && (chk_stride <= 0 || chk_base < 0)) return cudaErrorInvalidValue;
  long long limit = 0;
  cudaError_t err = g_limit.get(reinterpret_cast<const void*>(kKernel), &limit);
  if (err != cudaSuccess) return err;
  const long long bytes = kNodeBytes * ((n + kBlocks - 1) / kBlocks);
  const long long smem = n > 0 && bytes <= limit ? bytes : 0;
  return launch_cluster(kKernel, kBlocks, kThreads, smem, stream, avail, rank, exec_ok, drivers,
                        executors, counts, valid, probe, n, n_apps, feasible_out, driver_idx_out,
                        usage_out, avail_out, scratch, smem > 0 ? 1 : 0,
                        Checkpoints{chk_out, chk_base, chk_stride, chk_slots});
}
