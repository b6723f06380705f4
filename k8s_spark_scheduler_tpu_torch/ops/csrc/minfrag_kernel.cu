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
// real capacity reaches the unbounded sentinel.
//
// Design.  As queue_kernel.cu: one block of 1024 threads walks the queue,
// the carry, work plane, ranks and exec_ok in 21 bytes a node of shared
// memory while they fit (215,040 bytes at the 10,240-node bucket), planar
// global scratch above that.
//
// Bound.  Each feasible app takes some 38 block reductions in sequence
// (two for the gang core, the maximum, the two passes' totals, 31 probes of
// the binary search, the drained sum, the class scan and the final
// placement's minimum), each a few barriers on one SM.  The kernel is bound
// by that serial chain, not by device memory or by the ALUs.  Narrowing the
// search to [1, max capacity] or spreading an app over several SMs are the
// ways to go faster.

#include "gang_common.cuh"

namespace {

using namespace gang;

__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_min_frag_kernel(const int* __restrict__ avail_in,    // [N, 3]
                           const int* __restrict__ rank_in,     // [N]
                           const uint8_t* __restrict__ ok_in,   // [N]
                           const int* __restrict__ drivers,     // [A, 3]
                           const int* __restrict__ executors,   // [A, 3]
                           const int* __restrict__ counts,      // [A]
                           const uint8_t* __restrict__ valid,   // [A]
                           int n, int n_apps,
                           uint8_t* __restrict__ feasible_out,  // [A]
                           int* __restrict__ driver_idx_out,    // [A]
                           int* __restrict__ avail_out,         // [N, 3]
                           int* __restrict__ scratch,           // [4N] when not in shared memory
                           int in_shared) {
  extern __shared__ int4 smem_raw[];
  __shared__ int red_i[kWarps];
  __shared__ int2 red_i2[kWarps];
  __shared__ unsigned long long red_u[kWarps];
  const Red red{red_i, red_i2, red_u};

  Nodes s;
  init_nodes(&s, reinterpret_cast<int*>(smem_raw), scratch, in_shared, avail_in, rank_in, ok_in, n);
  const auto all = [](int) { return true; };

  for (int a = 0; a < n_apps; ++a) {
    if (!valid[a]) {  // uniform across the block
      if (threadIdx.x == 0) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }
    const App app = load_app(drivers, executors, counts, a);
    const int didx = gang_core(s, app, all, red);
    if (threadIdx.x == 0) {
      feasible_out[a] = didx < n ? 1 : 0;
      driver_idx_out[a] = didx;
    }
    if (didx == n) continue;
    min_frag_drain(s, app, didx, all, red);
    subtract_usage(s, app, didx, [&](int i) { return s.work[i] > 0; });
  }
  store_avail(s, avail_out);
}

SharedLimit g_limit;

}  // namespace

// Dynamic shared memory the kernel takes for n nodes on the current
// device, or 0 when they do not fit and the kernel works from global
// scratch.  A negative value is a CUDA error code, negated.
extern "C" long long fifo_queue_min_frag_shared_bytes(int n) {
  long long limit = 0;
  cudaError_t err =
      g_limit.get(reinterpret_cast<const void*>(fifo_queue_min_frag_kernel), &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long bytes = node_shared_bytes(n, 0);
  return n > 0 && bytes <= limit ? bytes : 0;
}

// Launches the kernel on `stream` on the current device; `scratch` ([4N]
// int32) is needed only when fifo_queue_min_frag_shared_bytes(n) is 0.
// Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_min_frag_launch(const int* avail, const int* rank,
                                          const uint8_t* exec_ok, const int* drivers,
                                          const int* executors, const int* counts,
                                          const uint8_t* valid, int n, int n_apps,
                                          uint8_t* feasible_out, int* driver_idx_out,
                                          int* avail_out, int* scratch, void* stream) {
  const long long smem = fifo_queue_min_frag_shared_bytes(n);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0 && scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  fifo_queue_min_frag_kernel<<<1, kThreads, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      avail, rank, exec_ok, drivers, executors, counts, valid, n, n_apps, feasible_out,
      driver_idx_out, avail_out, scratch, smem > 0 ? 1 : 0);
  return cudaGetLastError();
}
