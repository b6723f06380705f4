// Whole-FIFO-queue gang solve (tightly-pack / distribute-evenly) for Hopper.
//
// Replaces the Pallas TPU kernel k8s_spark_scheduler_tpu/ops/pallas_queue.py:
// _queue_kernel (with _gang_core and _flat_cumsum_exclusive), reached from
// pallas_solve_queue.  Same function, same int32 semantics:
//
//   for each app a, in FIFO order, against the carried availability:
//     cap_n  = clip(min_d trunc(avail[n,d] / max(ex_d, 1)), 0, k)   (BIG if ex_d == 0
//              and avail[n,d] >= 0, 0 if ex_d == 0 and avail[n,d] < 0), 0 unless exec_ok
//     cap'_n = the same with the driver subtracted from node n
//     driver = the lowest (rank, node) with rank < BIG, driver fits, and
//              S - cap_n + cap'_n >= k          (S = sum of cap)
//     fill   = tightly: clip(k - exclusive_cumsum(cap), 0, cap) > 0
//              evenly : cap > 0 and exclusive_count(cap > 0) < k
//     carry -= executor on every filled node, else driver on the driver node
//              (the reference's usage-subtraction quirk: executor overwrites driver)
//   invalid apps are infeasible and subtract nothing; infeasible -> driver_idx = N.
//
// Design.  The apps are sequentially dependent through the carry, so the
// whole queue runs in ONE thread block of 1024 threads that walks the apps
// in order (gang_common.cuh: each thread owns a contiguous chunk of
// ceil(N/1024) nodes).  Per app: (a) capacity per node, stored, and a block
// sum; (b) driver candidates and a block min over the (rank, node) key;
// (c) a block exclusive scan of cap (tightly) or of cap > 0 (evenly);
// (d) the usage subtraction, in place.  Every node is touched only by its
// owning thread, so the block reductions are the only synchronisation.
//
// Bound.  Each app reads the carry, rank, exec_ok and writes the carry:
// bytes are tiny and stay in shared memory (the carry, rank, capacity and
// exec_ok take 21 bytes a node: 215,040 bytes at the 10,240-node bucket,
// under the 232,448 a block may use after cudaFuncSetAttribute).  One SM
// therefore does all the integer divisions and the three block reductions
// (two barriers each) of every app in sequence: the kernel is bound by the
// serial latency of A dependent app steps on one SM, not by device memory.
// When N does not fit in shared memory the same code runs on planar
// scratch in global memory (L2 holds it).  Spreading an app over many SMs
// (a grid-wide sync per phase) is the way to go faster.

#include "gang_common.cuh"

namespace {

using namespace gang;

constexpr int kThreads = 1024;
using Red = BlockRed<kThreads>;

template <bool kEvenly>
__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_kernel(const int* __restrict__ avail_in,     // [N, 3]
                  const int* __restrict__ rank_in,      // [N]
                  const uint8_t* __restrict__ ok_in,    // [N]
                  const int* __restrict__ drivers,      // [A, 3]
                  const int* __restrict__ executors,    // [A, 3]
                  const int* __restrict__ counts,       // [A]
                  const uint8_t* __restrict__ valid,    // [A]
                  int n, int n_apps,
                  uint8_t* __restrict__ feasible_out,   // [A]
                  int* __restrict__ driver_idx_out,     // [A]
                  int* __restrict__ avail_out,          // [N, 3]
                  int* __restrict__ scratch,            // [4N] when not in shared memory
                  int in_shared) {
  extern __shared__ int4 smem_raw[];
  __shared__ Red::Storage red_storage;
  const Red red(&red_storage);

  Nodes s;
  init_nodes<kThreads, true>(&s, in_shared ? reinterpret_cast<uint8_t*>(smem_raw) : nullptr,
                             scratch, Identity{}, avail_in, rank_in, ok_in, n, 0, n);

  for (int a = 0; a < n_apps; ++a) {
    if (!valid[a]) {  // uniform across the block
      if (threadIdx.x == 0) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }
    const App app = load_app(drivers, executors, counts, a);
    const int didx = gang_core<false>(s, app, red, Identity{}).idx;
    if (threadIdx.x == 0) {
      feasible_out[a] = didx < n ? 1 : 0;
      driver_idx_out[a] = didx;
    }
    if (didx == n) continue;

    // (c) exclusive prefix over nodes in order, then (d) in the same walk
    // the usage subtraction: executor on filled nodes, else driver on its node
    int part = 0;
    for (int i = s.lo; i < s.hi; ++i) part += kEvenly ? (s.work[i] > 0) : s.work[i];
    int run = red.exclusive_scan(part);
    for (int i = s.lo; i < s.hi; ++i) {
      const int c = s.work[i];
      bool filled;
      if (kEvenly) {
        filled = c > 0 && run < app.k;
        run += c > 0;
      } else {
        filled = c > 0 && app.k - run > 0;
        run += c;
      }
      if (filled) {
        s.cpu[i] -= app.ec;
        s.mem[i] -= app.em;
        s.gpu[i] -= app.eg;
      } else if (i == didx) {
        s.cpu[i] -= app.dc;
        s.mem[i] -= app.dm;
        s.gpu[i] -= app.dg;
      }
    }
  }
  store_avail<kThreads>(s, Identity{}, avail_out);
}

SharedLimit g_limit[2];  // per variant

template <bool kEvenly>
long long shared_bytes(int n) {
  long long limit = 0;
  cudaError_t err =
      g_limit[kEvenly].get(reinterpret_cast<const void*>(fifo_queue_kernel<kEvenly>), &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long bytes = kNodeBytes * n;
  return n > 0 && bytes <= limit ? bytes : 0;
}

}  // namespace

// Dynamic shared memory the kernel takes for n nodes on the current
// device, or 0 when they do not fit and the kernel works from global
// scratch.  A negative value is a CUDA error code, negated.
extern "C" long long fifo_queue_shared_bytes(int n) { return shared_bytes<false>(n); }

// Launches the queue kernel on `stream` on the current device; `scratch`
// ([4N] int32) is needed only when fifo_queue_shared_bytes(n) is 0.
// Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_launch(const int* avail, const int* rank, const uint8_t* exec_ok,
                                 const int* drivers, const int* executors, const int* counts,
                                 const uint8_t* valid, int n, int n_apps, int evenly,
                                 uint8_t* feasible_out, int* driver_idx_out, int* avail_out,
                                 int* scratch, void* stream) {
  const long long smem = evenly ? shared_bytes<true>(n) : shared_bytes<false>(n);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0 && scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  void (*kernel)(const int*, const int*, const uint8_t*, const int*, const int*, const int*,
                 const uint8_t*, int, int, uint8_t*, int*, int*, int*, int) =
      evenly ? fifo_queue_kernel<true> : fifo_queue_kernel<false>;
  kernel<<<1, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      avail, rank, exec_ok, drivers, executors, counts, valid, n, n_apps, feasible_out,
      driver_idx_out, avail_out, scratch, smem > 0 ? 1 : 0);
  return cudaGetLastError();
}
