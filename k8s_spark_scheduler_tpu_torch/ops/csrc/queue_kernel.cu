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
// in order.  Each thread owns a contiguous chunk of ceil(N/1024) nodes, so
// a block-wide exclusive scan of per-thread partial sums keeps node order
// for the prefix sums.  Per app: (a) capacity per node, stored, and a block
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
// (two barriers each) of every app in sequence: the kernel is bound by the serial latency of A
// dependent app steps on one SM, not by device memory.  When N does not
// fit in shared memory the same code runs on planar scratch in global
// memory (L2 holds it).  Spreading an app over many SMs (a grid-wide sync
// per phase) is the way to go faster.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ int dim_cap(int avail, int req) {
  // zero requirement: unbounded unless the dimension is already negative
  if (req == 0) return avail >= 0 ? kBig : 0;
  return avail / (req > 1 ? req : 1);  // truncates, like lax.div
}

__device__ __forceinline__ int node_cap(int c, int m, int g, int ec, int em, int eg, int k) {
  int v = min(min(dim_cap(c, ec), dim_cap(m, em)), dim_cap(g, eg));
  return min(max(v, 0), k);
}

// Block-wide sum; red must hold kWarps ints.  Ends with a barrier so the
// scratch may be reused at once.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned long long block_min(unsigned long long v,
                                                        unsigned long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned long long r = kNoKey;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = red[w] < r ? red[w] : r;
  __syncthreads();
  return r;
}

// Exclusive scan over threads in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  __syncthreads();
  return before + incl - v;
}

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
  __shared__ int red_i[kWarps];
  __shared__ unsigned long long red_u[kWarps];

  int* base = in_shared ? reinterpret_cast<int*>(smem_raw) : scratch;
  int* cpu = base;
  int* mem = cpu + n;
  int* gpu = mem + n;
  int* cap = gpu + n;
  const int* rank = rank_in;
  const uint8_t* ok = ok_in;
  if (in_shared) {
    int* rank_s = cap + n;
    uint8_t* ok_s = reinterpret_cast<uint8_t*>(rank_s + n);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      rank_s[i] = rank_in[i];
      ok_s[i] = ok_in[i];
    }
    rank = rank_s;
    ok = ok_s;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cpu[i] = avail_in[3 * i];
    mem[i] = avail_in[3 * i + 1];
    gpu[i] = avail_in[3 * i + 2];
  }
  __syncthreads();

  const int tid = static_cast<int>(threadIdx.x);
  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, n);
  const int hi = min(lo + chunk, n);

  for (int a = 0; a < n_apps; ++a) {
    if (!valid[a]) {  // uniform across the block
      if (tid == 0) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }
    const int k = counts[a];
    const int dc = drivers[3 * a], dm = drivers[3 * a + 1], dg = drivers[3 * a + 2];
    const int ec = executors[3 * a], em = executors[3 * a + 1], eg = executors[3 * a + 2];

    // (a) executor capacity per node, and its total
    int part = 0;
    for (int i = lo; i < hi; ++i) {
      const int c = ok[i] ? node_cap(cpu[i], mem[i], gpu[i], ec, em, eg, k) : 0;
      cap[i] = c;
      part += c;
    }
    const int total = block_sum(part, red_i);

    // (b) first feasible driver: lowest (rank, node)
    unsigned long long best = kNoKey;
    for (int i = lo; i < hi; ++i) {
      const int r = rank[i];
      if (r < kBig && cpu[i] >= dc && mem[i] >= dm && gpu[i] >= dg) {
        const int cd = ok[i] ? node_cap(cpu[i] - dc, mem[i] - dm, gpu[i] - dg, ec, em, eg, k) : 0;
        if (total - cap[i] + cd >= k) {
          // flipping the sign bit orders signed ranks as unsigned keys
          const unsigned long long key =
              (static_cast<unsigned long long>(static_cast<unsigned>(r) ^ 0x80000000u) << 32) |
              static_cast<unsigned>(i);
          best = key < best ? key : best;
        }
      }
    }
    best = block_min(best, red_u);
    const bool feasible = best != kNoKey;  // uniform; a candidate's rank is < BIG
    const int didx = feasible ? static_cast<int>(best & 0xffffffffu) : n;
    if (tid == 0) {
      feasible_out[a] = feasible ? 1 : 0;
      driver_idx_out[a] = didx;
    }
    if (!feasible) continue;

    // the driver's node keeps the capacity left beside the driver
    if (didx >= lo && didx < hi) {
      cap[didx] = ok[didx] ? node_cap(cpu[didx] - dc, mem[didx] - dm, gpu[didx] - dg, ec, em, eg, k)
                           : 0;
    }

    // (c) exclusive prefix over nodes in order
    part = 0;
    for (int i = lo; i < hi; ++i) part += kEvenly ? (cap[i] > 0) : cap[i];
    int run = block_exclusive_scan(part, red_i);

    // (d) usage subtraction: executor on filled nodes, else driver on its node
    for (int i = lo; i < hi; ++i) {
      const int c = cap[i];
      bool filled;
      if (kEvenly) {
        filled = c > 0 && run < k;
        run += c > 0;
      } else {
        filled = c > 0 && k - run > 0;
        run += c;
      }
      if (filled) {
        cpu[i] -= ec;
        mem[i] -= em;
        gpu[i] -= eg;
      } else if (i == didx) {
        cpu[i] -= dc;
        mem[i] -= dm;
        gpu[i] -= dg;
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    avail_out[3 * i] = cpu[i];
    avail_out[3 * i + 1] = mem[i];
    avail_out[3 * i + 2] = gpu[i];
  }
}

long long shared_bytes_for(int n) {
  // cpu, mem, gpu, cap, rank int32 planes + exec_ok bytes, 16-byte aligned
  return 20ll * n + ((static_cast<long long>(n) + 15) / 16) * 16;
}

// Per-device facts the launch needs, looked up once per device: the
// opt-in shared memory a block may use, the kernel's static shared
// memory, and whether each variant's dynamic-shared-memory limit has
// been raised to what is left.  All calls act on the calling thread's
// current device, which the caller sets (torch's device guard).
constexpr int kMaxDevices = 64;
std::mutex g_lock;
long long g_dyn_limit[kMaxDevices];  // 0 = not looked up yet
bool g_raised[kMaxDevices][2];

cudaError_t dynamic_limit(int device, long long* out) {
  std::lock_guard<std::mutex> guard(g_lock);
  if (g_dyn_limit[device] == 0) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fifo_queue_kernel<false>);
    if (err != cudaSuccess) return err;
    g_dyn_limit[device] = optin - static_cast<long long>(attr.sharedSizeBytes);
  }
  *out = g_dyn_limit[device];
  return cudaSuccess;
}

template <bool kEvenly>
cudaError_t raise_limit(int device) {
  std::lock_guard<std::mutex> guard(g_lock);
  if (!g_raised[device][kEvenly]) {
    cudaError_t err = cudaFuncSetAttribute(fifo_queue_kernel<kEvenly>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(g_dyn_limit[device]));
    if (err != cudaSuccess) return err;
    g_raised[device][kEvenly] = true;
  }
  return cudaSuccess;
}

}  // namespace

// Dynamic shared memory the kernel takes for n nodes on the current
// device, or 0 when they do not fit and the kernel works from global
// scratch.  A negative value is a CUDA error code, negated.
extern "C" long long fifo_queue_shared_bytes(int n) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (device >= kMaxDevices) return -static_cast<long long>(cudaErrorInvalidDevice);
  long long limit = 0;
  err = dynamic_limit(device, &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long bytes = shared_bytes_for(n);
  return n > 0 && bytes <= limit ? bytes : 0;
}

// Launches the queue kernel on `stream` on the current device; `scratch`
// ([4N] int32) is needed only when fifo_queue_shared_bytes(n) is 0.
// Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_launch(const int* avail, const int* rank, const uint8_t* exec_ok,
                                 const int* drivers, const int* executors, const int* counts,
                                 const uint8_t* valid, int n, int n_apps, int evenly,
                                 uint8_t* feasible_out, int* driver_idx_out, int* avail_out,
                                 int* scratch, void* stream) {
  const long long smem = fifo_queue_shared_bytes(n);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0 && scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  if (smem > 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = evenly ? raise_limit<true>(device) : raise_limit<false>(device);
    if (err != cudaSuccess) return err;
  }
  void (*kernel)(const int*, const int*, const uint8_t*, const int*, const int*, const int*,
                 const uint8_t*, int, int, uint8_t*, int*, int*, int*, int) =
      evenly ? fifo_queue_kernel<true> : fifo_queue_kernel<false>;
  kernel<<<1, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      avail, rank, exec_ok, drivers, executors, counts, valid, n, n_apps, feasible_out,
      driver_idx_out, avail_out, scratch, smem > 0 ? 1 : 0);
  return cudaGetLastError();
}
