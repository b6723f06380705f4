// Device code shared by the whole-queue gang-solve kernels (queue_kernel.cu,
// minfrag_kernel.cu, single_az_kernel.cu).
//
// Every kernel walks the FIFO queue in ONE block of kThreads threads; thread t
// owns the contiguous node chunk [lo, hi), so a block-wide exclusive scan of
// per-thread partial sums is a prefix in node order.  Block reductions are
// the only synchronisation: each ends with a barrier, so its scratch may be
// reused at once and every thread returns the same value.
//
// The per-app steps below replace the Pallas helpers of
// k8s_spark_scheduler_tpu/ops/pallas_queue.py: gang_core (_gang_core),
// tightly_fill (the _solve_tightly fill), min_frag_drain (_solve_min_frag,
// _mf_run, _mf_caps).  Each takes a node predicate `in(i)` (the zone mask of
// the single-AZ kernel, always true elsewhere) and touches the per-node work
// plane only for nodes where it holds.  All arithmetic is int32 with the
// reference's semantics: truncating division, the zero-requirement
// dimension, the (rank, node) minimum, argmin meaning the first index.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace gang {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 2147483647;
// unbounded capacity of the min-frag drain (batch_solver.MF_SENT); callers
// guard that no real capacity reaches it
constexpr int kMfSent = 2147483646;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// ---- capacities --------------------------------------------------------------

// One dimension's executor capacity; a zero requirement gives `unbounded`
// unless the dimension is already negative.
__device__ __forceinline__ int dim_cap(int avail, int req, int unbounded) {
  if (req == 0) return avail >= 0 ? unbounded : 0;
  return avail / (req > 1 ? req : 1);  // truncates, like lax.div
}

// Executor capacity clamped to [0, k] (the gang core's).
__device__ __forceinline__ int node_cap(int c, int m, int g, int ec, int em, int eg, int k) {
  int v = min(min(dim_cap(c, ec, kBig), dim_cap(m, em, kBig)), dim_cap(g, eg, kBig));
  return min(max(v, 0), k);
}

// Unclamped executor capacity for the min-frag drain, in [0, kMfSent].
__device__ __forceinline__ int mf_cap(int c, int m, int g, int ec, int em, int eg) {
  int v = min(min(dim_cap(c, ec, kMfSent), dim_cap(m, em, kMfSent)), dim_cap(g, eg, kMfSent));
  return max(v, 0);
}

// ---- block reductions --------------------------------------------------------

struct Red {
  int* i;                  // [kWarps]
  int2* i2;                // [kWarps]
  unsigned long long* u;   // [kWarps]
};

__device__ __forceinline__ int block_sum(int v, const Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) red.i[warp] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red.i[w];
  __syncthreads();
  return r;
}

// Two independent sums in one pass.
__device__ __forceinline__ int2 block_sum2(int2 v, const Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, off);
    v.y += __shfl_xor_sync(kFull, v.y, off);
  }
  if (lane == 0) red.i2[warp] = v;
  __syncthreads();
  int2 r = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.x += red.i2[w].x;
    r.y += red.i2[w].y;
  }
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_max(int v, const Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) red.i[warp] = v;
  __syncthreads();
  int r = red.i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = max(r, red.i[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned long long block_min(unsigned long long v, const Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  if (lane == 0) red.u[warp] = v;
  __syncthreads();
  unsigned long long r = kNoKey;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = red.u[w] < r ? red.u[w] : r;
  __syncthreads();
  return r;
}

// Exclusive scan over threads in thread order.
__device__ __forceinline__ int block_exclusive_scan(int v, const Red& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) red.i[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red.i[w];
  __syncthreads();
  return before + incl - v;
}

// ---- the queue state one block walks ------------------------------------------

struct Nodes {
  int* cpu;          // [n] carried availability, updated after each app
  int* mem;
  int* gpu;
  int* work;         // [n] per-app work plane: capacities, then executor counts
  const int* rank;   // [n] driver rank, kBig = not a candidate
  const uint8_t* ok; // [n] executor candidate
  int n, lo, hi;     // node count and this thread's chunk [lo, hi)
};

// The chunk of nodes this thread owns.
__device__ __forceinline__ void chunk_of(int n, int* lo, int* hi) {
  const int chunk = (n + kThreads - 1) / kThreads;
  *lo = min(static_cast<int>(threadIdx.x) * chunk, n);
  *hi = min(*lo + chunk, n);
}

// Bytes of dynamic shared memory the queue state takes: the cpu, mem, gpu,
// work and rank int32 planes, exec_ok and `extra` more bytes a node,
// 16-byte aligned.
inline long long node_shared_bytes(int n, int extra) {
  return 20ll * n + ((static_cast<long long>(n) * (1 + extra) + 15) / 16) * 16;
}

// Lays the queue state out in dynamic shared memory (`smem`, rank and
// exec_ok copied in) or, when it does not fit, in global scratch ([4N]
// int32; rank and exec_ok read in place), loads the availability and
// sets this thread's chunk.  Returns the first shared byte after the
// state (where a kernel may keep `extra` bytes a node), or nullptr.
__device__ __forceinline__ uint8_t* init_nodes(Nodes* s, int* smem, int* scratch, int in_shared,
                                               const int* avail_in, const int* rank_in,
                                               const uint8_t* ok_in, int n) {
  int* base = in_shared ? smem : scratch;
  s->cpu = base;
  s->mem = s->cpu + n;
  s->gpu = s->mem + n;
  s->work = s->gpu + n;
  s->rank = rank_in;
  s->ok = ok_in;
  s->n = n;
  uint8_t* rest = nullptr;
  if (in_shared) {
    int* rank_s = s->work + n;
    uint8_t* ok_s = reinterpret_cast<uint8_t*>(rank_s + n);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      rank_s[i] = rank_in[i];
      ok_s[i] = ok_in[i];
    }
    s->rank = rank_s;
    s->ok = ok_s;
    rest = ok_s + n;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s->cpu[i] = avail_in[3 * i];
    s->mem[i] = avail_in[3 * i + 1];
    s->gpu[i] = avail_in[3 * i + 2];
  }
  chunk_of(n, &s->lo, &s->hi);
  __syncthreads();
  return rest;
}

__device__ __forceinline__ void store_avail(const Nodes& s, int* avail_out) {
  __syncthreads();
  for (int i = threadIdx.x; i < s.n; i += kThreads) {
    avail_out[3 * i] = s.cpu[i];
    avail_out[3 * i + 1] = s.mem[i];
    avail_out[3 * i + 2] = s.gpu[i];
  }
}

struct App {
  int dc, dm, dg;  // driver
  int ec, em, eg;  // executor
  int k;           // executor count
};

__device__ __forceinline__ App load_app(const int* drivers, const int* executors,
                                        const int* counts, int a) {
  return App{drivers[3 * a], drivers[3 * a + 1], drivers[3 * a + 2],
             executors[3 * a], executors[3 * a + 1], executors[3 * a + 2], counts[a]};
}

// Feasibility and the first driver (pallas_queue._gang_core) over the nodes
// where in(i) holds: writes each such node's executor capacity to `work`
// (the driver's node keeps the capacity left beside the driver) and returns
// the driver's index, or n when the gang does not fit.
template <typename In>
__device__ int gang_core(const Nodes& s, const App& a, In in, const Red& red) {
  int part = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int c = s.ok[i] ? node_cap(s.cpu[i], s.mem[i], s.gpu[i], a.ec, a.em, a.eg, a.k) : 0;
    s.work[i] = c;
    part += c;
  }
  const int total = block_sum(part, red);

  unsigned long long best = kNoKey;
  for (int i = s.lo; i < s.hi; ++i) {
    const int r = s.rank[i];
    if (r < kBig && in(i) && s.cpu[i] >= a.dc && s.mem[i] >= a.dm && s.gpu[i] >= a.dg) {
      const int cd = s.ok[i] ? node_cap(s.cpu[i] - a.dc, s.mem[i] - a.dm, s.gpu[i] - a.dg,
                                        a.ec, a.em, a.eg, a.k)
                             : 0;
      if (total - s.work[i] + cd >= a.k) {
        // flipping the sign bit orders signed ranks as unsigned keys
        const unsigned long long key =
            (static_cast<unsigned long long>(static_cast<unsigned>(r) ^ 0x80000000u) << 32) |
            static_cast<unsigned>(i);
        best = key < best ? key : best;
      }
    }
  }
  best = block_min(best, red);
  if (best == kNoKey) return s.n;  // a candidate's rank is < kBig
  const int didx = static_cast<int>(best & 0xffffffffu);
  if (didx >= s.lo && didx < s.hi) {
    s.work[didx] = s.ok[didx] ? node_cap(s.cpu[didx] - a.dc, s.mem[didx] - a.dm,
                                         s.gpu[didx] - a.dg, a.ec, a.em, a.eg, a.k)
                              : 0;
  }
  return didx;
}

// Tightly-pack fill over a feasible gang_core's capacities:
// work[i] = clip(k - exclusive_cumsum(cap)[i], 0, cap[i]) on the nodes in(i).
template <typename In>
__device__ void tightly_fill(const Nodes& s, const App& a, In in, const Red& red) {
  int part = 0;
  for (int i = s.lo; i < s.hi; ++i) part += in(i) ? s.work[i] : 0;
  int run = block_exclusive_scan(part, red);
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int c = s.work[i];
    s.work[i] = min(max(a.k - run, 0), c);
    run += c;
  }
}

// The minimal-fragmentation drain (pallas_queue._solve_min_frag after
// _gang_core) for a feasible app with its driver on node didx: writes each
// node's executor count to work[i] on the nodes in(i).
//
// d = the unclamped capacity with the driver subtracted on its node.  The
// reference tries the (k+max)/2 subset and then the full set, each a drain
// over value classes: v* = max{v : sum over d >= v of min(d, k) >= k} (31
// probes of a binary search), the classes above v* drain fully, the first
// t* = (r-1)/v* nodes at v* drain in node order, and the remaining k* go
// to the smallest remaining capacity >= k*, first index among equals.  The
// subset wins when it fits, so which pass places is known from the two
// passes' totals before any probe: only that pass is run.
template <typename In>
__device__ void min_frag_drain(const Nodes& s, const App& a, int didx, In in, const Red& red) {
  const int k = a.k;
  int mx = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    int d = 0;
    if (s.ok[i]) {
      const bool drv = i == didx;
      d = mf_cap(s.cpu[i] - (drv ? a.dc : 0), s.mem[i] - (drv ? a.dm : 0),
                 s.gpu[i] - (drv ? a.dg : 0), a.ec, a.em, a.eg);
    }
    s.work[i] = d;
    mx = max(mx, d);
  }
  const int max_cap = block_max(mx, red);
  const bool has_sent = max_cap == kMfSent;
  // floor((k + max) / 2) without int32 overflow; >> is floor division by 2
  const int target = (k >> 1) + (max_cap >> 1) + (((k & 1) + (max_cap & 1)) >> 1);
  const bool attempt = has_sent || k < max_cap;
  auto in_subset = [&](int d) {
    return d > 0 && attempt && (has_sent ? d < kMfSent : d < target);
  };

  int2 part2 = make_int2(0, 0);
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int d = s.work[i];
    part2.x += in_subset(d) ? min(d, k) : 0;
    part2.y += d > 0 ? min(d, k) : 0;
  }
  const int2 totals = block_sum2(part2, red);
  const bool full_ok = totals.y >= k && k > 0;
  if (!full_ok) {  // no executor is placed
    for (int i = s.lo; i < s.hi; ++i)
      if (in(i)) s.work[i] = 0;
    return;
  }
  const bool use_sub = attempt && totals.x >= k;  // k > 0 here
  auto in_pass = [&](int d) { return use_sub ? in_subset(d) : d > 0; };

  int lo = 1, hi = kMfSent;
  for (int probe = 0; probe < 31; ++probe) {
    const int mid = lo + (hi - lo + 1) / 2;  // hi - lo + 1 >= 0: truncation is floor
    int part = 0;
    for (int i = s.lo; i < s.hi; ++i) {
      if (!in(i)) continue;
      const int d = s.work[i];
      part += in_pass(d) && d >= mid ? min(d, k) : 0;
    }
    if (block_sum(part, red) >= k) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int vstar = lo;

  int drained_sum = 0, at_count = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int d = s.work[i];
    if (!in_pass(d)) continue;
    drained_sum += d > vstar ? d : 0;
    at_count += d == vstar;
  }
  const int r = k - block_sum(drained_sum, red);
  const int tstar = max(r - 1, 0) / vstar;
  const int kstar = r - tstar * vstar;
  const int at_before = block_exclusive_scan(at_count, red);

  // the final placement: smallest remaining capacity >= k*, first index
  unsigned long long best = kNoKey;
  int run = at_before;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int d = s.work[i];
    if (!in_pass(d)) continue;
    const bool at = d == vstar;
    const bool drained = d > vstar || (at && run < tstar);
    run += at;
    if (!drained && d >= kstar) {
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned>(d)) << 32) |
          static_cast<unsigned>(i);
      best = key < best ? key : best;
    }
  }
  best = block_min(best, red);
  const int partial = best == kNoKey ? 0 : static_cast<int>(best & 0xffffffffu);

  run = at_before;
  for (int i = s.lo; i < s.hi; ++i) {
    if (!in(i)) continue;
    const int d = s.work[i];
    int count = 0;
    if (in_pass(d)) {
      const bool at = d == vstar;
      if (d > vstar || (at && run < tstar)) count = d;
      run += at;
    }
    s.work[i] = count + (i == partial ? kstar : 0);
  }
}

// The reference's usage subtraction: one executor's worth on every node
// where placed(i) (work[i] > 0), else the driver on its node.
template <typename Placed>
__device__ void subtract_usage(const Nodes& s, const App& a, int didx, Placed placed) {
  for (int i = s.lo; i < s.hi; ++i) {
    if (placed(i)) {
      s.cpu[i] -= a.ec;
      s.mem[i] -= a.em;
      s.gpu[i] -= a.eg;
    } else if (i == didx) {
      s.cpu[i] -= a.dc;
      s.mem[i] -= a.dm;
      s.gpu[i] -= a.dg;
    }
  }
}

// ---- launch plumbing -------------------------------------------------------------

// The dynamic shared memory a kernel may take on the calling thread's
// current device (the opt-in limit less its static shared memory), looked
// up and granted to the kernel once per device.  The caller sets the
// device (torch's device guard).
class SharedLimit {
 public:
  cudaError_t get(const void* kernel, long long* out) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> guard(lock_);
    if (limit_[device] == 0) {
      int optin = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return err;
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return err;
      const long long limit = optin - static_cast<long long>(attr.sharedSizeBytes);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(limit));
      if (err != cudaSuccess) return err;
      limit_[device] = limit;
    }
    *out = limit_[device];
    return cudaSuccess;
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::mutex lock_;
  long long limit_[kMaxDevices] = {};  // 0 = not looked up yet
};

}  // namespace gang
