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
//     fill   = tightly: clip(k - exclusive_cumsum(cap'), 0, cap') > 0
//              evenly : cap' > 0 and exclusive_count(cap' > 0) < k
//              (cap' here: cap with the driver's node at its cap'_d)
//     carry -= executor on every filled node, else driver on the driver node
//              (the reference's usage-subtraction quirk: executor overwrites driver)
//   invalid apps are infeasible and subtract nothing; infeasible -> driver_idx = N.
//   Sums and prefixes wrap as int32, as the reference's do.
//
// Two optional arguments serve the refusal explainer (ops/explain.py),
// which asks, in one launch, at which queue position a later gang stopped
// fitting: a probe flag per app (a probed app gets its verdict and driver
// against the carry but subtracts nothing, so the explainer interleaves
// the refused gang between the queue's apps), and a usage output per app
// (2 x the nodes given executors, + 1 when the driver's own node got
// none; 0 for an app that subtracted nothing) from which the explainer
// reads what each earlier gang took.  The Filter passes neither.
//
// One more optional argument serves the delta-solve session
// (ops/fifo_session.py, the reference's native FifoSession on the card): a
// checkpoint buffer that gets the carried planes before every app whose
// queue position (chk_base + the launch's local app) is a positive multiple
// of chk_stride, so one launch both solves a queue or its suffix and leaves
// the carries a later launch resumes from (gang_common.cuh: Checkpoints).
// A checkpoint is one store of each block's segment between two apps, at
// every chk_stride-th app only.
//
// Bound.  The apps depend on each other through the carry, so the kernel
// is a chain of per-app steps, each a few walks over a thread's nodes and
// reductions across the threads that hold them; the bytes are tiny and
// the int32 operations of the whole queue take 0.017 ms of the card's
// rate at the main path's 10,240 x 1,024 bucket.  What bounds it is the
// latency of that chain: per app, two cluster exchanges (a block barrier,
// a write into every block through distributed shared memory announced on
// its mbarrier, the wait for every block's) and three short walks.  The
// exchanges are most of it: on 1,024 nodes, where the walks nearly vanish,
// the kernel keeps about four fifths of its time (PERF.md).
//
// Design.  One thread-block cluster of 8 blocks of 256 threads splits the
// node axis into 8 contiguous segments (1,280 nodes a block, 5 a thread,
// at the 10,240-node bucket), each in its block's shared memory: the carry,
// a work plane, ranks and exec_ok in 21 bytes a node, or planar global
// scratch when a segment does not fit (above ~10,400 nodes a block).  Per
// app:
//   walk 1: cap of each node; exchange 1 (ClusterRed::scan_sum): S and the
//           exclusive prefix P of x (x = cap for tightly, cap > 0 for evenly)
//           at this thread's first node;
//   walk 2: driver candidates and their cap'; exchange 2
//           (ClusterRed::min_pay): the (rank, node) minimum d, carrying its
//           x'_d - x_d;
//   walk 3: the fill from P'_i = P_i + [i > d] (x'_d - x_d) -- only the
//           driver's node changes between the two prefixes, so no third
//           exchange -- and the usage subtraction, in place.
// A walk takes a thread's nodes kGroup at a time, unrolled, so their loads
// issue together.  The apps' scalars are staged into shared memory a tile
// at a time, each executor request turned into a multiply-high divisor
// (Divisor), so nothing on the per-app chain reads global memory or
// divides.  The launch is one cluster whatever N is; a refused launch
// returns its CUDA error.  At the main path's inputs this design took
// 3.5 ms against 14.2 ms for the earlier design, one block of 1,024
// threads walking the whole queue (PERF.md).

#include "gang_common.cuh"

namespace {

using namespace gang;

constexpr int kBlocks = kMaxCluster;
constexpr int kThreads = 256;
// nodes a thread takes at once in a walk: the 5 a thread holds at the
// 10,240-node bucket (1,280 a block)
constexpr int kGroup = 5;
constexpr int kTile = 256;  // apps staged in shared memory at a time
using Red = ClusterRed<kThreads>;

// int32 addition and subtraction that wrap, as the reference's int32 arrays
// do (the unsigned detour keeps the compiler from assuming no overflow)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// floor(n / d) for 0 <= n < 2^31 and a divisor d >= 1 fixed per app, as a
// multiply-high (Hacker's Delight, 10-8, the 33-bit multiplier 2^32 + m):
// with l = ceil(log2 d) and m = ceil(2^(32+l) / d) - 2^32,
//   floor(n / d) = (umulhi(n, m) + n) >> l.
// Exact: ceil(2^(32+l) / d) = (2^(32+l) + e) / d with 0 <= e < d <= 2^l,
// so n (2^32 + m) / 2^(32+l) = n/d + n e / (d 2^(32+l)), and n e < 2^(31+l)
// keeps the error below 1/d; umulhi(n, m) < n, so the sum fits in 32 bits.
struct Divisor {
  unsigned mul;
  int shift;  // l, or -1: the request is 0, so the dimension is unbounded
};

__device__ __forceinline__ Divisor make_divisor(int req) {
  if (req == 0) return Divisor{0u, -1};
  const unsigned d = req > 1 ? static_cast<unsigned>(req) : 1u;  // max(req, 1), like the reference
  const int l = 32 - __clz(d - 1);
  const unsigned long long big = (1ull << (32 + l)) + d - 1;
  return Divisor{static_cast<unsigned>(big / d), l};  // the 2^32 bit drops in the cast
}

// One dimension's executor capacity before the clamp: 0 for a negative
// availability (the reference's min and clamp give 0 there too), kBig for
// a zero request, else the truncating quotient.
__device__ __forceinline__ int dim_quot(int avail, Divisor dv) {
  if (avail < 0) return 0;
  if (dv.shift < 0) return kBig;
  const unsigned n = static_cast<unsigned>(avail);
  return static_cast<int>((__umulhi(n, dv.mul) + n) >> dv.shift);
}

struct QueueApp {
  int dc, dm, dg;  // driver
  int ec, em, eg;  // executor
  int k;
  int valid;
  int probe;  // verdict only: subtract nothing
  Divisor div[3];
};

// Executor capacity clamped to [0, k] (a negative k gives k, as min(., k)
// does in the reference).
__device__ __forceinline__ int app_cap(const QueueApp& a, int c, int m, int g) {
  const int v = min(min(dim_quot(c, a.div[0]), dim_quot(m, a.div[1])), dim_quot(g, a.div[2]));
  return min(v, a.k);
}

// Apps [first, first + count) into the block's tile.
__device__ void stage_apps(QueueApp* tile, const int* drivers, const int* executors,
                           const int* counts, const uint8_t* valid, const uint8_t* probe,
                           int first, int count) {
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const int a = first + t;
    QueueApp q;
    q.dc = drivers[3 * a];
    q.dm = drivers[3 * a + 1];
    q.dg = drivers[3 * a + 2];
    q.ec = executors[3 * a];
    q.em = executors[3 * a + 1];
    q.eg = executors[3 * a + 2];
    q.k = counts[a];
    q.valid = valid[a];
    q.probe = probe != nullptr ? probe[a] : 0;
    q.div[0] = make_divisor(q.ec);
    q.div[1] = make_divisor(q.em);
    q.div[2] = make_divisor(q.eg);
    tile[t] = q;
  }
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
                  const uint8_t* __restrict__ probe,    // [A] or null
                  int n, int n_apps,
                  uint8_t* __restrict__ feasible_out,   // [A]
                  int* __restrict__ driver_idx_out,     // [A]
                  int* __restrict__ usage_out,          // [A], zeroed, or null
                  int* __restrict__ avail_out,          // [N, 3]
                  int* __restrict__ scratch,            // [4N] when not in shared memory
                  int in_shared,
                  Checkpoints chk) {                    // the session's checkpoints, or out null
  extern __shared__ int4 smem_raw[];
  __shared__ Red::Storage red_storage;
  __shared__ QueueApp tile[kTile];
  Red red(&red_storage);

  const int chunk = (n + red.size - 1) / red.size;
  const int base = min(red.rank * chunk, n);
  Nodes s;
  init_nodes<kThreads, true>(&s, in_shared ? reinterpret_cast<uint8_t*>(smem_raw) : nullptr,
                             scratch, Identity{}, avail_in, rank_in, ok_in, n, base,
                             min(base + chunk, n) - base);
  cg::this_cluster().sync();  // every block runs before DSMEM writes
  const bool writer = red.rank == 0 && threadIdx.x == 0;

  for (int a = 0; a < n_apps; ++a) {
    store_checkpoint<kThreads>(s, chk, a);
    const int t = a % kTile;
    if (t == 0) {  // uniform: every thread is past the previous tile's last app
      __syncthreads();
      stage_apps(tile, drivers, executors, counts, valid, probe, a, min(kTile, n_apps - a));
      __syncthreads();
    }
    const QueueApp app = tile[t];
    if (!app.valid) {  // uniform across the cluster
      if (writer) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }

    // walk 1: capacities; exchange 1: S and this thread's prefix of x.
    // Each walk takes kGroup nodes at a time, their loads issued together
    // (an index past the chunk reads its last node and is masked).
    int part_x = 0, part_s = 0;
    for (int i0 = s.lo; i0 < s.hi; i0 += kGroup) {
      int cap[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = min(i0 + j, s.hi - 1);
        cap[j] = s.ok[i] ? app_cap(app, s.cpu[i], s.mem[i], s.gpu[i]) : 0;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (i0 + j < s.hi) {
          s.work[i0 + j] = cap[j];
          part_s = wadd(part_s, cap[j]);
          part_x = kEvenly ? part_x + (cap[j] > 0) : wadd(part_x, cap[j]);
        }
      }
    }
    const int2 scan = red.scan_sum(make_int2(part_x, part_s));
    const int total = scan.y;

    // walk 2: this thread's best driver candidate; exchange 2: the winner
    // and its x'_d - x_d
    unsigned long long best = kNoKey;
    int best_i = -1, best_cap = 0, best_delta = 0;
    for (int i0 = s.lo; i0 < s.hi; i0 += kGroup) {
      unsigned long long kv[kGroup];
      int c[kGroup], cd[kGroup];
      bool cand[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = min(i0 + j, s.hi - 1);
        const int r = s.rank[i], cpu = s.cpu[i], mem = s.mem[i], gpu = s.gpu[i];
        // flipping the sign bit orders signed ranks as unsigned keys
        kv[j] = (static_cast<unsigned long long>(static_cast<unsigned>(r) ^ 0x80000000u) << 32) |
                static_cast<unsigned>(s.base + i);
        c[j] = s.work[i];
        cand[j] = i0 + j < s.hi && r < kBig && cpu >= app.dc && mem >= app.dm && gpu >= app.dg;
        cd[j] = cand[j] && s.ok[i]
                    ? app_cap(app, wsub(cpu, app.dc), wsub(mem, app.dm), wsub(gpu, app.dg))
                    : 0;
        cand[j] = cand[j] && wadd(wsub(total, c[j]), cd[j]) >= app.k;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (cand[j] && kv[j] < best) {
          best = kv[j];
          best_i = i0 + j;
          best_cap = cd[j];
          best_delta = kEvenly ? static_cast<int>(cd[j] > 0) - static_cast<int>(c[j] > 0)
                               : wsub(cd[j], c[j]);
        }
      }
    }
    const KeyPay won = red.min_pay(best, best_delta);
    const int driver = won.key == kNoKey ? n : static_cast<int>(won.key & 0xffffffffu);
    if (writer) {
      feasible_out[a] = driver < n ? 1 : 0;
      driver_idx_out[a] = driver;
    }
    if (driver == n || app.probe) continue;  // uniform

    // walk 3: the fill from P' and the usage subtraction (executor on filled
    // nodes, else the driver on its node)
    const int local = best == won.key ? best_i : -1;  // keys are unique: one thread holds it
    int run = wadd(scan.x, s.base + s.lo > driver ? won.pay : 0);
    int hosted = 0, driver_row = 0;  // this thread's share of the usage
    for (int i0 = s.lo; i0 < s.hi; i0 += kGroup) {
      int c[kGroup], cpu[kGroup], mem[kGroup], gpu[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = min(i0 + j, s.hi - 1);
        c[j] = i == local ? best_cap : s.work[i];
        cpu[j] = s.cpu[i];
        mem[j] = s.mem[i];
        gpu[j] = s.gpu[i];
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int i = i0 + j;
        if (i < s.hi) {
          bool filled;
          if (kEvenly) {
            filled = c[j] > 0 && run < app.k;
            run += c[j] > 0;
          } else {
            filled = c[j] > 0 && wsub(app.k, run) > 0;
            run = wadd(run, c[j]);
          }
          if (filled) {
            s.cpu[i] = wsub(cpu[j], app.ec);
            s.mem[i] = wsub(mem[j], app.em);
            s.gpu[i] = wsub(gpu[j], app.eg);
            ++hosted;
          } else if (i == local) {
            s.cpu[i] = wsub(cpu[j], app.dc);
            s.mem[i] = wsub(mem[j], app.dm);
            s.gpu[i] = wsub(gpu[j], app.dg);
            driver_row = 1;
          }
        }
      }
    }
    // the usage is only read after the launch: a fire-and-forget add
    if (usage_out != nullptr && (hosted | driver_row)) atomicAdd(usage_out + a, 2 * hosted + driver_row);
  }
  store_avail<kThreads>(s, Identity{}, avail_out);
  cg::this_cluster().sync();
}

SharedLimit g_limit[2];  // per variant

template <bool kEvenly>
long long segment_bytes(int n) {
  long long limit = 0;
  cudaError_t err =
      g_limit[kEvenly].get(reinterpret_cast<const void*>(fifo_queue_kernel<kEvenly>), &limit);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long bytes = kNodeBytes * ((n + kBlocks - 1) / kBlocks);
  return n > 0 && bytes <= limit ? bytes : 0;
}

}  // namespace

// The launch: one cluster of fifo_queue_blocks() blocks of
// fifo_queue_threads() threads.
extern "C" int fifo_queue_blocks() { return kBlocks; }
extern "C" int fifo_queue_threads() { return kThreads; }

// Dynamic shared memory a block of the kernel takes for n nodes on the
// current device (its segment of the node planes), or 0 when a segment
// does not fit and the kernel works from global scratch; `static_bytes`
// (if not null) gets the kernel's static shared memory (the app tile and
// the exchange slots).  A negative value is a CUDA error code, negated.
extern "C" long long fifo_queue_shared_bytes(int n, long long* static_bytes) {
  const long long bytes = segment_bytes<false>(n);
  if (bytes >= 0 && static_bytes != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t err =
        cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fifo_queue_kernel<false>));
    if (err != cudaSuccess) return -static_cast<long long>(err);
    *static_bytes = static_cast<long long>(attr.sharedSizeBytes);
  }
  return bytes;
}

// Launches the queue kernel on `stream` on the current device as one
// cluster; `scratch` ([4N] int32) is needed only when
// fifo_queue_shared_bytes(n) is 0.  `probe` ([A] bytes) and `usage_out`
// ([A] int32, zeroed by the caller) may each be null.  `chk_out`
// ([chk_slots, N, 3] int32, or null for none) gets the carried planes
// before each app at a queue position p = chk_base + a with p > 0 and
// p % chk_stride == 0, in slot p / chk_stride - 1 (gang_common.cuh:
// Checkpoints).  Returns the CUDA error code (0 = ok); a refused launch
// returns its error and nothing runs.
extern "C" int fifo_queue_launch(const int* avail, const int* rank, const uint8_t* exec_ok,
                                 const int* drivers, const int* executors, const int* counts,
                                 const uint8_t* valid, const uint8_t* probe, int n, int n_apps,
                                 int evenly, uint8_t* feasible_out, int* driver_idx_out,
                                 int* usage_out, int* avail_out, int* scratch, int chk_base,
                                 int chk_stride, int chk_slots, int* chk_out, void* stream) {
  const long long smem = evenly ? segment_bytes<true>(n) : segment_bytes<false>(n);
  if (smem < 0) return static_cast<int>(-smem);
  if (smem == 0 && scratch == nullptr && n > 0) return cudaErrorInvalidValue;
  if (chk_out != nullptr && (chk_stride <= 0 || chk_base < 0)) return cudaErrorInvalidValue;
  const auto kernel = evenly ? fifo_queue_kernel<true> : fifo_queue_kernel<false>;
  return launch_cluster(kernel, kBlocks, kThreads, smem, stream, avail, rank, exec_ok, drivers,
                        executors, counts, valid, probe, n, n_apps, feasible_out, driver_idx_out,
                        usage_out, avail_out, scratch, smem > 0 ? 1 : 0,
                        Checkpoints{chk_out, chk_base, chk_stride, chk_slots});
}
