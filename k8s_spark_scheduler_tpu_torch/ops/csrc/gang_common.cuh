// Device code shared by the whole-queue gang-solve kernels (queue_kernel.cu,
// minfrag_kernel.cu, single_az_kernel.cu).
//
// A kernel walks the FIFO queue in one block, or in a thread-block cluster
// whose blocks each hold a segment of the node axis.  A block keeps its
// segment's state (Nodes) with local indices [0, len); thread t owns a
// contiguous chunk [lo, hi) of the range it is working on, so a scan of
// per-thread partial sums in thread order is a prefix in node order.
// Reductions are the only synchronisation, through a policy object:
// BlockRed (one block; each reduction ends with a barrier) or ClusterRed
// (the block's partial is written into every block of the cluster through
// distributed shared memory, each write announced on that block's
// mbarrier).  Every thread of every block gets the same value.
//
// The per-app steps below replace the Pallas helpers of
// k8s_spark_scheduler_tpu/ops/pallas_queue.py: gang_core (_gang_core),
// tightly_fill (the _solve_tightly fill), min_frag_drain (_solve_min_frag,
// _mf_run, _mf_caps).  All arithmetic is int32 with the reference's
// semantics: truncating division, the zero-requirement dimension, the
// (rank, node) minimum, argmin meaning the first index.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace gang {

namespace cg = cooperative_groups;

constexpr int kBig = 2147483647;
// unbounded capacity of the min-frag drain (batch_solver.MF_SENT); callers
// guard that no real capacity reaches it
constexpr int kMfSent = 2147483646;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kMaxCluster = 8;  // the portable cluster size

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

// node_cap from mf_cap's value: under the min-frag guard (no availability
// above kMfSent - 1) d == kMfSent exactly where node_cap's minimum is kBig.
__device__ __forceinline__ int clamp_cap(int d, int k) { return d == kMfSent ? k : min(d, k); }

// ---- reductions ----------------------------------------------------------------

// A (rank, node) key packed in an int4's x (low) and y (high) lanes.
__device__ __forceinline__ unsigned long long key_of(int4 a) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(a.y)) << 32) |
         static_cast<unsigned>(a.x);
}

struct KeyPay {
  unsigned long long key;
  int pay;
};

// Reductions over one block of kThreads threads.  Each returns the same
// value in every thread and ends with a barrier, so the storage may be
// reused at once.
template <int kThreads>
struct BlockRed {
  static constexpr int kWarps = kThreads / 32;
  struct Storage {
    int i[kWarps];
    int2 i2[kWarps];
    int4 i4[kWarps];
    unsigned long long u[kWarps];
  };
  Storage* st;

  __device__ explicit BlockRed(Storage* storage) : st(storage) {}

  __device__ int sum(int v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) st->i[warp] = v;
    __syncthreads();
    int r = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r += st->i[w];
    __syncthreads();
    return r;
  }

  __device__ int max(int v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = ::max(v, __shfl_xor_sync(kFull, v, off));
    if (lane == 0) st->i[warp] = v;
    __syncthreads();
    int r = st->i[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = ::max(r, st->i[w]);
    __syncthreads();
    return r;
  }

  // Two independent sums in one pass.
  __device__ int2 sum2(int2 v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(kFull, v.x, off);
      v.y += __shfl_xor_sync(kFull, v.y, off);
    }
    if (lane == 0) st->i2[warp] = v;
    __syncthreads();
    int2 r = make_int2(0, 0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      r.x += st->i2[w].x;
      r.y += st->i2[w].y;
    }
    __syncthreads();
    return r;
  }

  // (sum of s.x, sum of s.y, max of m)
  __device__ int3 sum2max(int2 s, int m) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_xor_sync(kFull, s.x, off);
      s.y += __shfl_xor_sync(kFull, s.y, off);
      m = ::max(m, __shfl_xor_sync(kFull, m, off));
    }
    if (lane == 0) st->i4[warp] = make_int4(s.x, s.y, m, 0);
    __syncthreads();
    int3 r = make_int3(0, 0, 0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int4 p = st->i4[w];
      r.x += p.x;
      r.y += p.y;
      r.z = ::max(r.z, p.z);
    }
    __syncthreads();
    return r;
  }

  __device__ unsigned long long min(unsigned long long v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      unsigned long long o = __shfl_xor_sync(kFull, v, off);
      v = o < v ? o : v;
    }
    if (lane == 0) st->u[warp] = v;
    __syncthreads();
    unsigned long long r = kNoKey;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r = st->u[w] < r ? st->u[w] : r;
    __syncthreads();
    return r;
  }

  // Exclusive scan over threads in thread order.
  __device__ int exclusive_scan(int v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) st->i[warp] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += st->i[w];
    __syncthreads();
    return before + incl - v;
  }

  // (exclusive scan of v.x in thread order, sum of v.y) in one pass.
  __device__ int2 scan_sum(int2 v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v.x, tot = v.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
      tot += __shfl_xor_sync(kFull, tot, off);
    }
    if (lane == 31) st->i2[warp] = make_int2(incl, tot);
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int2 p = st->i2[w];
      before += w < warp ? p.x : 0;
      all += p.y;
    }
    __syncthreads();
    return make_int2(before + incl - v.x, all);
  }
};

// Reductions over a thread-block cluster of kThreads-thread blocks whose
// blocks hold consecutive segments of the node axis in cluster rank order.
// A reduction is a warp step (__reduce_*_sync where it fits), one block
// barrier, then C threads of each block combine the warps' partials and
// each writes the block's partial into one block's exchange slots through
// distributed shared memory and arrives (release, cluster scope) on that
// block's mbarrier; every thread waits (acquire) until its block's mbarrier
// has its C arrivals and combines the C slots.  No cluster-wide barrier:
// a block goes on as soon as every block's partial has reached it.
// Slots, mbarriers and warp partials are double-buffered by parity: a block
// writes parity p's again only after passing the next reduction's wait,
// which needs every block's next partial, which each block sends after the
// block barrier that follows its reads of parity p.  The object is per
// thread (it carries the parity and the mbarriers' phases); construct it
// before the kernel's first cluster barrier, which publishes the mbarriers'
// initialisation to the other blocks.
template <int kThreads>
struct ClusterRed {
  static constexpr int kWarps = kThreads / 32;
  struct Storage {
    int4 part[2][kWarps];
    int4 slot[2][kMaxCluster];
    unsigned long long bar[2];  // mbarriers
  };
  Storage* st;
  int rank, size, parity;
  unsigned phases;  // bit p: the phase parity the next wait on bar[p] expects

  static __device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
  }

  __device__ explicit ClusterRed(Storage* storage) : st(storage), parity(0), phases(0) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    size = static_cast<int>(cluster.num_blocks());
    if (threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&st->bar[p])),
                     "r"(size)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // This reduction's warp partials.
  __device__ __forceinline__ int4* part() const { return st->part[parity]; }

  // Lane 0 of each warp has written part()[warp]; combine them per block
  // with `op` and exchange.  Returns this reduction's C slots.
  template <class Op>
  __device__ const int4* exchange(Op op) {
    __syncthreads();
    const unsigned bar = smem_addr(&st->bar[parity]);
    if (static_cast<int>(threadIdx.x) < size) {
      const int4* part = this->part();
      int4 acc = part[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc = op(acc, part[w]);
      int4* dst = cg::this_cluster().map_shared_rank(&st->slot[parity][0], threadIdx.x);
      dst[rank] = acc;
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote)
                   : "r"(bar), "r"(static_cast<unsigned>(threadIdx.x)));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
                   : "memory");
    }
    asm volatile(
        "{\n\t"
        ".reg .pred done;\n\t"
        "LAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
        "@done bra DONE;\n\t"
        "bra LAB_WAIT;\n\t"
        "DONE:\n\t"
        "}" ::"r"(bar),
        "r"((phases >> parity) & 1u)
        : "memory");
    phases ^= 1u << parity;
    const int4* got = st->slot[parity];
    parity ^= 1;
    return got;
  }

  __device__ int sum(int v) {
    v = __reduce_add_sync(kFull, v);
    if ((threadIdx.x & 31) == 0) part()[threadIdx.x >> 5] = make_int4(v, 0, 0, 0);
    const int4* got = exchange([](int4 a, int4 b) { return make_int4(a.x + b.x, 0, 0, 0); });
    int r = 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) r += b < size ? got[b].x : 0;
    return r;
  }

  __device__ int max(int v) {
    v = __reduce_max_sync(kFull, v);
    if ((threadIdx.x & 31) == 0) part()[threadIdx.x >> 5] = make_int4(v, 0, 0, 0);
    const int4* got = exchange([](int4 a, int4 b) { return make_int4(::max(a.x, b.x), 0, 0, 0); });
    int r = got[0].x;
#pragma unroll
    for (int b = 1; b < kMaxCluster; ++b) r = b < size ? ::max(r, got[b].x) : r;
    return r;
  }

  __device__ int3 sum2max(int2 s, int m) {
    s.x = __reduce_add_sync(kFull, s.x);
    s.y = __reduce_add_sync(kFull, s.y);
    m = __reduce_max_sync(kFull, m);
    if ((threadIdx.x & 31) == 0) part()[threadIdx.x >> 5] = make_int4(s.x, s.y, m, 0);
    const int4* got = exchange(
        [](int4 a, int4 b) { return make_int4(a.x + b.x, a.y + b.y, ::max(a.z, b.z), 0); });
    int3 r = make_int3(0, 0, 0);
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) {
      if (b < size) {
        r.x += got[b].x;
        r.y += got[b].y;
        r.z = ::max(r.z, got[b].z);
      }
    }
    return r;
  }

  __device__ unsigned long long min(unsigned long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      unsigned long long o = __shfl_xor_sync(kFull, v, off);
      v = o < v ? o : v;
    }
    if ((threadIdx.x & 31) == 0) {
      part()[threadIdx.x >> 5] =
          make_int4(static_cast<int>(v & 0xffffffffu), static_cast<int>(v >> 32), 0, 0);
    }
    const int4* got = exchange([](int4 a, int4 b) { return key_of(b) < key_of(a) ? b : a; });
    unsigned long long r = kNoKey;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) r = b < size && key_of(got[b]) < r ? key_of(got[b]) : r;
    return r;
  }

  // The smallest key over the cluster's threads and the payload of the
  // thread that holds it, in one exchange.  Keys other than kNoKey are
  // unique; when every key is kNoKey the payload is meaningless.
  __device__ KeyPay min_pay(unsigned long long key, int pay) {
    const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
    const unsigned min_hi = __reduce_min_sync(kFull, hi);
    const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
    const unsigned owner = __ballot_sync(kFull, hi == min_hi && lo == min_lo);
    pay = __shfl_sync(kFull, pay, __ffs(owner) - 1);
    if ((threadIdx.x & 31) == 0) {
      part()[threadIdx.x >> 5] =
          make_int4(static_cast<int>(min_lo), static_cast<int>(min_hi), pay, 0);
    }
    const int4* got = exchange([](int4 a, int4 b) { return key_of(b) < key_of(a) ? b : a; });
    int4 r = got[0];
#pragma unroll
    for (int b = 1; b < kMaxCluster; ++b) r = b < size && key_of(got[b]) < key_of(r) ? got[b] : r;
    return KeyPay{key_of(r), r.z};
  }

  // Exclusive scan of v.x over the cluster's threads in (rank, thread)
  // order, and the sum of v.y, in one exchange.  The offset of this
  // thread's warp within its block is read after the exchange, whose
  // barrier publishes the warp partials too (they stay until the
  // reduction after next, by parity).
  __device__ int2 scan_sum(int2 v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v.x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int tot = __reduce_add_sync(kFull, v.y);
    int4* warps = part();
    if (lane == 31) warps[warp] = make_int4(incl, tot, 0, 0);
    const int4* got = exchange([](int4 a, int4 b) { return make_int4(a.x + b.x, a.y + b.y, 0, 0); });
    int2 r = make_int2(incl - v.x, 0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) r.x += w < warp ? warps[w].x : 0;
#pragma unroll
    for (int b = 0; b < kMaxCluster; ++b) {
      r.x += b < rank ? got[b].x : 0;
      r.y += b < size ? got[b].y : 0;
    }
    return r;
  }
};

// ---- the queue state one block walks ------------------------------------------

struct Nodes {
  int* cpu;          // [len] carried availability, updated after each app
  int* mem;
  int* gpu;
  int* work;         // [len] per-app work plane: capacities, then executor counts
  const int* rank;   // [len] driver rank, kBig = not a candidate
  const uint8_t* ok; // [len] executor candidate
  int n;             // node count of the whole problem (the "no driver" index)
  int base;          // node index of local node 0 (in the kernel's node order)
  int len;           // nodes this block holds
  int lo, hi;        // this thread's chunk of the current range, local
};

// This thread's chunk of the local range [begin, end) over kThreads threads.
template <int kThreads>
__device__ __forceinline__ void set_range(Nodes* s, int begin, int end) {
  const int chunk = (end - begin + kThreads - 1) / kThreads;
  s->lo = min(begin + static_cast<int>(threadIdx.x) * chunk, end);
  s->hi = min(s->lo + chunk, end);
}

// Bytes of dynamic shared memory `cap` nodes of queue state take: the cpu,
// mem, gpu, work and rank int32 planes and exec_ok.
constexpr long long kNodeBytes = 21;

// Lays out the state of the nodes [base, base + len) of the kernel's node
// order in `smem` (room for that many nodes) or, when smem is nullptr, at
// offset `base` of planar global scratch: [4n] int32 (cpu, mem, gpu, work)
// with rank and exec_ok read in place when `src` is the identity, else
// [5n] int32 and [n] bytes that hold them too.  Node j of the kernel's
// order is input node src(j).  Loads the state and sets this thread's
// chunk of the whole segment.
template <int kThreads, bool kIdentity, class Src>
__device__ void init_nodes(Nodes* s, uint8_t* smem, int* scratch, Src src, const int* avail_in,
                           const int* rank_in, const uint8_t* ok_in, int n, int base, int len) {
  s->n = n;
  s->base = base;
  s->len = len;
  int* rank_w;
  uint8_t* ok_w;
  if (smem != nullptr) {
    int* p = reinterpret_cast<int*>(smem);
    s->cpu = p;
    s->mem = p + len;
    s->gpu = p + 2 * len;
    s->work = p + 3 * len;
    rank_w = p + 4 * len;
    ok_w = reinterpret_cast<uint8_t*>(p + 5 * len);
  } else {
    s->cpu = scratch + base;
    s->mem = scratch + n + base;
    s->gpu = scratch + 2 * n + base;
    s->work = scratch + 3 * n + base;
    rank_w = kIdentity ? nullptr : scratch + 4 * n + base;
    ok_w = kIdentity ? nullptr : reinterpret_cast<uint8_t*>(scratch + 5 * n) + base;
  }
  if (rank_w == nullptr) {
    s->rank = rank_in + base;
    s->ok = ok_in + base;
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int o = src(base + i);
      rank_w[i] = rank_in[o];
      ok_w[i] = ok_in[o];
    }
    s->rank = rank_w;
    s->ok = ok_w;
  }
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int o = src(base + i);
    s->cpu[i] = avail_in[3 * o];
    s->mem[i] = avail_in[3 * o + 1];
    s->gpu[i] = avail_in[3 * o + 2];
  }
  set_range<kThreads>(s, 0, len);
  __syncthreads();
}

template <int kThreads, class Src>
__device__ void store_avail(const Nodes& s, Src src, int* avail_out) {
  __syncthreads();
  for (int i = threadIdx.x; i < s.len; i += kThreads) {
    const int o = src(s.base + i);
    avail_out[3 * o] = s.cpu[i];
    avail_out[3 * o + 1] = s.mem[i];
    avail_out[3 * o + 2] = s.gpu[i];
  }
}

// The node order of a kernel that keeps the input's order.
struct Identity {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};

// Checkpoints of the carried planes for the delta-solve session
// (ops/fifo_session.py, the counterpart of the reference's native
// FifoSession): before the app at queue position p = base + a (a the
// launch's local app), whenever p > 0 and p % stride == 0, the planes go to
// slot p / stride - 1 of `out` ([slots, n, 3] int32, the layout of the
// session's checkpoint buffer: slot j holds the planes before position
// (j + 1) * stride).  A slot past `slots` is never written; `out` null
// writes nothing.
struct Checkpoints {
  int* out;
  int base;
  int stride;
  int slots;
};

// The checkpoint due before local app a, if any: every thread of every
// block of the cluster calls it at the same a (a uniform condition), and
// each block stores its own segment.  store_avail's barrier orders the
// previous app's in-place subtraction before the store; the next write of
// the planes comes after the next app's first exchange, whose block barrier
// every thread reaches only after its part of the store.
template <int kThreads>
__device__ __forceinline__ void store_checkpoint(const Nodes& s, const Checkpoints& c, int a) {
  if (c.out == nullptr) return;
  const int p = c.base + a;
  if (p <= 0 || p % c.stride != 0) return;
  const int slot = p / c.stride - 1;
  if (slot >= c.slots) return;
  store_avail<kThreads>(s, Identity{}, c.out + static_cast<size_t>(slot) * 3 * s.n);
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

// The gang core's driver: idx is its node index as `key` numbers nodes (n
// when the gang does not fit), local its local index in the thread whose
// chunk holds it and -1 in every other thread.
struct Driver {
  int idx;
  int local;
};

// Feasibility and the first driver (pallas_queue._gang_core) over this
// thread's chunk: writes each node's executor capacity to `work` (the
// driver's node keeps the capacity left beside the driver), clamped to
// [0, k], or kUnclamped: the min-frag drain's unclamped capacity (callers
// guard mf_sentinel_safe).  `key(i)` numbers local node i for the (rank,
// node) minimum.
template <bool kUnclamped, class R, class Key>
__device__ Driver gang_core(const Nodes& s, const App& a, R& red, Key key) {
  int part = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    int c = 0;
    if (kUnclamped) {
      const int d = s.ok[i] ? mf_cap(s.cpu[i], s.mem[i], s.gpu[i], a.ec, a.em, a.eg) : 0;
      s.work[i] = d;
      c = clamp_cap(d, a.k);
    } else {
      c = s.ok[i] ? node_cap(s.cpu[i], s.mem[i], s.gpu[i], a.ec, a.em, a.eg, a.k) : 0;
      s.work[i] = c;
    }
    part += c;
  }
  const int total = red.sum(part);

  unsigned long long best = kNoKey;
  int best_i = -1;
  for (int i = s.lo; i < s.hi; ++i) {
    const int r = s.rank[i];
    if (r < kBig && s.cpu[i] >= a.dc && s.mem[i] >= a.dm && s.gpu[i] >= a.dg) {
      const int cd = s.ok[i] ? node_cap(s.cpu[i] - a.dc, s.mem[i] - a.dm, s.gpu[i] - a.dg,
                                        a.ec, a.em, a.eg, a.k)
                             : 0;
      const int c = kUnclamped ? clamp_cap(s.work[i], a.k) : s.work[i];
      if (total - c + cd >= a.k) {
        // flipping the sign bit orders signed ranks as unsigned keys
        const unsigned long long kv =
            (static_cast<unsigned long long>(static_cast<unsigned>(r) ^ 0x80000000u) << 32) |
            static_cast<unsigned>(key(i));
        if (kv < best) {
          best = kv;
          best_i = i;
        }
      }
    }
  }
  const unsigned long long won = red.min(best);
  if (won == kNoKey) return Driver{s.n, -1};  // a candidate's rank is < kBig
  const int local = best == won ? best_i : -1;  // keys are unique: one thread holds it
  if (local >= 0) {
    const int c = s.cpu[local] - a.dc, m = s.mem[local] - a.dm, g = s.gpu[local] - a.dg;
    s.work[local] = !s.ok[local] ? 0
                    : kUnclamped ? mf_cap(c, m, g, a.ec, a.em, a.eg)
                                 : node_cap(c, m, g, a.ec, a.em, a.eg, a.k);
  }
  return Driver{static_cast<int>(won & 0xffffffffu), local};
}

// Tightly-pack fill over a feasible gang_core's capacities:
// work[i] = clip(k - exclusive_cumsum(cap)[i], 0, cap[i]).
template <class R>
__device__ void tightly_fill(const Nodes& s, const App& a, R& red) {
  int part = 0;
  for (int i = s.lo; i < s.hi; ++i) part += s.work[i];
  int run = red.exclusive_scan(part);
  for (int i = s.lo; i < s.hi; ++i) {
    const int c = s.work[i];
    s.work[i] = min(max(a.k - run, 0), c);
    run += c;
  }
}

// The minimal-fragmentation drain (pallas_queue._solve_min_frag after
// _gang_core) for a feasible app, over gang_core<true>'s capacities
// d (the driver subtracted on its node): writes each node's executor count
// to work.  Node order for its ties is s.base + i.
//
// The reference tries the (k+max)/2 subset and then the full set, each a
// drain over value classes: v* = max{v : sum over d >= v of min(d, k) >= k}
// (31 probes of a binary search over [1, kMfSent]), the classes above v*
// drain fully, the first t* = (r-1)/v* nodes at v* drain in node order, and
// the remaining k* go to the smallest remaining capacity >= k*, first index
// among equals.  The subset wins when it fits, so which pass places is
// known from the two passes' totals: only that pass is run.  Let m be the
// pass's largest capacity.  If m >= k, one node alone gives k, so v* = m,
// r = k, t* = 0, k* = k and the drain is the final minimum alone.  Else
// min(d, k) = d on the pass and v* lies in [1, m]: ceil(log2 m) probes find
// it, then one scan gives the drained sum and the class ranks together.
// minfrag_kernel.vstar_short is the same search in plain PyTorch.
template <class R>
__device__ void min_frag_drain(const Nodes& s, const App& a, R& red) {
  const int k = a.k;
  int mx = 0;
  for (int i = s.lo; i < s.hi; ++i) mx = max(mx, s.work[i]);
  const int max_cap = red.max(mx);
  const bool has_sent = max_cap == kMfSent;
  // floor((k + max) / 2) without int32 overflow; >> is floor division by 2
  const int target = (k >> 1) + (max_cap >> 1) + (((k & 1) + (max_cap & 1)) >> 1);
  const bool attempt = has_sent || k < max_cap;
  auto in_subset = [&](int d) {
    return d > 0 && attempt && (has_sent ? d < kMfSent : d < target);
  };

  int2 part2 = make_int2(0, 0);
  int sub_max = 0;
  for (int i = s.lo; i < s.hi; ++i) {
    const int d = s.work[i];
    if (in_subset(d)) {
      part2.x += min(d, k);
      sub_max = max(sub_max, d);
    }
    part2.y += d > 0 ? min(d, k) : 0;
  }
  const int3 totals = red.sum2max(part2, sub_max);
  const bool full_ok = totals.y >= k && k > 0;
  if (!full_ok) {  // no executor is placed
    for (int i = s.lo; i < s.hi; ++i) s.work[i] = 0;
    return;
  }
  const bool use_sub = attempt && totals.x >= k;  // k > 0 here
  auto in_pass = [&](int d) { return use_sub ? in_subset(d) : d > 0; };
  const int m = use_sub ? totals.z : max_cap;

  int vstar = m, tstar = 0, kstar = k, at_before = 0;
  if (m < k) {
    int lo = 1, hi = m;
    while (lo < hi) {  // uniform: every thread holds the same bounds
      const int mid = lo + (hi - lo + 1) / 2;
      int part = 0;
      for (int i = s.lo; i < s.hi; ++i) {
        const int d = s.work[i];
        part += in_pass(d) && d >= mid ? d : 0;
      }
      if (red.sum(part) >= k) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    vstar = lo;
    int2 at_drained = make_int2(0, 0);
    for (int i = s.lo; i < s.hi; ++i) {
      const int d = s.work[i];
      if (!in_pass(d)) continue;
      at_drained.x += d == vstar;
      at_drained.y += d > vstar ? d : 0;
    }
    const int2 scan = red.scan_sum(at_drained);
    at_before = scan.x;
    const int r = k - scan.y;
    tstar = max(r - 1, 0) / vstar;
    kstar = r - tstar * vstar;
  }

  // the final placement: smallest remaining capacity >= k*, first index (a
  // feasible pass always has one: some node at v* is left, and v* >= k*)
  unsigned long long best = kNoKey;
  int run = at_before;
  for (int i = s.lo; i < s.hi; ++i) {
    const int d = s.work[i];
    if (!in_pass(d)) continue;
    const bool at = d == vstar;
    const bool drained = d > vstar || (at && run < tstar);
    run += at;
    if (!drained && d >= kstar) {
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned>(d)) << 32) |
          static_cast<unsigned>(s.base + i);
      best = key < best ? key : best;
    }
  }
  best = red.min(best);
  const int partial = best == kNoKey ? -1 : static_cast<int>(best & 0xffffffffu);

  run = at_before;
  for (int i = s.lo; i < s.hi; ++i) {
    const int d = s.work[i];
    int count = 0;
    if (in_pass(d)) {
      const bool at = d == vstar;
      if (d > vstar || (at && run < tstar)) count = d;
      run += at;
    }
    s.work[i] = count + (s.base + i == partial ? kstar : 0);
  }
}

// Adds this thread's share of an app's usage to *usage before
// subtract_usage applies it: 2 for each node with work[i] > 0, + 1 when
// the driver's node (local index `driver`, -1 when not in this chunk) has
// none.  The sum is only read after the launch: a fire-and-forget add.
__device__ __forceinline__ void add_usage(const Nodes& s, int driver, int* usage) {
  int v = 0;
  for (int i = s.lo; i < s.hi; ++i) v += s.work[i] > 0 ? 2 : (i == driver ? 1 : 0);
  if (v) atomicAdd(usage, v);
}

// The reference's usage subtraction over this thread's chunk: one
// executor's worth on every node with work[i] > 0, else the driver on the
// driver's node (local index `driver`, -1 when not in this chunk).
__device__ __forceinline__ void subtract_usage(const Nodes& s, const App& a, int driver) {
  for (int i = s.lo; i < s.hi; ++i) {
    if (s.work[i] > 0) {
      s.cpu[i] -= a.ec;
      s.mem[i] -= a.em;
      s.gpu[i] -= a.eg;
    } else if (i == driver) {
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

// Launches `kernel` as clusters of `cluster` blocks (grid = one cluster) of
// `threads` threads with `smem` dynamic shared bytes on `stream`.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, int threads, long long smem,
                           void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gang
