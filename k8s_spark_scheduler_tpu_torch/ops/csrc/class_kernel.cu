// Class-compressed whole-FIFO-queue pass (tightly-pack, distribute-evenly,
// minimal fragmentation) for Hopper.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the reference
// package's native class solver (native/fifo_solver.cpp: class_rebuild,
// class_absorb, step_app_plain_classes, step_app_minfrag_classes,
// fifo_solve_queue_classes, the session's class mode), which the port may
// not carry as a host lane.  Its decisions and planes equal the row kernels'
// (queue_kernel.cu, minfrag_kernel.cu) byte for byte; ops/class_kernel.py
// holds the plain version and says how a step runs.  The rule, as the
// reference's: nodes with equal (a0, a1, a2, exec_ok) form a class; a node a
// placement wrote moves to the overlay; the partition is rebuilt when the
// overlay holds more than max(512, n / 64) nodes.
//
// Bound.  As in the row kernels, the apps depend on each other through the
// carry, so the pass is a chain of per-app steps; the bytes and operations
// the function needs are tiny (each node's triple read and written once,
// each app's formulas once per class).  What bounds it is the latency of the
// chain: per app a handful of block reductions and short gathers.  The
// design cuts the work on the chain from O(nodes) to O(classes + overlay +
// the nodes a fill walks past): the row kernel's per-app walks over every
// node and its cluster exchanges give way to one block's walks over the
// class records, the overlay and a short node window.
//
// Design.  One block of kThreads threads; the partition lives in global
// memory (it is the session's, kept between launches): node -> class (-1:
// overlay), a 32-byte record a class (triple, exec_ok, live members, a
// lower bound lb of its first live member, the app's value), the overlay's
// node ids, per-node scratch.  Per app:
//   values:  each class's value (once per class) and each overlay node's;
//            one reduction gives the capacity total and the fill's start;
//   probe:   the candidates in rank order, kThreads at a time, a reduction
//            a chunk, stopping at the first chunk that holds a fit;
//   take:    node ids upward from the start, kThreads at a time, a block
//            scan of the selected nodes' weights; a taken node gets one
//            executor subtracted and moves to the overlay (absorb);
//   min-frag: reductions over the holders (classes, overlay, the driver's
//            node) decide the attempt and each drain round; each round is
//            one take.
// The rebuild is one O(n) pass: an open-addressing hash of the keys in
// global memory (a node claims an empty slot with atomicCAS), class ids in
// the order threads claim them, live counts and lower bounds by atomics.
// Reads of what atomics write (the table, live counts, lower bounds) go
// through L2 (__ldcg).

#include "gang_common.cuh"

namespace {

using namespace gang;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 8;  // a class record: a0 a1 a2 eok live lb val -
enum { kA0, kA1, kA2, kEok, kLive, kLb, kVal };
enum { kClasses, kOverlay, kClassesLast, kRebuilds, kOverlayPeak, kClassesInitial };
enum { kTightly, kEvenly, kMinFrag };
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// native clamped_cap: the executor capacity in [0, k]
__device__ __forceinline__ int clamped(int a0, int a1, int a2, const int* e, int k) {
  const int v = min(min(dim_cap(a0, e[0], kBig), dim_cap(a1, e[1], kBig)), dim_cap(a2, e[2], kBig));
  return max(min(v, k), 0);
}

// native mf_cap_one: the unclamped capacity of the min-frag drain, >= 0
__device__ __forceinline__ int unclamped(int a0, int a1, int a2, const int* e) {
  return mf_cap(a0, a1, a2, e[0], e[1], e[2]);
}

struct Agg {
  long long sum;
  int lo;   // a minimum
  int lo2;  // another minimum
  int hi;   // a maximum
};

__device__ __forceinline__ Agg agg0() { return Agg{0, kNone, kNone, 0}; }

__device__ __forceinline__ Agg combine(Agg a, const Agg& b) {
  a.sum += b.sum;
  a.lo = min(a.lo, b.lo);
  a.lo2 = min(a.lo2, b.lo2);
  a.hi = max(a.hi, b.hi);
  return a;
}

struct Shared {
  Agg agg[kWarps];
  long long scan[kWarps];
  int capd;         // cap'_d
  int last;         // the last node a take took
  int ov_count;     // overlay size
  int nclasses;
  int didx_taken;   // the driver's node was taken (it hosts an executor)
  int didx_member;  // the driver's node's class while it is a live member, else -1
};

// The block's state; every thread holds the same scalars.
struct Ctx {
  Shared* sh;
  int* planes;  // [n, 3], the carry
  const uint8_t* eok;
  int* node_cls;
  int* cls;
  int* ov;
  int* node_val;
  int* slot;
  int* table;
  int mask;
  int n;
  // the app
  int d[3], e[3], k;
  int policy;
  int didx, dval;  // the driver's node and its value (cap'_d, or min-frag's)
};

__device__ Agg block_agg(Agg v, Shared* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Agg o;
    o.sum = __shfl_xor_sync(kFull, v.sum, off);
    o.lo = __shfl_xor_sync(kFull, v.lo, off);
    o.lo2 = __shfl_xor_sync(kFull, v.lo2, off);
    o.hi = __shfl_xor_sync(kFull, v.hi, off);
    v = combine(v, o);
  }
  if (lane == 0) sh->agg[warp] = v;
  __syncthreads();
  Agg r = agg0();
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) r = combine(r, sh->agg[w]);
  __syncthreads();
  return r;
}

// The block's exclusive prefix of x in thread order; *total gets the sum.
__device__ long long block_scan(long long x, Shared* sh, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh->scan[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) {
    const long long s = sh->scan[w];
    all += s;
    if (w < warp) before += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - x;
}

__device__ __forceinline__ int live_of(const Ctx& c, int cid) { return __ldcg(c.cls + cid * kFields + kLive); }
__device__ __forceinline__ int lb_of(const Ctx& c, int cid) { return __ldcg(c.cls + cid * kFields + kLb); }

// A node's value for the app: its class's, its overlay entry's, or on the
// driver's node the driver-adjusted one (0 once taken).
__device__ __forceinline__ int node_value(const Ctx& c, int i) {
  if (i == c.didx) return c.sh->didx_taken ? 0 : c.dval;
  const int cid = c.node_cls[i];
  return cid >= 0 ? c.cls[cid * kFields + kVal] : c.node_val[i];
}

// The node leaves its class for the overlay (one thread a node).
__device__ void absorb(const Ctx& c, int i) {
  const int cid = c.node_cls[i];
  if (cid >= 0) {
    atomicSub(c.cls + cid * kFields + kLive, 1);
    c.node_cls[i] = -1;
    c.ov[atomicAdd(&c.sh->ov_count, 1)] = i;
  }
  c.node_val[i] = 0;
  if (i == c.didx) {
    c.sh->didx_taken = 1;
    c.sh->didx_member = -1;
  }
}

// class_rebuild: the partition from the planes; the overlay empties.
__device__ void rebuild(const Ctx& c, long long* meta) {
  const int t0 = threadIdx.x;
  for (int s = t0; s <= c.mask; s += kThreads) c.table[s] = -1;
  if (t0 == 0) c.sh->nclasses = 0;
  __syncthreads();
  for (int i = t0; i < c.n; i += kThreads) {
    const int a0 = c.planes[3 * i], a1 = c.planes[3 * i + 1], a2 = c.planes[3 * i + 2];
    const uint8_t ok = c.eok[i];
    unsigned long long h = static_cast<unsigned>(a0);
    h = h * 0x9E3779B97F4A7C15ull + static_cast<unsigned>(a1);
    h = h * 0x9E3779B97F4A7C15ull + static_cast<unsigned>(a2);
    h = h * 0x9E3779B97F4A7C15ull + ok;
    h ^= h >> 29;
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 32;
    int s = static_cast<int>(h & static_cast<unsigned long long>(c.mask));
    while (true) {
      int held = __ldcg(c.table + s);
      if (held < 0) held = atomicCAS(c.table + s, -1, i);
      if (held < 0 || (c.planes[3 * held] == a0 && c.planes[3 * held + 1] == a1 &&
                       c.planes[3 * held + 2] == a2 && c.eok[held] == ok)) {
        c.slot[i] = s;
        break;
      }
      s = (s + 1) & c.mask;
    }
  }
  __syncthreads();
  // each slot's first claimant numbers its class
  for (int i = t0; i < c.n; i += kThreads) {
    const int s = c.slot[i];
    if (__ldcg(c.table + s) == i) {
      const int cid = atomicAdd(&c.sh->nclasses, 1);
      int* r = c.cls + cid * kFields;
      r[kA0] = c.planes[3 * i];
      r[kA1] = c.planes[3 * i + 1];
      r[kA2] = c.planes[3 * i + 2];
      r[kEok] = c.eok[i];
      r[kLive] = 0;
      r[kLb] = kBig;
      r[kVal] = 0;
      c.table[s] = -2 - cid;
    }
  }
  __syncthreads();
  for (int i = t0; i < c.n; i += kThreads) {
    const int cid = -2 - __ldcg(c.table + c.slot[i]);
    c.node_cls[i] = cid;
    atomicAdd(c.cls + cid * kFields + kLive, 1);
    atomicMin(c.cls + cid * kFields + kLb, i);
  }
  __syncthreads();
  if (t0 == 0) {
    c.sh->ov_count = 0;
    meta[kClassesLast] = c.sh->nclasses;
    meta[kRebuilds] += 1;
  }
  __syncthreads();
}

// Walk nodes [lo, n) upward, kThreads at a time: take each selected node
// (select(v) on its value v) while the weights of the selected nodes before
// it sum below `limit`.  A taken node loses one executor and is absorbed.
// Returns the last node taken (-1: none).
template <class Select, class Weight>
__device__ int take(const Ctx& c, int lo, long long limit, Select select, Weight weight) {
  if (threadIdx.x == 0) c.sh->last = -1;
  __syncthreads();
  if (limit <= 0) return -1;
  long long cum = 0;
  for (int base = lo; base < c.n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool sel = false;
    long long w = 0;
    if (i < c.n) {
      const int v = node_value(c, i);
      sel = select(v);
      w = sel ? weight(v) : 0;
    }
    long long total;
    const long long before = cum + block_scan(w, c.sh, &total);
    if (sel && before < limit) {
      c.planes[3 * i] = wsub(c.planes[3 * i], c.e[0]);
      c.planes[3 * i + 1] = wsub(c.planes[3 * i + 1], c.e[1]);
      c.planes[3 * i + 2] = wsub(c.planes[3 * i + 2], c.e[2]);
      absorb(c, i);
      atomicMax(&c.sh->last, i);
    }
    cum += total;
    if (cum >= limit) break;  // uniform
  }
  __syncthreads();
  return c.sh->last;
}

// No live member of the classes whose value satisfies `which` lies at or
// below `last` any more: their lower bounds rise past it.
template <class Which>
__device__ void raise_bounds(const Ctx& c, int last, Which which) {
  if (last < 0) return;
  const int nc = c.sh->nclasses;
  for (int cid = threadIdx.x; cid < nc; cid += kThreads) {
    int* r = c.cls + cid * kFields;
    if (which(r[kVal]) && lb_of(c, cid) <= last) r[kLb] = last + 1;
  }
  __syncthreads();
}

// Step 2: the first candidate in rank order that takes the driver and leaves
// k executors of capacity; sets c.didx (-1: none) and the block's capd.
__device__ void probe(Ctx& c, const int* cand, int n_cand, long long total, bool clamp_value) {
  c.didx = -1;
  if (total < c.k) return;
  for (int base = 0; base < n_cand; base += kThreads) {
    const int t = base + threadIdx.x;
    Agg g = agg0();
    int cwd = 0;
    if (t < n_cand) {
      const int i = cand[t];
      const int a0 = c.planes[3 * i], a1 = c.planes[3 * i + 1], a2 = c.planes[3 * i + 2];
      if (a0 >= c.d[0] && a1 >= c.d[1] && a2 >= c.d[2]) {
        cwd = c.eok[i] ? clamped(wsub(a0, c.d[0]), wsub(a1, c.d[1]), wsub(a2, c.d[2]), c.e, c.k) : 0;
        const int cid = c.node_cls[i];
        int capi = cid >= 0 ? c.cls[cid * kFields + kVal] : c.node_val[i];
        if (clamp_value) capi = max(min(capi, c.k), 0);
        if (total - capi + cwd >= c.k) g.lo = t;
      }
    }
    g = block_agg(g, c.sh);
    if (g.lo != kNone) {
      if (t == g.lo) c.sh->capd = cwd;
      __syncthreads();
      c.didx = cand[g.lo];
      c.dval = c.sh->capd;
      return;
    }
  }
}

// Step 1: each class's value into its record and each overlay node's into
// node_val.  Returns the capacity total (values clamped to [0, k] under
// min-frag) in .sum and, for the plain policies, the least lower bound of a
// class or overlay node with a positive value in .lo.
__device__ Agg values(const Ctx& c) {
  Agg g = agg0();
  const bool mf = c.policy == kMinFrag;
  const int nc = c.sh->nclasses;
  for (int cid = threadIdx.x; cid < nc; cid += kThreads) {
    int* r = c.cls + cid * kFields;
    const int v = !r[kEok] ? 0 : mf ? unclamped(r[kA0], r[kA1], r[kA2], c.e) : clamped(r[kA0], r[kA1], r[kA2], c.e, c.k);
    r[kVal] = v;
    const int live = live_of(c, cid);
    g.sum += static_cast<long long>(mf ? max(min(v, c.k), 0) : v) * live;
    if (v > 0 && live > 0) g.lo = min(g.lo, lb_of(c, cid));
  }
  const int nov = c.sh->ov_count;
  for (int j = threadIdx.x; j < nov; j += kThreads) {
    const int i = c.ov[j];
    const int a0 = c.planes[3 * i], a1 = c.planes[3 * i + 1], a2 = c.planes[3 * i + 2];
    const int v = !c.eok[i] ? 0 : mf ? unclamped(a0, a1, a2, c.e) : clamped(a0, a1, a2, c.e, c.k);
    c.node_val[i] = v;
    g.sum += mf ? max(min(v, c.k), 0) : v;
    if (v > 0) g.lo = min(g.lo, i);
  }
  return block_agg(g, c.sh);
}

// Visit every holder of the min-frag step: each class with live members
// other than the driver's node (value, multiplicity, lower bound), each
// overlay node but the driver's (value, 1, node), the driver's node with its
// own value until it is taken.
template <class F>
__device__ void for_holders(const Ctx& c, F f) {
  const int nc = c.sh->nclasses;
  const int member = c.sh->didx_member;
  for (int cid = threadIdx.x; cid < nc; cid += kThreads) {
    const int live = live_of(c, cid) - (cid == member ? 1 : 0);
    if (live > 0) f(c.cls[cid * kFields + kVal], live, lb_of(c, cid));
  }
  const int nov = c.sh->ov_count;
  for (int j = threadIdx.x; j < nov; j += kThreads) {
    const int i = c.ov[j];
    if (i != c.didx) f(c.node_val[i], 1, i);
  }
  if (threadIdx.x == 0 && !c.sh->didx_taken) f(c.dval, 1, c.didx);
}

// The first t holders of value v in node order.
__device__ void take_value(const Ctx& c, int v, long long t) {
  Agg g = agg0();
  for_holders(c, [&](int x, int, int start) {
    if (x == v) g.lo = min(g.lo, start);
  });
  g = block_agg(g, c.sh);
  const int last = take(c, g.lo, t, [v](int x) { return x == v; }, [](int) { return 1LL; });
  raise_bounds(c, last, [v](int x) { return x == v; });
}

// Σ value x multiplicity over the holders with 0 < value < bound.
__device__ long long value_sum(const Ctx& c, long long bound) {
  Agg g = agg0();
  for_holders(c, [&](int x, int m, int) {
    if (x > 0 && x < bound) g.sum += static_cast<long long>(x) * m;
  });
  return block_agg(g, c.sh).sum;
}

// The value-ordered drain over the holders with values in (0, bound); the
// caller knows it succeeds (value_sum(bound) >= k).
__device__ void drain(const Ctx& c, long long bound) {
  long long rem = c.k, ceiling = bound;
  while (true) {
    Agg g = agg0();  // .hi: the largest value; .lo: the smallest >= rem
    for_holders(c, [&](int x, int, int) {
      if (x > 0 && x < ceiling) {
        g.hi = max(g.hi, x);
        if (x >= rem) g.lo = min(g.lo, x);
      }
    });
    g = block_agg(g, c.sh);
    const int maxv = g.hi;
    if (rem <= maxv) {  // instant fit
      take_value(c, g.lo, 1);
      return;
    }
    Agg h = agg0();
    for_holders(c, [&](int x, int m, int) {
      if (x == maxv) h.sum += m;
    });
    const long long cnt = block_agg(h, c.sh).sum;
    const long long t = min(cnt, rem / maxv);
    take_value(c, maxv, t);
    rem -= t * maxv;
    if (rem == 0) return;
    if (t < cnt) {
      Agg f = agg0();
      for_holders(c, [&](int x, int, int) {
        if (x >= rem && x < ceiling) f.lo = min(f.lo, x);
      });
      take_value(c, block_agg(f, c.sh).lo, 1);
      return;
    }
    ceiling = maxv;
  }
}

__device__ void step_min_frag(Ctx& c, const int* cand, int n_cand) {
  const Agg tot = values(c);
  probe(c, cand, n_cand, tot.sum, true);
  if (c.didx < 0) return;
  const int i = c.didx;
  c.dval = c.eok[i] ? unclamped(wsub(c.planes[3 * i], c.d[0]), wsub(c.planes[3 * i + 1], c.d[1]),
                                wsub(c.planes[3 * i + 2], c.d[2]), c.e)
                    : 0;
  if (threadIdx.x == 0) c.sh->didx_member = c.node_cls[i];
  __syncthreads();
  const int k = c.k;
  if (k <= 0) return;
  Agg g = agg0();  // .hi max, .lo min >= k, .lo2 min > 0, .sum Σ positive values
  for_holders(c, [&](int x, int m, int) {
    g.hi = max(g.hi, x);
    if (x >= k) g.lo = min(g.lo, x);
    if (x > 0) {
      g.lo2 = min(g.lo2, x);
      g.sum += static_cast<long long>(x) * m;
    }
  });
  g = block_agg(g, c.sh);
  const int maxc = g.hi;
  if (maxc <= 0) return;
  const bool has_sent = maxc == kMfSent;
  const bool attempt = has_sent || k < maxc;
  const long long target =
      has_sent ? static_cast<long long>(kMfSent) : (attempt ? (static_cast<long long>(k) + maxc) / 2 : 0);
  const int min_ge = g.lo == kNone ? kBig : g.lo;
  const int min_pos = g.lo2 == kNone ? kBig : g.lo2;
  const bool have_ge = min_ge != kBig && min_ge >= k;
  if (attempt && have_ge && min_ge < target) {
    take_value(c, min_ge, 1);
  } else if (attempt && min_pos != kBig && min_pos < target && value_sum(c, target) >= k) {
    drain(c, target);
  } else if (have_ge) {
    take_value(c, min_ge, 1);
  } else if (g.sum >= k) {
    drain(c, kBig);
  }
}

__device__ void step_plain(Ctx& c, const int* cand, int n_cand) {
  const Agg tot = values(c);
  probe(c, cand, n_cand, tot.sum, false);
  if (c.didx < 0 || c.k <= 0) return;
  const int lo = min(tot.lo, c.didx);
  const int last = c.policy == kEvenly
                       ? take(c, lo, c.k, [](int v) { return v > 0; }, [](int) { return 1LL; })
                       : take(c, lo, c.k, [](int v) { return v > 0; }, [](int v) { return static_cast<long long>(v); });
  raise_bounds(c, last, [](int v) { return v > 0; });
}

__global__ void __launch_bounds__(kThreads, 1)
fifo_queue_classes_kernel(const int* avail_in,   // [N, 3]
                          const int* cand,       // [M] candidates in (rank, node) order
                          int n_cand,
                          const uint8_t* eok,    // [N]
                          const int* apps,       // [A, 8]
                          int n, int n_apps, int policy, int rebuild_first,
                          uint8_t* feasible_out,  // [A]
                          int* driver_idx_out,    // [A]
                          int* planes,            // [N, 3] out: the carry
                          int* node_cls, int* cls, int* ov, int* node_val, int* slot, int* table,
                          long long* meta, int mask, Checkpoints chk) {
  __shared__ Shared sh;
  Ctx c;
  c.sh = &sh;
  c.planes = planes;
  c.eok = eok;
  c.node_cls = node_cls;
  c.cls = cls;
  c.ov = ov;
  c.node_val = node_val;
  c.slot = slot;
  c.table = table;
  c.mask = mask;
  c.n = n;
  c.policy = policy;
  for (int x = threadIdx.x; x < 3 * n; x += kThreads) planes[x] = avail_in[x];
  if (threadIdx.x == 0) {
    sh.nclasses = static_cast<int>(meta[kClasses]);
    sh.ov_count = static_cast<int>(meta[kOverlay]);
  }
  __syncthreads();
  if (rebuild_first && n > 0) {
    rebuild(c, meta);
    if (threadIdx.x == 0) meta[kClassesInitial] = sh.nclasses;
  }
  const int limit = max(512, n / 64);
  const bool writer = threadIdx.x == 0;

  for (int a = 0; a < n_apps; ++a) {
    if (chk.out != nullptr) {
      const int p = chk.base + a;
      if (p > 0 && p % chk.stride == 0 && p / chk.stride - 1 < chk.slots) {
        int* out = chk.out + static_cast<size_t>(p / chk.stride - 1) * 3 * n;
        for (int x = threadIdx.x; x < 3 * n; x += kThreads) out[x] = planes[x];
      }
    }
    const int* row = apps + 8 * a;
    if (writer) {
      feasible_out[a] = 0;
      driver_idx_out[a] = n;
    }
    if (!row[7] || n == 0) continue;  // uniform
    c.d[0] = row[0];
    c.d[1] = row[1];
    c.d[2] = row[2];
    c.e[0] = row[3];
    c.e[1] = row[4];
    c.e[2] = row[5];
    c.k = row[6];
    c.didx = -1;
    c.dval = 0;
    if (writer) {
      sh.didx_taken = 0;
      sh.didx_member = -1;
    }
    __syncthreads();
    if (policy == kMinFrag) {
      step_min_frag(c, cand, n_cand);
    } else {
      step_plain(c, cand, n_cand);
    }
    if (c.didx < 0) continue;  // uniform; an infeasible app changes nothing
    __syncthreads();
    if (writer) {
      feasible_out[a] = 1;
      driver_idx_out[a] = c.didx;
      if (!sh.didx_taken) {
        const int i = c.didx;
        planes[3 * i] = wsub(planes[3 * i], c.d[0]);
        planes[3 * i + 1] = wsub(planes[3 * i + 1], c.d[1]);
        planes[3 * i + 2] = wsub(planes[3 * i + 2], c.d[2]);
        absorb(c, i);
      }
      if (sh.ov_count > meta[kOverlayPeak]) meta[kOverlayPeak] = sh.ov_count;
    }
    __syncthreads();
    if (sh.ov_count > limit) rebuild(c, meta);  // uniform
  }
  __syncthreads();
  if (writer) {
    meta[kClasses] = sh.nclasses;
    meta[kOverlay] = sh.ov_count;
  }
}

}  // namespace

// Launches the kernel on `stream` on the current device as one block.  The
// class state (node_cls [n], cls [max(n, 1), 8], ov [n], node_val [n], slot
// [n], table [mask + 1], meta [8] int64) is read and updated in place; with
// rebuild_first the partition is built from avail first.  chk_out ([chk_slots,
// n, 3] int32, or null) gets the checkpoints of queue_kernel.cu's launch.
// Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_classes_launch(const int* avail, const int* cand, int n_cand,
                                         const uint8_t* exec_ok, const int* apps, int n,
                                         int n_apps, int policy, int rebuild_first,
                                         uint8_t* feasible_out, int* driver_idx_out,
                                         int* avail_out, int* node_cls, int* cls, int* ov,
                                         int* node_val, int* slot, int* table, long long* meta,
                                         int mask, int chk_base, int chk_stride, int chk_slots,
                                         int* chk_out, void* stream) {
  if (chk_out != nullptr && (chk_stride <= 0 || chk_base < 0)) return cudaErrorInvalidValue;
  if (policy < kTightly || policy > kMinFrag) return cudaErrorInvalidValue;
  fifo_queue_classes_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      avail, cand, n_cand, exec_ok, apps, n, n_apps, policy, rebuild_first, feasible_out,
      driver_idx_out, avail_out, node_cls, cls, ov, node_val, slot, table, meta, mask,
      Checkpoints{chk_out, chk_base, chk_stride, chk_slots});
  return cudaGetLastError();
}
