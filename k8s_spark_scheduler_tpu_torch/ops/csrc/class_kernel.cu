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
// Bound.  The apps depend on each other through the carry, so the pass is a
// chain of per-app steps, and the bytes and operations the function needs
// are tiny (each node's triple read and written once, each app's formulas
// once per class).  What bounds it on this card is the latency of one app's
// step: its dependent memory round trips, its block-wide barriers and the
// dependent arithmetic between them.  A round trip to L2 costs some 300-600
// cycles, a barrier with the reductions around it a few hundred more, and
// an int32 division by a runtime divisor ~100; the design counts all three.
//
// Design.  One block of kThreads = 256 threads (the code takes the block
// size as a template argument; at 512 and 1,024 threads, measured, the
// registers spill at their caps and the steps run slower).
//   The partition in shared memory while it fits: the class records as
//   separate arrays of their fields (a0 a1 a2 exec_ok live lb value), the
//   overlay as its node ids with a mirror of their planes, exec_ok and
//   value.  Loaded at the launch's start (or built by a rebuild), written
//   back to the session's ClassState at its end.  Accesses go through
//   generic pointers chosen at each (re)build by the class count (the
//   atomics on live and lb through shared-space ones): records that do not
//   fit stay in the state's [n, 8] rows in global memory, an overlay that
//   does not fit uses the state's `ovx` scratch.  Same code, same answers,
//   no fallback.
//   The chain reads no plane: a node's triple is its class's or its
//   overlay mirror's, so the steps write the planes and never read them.
//   A node's code in node_cls is its class id, or -2 - its overlay
//   position while the launch runs (-1 again at its end, the state's
//   layout), so its value is one shared read away.  Each thread keeps its
//   first-chunk candidate's code in a register, refreshed from the overlay
//   entries an app adds and after a rebuild; pass A prefetches the node
//   codes of the window where the last app's first take began.  The
//   prologue turns every app's executor request into multiply-shift
//   divisions (`divs`), prefetched with the app's row.
//   Where the records may lie in global memory, the passes over the classes
//   load kGlobalBatch classes a thread before storing, so that many round
//   trips are in flight; in shared memory one class at a time.
//   Reductions are warp redux instructions, then one barrier, then each warp
//   reduces the warps' partials again (two buffers in turn, so no barrier
//   closes a reduction).  Sums saturate exactly (32-bit halves) where the
//   only question is "at least k".
//   Per app (tightly-pack, distribute-evenly), three barriers:
//     pass A  the values of the classes and the overlay, the capacity total,
//             the fill's start, and the first T candidates' (capacity -
//             capacity with the driver, fit) in one pass; the first fitting
//             candidate follows from the warps' minima and two ballots over
//             shared memory, with no second reduction;
//     take    node ids upward from the start, 1,024 a step (kChunk / T a
//             thread, a vector load of their codes), a warp scan and one
//             barrier a step; a taken node loses one executor and moves to
//             the overlay; the driver's node is finished by its walker;
//             one barrier closes the take.
//   The lower bounds of the classes a take walked through rise in the next
//   pass over the classes (by the same thread, so no barrier).
//   Minimal fragmentation: one pass over the holders (classes, overlay, the
//   driver's node) gives a drain round everything it needs: the largest
//   value with its count and least start, the least value >= rem with its
//   least start, the least positive value and the capacity sum below a
//   bound; a take of value v starts from the start that pass found.
// The rebuild is one O(n) pass: an open-addressing hash of the keys in
// global memory (a node claims an empty slot with atomicCAS), class ids in
// the order threads claim them; with the class count known the records go
// to shared memory or stay global, then live counts and lower bounds by
// atomics.  Reads of what global atomics write go through L2 (__ldcg, or a
// volatile load through a generic pointer).
//
// Shared memory: sizeof(Shared<T>) = 36 T + 2,080 bytes static (the
// candidate records, two buffers; the first T candidate ids; the reduction
// buffers), and the launch's dynamic `smem_bytes` (at most 227 KB less the
// static part) for the overlay (24 bytes an entry, capacity min(n, the
// rebuild limit + the launch's largest k + 2)) and the classes (28 bytes a
// class): at 256 threads and 20,480 nodes some 7,450 classes.
// ops/class_kernel.py computes both sizes and mirrors the placement rule.

#include "gang_common.cuh"

namespace {

using namespace gang;

constexpr int kFields = 8;  // a ClassState.cls row: a0 a1 a2 eok live lb val -
enum { kA0, kA1, kA2, kEok, kLive, kLb, kVal };
enum { kClasses, kOverlay, kClassesLast, kRebuilds, kOverlayPeak, kClassesInitial, kSharedPlacements,
       kGlobalPlacements };
enum { kTightly, kEvenly, kMinFrag };
constexpr int kNone = 0x7fffffff;
constexpr int kThreads = 256;     // the block (512 or 1,024 measured slower: they spill registers)
constexpr int kChunk = 1024;      // nodes a take walks per block-wide step
constexpr int kClassWords = 7;    // a class in shared memory: a0 a1 a2 eok live lb val
constexpr int kOverlayWords = 6;  // an overlay entry: node a0 a1 a2 eok val
constexpr int kRedFields = 8;
// classes a thread loads at once in a pass over the classes: 4 where they
// may lie in global memory (4 round trips in flight), 1 in shared memory
// (where the registers 4 would take cost more than the latency saved)
constexpr int kGlobalBatch = 4;

template <int T>
struct Shared {
  // the candidates of one chunk: (capacity - capacity with the driver,
  // capacity with the driver or -1: no fit, the driver's min-frag value,
  // the node's code), two buffers in turn
  int4 cand_rec[2][T];
  int cand_id[T];                  // the first T candidates' node ids
  int red[2][kRedFields][32];      // the warps' partials of a reduction
  int ov_count;
  int nclasses;
  int didx_taken[2];  // the driver's node hosts an executor (it was taken), two slots in turn
  int last[2];        // the last node a take took, two slots in turn
};

constexpr int static_smem_bytes(int t) { return 36 * t + 2080; }

// the launch's dynamic shared memory: the overlay's arrays, then the classes'
extern __shared__ int4 dyn_smem[];
__device__ __forceinline__ int* dyn_ints() { return reinterpret_cast<int*>(dyn_smem); }
static_assert(sizeof(Shared<kThreads>) == static_smem_bytes(kThreads), "ops/class_kernel.py mirrors this size");

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Division by one app's request in one dimension, as dim_cap divides: a
// zero request (sh -2), a divisor of 1 (sh -1, also a negative request),
// else floor(a / d) = umulhi(a, m) >> sh for 0 <= a < 2^31, with m =
// ceil(2^(31 + l) / d), l = ceil(log2 d) (Granlund-Montgomery, N = 31).
// Made once a launch for every app (the prologue), so the steps multiply.
struct Div {
  unsigned m;
  int sh;
};

__device__ __forceinline__ Div make_div(int req) {
  if (req == 0) return Div{0u, -2};
  if (req <= 1) return Div{0u, -1};
  const unsigned d = static_cast<unsigned>(req);
  const int l = 32 - __clz(d - 1);
  return Div{static_cast<unsigned>(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

// dim_cap with a made division.  A negative availability gives a value
// <= 0, not dim_cap's exact quotient: every caller clamps at 0, where both
// agree.
__device__ __forceinline__ int cap_dim(int a, Div v, int unbounded) {
  if (v.sh == -2) return a >= 0 ? unbounded : 0;
  if (a <= 0 || v.sh == -1) return a;
  return static_cast<int>(__umulhi(static_cast<unsigned>(a), v.m) >> v.sh);
}

// native clamped_cap: the executor capacity in [0, k]
__device__ __forceinline__ int clamped(int a0, int a1, int a2, const Div* dv, int k) {
  const int v = min(min(cap_dim(a0, dv[0], kBig), cap_dim(a1, dv[1], kBig)), cap_dim(a2, dv[2], kBig));
  return max(min(v, k), 0);
}

// native mf_cap_one: the unclamped capacity of the min-frag drain, >= 0
__device__ __forceinline__ int unclamped(int a0, int a1, int a2, const Div* dv) {
  const int v = min(min(cap_dim(a0, dv[0], kMfSent), cap_dim(a1, dv[1], kMfSent)), cap_dim(a2, dv[2], kMfSent));
  return max(v, 0);
}

// a field that global atomics may have written (L1 may hold a stale line)
__device__ __forceinline__ int ld_v(const int* p) { return *reinterpret_cast<const volatile int*>(p); }

__device__ __forceinline__ unsigned sat32(unsigned long long s) {
  return s > 0xffffffffull ? 0xffffffffu : static_cast<unsigned>(s);
}

// The warp's sum of v, saturated at 2^32 - 1 (exact below it).
__device__ __forceinline__ unsigned warp_sat_sum(unsigned v) {
  const unsigned hi = __reduce_add_sync(kFull, v >> 16);
  const unsigned lo = __reduce_add_sync(kFull, v & 0xffffu);
  return sat32((static_cast<unsigned long long>(hi) << 16) + lo);
}

// a + b for a, b in [0, kBig], saturated at kBig
__device__ __forceinline__ int sat_add(int a, int b) {
  const unsigned s = static_cast<unsigned>(a) + static_cast<unsigned>(b);
  return s > static_cast<unsigned>(kBig) ? kBig : static_cast<int>(s);
}

// the warp's inclusive prefix of x in lane order, saturated at kBig
__device__ __forceinline__ int warp_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = sat_add(x, y);
  }
  return x;
}

// The partition's fields: field f of class cid at c<f>[cid * cs], entry
// j's overlay fields at o<f>[j].
struct Part {
  int *ca0, *ca1, *ca2, *ceok, *clive, *clb, *cval;
  int cs;
  int *oid, *oa0, *oa1, *oa2, *oeok, *oval;
};

// The block's state; every thread holds the same scalars.
struct Ctx {
  Part g;  // the partition through generic pointers (shared or global memory)
  int live_off, lb_off;  // with cs == 1: where live and lb start in dyn_ints() (shared atomics)
  int cls_off, nc_s;     // with cs == 1: where the records start in dyn_ints(), and their count
  int ov_cap;            // the overlay's capacity (in dyn_ints() from 0, when it fits)
  int* planes;  // [n, 3], the carry (written by the steps, read by the candidates and the rebuild)
  const uint8_t* eok;
  int* node_cls;  // class id, or -2 - overlay position
  int n;
  // the app
  int d[3], e[3], k;
  Div dv[3];  // its executor request's divisions
  int policy;
  int didx, dval, dcode;  // the driver's node, its value, its code at the probe
  int dtaken;             // the driver's node was taken (as of the last take)
  int dslot;              // the app's didx_taken slot
  bool finished;          // min-frag: a take finished the driver's row
  // a deferred raise of lower bounds: the classes whose value is pv (-1:
  // any positive) have no live member at or below plast (-1: none pending)
  int plast, pv;
  int seq;    // block reductions so far: the buffer in turn
  int takes;  // takes so far: the `last` slot in turn
  // this thread's candidate of the first chunk: its node, exec_ok, code
  // (kept current from the overlay's new entries and the rebuilds)
  int my_cand, my_code;
  bool my_eok;
  // the take's first window, prefetched in pass A where the last app's
  // first take began (valid until a take writes)
  int spec;
  int4 pre;
  bool pre_ok;
};

// The partition as one step sees it.  With S (the whole partition in
// shared memory) the pointers derive from the shared array, so the compiler
// emits shared loads, stores and atomics; else the generic ones.
template <bool S>
__device__ __forceinline__ Part part(const Ctx& c) {
  if (S) {
    int* cl = dyn_ints() + c.cls_off;
    int* ov = dyn_ints();
    const int nc = c.nc_s, cap = c.ov_cap;
    return Part{cl, cl + nc, cl + 2 * nc, cl + 3 * nc, cl + 4 * nc, cl + 5 * nc, cl + 6 * nc, 1,
                ov, ov + cap, ov + 2 * cap, ov + 3 * cap, ov + 4 * cap, ov + 5 * cap};
  }
  return c.g;
}

__device__ __forceinline__ int code_value(const Part& p, int code) {
  return code >= 0 ? p.cval[code * p.cs] : p.oval[-2 - code];
}

// Node i (code `code`) loses `sub`; a class member moves to the overlay.
// One thread a node.
template <int T, bool S>
__device__ void write_node(const Ctx& c, Shared<T>& sh, int i, int code, const int* sub) {
  const Part p = part<S>(c);
  int a0, a1, a2, q;
  if (code >= 0) {
    const int r = code * p.cs;
    a0 = p.ca0[r];
    a1 = p.ca1[r];
    a2 = p.ca2[r];
    if (S || p.cs != 1) {
      atomicSub(p.clive + r, 1);  // with S, a shared-space pointer
    } else {
      atomicSub(dyn_ints() + c.live_off + code, 1);
    }
    q = atomicAdd(&sh.ov_count, 1);
    p.oid[q] = i;
    p.oeok[q] = p.ceok[r];
    c.node_cls[i] = -2 - q;
  } else {
    q = -2 - code;
    a0 = p.oa0[q];
    a1 = p.oa1[q];
    a2 = p.oa2[q];
  }
  a0 = wsub(a0, sub[0]);
  a1 = wsub(a1, sub[1]);
  a2 = wsub(a2, sub[2]);
  c.planes[3 * i] = a0;
  c.planes[3 * i + 1] = a1;
  c.planes[3 * i + 2] = a2;
  p.oa0[q] = a0;
  p.oa1[q] = a1;
  p.oa2[q] = a2;
  p.oval[q] = 0;
}

// Points the class fields at shared memory (nc records from dyn_ints() +
// off) or at the state's rows.
__device__ __forceinline__ void place_classes(Ctx& c, bool shared, int off, int nc, int* cls) {
  if (shared) {
    int* smem = dyn_ints() + off;
    c.cls_off = off;
    c.nc_s = nc;
    c.live_off = off + 4 * nc;
    c.lb_off = off + 5 * nc;
    c.g.ca0 = smem;
    c.g.ca1 = smem + nc;
    c.g.ca2 = smem + 2 * nc;
    c.g.ceok = smem + 3 * nc;
    c.g.clive = smem + 4 * nc;
    c.g.clb = smem + 5 * nc;
    c.g.cval = smem + 6 * nc;
    c.g.cs = 1;
  } else {
    c.g.ca0 = cls + kA0;
    c.g.ca1 = cls + kA1;
    c.g.ca2 = cls + kA2;
    c.g.ceok = cls + kEok;
    c.g.clive = cls + kLive;
    c.g.clb = cls + kLb;
    c.g.cval = cls + kVal;
    c.g.cs = kFields;
  }
}

struct Layout {
  int smem_cls;   // where shared records start in dyn_ints()
  int cls_room;   // records that fit there
  int* cls;       // the state's rows
  int* slot;
  int* table;
  int mask;
  long long* meta;
};

// class_rebuild: the partition from the planes; the overlay empties.
template <int T>
__device__ void rebuild(Ctx& c, Shared<T>& sh, const Layout& L) {
  const int t0 = threadIdx.x;
  for (int s = t0; s <= L.mask; s += T) L.table[s] = -1;
  if (t0 == 0) sh.nclasses = 0;
  __syncthreads();
  for (int i = t0; i < c.n; i += T) {
    const int a0 = c.planes[3 * i], a1 = c.planes[3 * i + 1], a2 = c.planes[3 * i + 2];
    const uint8_t ok = c.eok[i];
    unsigned long long h = static_cast<unsigned>(a0);
    h = h * 0x9E3779B97F4A7C15ull + static_cast<unsigned>(a1);
    h = h * 0x9E3779B97F4A7C15ull + static_cast<unsigned>(a2);
    h = h * 0x9E3779B97F4A7C15ull + ok;
    h ^= h >> 29;
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 32;
    int s = static_cast<int>(h & static_cast<unsigned long long>(L.mask));
    while (true) {
      int held = __ldcg(L.table + s);
      if (held < 0) held = atomicCAS(L.table + s, -1, i);
      if (held < 0 || (c.planes[3 * held] == a0 && c.planes[3 * held + 1] == a1 &&
                       c.planes[3 * held + 2] == a2 && c.eok[held] == ok)) {
        L.slot[i] = s;
        break;
      }
      s = (s + 1) & L.mask;
    }
  }
  __syncthreads();
  // each slot's first claimant numbers its class and marks itself
  for (int i = t0; i < c.n; i += T) {
    const int s = L.slot[i];
    if (__ldcg(L.table + s) == i) {
      L.table[s] = -2 - atomicAdd(&sh.nclasses, 1);
      L.slot[i] = -1 - s;
    }
  }
  __syncthreads();
  const int nc = sh.nclasses;
  const bool shared = nc <= L.cls_room;
  place_classes(c, shared, L.smem_cls, nc, L.cls);
  for (int cid = t0; cid < nc; cid += T) {
    c.g.clive[cid * c.g.cs] = 0;
    c.g.clb[cid * c.g.cs] = kBig;
    c.g.cval[cid * c.g.cs] = 0;
  }
  __syncthreads();
  for (int i = t0; i < c.n; i += T) {
    const int raw = L.slot[i];
    const int cid = -2 - __ldcg(L.table + (raw < 0 ? -1 - raw : raw));
    const int r = cid * c.g.cs;
    c.node_cls[i] = cid;
    if (shared) {
      atomicAdd(dyn_ints() + c.live_off + cid, 1);
      atomicMin(dyn_ints() + c.lb_off + cid, i);
    } else {
      atomicAdd(c.g.clive + r, 1);
      atomicMin(c.g.clb + r, i);
    }
    if (raw < 0) {
      c.g.ca0[r] = c.planes[3 * i];
      c.g.ca1[r] = c.planes[3 * i + 1];
      c.g.ca2[r] = c.planes[3 * i + 2];
      c.g.ceok[r] = c.eok[i];
    }
  }
  if (t0 == 0) {
    sh.ov_count = 0;
    L.meta[kClassesLast] = nc;
    L.meta[kRebuilds] += 1;
    L.meta[shared ? kSharedPlacements : kGlobalPlacements] += 1;
  }
  __syncthreads();
  c.plast = -1;
}

// Walk nodes [start, n) upward, kChunk a step: take each selected node
// (sel(v) on its value v) while the weights of the selected nodes before it
// sum below `limit`.  A taken node loses one executor and moves to the
// overlay.  With `finish`, the driver's node, when not taken, gets the
// driver subtracted here (by its walker, or by thread 0 past the walk).
// Ends with a barrier; returns the last node taken (-1: none).
template <int T, bool S, class Sel, class Weight>
__device__ int take(Ctx& c, Shared<T>& sh, int start, int limit, bool finish, Sel sel, Weight weight) {
  const Part p = part<S>(c);
  constexpr int kPer = kChunk / T;
  constexpr int kW = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int mylast = -1;
  const int base0 = start & ~(kPer - 1);
  int base = base0;
  bool use_pre = c.pre_ok && base == c.spec;
  if (c.pre_ok) c.spec = base;  // the next app prefetches where its first take begins
  c.pre_ok = false;
  if (limit > 0) {
    int cum = 0;
    while (base < c.n) {
      const int i0 = base + tid * kPer;
      int code[kPer];
      if (use_pre) {
        code[0] = c.pre.x;
        code[1 % kPer] = kPer > 1 ? c.pre.y : c.pre.x;
        code[2 % kPer] = kPer > 2 ? c.pre.z : c.pre.x;
        code[3 % kPer] = kPer > 3 ? c.pre.w : code[3 % kPer];
        use_pre = false;
      } else if (kPer == 4 && i0 + 3 < c.n) {
        const int4 q = *reinterpret_cast<const int4*>(c.node_cls + i0);
        code[0] = q.x;
        code[1 % kPer] = q.y;
        code[2 % kPer] = q.z;
        code[3 % kPer] = q.w;
      } else if (kPer == 2 && i0 + 1 < c.n) {
        const int2 q = *reinterpret_cast<const int2*>(c.node_cls + i0);
        code[0] = q.x;
        code[1 % kPer] = q.y;
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q) code[q] = i0 + q < c.n ? c.node_cls[i0 + q] : 0;
      }
      int w[kPer];
      int mine = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = i0 + q;
        w[q] = -1;  // not selected
        if (i >= start && i < c.n) {
          const int v = i == c.didx ? (c.dtaken ? 0 : c.dval) : code_value(p, code[q]);
          if (sel(v)) {
            w[q] = weight(v);
            mine = sat_add(mine, w[q]);
          }
        }
      }
      const int incl = warp_scan(mine);
      const int buf = c.seq++ & 1;
      if (lane == 31) sh.red[buf][0][warp] = incl;
      __syncthreads();
      const int wtot = warp_scan(lane < kW ? sh.red[buf][0][lane] : 0);
      const int total = __shfl_sync(kFull, wtot, kW - 1);
      const int wbefore = __shfl_sync(kFull, wtot, warp == 0 ? 0 : warp - 1);
      const int up = __shfl_up_sync(kFull, incl, 1);
      int before = sat_add(cum, sat_add(warp == 0 ? 0 : wbefore, lane == 0 ? 0 : up));
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = i0 + q;
        if (w[q] >= 0 && before < limit) {
          write_node<T, S>(c, sh, i, code[q], c.e);
          mylast = i;
          if (i == c.didx) sh.didx_taken[c.dslot] = 1;
        } else if (finish && i == c.didx) {
          write_node<T, S>(c, sh, i, code[q], c.d);
        }
        if (w[q] >= 0) before = sat_add(before, w[q]);
      }
      cum = sat_add(cum, total);
      base += kChunk;
      if (cum >= limit) break;  // uniform
    }
  }
  // the driver's node outside the walked nodes [base0, base)
  if (finish && tid == 0 && (c.didx < base0 || c.didx >= base)) write_node<T, S>(c, sh, c.didx, c.dcode, c.d);
  const int slot = c.takes++ & 1;
  if (mylast >= 0) atomicMax(&sh.last[slot], mylast);
  __syncthreads();
  const int last = sh.last[slot];
  if (tid == 0) sh.last[slot ^ 1] = -1;
  c.dtaken = sh.didx_taken[c.dslot];
  return last;
}

// Pass A: each class's value (after the deferred raise of its lower bound)
// and each overlay entry's; the capacity total (values clamped to [0, k]
// under min-frag) and the plain fill's start; the first fitting candidate
// in rank order.  Sets c.didx (-1: none), c.dval, c.dcode; returns the
// fill's start.
template <int T, bool S>
__device__ int values_probe(Ctx& c, Shared<T>& sh, const int* cand, int n_cand) {
  const Part p = part<S>(c);
  constexpr int kW = T / 32;
  constexpr int kPer = kChunk / T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool mf = c.policy == kMinFrag;
  const int n0 = min(n_cand, T);
  // the take's first window: issued first, used after this pass's barrier
  {
    const int i0 = c.spec + tid * kPer;
    if (kPer == 4 && i0 + 3 < c.n) {
      c.pre = *reinterpret_cast<const int4*>(c.node_cls + i0);
    } else if (kPer == 2 && i0 + 1 < c.n) {
      const int2 q = *reinterpret_cast<const int2*>(c.node_cls + i0);
      c.pre = make_int4(q.x, q.y, 0, 0);
    } else {
      c.pre.x = i0 < c.n ? c.node_cls[i0] : 0;
      c.pre.y = kPer > 1 && i0 + 1 < c.n ? c.node_cls[i0 + 1] : 0;
      c.pre.z = kPer > 2 && i0 + 2 < c.n ? c.node_cls[i0 + 2] : 0;
      c.pre.w = kPer > 3 && i0 + 3 < c.n ? c.node_cls[i0 + 3] : 0;
    }
    c.pre_ok = true;
  }
  // the first chunk's candidate: its triple is its class's or its overlay
  // mirror's (no plane read)
  int pa0 = 0, pa1 = 0, pa2 = 0;
  const int pcode = c.my_code;
  if (tid < n0) {
    if (pcode >= 0) {
      const int r = pcode * p.cs;
      pa0 = p.ca0[r];
      pa1 = p.ca1[r];
      pa2 = p.ca2[r];
    } else {
      pa0 = p.oa0[-2 - pcode];
      pa1 = p.oa1[-2 - pcode];
      pa2 = p.oa2[-2 - pcode];
    }
  }
  unsigned long long sum = 0;
  int lo = kNone;
  const int nc = sh.nclasses;
  // kBatch classes a thread at a time, every load before any store
  constexpr int kBatch = S ? 1 : kGlobalBatch;
  for (int base = tid; base < nc; base += kBatch * T) {
    int old[kBatch], lb[kBatch], ok[kBatch], x0[kBatch], x1[kBatch], x2[kBatch], live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int cid = base + u * T;
      if (cid < nc) {
        const int r = cid * p.cs;
        old[u] = p.cval[r];
        lb[u] = ld_v(p.clb + r);
        ok[u] = p.ceok[r];
        x0[u] = p.ca0[r];
        x1[u] = p.ca1[r];
        x2[u] = p.ca2[r];
        live[u] = ld_v(p.clive + r);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int cid = base + u * T;
      if (cid < nc) {
        const int r = cid * p.cs;
        if (c.plast >= 0 && (c.pv < 0 ? old[u] > 0 : old[u] == c.pv) && lb[u] <= c.plast) {
          lb[u] = c.plast + 1;
          p.clb[r] = lb[u];
        }
        const int v = !ok[u] ? 0 : mf ? unclamped(x0[u], x1[u], x2[u], c.dv) : clamped(x0[u], x1[u], x2[u], c.dv, c.k);
        p.cval[r] = v;
        sum += static_cast<unsigned long long>(mf ? max(min(v, c.k), 0) : v) * static_cast<unsigned>(live[u]);
        if (v > 0 && live[u] > 0) lo = min(lo, lb[u]);
      }
    }
  }
  c.plast = -1;
  const int nov = sh.ov_count;
  for (int j = T - 1 - tid; j < nov; j += T) {  // from the last warps: pass A's first ones hold the classes
    const int v = !p.oeok[j] ? 0 : mf ? unclamped(p.oa0[j], p.oa1[j], p.oa2[j], c.dv)
                                      : clamped(p.oa0[j], p.oa1[j], p.oa2[j], c.dv, c.k);
    p.oval[j] = v;
    sum += static_cast<unsigned>(mf ? max(min(v, c.k), 0) : v);
    if (v > 0) lo = min(lo, p.oid[j]);
  }
  int4 rec = make_int4(kNone, -1, 0, pcode);
  if (tid < n0 && pa0 >= c.d[0] && pa1 >= c.d[1] && pa2 >= c.d[2]) {
    const int b0 = wsub(pa0, c.d[0]), b1 = wsub(pa1, c.d[1]), b2 = wsub(pa2, c.d[2]);
    const int cwd = c.my_eok ? clamped(b0, b1, b2, c.dv, c.k) : 0;
    const int capi = c.my_eok ? clamped(pa0, pa1, pa2, c.dv, c.k) : 0;
    rec = make_int4(capi - cwd, cwd, mf && c.my_eok ? unclamped(b0, b1, b2, c.dv) : 0, pcode);
  }
  const int buf = c.seq++ & 1;
  if (tid < n0) sh.cand_rec[buf][tid] = rec;
  const unsigned wsum = warp_sat_sum(sat32(sum));
  const int wlo = __reduce_min_sync(kFull, lo);
  const int wdelta = __reduce_min_sync(kFull, rec.y >= 0 ? rec.x : kNone);
  const unsigned wfit = __ballot_sync(kFull, rec.y >= 0);
  if (lane == 0) {
    sh.red[buf][0][warp] = static_cast<int>(wsum);
    sh.red[buf][1][warp] = wlo;
    sh.red[buf][2][warp] = wdelta;
    sh.red[buf][3][warp] = wfit != 0;
  }
  __syncthreads();
  if (tid == 0) sh.didx_taken[c.dslot ^ 1] = 0;  // the next app's slot: its readers are past this barrier
  const bool in = lane < kW;
  const unsigned total = warp_sat_sum(in ? static_cast<unsigned>(sh.red[buf][0][lane]) : 0u);
  const int start = __reduce_min_sync(kFull, in ? sh.red[buf][1][lane] : kNone);
  c.didx = -1;
  const long long room = static_cast<long long>(total) - c.k;  // a candidate fits where delta <= room
  if (room < 0) return start;
  const unsigned hit = __ballot_sync(kFull, in && sh.red[buf][3][lane] && sh.red[buf][2][lane] <= room);
  if (hit) {
    const int w = __ffs(hit) - 1;
    const int t = w * 32 + lane;
    const int4 mine = t < n0 ? sh.cand_rec[buf][t] : make_int4(kNone, -1, 0, 0);
    const unsigned h2 = __ballot_sync(kFull, mine.y >= 0 && mine.x <= room);
    const int first = w * 32 + __ffs(h2) - 1;
    const int4 got = sh.cand_rec[buf][first];
    c.didx = sh.cand_id[first];
    c.dval = mf ? got.z : got.y;
    c.dcode = got.w;
    return start;
  }
  // the later chunks, one reduction each, until one holds a fit
  for (int base = T; base < n_cand; base += T) {
    const int t = base + tid;
    int4 r2 = make_int4(kNone, -1, 0, 0);
    if (t < n_cand) {
      const int i = cand[t];
      const int a0 = c.planes[3 * i], a1 = c.planes[3 * i + 1], a2 = c.planes[3 * i + 2];
      const bool ok = c.eok[i];
      r2.w = c.node_cls[i];
      if (a0 >= c.d[0] && a1 >= c.d[1] && a2 >= c.d[2]) {
        const int b0 = wsub(a0, c.d[0]), b1 = wsub(a1, c.d[1]), b2 = wsub(a2, c.d[2]);
        const int cwd = ok ? clamped(b0, b1, b2, c.dv, c.k) : 0;
        const int capi = ok ? clamped(a0, a1, a2, c.dv, c.k) : 0;
        r2 = make_int4(capi - cwd, cwd, mf && ok ? unclamped(b0, b1, b2, c.dv) : 0, r2.w);
      }
    }
    const bool fit = r2.y >= 0 && r2.x <= room;
    const int b = c.seq++ & 1;
    sh.cand_rec[b][tid] = r2;
    const int wfirst = __reduce_min_sync(kFull, fit ? tid : kNone);
    if (lane == 0) sh.red[b][0][warp] = wfirst;
    __syncthreads();
    const int first = __reduce_min_sync(kFull, in ? sh.red[b][0][lane] : kNone);
    if (first != kNone) {
      const int4 got = sh.cand_rec[b][first];
      c.didx = cand[base + first];
      c.dval = mf ? got.z : got.y;
      c.dcode = got.w;
      return start;
    }
  }
  return start;
}

// One pass over the min-frag holders: each class with live members other
// than the driver's node (value, multiplicity, lower bound), each overlay
// entry but the driver's node (value, 1, node), the driver's node with its
// own value until it is taken.
struct Hold {
  int maxv;      // the largest value in (0, ceiling), 0 if none
  unsigned cnt;  // its multiplicity
  int smax;      // the least start among its holders
  int minge;     // the least value in [rem, ceiling) (kNone: none)
  int sge;       // the least start among its holders
  int minpos;    // the least positive value (kNone: none)
  unsigned sum;  // sum of value x multiplicity over (0, bound), saturated
};

template <int T, bool S>
__device__ Hold holders(Ctx& c, Shared<T>& sh, int rem, int ceiling, int bound) {
  const Part p = part<S>(c);
  constexpr int kW = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int maxv = 0, smax = kNone, minge = kNone, sge = kNone, minpos = kNone;
  unsigned cnt = 0;
  unsigned long long sum = 0;
  auto add = [&](int x, int m, int start) {
    if (x > 0 && x < ceiling) {
      if (x > maxv) {
        maxv = x;
        cnt = m;
        smax = start;
      } else if (x == maxv) {
        cnt += m;
        smax = min(smax, start);
      }
      if (x >= rem) {
        if (x < minge) {
          minge = x;
          sge = start;
        } else if (x == minge) {
          sge = min(sge, start);
        }
      }
    }
    if (x > 0) {
      minpos = min(minpos, x);
      if (x < bound) sum += static_cast<unsigned long long>(x) * static_cast<unsigned>(m);
    }
  };
  const int member = c.dcode >= 0 && !c.dtaken ? c.dcode : -1;
  const int nc = sh.nclasses;
  constexpr int kBatch = S ? 1 : kGlobalBatch;
  for (int base = tid; base < nc; base += kBatch * T) {  // as pass A: loads first
    int x[kBatch], lb[kBatch], live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int cid = base + u * T;
      if (cid < nc) {
        const int r = cid * p.cs;
        x[u] = p.cval[r];
        lb[u] = ld_v(p.clb + r);
        live[u] = ld_v(p.clive + r) - (cid == member ? 1 : 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int cid = base + u * T;
      if (cid < nc) {
        if (c.plast >= 0 && x[u] == c.pv && lb[u] <= c.plast) {
          lb[u] = c.plast + 1;
          p.clb[cid * p.cs] = lb[u];
        }
        if (live[u] > 0) add(x[u], live[u], lb[u]);
      }
    }
  }
  c.plast = -1;
  const int nov = sh.ov_count;
  for (int j = T - 1 - tid; j < nov; j += T) {
    const int i = p.oid[j];
    if (i != c.didx) add(p.oval[j], 1, i);
  }
  if (tid == 0 && !c.dtaken) add(c.dval, 1, c.didx);
  Hold h;
  h.maxv = __reduce_max_sync(kFull, maxv);
  h.cnt = __reduce_add_sync(kFull, maxv == h.maxv ? cnt : 0u);
  h.smax = __reduce_min_sync(kFull, maxv == h.maxv ? smax : kNone);
  h.minge = __reduce_min_sync(kFull, minge);
  h.sge = __reduce_min_sync(kFull, minge == h.minge ? sge : kNone);
  h.minpos = __reduce_min_sync(kFull, minpos);
  h.sum = warp_sat_sum(sat32(sum));
  const int buf = c.seq++ & 1;
  int(*r)[32] = sh.red[buf];
  if (lane == 0) {
    r[0][warp] = h.maxv;
    r[1][warp] = static_cast<int>(h.cnt);
    r[2][warp] = h.smax;
    r[3][warp] = h.minge;
    r[4][warp] = h.sge;
    r[5][warp] = h.minpos;
    r[6][warp] = static_cast<int>(h.sum);
  }
  __syncthreads();
  const bool in = lane < kW;
  maxv = in ? r[0][lane] : 0;
  cnt = in ? static_cast<unsigned>(r[1][lane]) : 0u;
  smax = in ? r[2][lane] : kNone;
  minge = in ? r[3][lane] : kNone;
  sge = in ? r[4][lane] : kNone;
  h.maxv = __reduce_max_sync(kFull, maxv);
  h.cnt = __reduce_add_sync(kFull, maxv == h.maxv ? cnt : 0u);
  h.smax = __reduce_min_sync(kFull, maxv == h.maxv ? smax : kNone);
  h.minge = __reduce_min_sync(kFull, minge);
  h.sge = __reduce_min_sync(kFull, minge == h.minge ? sge : kNone);
  h.minpos = __reduce_min_sync(kFull, in ? r[5][lane] : kNone);
  h.sum = warp_sat_sum(in ? static_cast<unsigned>(r[6][lane]) : 0u);
  return h;
}

// The first t holders of value v in node order, from `start` (no later than
// the first of them).
// With `last_take` the step takes nothing after it, so the take finishes
// the driver's row unless an earlier take took its node.
template <int T, bool S>
__device__ void take_value(Ctx& c, Shared<T>& sh, int v, int start, int t, bool last_take) {
  const bool finish = last_take && !c.dtaken;
  c.finished = c.finished || finish;
  const int last = take<T, S>(c, sh, start, t, finish, [v](int x) { return x == v; }, [](int) { return 1; });
  if (last >= 0) {
    c.plast = last;
    c.pv = v;
  }
}

// The value-ordered drain over the holders with values in (0, ceiling),
// from its first round `h` (rem = k); the caller knows it succeeds.
template <int T, bool S>
__device__ void drain(Ctx& c, Shared<T>& sh, Hold h, int ceiling) {
  int rem = c.k;
  while (true) {
    const int maxv = h.maxv;
    if (rem <= maxv) {  // instant fit
      take_value<T, S>(c, sh, h.minge, h.sge, 1, true);
      return;
    }
    const int t = static_cast<int>(min(static_cast<long long>(h.cnt), static_cast<long long>(rem / maxv)));
    rem -= t * maxv;
    take_value<T, S>(c, sh, maxv, h.smax, t, rem == 0);
    if (rem == 0) return;
    if (static_cast<unsigned>(t) < h.cnt) {
      const Hold f = holders<T, S>(c, sh, rem, ceiling, 0);
      take_value<T, S>(c, sh, f.minge, f.sge, 1, true);
      return;
    }
    ceiling = maxv;
    h = holders<T, S>(c, sh, rem, ceiling, 0);
  }
}

// The driver row on its node, by thread 0, then a barrier.
template <int T, bool S>
__device__ void finish_driver(Ctx& c, Shared<T>& sh) {
  if (threadIdx.x == 0) write_node<T, S>(c, sh, c.didx, c.dcode, c.d);
  __syncthreads();
}

template <int T, bool S>
__device__ void step_min_frag(Ctx& c, Shared<T>& sh, const int* cand, int n_cand) {
  values_probe<T, S>(c, sh, cand, n_cand);
  if (c.didx < 0) return;
  c.finished = false;
  const int k = c.k;
  if (k > 0) {
    const Hold g = holders<T, S>(c, sh, k, kBig, kBig);
    const int maxc = g.maxv;
    if (maxc > 0) {
      const bool has_sent = maxc == kMfSent;
      const bool attempt = has_sent || k < maxc;
      const long long target =
          has_sent ? static_cast<long long>(kMfSent) : (attempt ? (static_cast<long long>(k) + maxc) / 2 : 0);
      const int min_ge = g.minge == kNone ? kBig : g.minge;
      const int min_pos = g.minpos == kNone ? kBig : g.minpos;
      const bool have_ge = min_ge != kBig && min_ge >= k;
      bool placed = false;
      if (attempt && have_ge && min_ge < target) {
        take_value<T, S>(c, sh, min_ge, g.sge, 1, true);
        placed = true;
      } else if (attempt && min_pos != kBig && min_pos < target) {
        const int bound = static_cast<int>(target);
        const Hold ph = holders<T, S>(c, sh, k, bound, bound);
        if (ph.sum >= static_cast<unsigned>(k)) {
          drain<T, S>(c, sh, ph, bound);
          placed = true;
        }
      }
      if (!placed) {
        if (have_ge) {
          take_value<T, S>(c, sh, min_ge, g.sge, 1, true);
        } else if (g.sum >= static_cast<unsigned>(k)) {
          drain<T, S>(c, sh, g, kBig);
        }
      }
    }
  }
  if (!c.finished && !c.dtaken) finish_driver<T, S>(c, sh);
}

template <int T, bool S>
__device__ void step_plain(Ctx& c, Shared<T>& sh, const int* cand, int n_cand) {
  const int start = values_probe<T, S>(c, sh, cand, n_cand);
  if (c.didx < 0) return;
  if (c.k <= 0) {
    finish_driver<T, S>(c, sh);
    return;
  }
  const int lo = min(start, c.didx);
  const int last = c.policy == kEvenly
                       ? take<T, S>(c, sh, lo, c.k, true, [](int v) { return v > 0; }, [](int) { return 1; })
                       : take<T, S>(c, sh, lo, c.k, true, [](int v) { return v > 0; }, [](int v) { return v; });
  if (last >= 0) {
    c.plast = last;
    c.pv = -1;
  }
}

// planes -> out, 3n ints, 16-byte vectors where both are aligned
template <int T>
__device__ void copy_planes(int* out, const int* in, int n3) {
  if (((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(in)) & 15) == 0) {
    const int n4 = n3 >> 2;
    for (int x = threadIdx.x; x < n4; x += T)
      reinterpret_cast<int4*>(out)[x] = reinterpret_cast<const int4*>(in)[x];
    for (int x = 4 * n4 + threadIdx.x; x < n3; x += T) out[x] = in[x];
  } else {
    for (int x = threadIdx.x; x < n3; x += T) out[x] = in[x];
  }
}

template <int T>
__global__ void __launch_bounds__(T, 1)
fifo_queue_classes_kernel(const int* avail_in,   // [N, 3]
                          const int* cand,       // [M] candidates in (rank, node) order
                          int n_cand,
                          const uint8_t* eok,    // [N]
                          const int* apps,       // [A, 8]
                          int n, int n_apps, int policy, int rebuild_first,
                          uint8_t* feasible_out,  // [A]
                          int* driver_idx_out,    // [A]
                          int* planes,            // [N, 3] out: the carry
                          int* node_cls, int* cls, int* ov, int* node_val, int* slot, int* table, int* ovx,
                          int2* divs,  // [A, 3] scratch: each app's divisions
                          long long* meta, int mask, int smem_bytes, Checkpoints chk) {
  __shared__ Shared<T> sh;
  int* dyn = dyn_ints();
  constexpr int kW = T / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = max(n, 1);
  Ctx c;
  c.planes = planes;
  c.eok = eok;
  c.node_cls = node_cls;
  c.n = n;
  c.policy = policy;
  c.plast = -1;
  c.pv = -1;
  c.seq = 0;
  c.takes = 0;
  c.dtaken = 0;
  c.dslot = 0;
  c.spec = 0;
  c.pre_ok = false;
  copy_planes<T>(planes, avail_in, 3 * n);
  // the launch's largest k bounds the overlay's growth within an app
  int kmax = 0;
  for (int a = tid; a < n_apps; a += T) {
    if (apps[8 * a + 7]) kmax = max(kmax, apps[8 * a + 6]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const Div v = make_div(apps[8 * a + 3 + j]);
      divs[3 * a + j] = make_int2(static_cast<int>(v.m), v.sh);
    }
  }
  kmax = __reduce_max_sync(kFull, kmax);
  if (lane == 0) sh.red[0][0][warp] = kmax;
  if (tid < T) sh.cand_id[tid] = tid < n_cand ? cand[tid] : 0;
  if (tid == 0) {
    sh.last[0] = -1;
    sh.last[1] = -1;
    sh.didx_taken[0] = 0;
    sh.didx_taken[1] = 0;
  }
  __syncthreads();
  kmax = __reduce_max_sync(kFull, lane < kW ? sh.red[0][0][lane] : 0);
  c.seq = 1;
  const int limit = max(512, n / 64);
  const long long ov_cap = min(static_cast<long long>(m), static_cast<long long>(limit) + kmax + 2);
  const long long ov_bytes = 4LL * kOverlayWords * ov_cap;
  const bool ov_shared = ov_bytes <= smem_bytes;
  Layout L;
  L.cls = cls;
  L.slot = slot;
  L.table = table;
  L.mask = mask;
  L.meta = meta;
  c.ov_cap = static_cast<int>(ov_cap);
  if (ov_shared) {
    const int cap = static_cast<int>(ov_cap);
    c.g.oid = dyn;
    c.g.oa0 = dyn + cap;
    c.g.oa1 = dyn + 2 * cap;
    c.g.oa2 = dyn + 3 * cap;
    c.g.oeok = dyn + 4 * cap;
    c.g.oval = dyn + 5 * cap;
    L.smem_cls = kOverlayWords * cap;
    L.cls_room = static_cast<int>((smem_bytes - ov_bytes) / (4 * kClassWords));
  } else {
    c.g.oid = ov;
    c.g.oa0 = ovx;
    c.g.oa1 = ovx + m;
    c.g.oa2 = ovx + 2 * m;
    c.g.oeok = ovx + 3 * m;
    c.g.oval = ovx + 4 * m;
    L.smem_cls = 0;
    L.cls_room = smem_bytes / (4 * kClassWords);
  }
  c.my_cand = sh.cand_id[tid];
  c.my_eok = tid < n_cand && eok[c.my_cand];

  if (rebuild_first && n > 0) {
    rebuild(c, sh, L);
    if (tid == 0) meta[kClassesInitial] = sh.nclasses;
  } else {
    // the state's partition (it mirrors avail): records into shared memory
    // if they fit, the overlay's mirror from avail
    const int nc = static_cast<int>(meta[kClasses]);
    const int nov = static_cast<int>(meta[kOverlay]);
    const bool shared = nc <= L.cls_room;
    place_classes(c, shared, L.smem_cls, nc, cls);
    if (shared) {
      for (int cid = tid; cid < nc; cid += T) {
        const int* r = cls + cid * kFields;
        c.g.ca0[cid] = r[kA0];
        c.g.ca1[cid] = r[kA1];
        c.g.ca2[cid] = r[kA2];
        c.g.ceok[cid] = r[kEok];
        c.g.clive[cid] = r[kLive];
        c.g.clb[cid] = r[kLb];
        c.g.cval[cid] = r[kVal];
      }
    }
    for (int j = tid; j < nov; j += T) {
      const int i = ov[j];
      c.g.oid[j] = i;
      c.g.oa0[j] = avail_in[3 * i];
      c.g.oa1[j] = avail_in[3 * i + 1];
      c.g.oa2[j] = avail_in[3 * i + 2];
      c.g.oeok[j] = eok[i];
      c.g.oval[j] = 0;
      node_cls[i] = -2 - j;
    }
    if (tid == 0) {
      sh.nclasses = nc;
      sh.ov_count = nov;
      meta[shared ? kSharedPlacements : kGlobalPlacements] += 1;
    }
    __syncthreads();
  }

  c.my_code = tid < n_cand ? node_cls[c.my_cand] : 0;
  int peak = 0;  // thread 0's overlay peak
  int row[8], next[8];
  int2 div[3], next_div[3];
#pragma unroll
  for (int f = 0; f < 8; ++f) next[f] = n_apps > 0 ? apps[f] : 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) next_div[j] = n_apps > 0 ? divs[j] : make_int2(0, -1);
  for (int a = 0; a < n_apps; ++a) {
#pragma unroll
    for (int f = 0; f < 8; ++f) row[f] = next[f];
#pragma unroll
    for (int j = 0; j < 3; ++j) div[j] = next_div[j];
    if (a + 1 < n_apps) {
#pragma unroll
      for (int f = 0; f < 8; ++f) next[f] = apps[8 * (a + 1) + f];
#pragma unroll
      for (int j = 0; j < 3; ++j) next_div[j] = divs[3 * (a + 1) + j];
    }
    if (chk.out != nullptr) {
      const int p = chk.base + a;
      if (p > 0 && p % chk.stride == 0 && p / chk.stride - 1 < chk.slots)
        copy_planes<T>(chk.out + static_cast<size_t>(p / chk.stride - 1) * 3 * n, planes, 3 * n);
    }
    if (!row[7] || n == 0) {  // uniform
      if (tid == 0) {
        feasible_out[a] = 0;
        driver_idx_out[a] = n;
      }
      continue;
    }
    c.d[0] = row[0];
    c.d[1] = row[1];
    c.d[2] = row[2];
    c.e[0] = row[3];
    c.e[1] = row[4];
    c.e[2] = row[5];
    c.k = row[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) c.dv[j] = Div{static_cast<unsigned>(div[j].x), div[j].y};
    c.dtaken = 0;
    const int nov0 = sh.ov_count;
    if (ov_shared && c.g.cs == 1) {  // the whole partition in shared memory
      if (policy == kMinFrag) {
        step_min_frag<T, true>(c, sh, cand, n_cand);
      } else {
        step_plain<T, true>(c, sh, cand, n_cand);
      }
    } else if (policy == kMinFrag) {
      step_min_frag<T, false>(c, sh, cand, n_cand);
    } else {
      step_plain<T, false>(c, sh, cand, n_cand);
    }
    c.dslot ^= 1;
    if (tid == 0) {
      feasible_out[a] = c.didx >= 0;
      driver_idx_out[a] = c.didx >= 0 ? c.didx : n;
    }
    if (c.didx < 0) continue;  // uniform; an infeasible app changes nothing
    const int nov = sh.ov_count;
    peak = max(peak, nov);
    if (nov > limit) {  // uniform
      rebuild(c, sh, L);
      c.my_code = tid < n_cand ? node_cls[c.my_cand] : 0;
    } else {
      // the candidate's node joined the overlay this app?
      for (int j = nov0; j < nov; ++j)
        if (c.g.oid[j] == c.my_cand) c.my_code = -2 - j;
    }
  }
  __syncthreads();
  // the partition back to the state's layout
  const int nc = sh.nclasses, nov = sh.ov_count;
  if (c.g.cs == 1) {
    for (int cid = tid; cid < nc; cid += T) {
      int* r = cls + cid * kFields;
      r[kA0] = c.g.ca0[cid];
      r[kA1] = c.g.ca1[cid];
      r[kA2] = c.g.ca2[cid];
      r[kEok] = c.g.ceok[cid];
      r[kLive] = c.g.clive[cid];
      r[kLb] = c.g.clb[cid];
      r[kVal] = c.g.cval[cid];
    }
  }
  for (int j = tid; j < nov; j += T) {
    const int i = c.g.oid[j];
    ov[j] = i;
    node_cls[i] = -1;
    node_val[i] = c.g.oval[j];
  }
  if (tid == 0) {
    meta[kClasses] = nc;
    meta[kOverlay] = nov;
    if (peak > meta[kOverlayPeak]) meta[kOverlayPeak] = peak;
  }
}

}  // namespace

// Launches the kernel on `stream` on the current device as one block of
// kThreads threads with `smem_bytes` of dynamic shared memory.  The class
// state (node_cls [n], cls [max(n, 1), 8], ov [n], node_val [n], slot [n],
// table [mask + 1], ovx [5, max(n, 1)], meta [8] int64) is read and updated
// in place; divs ([n_apps, 3, 2] int32, 8-byte aligned) is scratch; with
// rebuild_first the partition is built from avail first.  chk_out
// ([chk_slots, n, 3] int32, or null) gets the checkpoints of
// queue_kernel.cu's launch.  Returns the CUDA error code (0 = ok).
extern "C" int fifo_queue_classes_launch(const int* avail, const int* cand, int n_cand,
                                         const uint8_t* exec_ok, const int* apps, int n,
                                         int n_apps, int policy, int rebuild_first,
                                         uint8_t* feasible_out, int* driver_idx_out,
                                         int* avail_out, int* node_cls, int* cls, int* ov,
                                         int* node_val, int* slot, int* table, int* ovx, int* divs,
                                         long long* meta, int mask, int chk_base, int chk_stride,
                                         int chk_slots, int* chk_out, int smem_bytes, void* stream) {
  if (chk_out != nullptr && (chk_stride <= 0 || chk_base < 0)) return cudaErrorInvalidValue;
  if (policy < kTightly || policy > kMinFrag) return cudaErrorInvalidValue;
  if (smem_bytes < 0 || smem_bytes + static_smem_bytes(kThreads) > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = fifo_queue_classes_kernel<kThreads>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      avail, cand, n_cand, exec_ok, apps, n, n_apps, policy, rebuild_first, feasible_out, driver_idx_out,
      avail_out, node_cls, cls, ov, node_val, slot, table, ovx, reinterpret_cast<int2*>(divs), meta, mask,
      smem_bytes, Checkpoints{chk_out, chk_base, chk_stride, chk_slots});
  return cudaGetLastError();
}

// sizeof the kernel's static shared memory.
extern "C" int fifo_queue_classes_static_smem() { return static_cast<int>(sizeof(Shared<kThreads>)); }
