// Backward accumulation of the blocked GST Jacobian, for NVIDIA Hopper (sm_90a).
//
// Replaces: pygsti_tpu/ops/pallas_kernels.py, bwd_jacobian_accumulate (the
// Pallas TPU kernel, body _kernel), called from the 'blocked' Jacobian of
// pygsti_tpu/objectivefns/objectivefns.py (_block_probs_jac).
//
// What it computes.  For each circuit b, start from the effect rows
// Bc_{D-1} = E[b] (one row per outcome n) and walk the depth backwards: with
// k = cols[b, t] and F[b, t] the state before layer t,
//     A[b, n, k, i, j] = sum over {t : cols[b, t] = k} of Bc_t[n, i] F[b, t, j]
//     Bc_{t-1}[n, j]   = sum_i Bc_t[n, i] G[k, i, j]
// and return A and Bc_{-1} as B_final [B, NOUT, d].  An op index outside
// [0, K1) selects nothing, as the reference's one-hot contraction does: it
// adds nothing to A and zeroes Bc.  A[b, n, k] (d x d values) lands at
// A + (b * NOUT + n) * rowstride + k * d * d for k < Kw: rowstride K1 d^2
// and Kw K1 give A [B, NOUT, K1, d, d]; a caller that wants the blocks in
// the rows of its own Jacobian passes that row's length and Kw = K1 - 1
// (the last slot, the identity that pads short circuits, is not written).
//
// What bounds it on the H100: bytes.  A is written once (B*NOUT*Kw*d*d
// values), F, E and cols are read once: 888 MB in float64 over the 2-qubit
// fit's five depth buckets (0.265 ms at 3.35 TB/s), 10.1 GB over the
// 3-qubit cloud layout's twenty (3.02 ms).  The multiply-adds take a
// quarter of the byte time or less at the float64 rate outside the tensor
// cores.  What stands in the way of the store rate is the serial chain
// Bc_{D-1} -> ... -> Bc_{-1}: D dependent [NOUT, d] x [d, d] products per
// circuit.  Two routes, chosen by where the op stack G (K1 x d^2 values)
// fits.
//
// The shared route (G takes at most half the shared memory a block may opt
// in to and fits beside one layer's buffers: every 2-qubit and qutrit
// shape).  One kernel, a persistent grid (as many blocks as fit on the SMs
// at once), each block copying G into shared memory once and split by role.
//   * kSlots chain warps, each owning one slot of shared memory, each walking
//     its own circuits (m = warp, warp + kSlots, ... of the block's share
//     b = blockIdx.x + m * gridDim.x).  Per circuit it copies F into its slot
//     with cp.async (F is read once per circuit, not once per outcome) while
//     cols and E of its next circuit are already in flight, so no
//     device-memory load sits on the chain; sorts the layers by op with
//     ballots (seg_t lists each op's layers, descending t); then walks the
//     depth once for all outcomes together, each lane owning column j of an
//     outcome pair with G[k][:, j] in registers (the next layer's column
//     loaded during this layer's sums), and stashes every Bc_t in the slot.
//     Layers need only __syncwarp.  The several chain warps of an SM run
//     their chains side by side, which is what keeps the stores fed.
//   * kBulkWarps bulk warps take the slots' circuits in turn.  A thread owns
//     four consecutive j of one (k, i) for every outcome and sums
//     Bc_t[n, i] * F_t[j] over the layers of op k in registers, then writes
//     them once with 16-byte streaming stores, neighbouring threads on
//     neighbouring addresses (scalar stores where rowstride breaks the
//     16-byte alignment; the sums are the same): no accumulator in shared
//     memory, no K1-fold masked work, no atomics.
//   A slot passes from its chain warp to the bulk warps and back through two
//   named barriers (full: bar.arrive by the chain warp, bar.sync by the
//   bulk; empty: the reverse), so a chain warp starts its next circuit while
//   the bulk warps store the last one.  d = 16, NOUT = 4 (2 qubits) has a
//   compile-time path; any other d and NOUT take a path that reads them at
//   run time.  Where the stash for D layers exceeds shared memory, a circuit
//   is walked in chunks of DC layers from the top; the chain carries Bc
//   across chunks and the bulk adds each chunk into A (a read of the
//   thread's own earlier store).
//
// The two-stage route (every other shape: d 64 at 3 qubits, d 16 past 56
// ops in float64).  A block per circuit leaves half an H100 idle at the
// 3-qubit layout's B 64, and a stash of Bc in shared memory would be walked
// in chunks that re-read and re-write A.  So the chain and the bulk are two
// kernels, with every Bc_t passed through a scratch stash [B, D, NOUT, d]
// in device memory (17.8 MB at the deepest 3-qubit bucket, against A's 503
// MB; written once, read once).
//   * Stage 1, the chain: a block per (circuit, group of at most four
//     outcomes: 128 blocks at the 3-qubit layout).  Each layer's [NG, d] x
//     [d, d] product reads G[k] once into shared memory, in chunks of RC rows
//     (all of G[k] where two fit, 32 KB at d 64 in float64), with cp.async,
//     double-buffered, so the next layer's op arrives during this layer's
//     product; the op indices are loaded two steps ahead.  A thread owns
//     outputs (n, j), neighbouring threads on neighbouring j (the G row read
//     is conflict-free, the Bc read a broadcast), with four partial sums.
//     Bc_t goes to the stash before layer t, Bc_{-1} to B_final.  Its
//     multiply-adds, latency-bound at a few warps an SM, set its pace (about
//     1.8 us a layer at the 3-qubit layout: chip_smoke.py phase 20).
//   * Stage 2, the bulk: a grid over output tiles (b, k, a run of rows of
//     A[b, :, k] seen as [NOUT d, d]), thousands per launch (64 x 30 x 8 at
//     3 qubits in float64), enough to fill every SM.  A thread keeps one
//     16-byte column vector of 8 (float64) or 4 (float32) rows, so a layer
//     costs it one F load and a few stash loads; each warp finds op k's
//     layers of circuit b with ballots over 128 layers of cols at a time
//     (descending t, the order of the plain version's sum); the sums stay in
//     registers and are written once with streaming stores, neighbouring
//     threads on neighbouring addresses.  A tile whose op circuit b never
//     uses reads only cols and writes zeros, at the rate of the card's own
//     fill of A.  No atomics.
//   The summation order is fixed on both routes, so two launches give
//   bitwise equal results, and the blocks are the same bits whatever
//   rowstride and Kw.  Any B, D, K1.  A shape is refused only where one row
//   of Bc and of G, twice each, exceed the shared memory a block may opt in
//   to (d past 7,264 in float64 on an H100): the launcher returns minus the
//   bytes it would need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4;        // chain warps (circuits in flight) per block
constexpr int kBulkWarps = 4;    // warps that form and store A
constexpr int kThreads = 32 * (kSlots + kBulkWarps);
constexpr int kSync = 32 * (1 + kBulkWarps);   // one chain warp and the bulk warps

constexpr int kChainThreads = 256;   // two-stage route, stage 1
constexpr int kChainOutcomes = 4;    // outcomes of one stage-1 block, at most
constexpr int kTileThreads = 256;    // two-stage route, stage 2
constexpr int kTileValues = 16;      // values of A per stage-2 thread

template <typename T> struct Two;
template <> struct Two<double> { using type = double2; };
template <> struct Two<float> { using type = float2; };

// VEC consecutive values in one 16-byte access (VEC 1: a scalar)
template <typename T, int VEC> struct Vec { using type = T; };
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float, 4> { using type = float4; };

__device__ __forceinline__ void st_stream4(double* p, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}
__device__ __forceinline__ void st_stream4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets in shared memory for chunks of DC layers, with G at offset 0.
// Slot s (one per chain warp) starts at slot0 + s * slot_bytes; the chain
// warp's own buffers at warp0 + s * warp_bytes.
struct Layout {
  size_t g, slot0, slot_bytes, stash, f, seg_t, seg_start;
  size_t warp0, warp_bytes, carry, ce, ce_bytes, ce_e, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int DC, int K1, int d, int NOUT) {
  const size_t NOUTp = NOUT + (NOUT & 1);
  Layout L;
  L.g = 0;
  L.slot0 = up16(sizeof(T) * K1 * d * d);
  size_t o = 0;
  L.stash = o;     o = up16(o + sizeof(T) * DC * d * NOUTp);
  L.f = o;         o = up16(o + sizeof(T) * DC * d);
  L.seg_t = o;     o = up16(o + sizeof(int32_t) * DC);
  L.seg_start = o; o = up16(o + sizeof(int32_t) * (K1 + 1));
  L.slot_bytes = o;
  L.warp0 = L.slot0 + kSlots * L.slot_bytes;
  o = 0;
  L.carry = o;     o = up16(o + sizeof(T) * d * NOUTp);
  L.ce_e = up16(sizeof(int32_t) * DC);
  L.ce_bytes = up16(L.ce_e + sizeof(T) * NOUT * d);
  L.ce = o;        o += 2 * L.ce_bytes;
  L.warp_bytes = o;
  L.total = L.warp0 + kSlots * L.warp_bytes;
  return L;
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `nthreads` threads (thread `me` of them) copy nbytes (a multiple of 4) to
// 16-byte aligned shared memory: 16 bytes a thread where the source is
// aligned for it, 4 bytes otherwise.
__device__ __forceinline__ void copy_async(void* sdst, const void* gsrc, int nbytes, int me,
                                           int nthreads) {
  char* s = static_cast<char*>(sdst);
  const char* g = static_cast<const char*>(gsrc);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n16 = nbytes >> 4;
    for (int x = me; x < n16; x += nthreads) cp_async16(s + 16 * x, g + 16 * x);
    done = n16 << 4;
  }
  for (int x = (done >> 2) + me; x < (nbytes >> 2); x += nthreads)
    cp_async4(s + 4 * x, g + 4 * x);
}

// ---------------------------------------------------------------------------
// The shared route.
// DT, NT: d and NOUT known at compile time (the fast path: NT / 2 * DT = 32,
// so each chain lane owns one column j of one outcome pair); 0, 0: any d and
// NOUT, read at run time.  vec: rowstride and A keep 16-byte stores aligned.
template <typename T, int DT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
bwd_jacobian_kernel(const int32_t* __restrict__ cols, const T* __restrict__ G,
                    const T* __restrict__ E, const T* __restrict__ F,
                    T* __restrict__ A, T* __restrict__ b_final,
                    int B, int D, int K1, int d_rt, int nout_rt, int DC, int Kw,
                    long long rowstride, bool vec) {
  using T2 = typename Two<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = DT ? DT : d_rt;
  const int NOUT = NT ? NT : nout_rt;
  const Layout L = layout<T>(DC, K1, d, NOUT);
  T* g = reinterpret_cast<T*>(smem + L.g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NOUTp = NOUT + (NOUT & 1);
  const int S = d * NOUTp;               // one stash row, [i][n]
  const int dd = d * d;
  const int nch = (D + DC - 1) / DC;
  const int M = (B - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  for (int x = tid; x < K1 * dd; x += kThreads) g[x] = G[x];
  __syncthreads();

  if (warp < kSlots) {
    // ---- chain warp: circuits m = warp, warp + kSlots, ... of this block
    const int w = warp;
    unsigned char* slot = smem + L.slot0 + w * L.slot_bytes;
    T* stash = reinterpret_cast<T*>(slot + L.stash);
    T* fsl = reinterpret_cast<T*>(slot + L.f);
    int32_t* seg_t = reinterpret_cast<int32_t*>(slot + L.seg_t);
    int32_t* seg_start = reinterpret_cast<int32_t*>(slot + L.seg_start);
    unsigned char* wa = smem + L.warp0 + w * L.warp_bytes;
    T* carry = reinterpret_cast<T*>(wa + L.carry);

    // cols (and E for a circuit's first chunk) of unit (m, c) into buffer p
    auto issue_ce = [&](int m, int c, int p) {
      if (m < M) {
        const long b = blockIdx.x + static_cast<long>(m) * gridDim.x;
        const int t_hi = D - c * DC, t_lo = max(0, t_hi - DC);
        unsigned char* buf = wa + L.ce + p * L.ce_bytes;
        copy_async(buf, cols + b * D + t_lo, (t_hi - t_lo) * 4, lane, 32);
        if (c == 0)
          copy_async(buf + L.ce_e, E + b * NOUT * d, NOUT * d * (int)sizeof(T), lane, 32);
      }
      cp_async_commit();
    };
    issue_ce(w, 0, 0);

    int fills = 0, p = 0;
    for (int m = w; m < M; m += kSlots) {
      const long b = blockIdx.x + static_cast<long>(m) * gridDim.x;
      for (int c = 0; c < nch; ++c) {
        const int t_hi = D - c * DC, t_lo = max(0, t_hi - DC), nt = t_hi - t_lo;
        if (fills > 0) bar_sync(1 + kSlots + w, kSync);       // the bulk is done with the slot
        copy_async(fsl, F + (b * D + t_lo) * d, nt * d * (int)sizeof(T), lane, 32);
        cp_async_commit();
        if (c + 1 < nch) issue_ce(m, c + 1, p ^ 1);
        else issue_ce(m + kSlots, 0, p ^ 1);
        cp_async_wait<2>();                                  // this unit's cols and E
        __syncwarp();
        const int32_t* cs = reinterpret_cast<const int32_t*>(wa + L.ce + p * L.ce_bytes);
        const T* es = reinterpret_cast<const T*>(wa + L.ce + p * L.ce_bytes + L.ce_e);

        // the top row: E transposed to [i][n], or the previous chunk's carry
        T* top = stash + (nt - 1) * S;
        for (int x = lane; x < S; x += 32) {
          const int i = x / NOUTp, n = x - i * NOUTp;
          top[x] = c == 0 ? (n < NOUT ? es[n * d + i] : T(0)) : carry[x];
        }
        // counting sort by op: seg_t lists, op by op, its layers (descending t)
        int base = 0;
        for (int k = 0; k < K1; ++k) {
          if (lane == 0) seg_start[k] = base;
          for (int hi = nt - 1; hi >= 0; hi -= 32) {
            const int tr = hi - lane;
            const bool hit = tr >= 0 && cs[tr] == k;
            const unsigned mk = __ballot_sync(0xffffffffu, hit);
            if (hit) seg_t[base + __popc(mk & ((1u << lane) - 1u))] = tr;
            base += __popc(mk);
          }
        }
        if (lane == 0) seg_start[K1] = base;
        __syncwarp();

        if constexpr (DT > 0) {
          // lane: column j of outcomes 2 np and 2 np + 1; G[k][:, j] in registers,
          // the next layer's column loaded while this layer's sums run
          static_assert(NT % 2 == 0 && NT / 2 * DT == 32, "one lane per (j, outcome pair)");
          const int np = lane / DT, j = lane % DT;
          T gc[DT], gn[DT];
          int k = cs[nt - 1];
          bool valid = static_cast<unsigned>(k) < static_cast<unsigned>(K1);
#pragma unroll
          for (int i = 0; i < DT; ++i) gc[i] = g[(valid ? k : 0) * dd + i * DT + j];
          for (int r = nt - 1; r >= 0; --r) {
            const int kn = r > 0 ? cs[r - 1] : 0;
            const bool vn = static_cast<unsigned>(kn) < static_cast<unsigned>(K1);
#pragma unroll
            for (int i = 0; i < DT; ++i) gn[i] = g[(vn ? kn : 0) * dd + i * DT + j];
            const T* row = stash + r * S + 2 * np;
            T a[4] = {T(0), T(0), T(0), T(0)}, q[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
            for (int i = 0; i < DT; ++i) {
              const T2 u = *reinterpret_cast<const T2*>(row + i * NT);
              a[i & 3] += u.x * gc[i];
              q[i & 3] += u.y * gc[i];
            }
            T ra = (a[0] + a[1]) + (a[2] + a[3]), rq = (q[0] + q[1]) + (q[2] + q[3]);
            if (!valid) ra = rq = T(0);
            T* dst = r > 0 ? stash + (r - 1) * S : carry;
            T2 v;
            v.x = ra;
            v.y = rq;
            *reinterpret_cast<T2*>(dst + j * NT + 2 * np) = v;
            __syncwarp();
#pragma unroll
            for (int i = 0; i < DT; ++i) gc[i] = gn[i];
            valid = vn;
          }
        } else {
          for (int r = nt - 1; r >= 0; --r) {
            const int k = cs[r];
            const bool valid = static_cast<unsigned>(k) < static_cast<unsigned>(K1);
            const T* row = stash + r * S;
            T* dst = r > 0 ? stash + (r - 1) * S : carry;
            for (int x = lane; x < NOUT * d; x += 32) {
              const int n = x / d, j = x - n * d;
              T acc = T(0);
              if (valid) {
                const T* gk = g + k * dd + j;
                for (int i = 0; i < d; ++i) acc += row[i * NOUTp + n] * gk[i * d];
              }
              dst[j * NOUTp + n] = acc;
            }
            __syncwarp();
          }
        }
        if (t_lo == 0) {
          for (int x = lane; x < NOUT * d; x += 32) {
            const int n = x / d, j = x - n * d;
            b_final[(b * NOUT + n) * d + j] = carry[j * NOUTp + n];
          }
        }
        cp_async_wait<1>();                                  // this unit's F
        __syncwarp();
        bar_arrive(1 + w, kSync);                            // the slot is full
        ++fills;
        p ^= 1;
      }
    }
    if (fills > 0) bar_sync(1 + kSlots + w, kSync);
    cp_async_wait<0>();
  } else {
    // ---- bulk warps: every unit of the block, in order, from its slot
    const int bt = tid - 32 * kSlots;
    constexpr int NBT = 32 * kBulkWarps;
    for (int m = 0; m < M; ++m) {
      const int w = m % kSlots;
      const long b = blockIdx.x + static_cast<long>(m) * gridDim.x;
      const unsigned char* slot = smem + L.slot0 + w * L.slot_bytes;
      const T* stash = reinterpret_cast<const T*>(slot + L.stash);
      const T* fsl = reinterpret_cast<const T*>(slot + L.f);
      const int32_t* seg_t = reinterpret_cast<const int32_t*>(slot + L.seg_t);
      const int32_t* seg_start = reinterpret_cast<const int32_t*>(slot + L.seg_start);
      T* Ab = A + static_cast<size_t>(b) * NOUT * rowstride;
      for (int c = 0; c < nch; ++c) {
        bar_sync(1 + w, kSync);
        if constexpr (DT > 0) {
          // item (k, i, four consecutive j), all outcomes: 4 x NT sums in registers
          constexpr int JV = DT / 4;
          const int items = Kw * DT * JV;
          for (int x = bt; x < items; x += NBT) {
            const int jv = x % JV, i = (x / JV) % DT, k = x / (JV * DT);
            T* ap = Ab + static_cast<size_t>(k) * dd + i * DT + jv * 4;
            T acc[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              T* an = ap + static_cast<size_t>(n) * rowstride;
              if (c == 0) {
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[n][v] = T(0);
              } else if (vec) {
                ld4(an, acc[n]);
              } else {
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[n][v] = an[v];
              }
            }
            const T* sp = stash + i * NT;
            const T* fp = fsl + jv * 4;
            const int q1 = seg_start[k + 1];
            for (int q = seg_start[k]; q < q1; ++q) {
              const int tr = seg_t[q];
              T f[4];
              ld4(fp + tr * DT, f);
#pragma unroll
              for (int n2 = 0; n2 < NT / 2; ++n2) {
                const T2 u = *reinterpret_cast<const T2*>(sp + tr * S + 2 * n2);
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  acc[2 * n2][v] += u.x * f[v];
                  acc[2 * n2 + 1][v] += u.y * f[v];
                }
              }
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              T* an = ap + static_cast<size_t>(n) * rowstride;
              if (vec) {
                st_stream4(an, acc[n]);
              } else {
#pragma unroll
                for (int v = 0; v < 4; ++v) __stcs(an + v, acc[n][v]);
              }
            }
          }
        } else {
          const int items = NOUT * Kw * dd;
          for (int x = bt; x < items; x += NBT) {
            const int j = x % d, i = (x / d) % d, k = (x / dd) % Kw, n = x / (Kw * dd);
            T* ap = Ab + static_cast<size_t>(n) * rowstride + static_cast<size_t>(k) * dd
                    + i * d + j;
            T acc = c == 0 ? T(0) : *ap;
            const int q1 = seg_start[k + 1];
            for (int q = seg_start[k]; q < q1; ++q) {
              const int tr = seg_t[q];
              acc += stash[tr * S + i * NOUTp + n] * fsl[tr * d + j];
            }
            __stcs(ap, acc);
          }
        }
        bar_arrive(1 + kSlots + w, kSync);                   // the slot is free
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The two-stage route.

// Shared memory of a stage-1 block: Bc and the next Bc [NG][d], two chunks of
// RC rows of G[k].
template <typename T>
__host__ __device__ inline size_t chain_smem(int NG, int RC, int d) {
  return 2 * up16(sizeof(T) * NG * d) + 2 * up16(sizeof(T) * RC * d);
}

// Stage 1: block (b, outcome group) walks circuit b's depth for outcomes
// [n0, n0 + NG), step s = (layer D-1 - s / nck, chunk s % nck of G's rows).
template <typename T>
__global__ void __launch_bounds__(kChainThreads)
bwd_chain_kernel(const int32_t* __restrict__ cols, const T* __restrict__ G,
                 const T* __restrict__ E, T* __restrict__ stash, T* __restrict__ b_final,
                 int D, int K1, int d, int NOUT, int NG, int RC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long b = blockIdx.x;
  const int n0 = blockIdx.y * NG, tid = threadIdx.x;
  const int no = min(NG, NOUT - n0) * d;                   // this block's outputs (n, j)
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = reinterpret_cast<T*>(smem + up16(sizeof(T) * NG * d));
  T* ring = reinterpret_cast<T*>(smem + 2 * up16(sizeof(T) * NG * d));
  const size_t stage = up16(sizeof(T) * RC * d) / sizeof(T);
  const size_t dd = static_cast<size_t>(d) * d;
  const int nck = (d + RC - 1) / RC, steps = D * nck;
  const int32_t* cb = cols + b * D;

  auto op_of = [&](int s) { return s < steps ? __ldg(cb + (D - 1 - s / nck)) : -1; };
  auto issue = [&](int s, int k) {                        // step s's rows of G[k]
    if (s < steps && static_cast<unsigned>(k) < static_cast<unsigned>(K1)) {
      const int i0 = (s % nck) * RC, nr = min(d - i0, RC);
      copy_async(ring + (s & 1) * stage, G + k * dd + static_cast<size_t>(i0) * d,
                 nr * d * (int)sizeof(T), tid, kChainThreads);
    }
    cp_async_commit();
  };

  for (int o = tid; o < no; o += kChainThreads) cur[o] = E[(b * NOUT + n0) * d + o];
  int k0 = op_of(0);
  issue(0, k0);
  int k1 = op_of(1);
  for (int s = 0; s < steps; ++s) {
    const int k2 = op_of(s + 2);                          // used a step from now
    issue(s + 1, k1);
    cp_async_wait<1>();                                   // step s's rows have landed
    __syncthreads();
    const int t = D - 1 - s / nck, c = s % nck;
    if (c == 0) {
      T* dst = stash + ((b * D + t) * NOUT + n0) * d;
      for (int o = tid; o < no; o += kChainThreads) dst[o] = cur[o];
    }
    const bool valid = static_cast<unsigned>(k0) < static_cast<unsigned>(K1);
    const int i0 = c * RC, nr = min(d - i0, RC);
    const T* gs = ring + (s & 1) * stage;
    for (int o = tid; o < no; o += kChainThreads) {
      const int n = o / d, j = o - n * d;
      T acc = c == 0 ? T(0) : nxt[o];
      if (valid) {
        const T* bc = cur + n * d + i0;
        const T* gj = gs + j;
        T a[4] = {T(0), T(0), T(0), T(0)};
        int i = 0;
        for (; i + 4 <= nr; i += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] += bc[i + u] * gj[(i + u) * d];
        }
        for (; i < nr; ++i) a[0] += bc[i] * gj[i * d];
        acc += (a[0] + a[1]) + (a[2] + a[3]);
      }
      nxt[o] = acc;
    }
    if (c == nck - 1) {
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();                                      // the ring stage and Bc are free
    k0 = k1;
    k1 = k2;
  }
  cp_async_wait<0>();
  for (int o = tid; o < no; o += kChainThreads) b_final[(b * NOUT + n0) * d + o] = cur[o];
}

// Stage 2: block (b, k, tile) forms rows [tile * NV * m, (tile + 1) * NV * m)
// of A[b, :, k] seen as [NOUT d rows (n, i), d columns j].  Thread (ro, c)
// keeps column vector c (VEC consecutive j) of rows ro, ro + m, ..., with m
// = kTileThreads / (d / VEC) rows a step, so it reads one F vector and NV
// stash values a layer; where a row has more than kTileThreads vectors it
// takes them in passes.
template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads, 4)
bwd_tile_kernel(const int32_t* __restrict__ cols, const T* __restrict__ stash,
                const T* __restrict__ F, T* __restrict__ A,
                int D, int d, int NOUT, int Kw, long long rowstride, int ntile) {
  using V = typename Vec<T, VEC>::type;
  constexpr int NV = kTileValues / VEC;                   // rows a thread
  const int tile = blockIdx.x % ntile;
  const long bk = blockIdx.x / ntile;
  const int k = static_cast<int>(bk % Kw);
  const long b = bk / Kw;
  const int tid = threadIdx.x, lane = tid & 31;
  const int CG = d / VEC, CGB = CG < kTileThreads ? CG : kTileThreads;
  const int m = kTileThreads / CGB, rows = NOUT * d;
  const int ro = tid / CGB, r0 = tile * NV * m + ro;
  const int32_t* cb = cols + b * D;
  const T* sb = stash + b * D * rows + r0;
  T* Ab = A + b * NOUT * rowstride + k * static_cast<long>(d) * d;
  for (int c = tid % CGB; c - tid % CGB < CG; c += CGB) {   // passes: one where CG <= threads
    const bool on = ro < m && c < CG;
    const T* fb = F + b * D * d + (on ? c * VEC : 0);
    T acc[NV][VEC];
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[q][v] = T(0);
    for (int hb = D - 1; hb >= 0; hb -= 128) {
      // op k's layers among the next 128, descending t: four windows of cols
      // loaded at once, one bit a layer
      int kk[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int tr = hb - 32 * w - lane;
        kk[w] = tr >= 0 ? __ldg(cb + tr) : -1;
      }
      unsigned mw[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) mw[w] = __ballot_sync(0xffffffffu, kk[w] == k);
      unsigned long long lo = mw[0] | (static_cast<unsigned long long>(mw[1]) << 32);
      unsigned long long hi = mw[2] | (static_cast<unsigned long long>(mw[3]) << 32);
      while (on && (lo | hi)) {
        int t;
        if (lo) {
          t = hb - (__ffsll(lo) - 1);
          lo &= lo - 1;
        } else {
          t = hb - 64 - (__ffsll(hi) - 1);
          hi &= hi - 1;
        }
        const V fv = __ldg(reinterpret_cast<const V*>(fb + static_cast<long>(t) * d));
        const T* f = reinterpret_cast<const T*>(&fv);
        const T* st = sb + static_cast<long>(t) * rows;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const T sv = r0 + q * m < rows ? __ldg(st + q * m) : T(0);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[q][v] += sv * f[v];
        }
      }
    }
    if (!on) continue;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int r = r0 + q * m;
      if (r >= rows) break;
      const int n = r / d, i = r - n * d;
      V v;
      T* vp = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int u = 0; u < VEC; ++u) vp[u] = acc[q][u];
      __stcs(reinterpret_cast<V*>(Ab + n * rowstride + static_cast<long>(i) * d + c * VEC), v);
    }
  }
}

// The device's SM count and the shared memory a block may opt in to, asked
// once per device.
int device_limits(int* dev, int* sms, size_t* smem_max) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static int sm_count[64], smem_optin[64];
  if (sm_count[*dev] == 0) {
    int optin = 0, count = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_optin[*dev] = optin;
    sm_count[*dev] = count;
  }
  *sms = sm_count[*dev];
  *smem_max = smem_optin[*dev];
  return 0;
}

// Let `kernel` use smem bytes of dynamic shared memory on device dev (once
// per device and size, `granted` being the kernel's own record).
template <typename K>
cudaError_t allow_smem(K kernel, int dev, size_t smem, size_t (&granted)[64]) {
  if (smem <= 48 * 1024 || smem <= granted[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted[dev] = smem;
  return err;
}

template <typename T, int DT, int NT>
int launch_shared(const void* cols, const void* G, const void* E, const void* F,
                  void* A, void* b_final, int B, int D, int K1, int d, int NOUT, int Kw,
                  long long rowstride, int dev, int sms, size_t smem_max, void* stream) {
  auto kernel = bwd_jacobian_kernel<T, DT, NT>;
  // chunks of equal length, as long as the shared memory allows
  int DC = D;
  while (DC > 1 && layout<T>(DC, K1, d, NOUT).total > smem_max) {
    const int nch = (D + DC - 1) / DC + 1;
    DC = (D + nch - 1) / nch;
  }
  const size_t smem = layout<T>(DC, K1, d, NOUT).total;
  if (smem > smem_max) return -static_cast<int>(smem);
  static size_t granted[64];
  cudaError_t err = allow_smem(kernel, dev, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // resident blocks per SM, asked once per device and shared-memory size
  constexpr int kOccSlots = 16;
  static size_t occ_smem[64][kOccSlots];
  static int occ_blocks[64][kOccSlots];
  static int occ_next[64];
  int per_sm = 0;
  for (int s = 0; s < kOccSlots; ++s)
    if (occ_smem[dev][s] == smem) { per_sm = occ_blocks[dev][s]; break; }
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int s = occ_next[dev]++ % kOccSlots;
    occ_smem[dev][s] = smem;
    occ_blocks[dev][s] = per_sm;
  }
  const bool vec = rowstride % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const long grid = B < (long)sms * per_sm ? B : (long)sms * per_sm;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(G), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<T*>(A), static_cast<T*>(b_final),
      B, D, K1, d, NOUT, DC, Kw, rowstride, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_two_stage(const void* cols, const void* G, const void* E, const void* F,
                     void* A, void* b_final, void* stash, int B, int D, int K1, int d,
                     int NOUT, int Kw, long long rowstride, int dev, size_t smem_max,
                     void* stream) {
  // stage 1: at most kChainOutcomes outcomes a block (at 3 qubits two blocks
  // a circuit: eight outcomes a block were slower on the H100, two no
  // faster), G[k] whole where two fit
  int NG = NOUT < kChainOutcomes ? NOUT : kChainOutcomes;
  while (NG > 1 && chain_smem<T>(NG, 1, d) > smem_max) --NG;
  if (chain_smem<T>(NG, 1, d) > smem_max) return -static_cast<int>(chain_smem<T>(NG, 1, d));
  int RC = d;
  while (RC > 1 && chain_smem<T>(NG, RC, d) > smem_max) {
    const int nck = (d + RC - 1) / RC + 1;
    RC = (d + nck - 1) / nck;
  }
  const size_t smem = chain_smem<T>(NG, RC, d);
  auto chain = bwd_chain_kernel<T>;
  static size_t granted[64];
  cudaError_t err = allow_smem(chain, dev, smem, granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain<<<dim3(B, (NOUT + NG - 1) / NG), kChainThreads, smem, st>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(G), static_cast<const T*>(E),
      static_cast<T*>(stash), static_cast<T*>(b_final), D, K1, d, NOUT, NG, RC);
  err = cudaGetLastError();
  if (err != cudaSuccess || Kw == 0) return static_cast<int>(err);
  // stage 2: 16-byte accesses where d, rowstride and the pointers allow them
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && rowstride % VEC == 0
                   && ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(F)) & 15) == 0;
  const int CG = d / (vec ? VEC : 1);
  const int rows_per_tile = kTileThreads / (CG < kTileThreads ? CG : kTileThreads)
                            * (kTileValues / (vec ? VEC : 1));
  const int ntile = (NOUT * d + rows_per_tile - 1) / rows_per_tile;
  const long blocks = static_cast<long>(B) * Kw * ntile;
  auto tile = vec ? bwd_tile_kernel<T, VEC> : bwd_tile_kernel<T, 1>;
  tile<<<static_cast<unsigned>(blocks), kTileThreads, 0, st>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(stash),
      static_cast<const T*>(F), static_cast<T*>(A), D, d, NOUT, Kw, rowstride, ntile);
  return static_cast<int>(cudaGetLastError());
}

// G in shared memory where it takes at most half of it and fits beside one
// layer's buffers (so that the chunks keep at least half), else the
// two-stage route.
template <typename T>
bool g_fits_shared(int K1, int d, int NOUT, size_t smem_max) {
  return 2 * sizeof(T) * K1 * d * d <= smem_max
      && layout<T>(1, K1, d, NOUT).total <= smem_max;
}

template <typename T>
int launch(const void* cols, const void* G, const void* E, const void* F, void* A,
           void* b_final, void* stash, int B, int D, int K1, int d, int NOUT, int Kw,
           long long rowstride, void* stream) {
  if (B <= 0 || D <= 0 || K1 <= 0 || d <= 0 || NOUT <= 0 || Kw < 0 || Kw > K1
      || rowstride < static_cast<long long>(Kw) * d * d)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  size_t smem_max = 0;
  const int err = device_limits(&dev, &sms, &smem_max);
  if (err != 0) return err;
  if (!g_fits_shared<T>(K1, d, NOUT, smem_max)) {
    if (stash == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_two_stage<T>(cols, G, E, F, A, b_final, stash, B, D, K1, d, NOUT, Kw,
                               rowstride, dev, smem_max, stream);
  }
  if (d == 16 && NOUT == 4)
    return launch_shared<T, 16, 4>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, Kw,
                                   rowstride, dev, sms, smem_max, stream);
  return launch_shared<T, 0, 0>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, Kw, rowstride,
                                dev, sms, smem_max, stream);
}

}  // namespace

// stash: scratch [B, D, NOUT, d] of the two-stage route (null on the shared
// route); A + (b * NOUT + n) * rowstride + k * d * d receives A[b, n, k]
// for k < Kw.  Returns 0, a CUDA error code, or minus the shared memory a
// refused shape would need.
extern "C" int bwd_jacobian_accumulate_f64(const void* cols, const void* G, const void* E,
                                           const void* F, void* A, void* b_final,
                                           void* stash, int B, int D, int K1, int d,
                                           int NOUT, int Kw, long long rowstride,
                                           void* stream) {
  return launch<double>(cols, G, E, F, A, b_final, stash, B, D, K1, d, NOUT, Kw, rowstride,
                        stream);
}

extern "C" int bwd_jacobian_accumulate_f32(const void* cols, const void* G, const void* E,
                                           const void* F, void* A, void* b_final,
                                           void* stash, int B, int D, int K1, int d,
                                           int NOUT, int Kw, long long rowstride,
                                           void* stream) {
  return launch<float>(cols, G, E, F, A, b_final, stash, B, D, K1, d, NOUT, Kw, rowstride,
                       stream);
}

// The route a launch on the current device takes for this shape: 1 with G in
// shared memory, 0 for the two-stage route, minus a CUDA error code if the
// device cannot be asked.  value_bytes is 8 (float64) or 4 (float32).
extern "C" int bwd_jacobian_g_in_shared(int value_bytes, int K1, int d, int NOUT) {
  int dev = 0, sms = 0;
  size_t smem_max = 0;
  const int err = device_limits(&dev, &sms, &smem_max);
  if (err != 0) return -err;
  return value_bytes == 8 ? g_fits_shared<double>(K1, d, NOUT, smem_max)
                          : g_fits_shared<float>(K1, d, NOUT, smem_max);
}
