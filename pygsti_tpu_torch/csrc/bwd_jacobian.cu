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
// and return A [B, NOUT, K1, d, d] and Bc_{-1} as B_final [B, NOUT, d].  An
// op index outside [0, K1) selects nothing, as the reference's one-hot
// contraction does: it adds nothing to A and zeroes Bc.
//
// What bounds it on the H100: bytes.  A is written once (B*NOUT*K1*d*d
// values: 811 MB in float64 over the 2-qubit fit's five depth buckets, with
// K1 = 7, d = 16, NOUT = 4), F, E and cols are read once; 888 MB in all, or
// 0.265 ms at 3.35 TB/s.  The multiply-adds (1.9 GFLOP) take a quarter of
// that at the float64 rate outside the tensor cores.  What stands in the way
// of the store rate is the serial chain Bc_{D-1} -> ... -> Bc_{-1}: D
// dependent small products per circuit, a few hundred cycles each.
//
// The design: a persistent grid (as many blocks as fit on the SMs at once),
// each block split by role.
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
//     neighbouring addresses: no accumulator in shared memory, no K1-fold
//     masked work, no atomics.
//   A slot passes from its chain warp to the bulk warps and back through two
//   named barriers (full: bar.arrive by the chain warp, bar.sync by the
//   bulk; empty: the reverse), so a chain warp starts its next circuit while
//   the bulk warps store the last one.  The summation order is fixed (by op,
//   then by layer), so two launches give bitwise equal results.
//
// Where the op stack G lives (template flag GS).  Where G (K1 x d^2 values)
// takes at most half the shared memory a block may opt in to on the device
// and fits beside one layer's buffers, each block copies G into shared
// memory once (GS = true: every 2-qubit and qutrit shape).  Otherwise G
// stays in global memory (GS = false) and the chain warps read the columns
// G[k][:, j] they need through the read-only path (__ldg); the bulk warps
// never read G.  At d 64 a stack of 10-30 ops
// is 0.3-1 MB, which stays resident in the H100's 50 MB L2, so those reads
// cost L2 bandwidth rather than HBM bandwidth.  Shared memory then holds
// only the slots and the warps' buffers, chunked as below.
//
// Shapes.  d = 16, NOUT = 4 (2 qubits) has a compile-time path; any other d
// and NOUT take a path that reads them at run time.  Any depth: where the
// stash for D layers exceeds shared memory, a circuit is walked in chunks of
// DC layers from the top; the chain carries Bc across chunks and the bulk
// adds each chunk into A (a read of the thread's own earlier store).  Any B:
// the grid has at most B blocks and each block takes every gridDim.x-th
// circuit.  A shape whose buffers for one layer do not fit the shared memory
// a block may opt in to, even with G in global memory, is refused: the
// launcher returns minus the bytes it would need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4;        // chain warps (circuits in flight) per block
constexpr int kBulkWarps = 4;    // warps that form and store A
constexpr int kThreads = 32 * (kSlots + kBulkWarps);
constexpr int kSync = 32 * (1 + kBulkWarps);   // one chain warp and the bulk warps

template <typename T> struct Two;
template <> struct Two<double> { using type = double2; };
template <> struct Two<float> { using type = float2; };

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

// Byte offsets in shared memory for chunks of DC layers, with G at offset 0
// when it lives there (g_shared).  Slot s (one per chain warp) starts at
// slot0 + s * slot_bytes; the chain warp's own buffers at warp0 + s *
// warp_bytes.
struct Layout {
  size_t g, slot0, slot_bytes, stash, f, seg_t, seg_start;
  size_t warp0, warp_bytes, carry, ce, ce_bytes, ce_e, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int DC, int K1, int d, int NOUT, bool g_shared) {
  const size_t NOUTp = NOUT + (NOUT & 1);
  Layout L;
  L.g = 0;
  L.slot0 = g_shared ? up16(sizeof(T) * K1 * d * d) : 0;
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

// One warp copies nbytes (a multiple of 4) to 16-byte aligned shared memory:
// 16 bytes a lane where the source is aligned for it, 4 bytes otherwise.
__device__ __forceinline__ void warp_copy_async(void* sdst, const void* gsrc, int nbytes,
                                                int lane) {
  char* s = static_cast<char*>(sdst);
  const char* g = static_cast<const char*>(gsrc);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n16 = nbytes >> 4;
    for (int x = lane; x < n16; x += 32) cp_async16(s + 16 * x, g + 16 * x);
    done = n16 << 4;
  }
  for (int x = (done >> 2) + lane; x < (nbytes >> 2); x += 32) cp_async4(s + 4 * x, g + 4 * x);
}

// One value of the op stack: from shared memory (GS), or from global memory
// through the read-only data path.
template <bool GS, typename T>
__device__ __forceinline__ T ld_g(const T* p) {
  if constexpr (GS) return *p;
  else return __ldg(p);
}

// DT, NT: d and NOUT known at compile time (the fast path: NT / 2 * DT = 32,
// so each chain lane owns one column j of one outcome pair); 0, 0: any d and
// NOUT, read at run time.  GS: G in shared memory (true) or global (false).
template <typename T, int DT, int NT, bool GS>
__global__ void __launch_bounds__(kThreads, 1)
bwd_jacobian_kernel(const int32_t* __restrict__ cols, const T* __restrict__ G,
                    const T* __restrict__ E, const T* __restrict__ F,
                    T* __restrict__ A, T* __restrict__ b_final,
                    int B, int D, int K1, int d_rt, int nout_rt, int DC) {
  using T2 = typename Two<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = DT ? DT : d_rt;
  const int NOUT = NT ? NT : nout_rt;
  const Layout L = layout<T>(DC, K1, d, NOUT, GS);
  const T* g = GS ? reinterpret_cast<const T*>(smem + L.g) : G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NOUTp = NOUT + (NOUT & 1);
  const int S = d * NOUTp;               // one stash row, [i][n]
  const int dd = d * d;
  const int nch = (D + DC - 1) / DC;
  const int M = (B - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;

  if constexpr (GS) {
    T* gs = reinterpret_cast<T*>(smem + L.g);
    for (int x = tid; x < K1 * dd; x += kThreads) gs[x] = G[x];
    __syncthreads();
  }

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
        warp_copy_async(buf, cols + b * D + t_lo, (t_hi - t_lo) * 4, lane);
        if (c == 0)
          warp_copy_async(buf + L.ce_e, E + b * NOUT * d, NOUT * d * (int)sizeof(T), lane);
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
        warp_copy_async(fsl, F + (b * D + t_lo) * d, nt * d * (int)sizeof(T), lane);
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
          for (int i = 0; i < DT; ++i) gc[i] = ld_g<GS>(g + (valid ? k : 0) * dd + i * DT + j);
          for (int r = nt - 1; r >= 0; --r) {
            const int kn = r > 0 ? cs[r - 1] : 0;
            const bool vn = static_cast<unsigned>(kn) < static_cast<unsigned>(K1);
#pragma unroll
            for (int i = 0; i < DT; ++i) gn[i] = ld_g<GS>(g + (vn ? kn : 0) * dd + i * DT + j);
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
                for (int i = 0; i < d; ++i) acc += row[i * NOUTp + n] * ld_g<GS>(gk + i * d);
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
      T* Ab = A + static_cast<size_t>(b) * NOUT * K1 * dd;
      for (int c = 0; c < nch; ++c) {
        bar_sync(1 + w, kSync);
        if constexpr (DT > 0) {
          // item (k, i, four consecutive j), all outcomes: 4 x NT sums in registers
          constexpr int JV = DT / 4;
          const int items = K1 * DT * JV;
          for (int x = bt; x < items; x += NBT) {
            const int jv = x % JV, i = (x / JV) % DT, k = x / (JV * DT);
            T* ap = Ab + static_cast<size_t>(k) * dd + i * DT + jv * 4;
            T acc[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (c == 0) {
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[n][v] = T(0);
              } else {
                ld4(ap + static_cast<size_t>(n) * K1 * dd, acc[n]);
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
            for (int n = 0; n < NT; ++n) st_stream4(ap + static_cast<size_t>(n) * K1 * dd, acc[n]);
          }
        } else {
          const int items = NOUT * K1 * dd;
          for (int x = bt; x < items; x += NBT) {
            const int j = x % d, i = (x / d) % d, k = (x / dd) % K1, n = x / (K1 * dd);
            T* ap = Ab + x;
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

template <typename T, int DT, int NT, bool GS>
int launch_shape(const void* cols, const void* G, const void* E, const void* F,
                 void* A, void* b_final, int B, int D, int K1, int d, int NOUT,
                 int dev, int sms, size_t smem_max, void* stream) {
  auto kernel = bwd_jacobian_kernel<T, DT, NT, GS>;
  // chunks of equal length, as long as the shared memory allows
  int DC = D;
  while (DC > 1 && layout<T>(DC, K1, d, NOUT, GS).total > smem_max) {
    const int nch = (D + DC - 1) / DC + 1;
    DC = (D + nch - 1) / nch;
  }
  const size_t smem = layout<T>(DC, K1, d, NOUT, GS).total;
  if (smem > smem_max) return -static_cast<int>(smem);
  static size_t granted[64];
  cudaError_t err;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted[dev] = smem;
  }
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
  const long grid = B < (long)sms * per_sm ? B : (long)sms * per_sm;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(G), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<T*>(A), static_cast<T*>(b_final),
      B, D, K1, d, NOUT, DC);
  return static_cast<int>(cudaGetLastError());
}

// G in shared memory where it takes at most half of it and fits beside one
// layer's buffers (so that the chunks keep at least half), else global.
template <typename T>
bool g_fits_shared(int K1, int d, int NOUT, size_t smem_max) {
  return 2 * sizeof(T) * K1 * d * d <= smem_max
      && layout<T>(1, K1, d, NOUT, true).total <= smem_max;
}

template <typename T, int DT, int NT>
int launch_route(const void* cols, const void* G, const void* E, const void* F,
                 void* A, void* b_final, int B, int D, int K1, int d, int NOUT,
                 void* stream) {
  int dev = 0, sms = 0;
  size_t smem_max = 0;
  const int err = device_limits(&dev, &sms, &smem_max);
  if (err != 0) return err;
  if (g_fits_shared<T>(K1, d, NOUT, smem_max))
    return launch_shape<T, DT, NT, true>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT,
                                         dev, sms, smem_max, stream);
  return launch_shape<T, DT, NT, false>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT,
                                        dev, sms, smem_max, stream);
}

template <typename T>
int launch(const void* cols, const void* G, const void* E, const void* F,
           void* A, void* b_final, int B, int D, int K1, int d, int NOUT,
           void* stream) {
  if (B <= 0 || D <= 0 || K1 <= 0 || d <= 0 || NOUT <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 16 && NOUT == 4)
    return launch_route<T, 16, 4>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, stream);
  return launch_route<T, 0, 0>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, stream);
}

}  // namespace

extern "C" int bwd_jacobian_accumulate_f64(const void* cols, const void* G,
                                           const void* E, const void* F,
                                           void* A, void* b_final, int B,
                                           int D, int K1, int d, int NOUT,
                                           void* stream) {
  return launch<double>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, stream);
}

extern "C" int bwd_jacobian_accumulate_f32(const void* cols, const void* G,
                                           const void* E, const void* F,
                                           void* A, void* b_final, int B,
                                           int D, int K1, int d, int NOUT,
                                           void* stream) {
  return launch<float>(cols, G, E, F, A, b_final, B, D, K1, d, NOUT, stream);
}

// The route a launch on the current device takes for this shape: 1 with G in
// shared memory, 0 with G in global memory, minus a CUDA error code if the
// device cannot be asked.  value_bytes is 8 (float64) or 4 (float32).
extern "C" int bwd_jacobian_g_in_shared(int value_bytes, int K1, int d, int NOUT) {
  int dev = 0, sms = 0;
  size_t smem_max = 0;
  const int err = device_limits(&dev, &sms, &smem_max);
  if (err != 0) return -err;
  return value_bytes == 8 ? g_fits_shared<double>(K1, d, NOUT, smem_max)
                          : g_fits_shared<float>(K1, d, NOUT, smem_max);
}
