// Backward accumulation of the blocked GST Jacobian, for NVIDIA Hopper (sm_90a).
//
// Replaces: pygsti_tpu/ops/pallas_kernels.py, bwd_jacobian_accumulate (the
// Pallas TPU kernel, body _kernel), called from the 'blocked' Jacobian of
// pygsti_tpu/objectivefns/objectivefns.py (_block_probs_jac).
//
// What it computes.  For each circuit b and outcome n, start from the effect
// row Bc = E[b, n] and walk the circuit depth backwards.  At layer t, with
// k = cols[b, t] and F[b, t] the state before that layer:
//     A[b, n, k, i, j] += Bc[i] * F[b, t, j]
//     Bc[j]            <- sum_i Bc[i] * G[k, i, j]
// and return A [B, NOUT, K1, d, d] and the final Bc as B_final [B, NOUT, d].
// An op index outside [0, K1) selects nothing, as the reference's one-hot
// contraction does: it adds nothing to A and zeroes Bc.
//
// What bounds it on the H100.  Bytes: A is written once (B*NOUT*K1*d*d
// values, 287 MB in float64 for a 5,000-circuit block of the 2-qubit fit with
// K1 = 7, d = 16, NOUT = 4), F and E are read once.  The arithmetic is one
// multiply-add per A element per layer, far below the card's rate.
//
// The first design.  The TPU kernel keeps the accumulator for a 128-circuit
// tile in VMEM; that does not fit one SM (one circuit's A is 57 KB in
// float64).  Here one thread block owns one (circuit, outcome) pair: its
// K1*d*d accumulator (14 KB in float64 at the 2-qubit shapes) and the op
// stack G live in shared memory, the d*d threads each own one (i, j) entry
// and add Bc[i]*F[t, j] into slot cols[t], and after a barrier d threads form
// the new Bc from G[k].  A is written to device memory once, at the end, with
// consecutive threads on consecutive addresses.  Speed is later work: every
// block reloads G, reads its circuit's F once per outcome, and synchronises
// twice per layer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void bwd_jacobian_kernel(const int32_t* __restrict__ cols,
                                    const T* __restrict__ G,
                                    const T* __restrict__ E,
                                    const T* __restrict__ F,
                                    T* __restrict__ A,
                                    T* __restrict__ b_final,
                                    int D, int K1, int d, int NOUT) {
  extern __shared__ unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [K1, d, d]
  T* g = acc + K1 * d * d;                  // [K1, d, d]
  T* bc = g + K1 * d * d;                   // [d]
  T* f = bc + d;                            // [d]

  const long pair = blockIdx.x;             // b * NOUT + n
  const long b = pair / NOUT;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int dd = d * d;
  const int kdd = K1 * dd;

  for (int x = tid; x < kdd; x += nthreads) {
    acc[x] = T(0);
    g[x] = G[x];
  }
  if (tid < d) bc[tid] = E[pair * d + tid];
  __syncthreads();

  const int32_t* cb = cols + b * D;
  const T* fb = F + b * (long)D * d;
  for (int t = D - 1; t >= 0; --t) {
    const int k = cb[t];
    const bool valid = (k >= 0) && (k < K1);
    if (tid < d) f[tid] = fb[(long)t * d + tid];
    __syncthreads();
    if (valid) {
      T* acck = acc + k * dd;
      for (int x = tid; x < dd; x += nthreads) {
        const int i = x / d;
        const int j = x - i * d;
        acck[x] += bc[i] * f[j];
      }
    }
    T nb = T(0);
    if (tid < d && valid) {
      const T* gk = g + k * dd;
      for (int i = 0; i < d; ++i) nb += bc[i] * gk[i * d + tid];
    }
    __syncthreads();
    if (tid < d) bc[tid] = nb;
  }
  __syncthreads();

  T* ab = A + pair * kdd;
  for (int x = tid; x < kdd; x += nthreads) ab[x] = acc[x];
  if (tid < d) b_final[pair * d + tid] = bc[tid];
}

template <typename T>
int launch(const void* cols, const void* G, const void* E, const void* F,
           void* A, void* b_final, int B, int D, int K1, int d, int NOUT,
           void* stream) {
  if ((long)B * NOUT == 0) return 0;
  int threads = d * d;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  threads = (threads + 31) / 32 * 32;
  const size_t smem = (size_t)(2 * K1 * d * d + 2 * d) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_jacobian_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bwd_jacobian_kernel<T><<<(unsigned int)((long)B * NOUT), threads, smem,
                           (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const T*)G, (const T*)E, (const T*)F, (T*)A,
      (T*)b_final, D, K1, d, NOUT);
  return (int)cudaGetLastError();
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
