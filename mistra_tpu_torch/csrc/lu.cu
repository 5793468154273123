// Batched dense matrix inverse by Gauss-Jordan with partial pivoting, for
// Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of mistra_tpu/chemistry/lu_pallas.py:
//   _lu_kernel   (no-pivot Doolittle elimination into packed LU) and
//   _inv_kernel  (explicit inverse from the packed LU, stored transposed),
// which the JAX package split in two only to fit the TPU's VMEM, and which
// it ran only for float32 on a TPU (every other backend pivots).  This
// kernel does the whole inverse in one pass, with row pivoting, in float32
// and float64.  The arithmetic is that of the plain torch version
// (mistra_tpu_torch/chemistry/lu.py: batched_inv_plain), operation by
// operation: build with -fmad=false so no multiply-add is contracted.
//
// Work: N independent m x m matrices (the block-arrow stage solver calls
// it on [B*nbin, ma, ma] aqueous blocks and the [B, mg, mg] Schur
// complement; ma = 80, mg = 101 for the tot mechanism, B = 2048 cells).
// Per matrix: m steps of a pivot search over one column and a rank-1
// update of all m*m entries, ~2 m^3 flops on m^2 values read once from
// device memory, so the kernel is bound by shared-memory traffic and the
// per-step barriers, not by device memory.
//
// Design (simple first): one thread block of 256 threads owns one matrix,
// held in dynamic shared memory (m = 101 in float64: 81.6 KB, above the
// 48 KB default, so the launch raises the block's limit).  Step k: a block
// argmax of |c[i, k]| over the rows not yet used (warp shuffles, then the
// 8 warp results; the first row on a tie), the pivot row scaled into
// scratch, then every thread updates its entries.  Rows are not swapped:
// the pivot order is recorded and undone when the result is written.
// The eliminated column k holds, from step k on, the inverse's column that
// the augmented form [A | I] would carry on its right (the classic
// in-place Gauss-Jordan), so one m*m array suffices.  A zero pivot gives
// non-finite output, as in the plain version; the Ros3 integrator treats
// it as a rejected step.  wgmma, TMA and several matrices per block are
// left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;                 // warp-result slots in smem
constexpr size_t kMaxSmem = 232448;        // 227 KB: a block's opt-in limit

template <typename T>
size_t smem_bytes(int m) {
  return (size_t(m) * m + 2 * size_t(m) + kSlots) * sizeof(T) +
         (2 * size_t(m) + kSlots) * sizeof(int);
}

// Is (va, ia) a better pivot candidate than (vb, ib)?  The larger value,
// NaN above all (as torch.argmax), and the lower row on a tie.
template <typename T>
__device__ __forceinline__ bool better(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const T* __restrict__ a, T* __restrict__ out, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mm = m * m;
  T* c = reinterpret_cast<T*>(smem);       // [m, m] working matrix
  T* rowp = c + mm;                        // [m] scaled pivot row
  T* f = rowp + m;                         // [m] multipliers (column k)
  T* wval = f + m;                         // [kSlots] warp candidates
  int* used = reinterpret_cast<int*>(wval + kSlots);  // [m] row used
  int* perm = used + m;                    // [m] pivot row of step k
  int* widx = perm + m;                    // [kSlots]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* A = a + size_t(blockIdx.x) * mm;
  T* O = out + size_t(blockIdx.x) * mm;
  for (int e = tid; e < mm; e += kThreads) c[e] = A[e];
  for (int i = tid; i < m; i += kThreads) used[i] = 0;
  // this thread's first entry (i0, j0) and its stride in (rows, cols)
  const int i0 = tid / m, j0 = tid - i0 * m;
  const int di = kThreads / m, dj = kThreads - di * m;
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    // ---- pivot: argmax |c[i, k]| over the unused rows -----------------
    T bv = T(-1);
    int bi = m;
    for (int i = tid; i < m; i += kThreads) {
      const T v = used[i] ? T(-1) : fabs(c[i * m + k]);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { wval[warp] = bv; widx[warp] = bi; }
    __syncthreads();
    T pv = wval[0];
    int p = widx[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(wval[w], widx[w], pv, p)) { pv = wval[w]; p = widx[w]; }
    }
    const T piv = c[p * m + k];

    // ---- scaled pivot row and multipliers ------------------------------
    for (int j = tid; j < m; j += kThreads) {
      rowp[j] = j == k ? T(1) / piv : c[p * m + j] / piv;
      f[j] = j == p ? T(0) : c[j * m + k];
    }
    __syncthreads();

    // ---- rank-1 update; column k becomes the inverse's column ----------
    int i = i0, j = j0;
    for (int e = tid; e < mm; e += kThreads) {
      T v;
      if (i == p) {
        v = rowp[j];
      } else if (j == k) {
        v = T(0) - f[i] * rowp[k];
      } else {
        v = c[e] - f[i] * rowp[j];
      }
      c[e] = v;
      i += di;
      j += dj;
      if (j >= m) { j -= m; ++i; }
    }
    if (tid == 0) { used[p] = 1; perm[k] = p; }
    __syncthreads();
  }

  // ---- undo the pivot order: inv[k, perm[q]] = c[perm[k], q] ----------
  int* iperm = used;                       // iperm[perm[q]] = q
  for (int q = tid; q < m; q += kThreads) iperm[perm[q]] = q;
  __syncthreads();
  int r = i0, s = j0;
  for (int e = tid; e < mm; e += kThreads) {
    O[e] = c[perm[r] * m + iperm[s]];
    r += di;
    s += dj;
    if (s >= m) { s -= m; ++r; }
  }
}

template <typename T>
int inverse(const void* a, void* out, int n, int m, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes<T>(m);
  if (m < 1 || smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  gj_inverse_kernel<T><<<n, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), m);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  a and out are device pointers of
// contiguous [n, m, m] arrays (out may not alias a); stream is a
// cudaStream_t.  Each returns cudaGetLastError() after the launch, or the
// error of a refused configuration.
extern "C" {

int batched_inv_f32(const void* a, void* out, int n, int m, void* stream) {
  return inverse<float>(a, out, n, m, stream);
}

int batched_inv_f64(const void* a, void* out, int n, int m, void* stream) {
  return inverse<double>(a, out, n, m, stream);
}

}  // extern "C"
