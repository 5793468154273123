// Vertical sedimentation advection of rows of nf levels, for Hopper (sm_90a):
// Bott's 4th-order monotone form (advsed1) and the upstream form (advsed0)
// in one kernel, chosen per row, and sedl's fixed Courant splits in the
// same launch.
//
// Replaces no TPU kernel.  The JAX package's advsed1
// (mistra_tpu/physics/sedimentation.py) is a lax.scan over the levels that
// XLA compiles into one loop; the port's plain version
// (mistra_tpu_torch/physics/sedimentation.py: advsed1) is a Python
// loop over nf - 2 levels of ~37 elementwise launches each, ~3,600
// launches per call, and sedl makes 8 such calls per substep.  This kernel
// does a whole call, or all of sedl's splits, in one launch.
//
// Arithmetic: that of the plain torch versions on the card, operation by
// operation and in the same order, so that the results are bit-equal to
// them in float32 and float64.  Built with -fmad=false, so no multiply and
// add are contracted.  PyTorch's CUDA division of a tensor by a Python
// number multiplies by the number's reciprocal rounded to the tensor's
// type, so /1920.0, /384.0, ... are multiplications by T(1)/T(1920), ...;
// a tensor divided by a tensor is an IEEE division, as here.  minimum,
// maximum and clamp propagate NaN as torch.minimum, torch.maximum and
// torch.clamp do, and otherwise use fmin/fmax, as PyTorch's kernels do.
//
// Bound: bytes.  A call reads c and y and writes the result once, 3 * rows
// * nf values (376.3 MB in float32 at btz96.ens64's sedp, 313,600 rows of
// 100 levels; 0.112 ms at 3.35 TB/s); the splits read the per-row xxxt and
// dt0 and write the per-row ground deposit besides.  The arithmetic, ~70
// operations per level and row and split, stays far below the card's
// rates.
//
// Design: one thread per row, kRows = 32 rows (one warp) per block.  The
// block loads its rows of y and c, contiguous in device memory, with
// coalesced loads into shared memory at an odd row stride (nf | 1), so that
// the 32 threads, each walking its own row, touch 32 distinct banks; each
// thread advects its row in place, and the block stores the rows back with
// coalesced stores.  Bott's recurrence couples the levels from the top
// down: the thread carries fm[j] in a register from the top interface to
// level 1, computes the polynomial coefficients of level j from the five
// levels y[j-2..j+2], kept in a sliding window of registers, and writes
// level j's result as soon as fm[j-1] is known (the window still holds the
// levels that the next step reads).  The upstream form walks bottom-up.
// Splits (nsplit > 0, sedl): each split sets the ghost level y[0] = y[1],
// scales the row's Courant numbers by dtmax = min(dt0, xxxt), advects, adds
// the flux out of level 1 to the ground deposit and takes dtmax from dt0,
// while dt0 > 0.1; a row whose dt0 falls to 0.1 stops, as the plain
// version's masked iterations leave it.  The last residual dt0 is dropped,
// as in the plain version (a known defect of the JAX package, matched).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 32;  // rows, one per thread, in a block
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float fmin_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_t(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fmax_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_t(double a, double b) { return fmax(a, b); }

// torch.minimum(a, b), torch.maximum(a, b): a NaN operand propagates
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmin_t(a, b);
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmax_t(a, b);
}
// torch.clamp(v, min=0.0) and torch.clamp(v, max=0.0)
template <typename T>
__device__ __forceinline__ T clamp_min0(T v) {
  return v != v ? v : fmax_t(v, T(0));
}
template <typename T>
__device__ __forceinline__ T clamp_max0(T v) {
  return v != v ? v : fmin_t(v, T(0));
}

// advsed1 on one row y[0..nf-1] in place; cv(j) is the Courant
// number of level j (read at j = 0..nf-2).
template <typename T, typename CV>
__device__ void bott_row(T* y, const CV& cv, int nf) {
  const T r1920 = T(1) / T(1920), r384 = T(1) / T(384),
          r768 = T(1) / T(768), r3840 = T(1) / T(3840), r24 = T(1) / T(24),
          r16 = T(1) / T(16), r48 = T(1) / T(48);
  // boundary flux at the top interior interface
  const T ytop = y[nf - 1];
  T cl = -cv(nf - 2);
  const T fm_top = minimum(
      ytop, cl * (ytop - (T(1) - cl) * (ytop - y[nf - 2]) * T(0.5)));
  T fm = fm_top;
  // y[j-2], y[j-1], y[j], y[j+1], y[j+2] of the level j being walked (the
  // original values: results go to y[j] only after the window moved past)
  T zm2 = nf >= 4 ? y[nf - 4] : T(0), zm1 = y[nf - 3], z0 = y[nf - 2],
    zp1 = ytop, zp2 = T(0);
  for (int j = nf - 2; j >= 1; --j) {
    T a0, a1, a2, a3, a4;
    if (j == 1 || j == nf - 2) {  // second-order forms
      a0 = (T(26) * z0 - zp1 - zm1) * r24;
      a1 = (zp1 - zm1) * r16;
      a2 = (zp1 + zm1 - T(2) * z0) * r48;
      a3 = T(0);
      a4 = T(0);
    } else {
      a0 = (T(9) * (zp2 + zm2) - T(116) * (zp1 + zm1) + T(2134) * z0) * r1920;
      a1 = (T(-5) * (zp2 - zm2) + T(34) * (zp1 - zm1)) * r384;
      a2 = (-zp2 + T(12) * (zp1 + zm1) - T(22) * z0 - zm2) * r384;
      a3 = (zp2 - T(2) * (zp1 - zm1) - zm2) * r768;
      a4 = (zp2 - T(4) * (zp1 + zm1) + T(6) * z0 + zm2) * r3840;
    }
    const T clm = -cv(j - 1);
    const T x1 = T(1) - T(2) * cl;
    const T x2 = x1 * x1;
    const T x3 = x1 * x2;
    const T ymin = minimum(z0, zp1);
    const T ymax = maximum(z0, zp1);
    T f = clamp_min0(a0 * cl - a1 * (T(1) - x2) + a2 * (T(1) - x3)
                     - a3 * (T(1) - x1 * x3) + a4 * (T(1) - x2 * x3));
    f = minimum(f, z0 - ymin + fm);
    f = maximum(f, z0 - ymax + fm);
    f = clamp_min0(f - (cl - clm) * z0);
    const T w = z0 / maximum(f + T(1.0e-15), z0);
    const T fm_below = f * w;  // fm[j-1]
    y[j] = z0 - fm_below + fm;
    fm = fm_below;
    cl = clm;
    zp2 = zp1;
    zp1 = z0;
    z0 = zm1;
    zm1 = zm2;
    zm2 = j >= 3 ? y[j - 3] : T(0);
  }
  y[0] = y[0] + fm;
  y[nf - 1] = ytop - fm_top;
}

// advsed0 on one row in place, bottom-up: fm[i] = -min(c[i], 0) y[i+1]
// carries level i+1 down into level i, fp[i] = max(c[i], 0) y[i] level i
// up into level i+1; the end levels keep their values.
template <typename T, typename CV>
__device__ void upstream_row(T* y, const CV& cv, int nf) {
  const T c0 = cv(0);
  T fm = -clamp_max0(c0) * y[1];
  T fp = clamp_min0(c0) * y[0];
  for (int j = 1; j <= nf - 2; ++j) {
    const T cj = cv(j);
    const T yj = y[j];
    const T fmj = -clamp_max0(cj) * y[j + 1];
    const T fpj = clamp_min0(cj) * yj;
    y[j] = yj - fm + fp + fmj - fpj;
    fm = fmj;
    fp = fpj;
  }
}

// nsplit == 0: out = advsed0(c, y) where upstream[row], else advsed1(c, y).
// nsplit > 0: sedl's splits of psi = y by advsed1 with Courant numbers
// c * dtmax, ground deposit per row (upstream is not read).
template <typename T>
__global__ void __launch_bounds__(kRows)
    sed_kernel(const T* __restrict__ c, const T* __restrict__ y,
               const unsigned char* __restrict__ upstream,
               const T* __restrict__ xxxt, const T* __restrict__ dt0,
               T* __restrict__ out, T* __restrict__ ground, int rows, int nf,
               int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = nf | 1;
  T* ys = reinterpret_cast<T*>(smem);
  T* cs = ys + kRows * stride;
  const int r0 = blockIdx.x * kRows;
  const int nrow = rows - r0 < kRows ? rows - r0 : kRows;
  const int n = nrow * nf;
  const size_t base = size_t(r0) * nf;
  for (int e = threadIdx.x; e < n; e += kRows) {
    const int r = e / nf, j = e - r * nf;
    ys[r * stride + j] = y[base + e];
    cs[r * stride + j] = c[base + e];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nrow) {
    const int row = r0 + t;
    T* yr = ys + t * stride;
    const T* cr = cs + t * stride;
    if (nsplit == 0) {
      const auto cv = [cr](int j) { return cr[j]; };
      if (upstream[row] != 0) {
        upstream_row(yr, cv, nf);
      } else {
        bott_row(yr, cv, nf);
      }
    } else {
      const T lim = xxxt[row];
      T left = dt0[row];
      T gnd = T(0);
      for (int s = 0; s < nsplit && left > T(0.1); ++s) {
        const T dtmax = minimum(left, lim);
        const auto cv = [cr, dtmax](int j) { return cr[j] * dtmax; };
        const T psi1 = yr[1];
        yr[0] = psi1;  // the ghost level
        bott_row(yr, cv, nf);
        gnd = gnd + yr[0] - psi1;
        left = left - dtmax;
      }
      ground[row] = gnd;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kRows) {
    const int r = e / nf, j = e - r * nf;
    out[base + e] = ys[r * stride + j];
  }
}

template <typename T>
size_t smem_bytes(int nf) {
  return 2 * size_t(kRows) * size_t(nf | 1) * sizeof(T);
}

template <typename T>
int advect(const void* c, const void* y, const void* upstream,
           const void* xxxt, const void* dt0, void* out, void* ground,
           int rows, int nf, int nsplit, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = smem_bytes<T>(nf);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(sed_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
  }
  const dim3 grid((rows + kRows - 1) / kRows), block(kRows);
  sed_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(y),
      static_cast<const unsigned char*>(upstream),
      static_cast<const T*>(xxxt), static_cast<const T*>(dt0),
      static_cast<T*>(out), static_cast<T*>(ground), rows, nf, nsplit);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of
// contiguous arrays: c, y, out [rows, nf]; upstream [rows] of bytes (0:
// Bott, else upstream; used only when nsplit == 0, else may be null);
// xxxt, dt0, ground [rows] (used only when nsplit > 0, else may be
// null); stream is a cudaStream_t.  Each returns
// cudaGetLastError() after the launch.
extern "C" {

int sed_advect_f32(const void* c, const void* y, const void* upstream,
                   const void* xxxt, const void* dt0, void* out, void* ground,
                   int rows, int nf, int nsplit, void* stream) {
  return advect<float>(c, y, upstream, xxxt, dt0, out, ground, rows, nf,
                       nsplit, stream);
}

int sed_advect_f64(const void* c, const void* y, const void* upstream,
                   const void* xxxt, const void* dt0, void* out, void* ground,
                   int rows, int nf, int nsplit, void* stream) {
  return advect<double>(c, y, upstream, xxxt, dt0, out, ground, rows, nf,
                        nsplit, stream);
}

}  // extern "C"
