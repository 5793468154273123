// Bott spectral-bin advection along the water-mass axis, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of mistra_tpu/physics/bott_pallas.py:
//   bott_advect_*  <- _bott_kernel   (walk + Bott split + banded deposit)
//   bott_dwsum_*   <- _dwsum_kernel  (walk + Bott split + per-row water-mass
//                                     change, no spectrum written)
// The arithmetic is that of the plain torch version
// (mistra_tpu_torch/physics/growth.py: _walk_rightward_banded,
// bott_advect_plain), expression by expression, so the two agree to
// rounding; build with -fmad=false so no multiply-add is contracted.
//
// Work: rows independent rows of nkt bins (rows = columns * levels * nka;
// 448,000 rows of 70 bins for 64 columns at the production grid).  Per bin
// the band searches take up to J steps and the deposit gather 2(J+2)+1, so
// the kernel is bound by shared-memory reads and integer/compare work, not
// by device memory: u and z are read once and psi written once (3 * rows *
// nkt values), and everything in between lives in shared memory.
//
// Design: one thread per bin and several rows per block (blockDim = (tpr,
// rows per block), tpr the bin count rounded up to a warp).  The TPU
// kernel's roll-and-select gathers and the reversal matmul are not needed:
// the row, its mirrored negated copy (for the leftward walk) and both prefix
// sums sit in shared memory and are indexed directly.  The prefix sums are
// serial (one thread per direction), accumulated in double and rounded once
// per bin, like the plain version's float64 cumsum.  The deposit is
// a destination gather in a fixed order (d = -D..D), with no atomics, so
// the result is the same from run to run; dwsum is a fixed-shape block
// reduction per row.

#include <cuda_runtime.h>

namespace {

constexpr double kWalkEps = 1.0e-7;  // remaining-time cutoff of the walk
constexpr double kYmin = 1.0e-32;    // significance cutoff of a source bin

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }

// Rightward characteristic walk of bin i with u[i] > 0 over a band of J
// bins (growth._walk_rightward_banded).  u, S, P are one row in shared
// memory; dt_eps = T(dt - eps) as in ``P + (dt - eps)``.
template <typename T>
__device__ T walk_right(const T* u, const T* S, const T* P, int i, int nkt,
                        int J, T dt, T dt_eps) {
  const T eps = T(kWalkEps);
  const T target = P[i] + dt_eps;
  // S is non-decreasing, so the band indicator S[i+d] < target is a prefix
  int count = 0;
  for (int d = 0; d < J; ++d) {
    const int k = i + d;
    if (k >= nkt || !(S[k] < target)) break;
    ++count;
  }
  int run = 0;
  for (int d = 0; d < J; ++d) {
    const int k = i + d + 1;
    if (k >= nkt || !(u[k] > T(0))) break;
    ++run;
  }
  const int kstar = i + count;
  const int b = i + 1 + run;
  const int kstop = kstar < b ? kstar : b;
  const int ks = kstop < 0 ? 0 : (kstop > nkt - 1 ? nkt - 1 : kstop);
  const int bs = b < 0 ? 0 : (b > nkt - 1 ? nkt - 1 : b);
  const T Pk = P[ks], uk = u[ks], Pb = P[bs], ub = u[bs];

  // fractional stop inside bin kstop
  const T R_in = dt - (Pk - P[i]);
  const T seg = tmin(R_in, T(1) / tmax(uk, T(1e-30)));
  const T x_frac = T(kstop) + uk * seg;

  // barrier cases
  const T bf = T(b);
  const T R = dt - (Pb - P[i]);
  const T dt0 = tmin(T(1) / tmax(fabs(ub), T(1e-30)), R);
  const T xb = bf + ub * dt0;
  const T x_osc = (R - dt0 > eps) ? bf - T(1) : xb;
  T x_barrier = (ub == T(0)) ? bf : x_osc;
  if (b >= nkt) x_barrier = T(nkt);
  return kstar < b ? x_frac : x_barrier;
}

// Shared-memory layout of one row slot.
template <typename T>
struct RowSlot {
  T *uf, *Sf, *Pf, *ur, *Sr, *Pr, *z, *wlo, *whi;
  int *klo, *khi;
  __device__ RowSlot(unsigned char* smem, int slot, int nslots, int nkt) {
    T* base = reinterpret_cast<T*>(smem) + size_t(slot) * 9 * nkt;
    uf = base; Sf = uf + nkt; Pf = Sf + nkt;
    ur = Pf + nkt; Sr = ur + nkt; Pr = Sr + nkt;
    z = Pr + nkt; wlo = z + nkt; whi = wlo + nkt;
    int* ib = reinterpret_cast<int*>(reinterpret_cast<T*>(smem) +
                                     size_t(nslots) * 9 * nkt) +
              size_t(slot) * 2 * nkt;
    klo = ib; khi = ib + nkt;
  }
};

// Walk + Bott split of one row: fills klo/khi/wlo/whi of the slot.
template <typename T>
__device__ void walk_and_split(RowSlot<T>& s, bool valid, int nkt, int J,
                               double dt_d) {
  const int i = threadIdx.x;
  const T dt = T(dt_d);
  const T dt_eps = T(dt_d - kWalkEps);

  // serial prefix sums, forward on thread 0 and mirrored on thread 1,
  // accumulated in double and rounded once per bin (as the plain version's
  // float64 cumsum), so the order of summation does not matter
  if (valid && (i == 0 || i == 1)) {
    const T* uu = i == 0 ? s.uf : s.ur;
    T* S = i == 0 ? s.Sf : s.Sr;
    T* P = i == 0 ? s.Pf : s.Pr;
    double acc = 0.0;
    for (int k = 0; k < nkt; ++k) {
      const T inv = uu[k] > T(0) ? T(1) / uu[k] : T(0);
      acc = acc + double(inv);
      const T sk = T(acc);
      S[k] = sk;
      P[k] = sk - inv;
    }
  }
  __syncthreads();
  if (!valid || i >= nkt) return;

  const T ui = s.uf[i];
  T x0;
  if (ui == T(0)) {
    x0 = T(i);
  } else if (ui > T(0)) {
    x0 = walk_right(s.uf, s.Sf, s.Pf, i, nkt, J, dt, dt_eps);
  } else {
    const int j = nkt - 1 - i;
    x0 = T(nkt - 1) - walk_right(s.ur, s.Sr, s.Pr, j, nkt, J, dt, dt_eps);
  }

  // ---- Bott polynomial split of the fractional position ----------------
  const T fl = floor(x0);
  const T c0 = x0 - fl;
  int k_low = int(fl);
  k_low = k_low < 0 ? 0 : (k_low > nkt - 1 ? nkt - 1 : k_low);
  int k_high = k_low + 1 > nkt - 1 ? nkt - 1 : k_low + 1;

  const T* z = s.z;
  const T zi = z[i];
  const T zm2 = z[(i - 2 + 2 * nkt) % nkt], zm1 = z[(i - 1 + nkt) % nkt];
  const T zp1 = z[(i + 1) % nkt], zp2 = z[(i + 2) % nkt];
  const T al = T(1) - T(2) * c0;
  const T al2 = al * al;
  const T al3 = al2 * al;
  T x1;
  if (i == 0 || i == nkt - 1) {
    x1 = c0 * zi;
  } else if (i == 1 || i == nkt - 2) {
    const T a0 = (T(26) * zi - zp1 - zm1) / T(24);
    const T a1 = (zp1 - zm1) / T(16);
    const T a2 = (zp1 + zm1 - T(2) * zi) / T(48);
    x1 = tmin(zi, a0 * c0 + a1 * (T(1) - al2) + a2 * (T(1) - al2 * al));
  } else {
    const T a0 = (T(9) * (zp2 + zm2) - T(116) * (zp1 + zm1) + T(2134) * zi)
                 / T(1920);
    const T a1 = (T(-5) * (zp2 - zm2) + T(34) * (zp1 - zm1)) / T(384);
    const T a2 = (-zp2 + T(12) * (zp1 + zm1) - T(22) * zi - zm2) / T(384);
    const T a3 = (zp2 - T(2) * (zp1 - zm1) - zm2) / T(768);
    const T a4 = (zp2 - T(4) * (zp1 + zm1) + T(6) * zi + zm2) / T(3840);
    x1 = tmin(zi, a0 * c0 + a1 * (T(1) - al2) + a2 * (T(1) - al3)
                      + a3 * (T(1) - al2 * al2) + a4 * (T(1) - al2 * al3));
  }
  x1 = tmax(T(0), x1);
  if (!(c0 > T(0))) x1 = T(0);
  const bool active = zi >= T(kYmin);
  s.klo[i] = k_low;
  s.khi[i] = k_high;
  s.wlo[i] = active ? zi - x1 : T(0);
  s.whi[i] = active ? x1 : T(0);
}

template <typename T>
__device__ void load_row(RowSlot<T>& s, const T* u, const T* z, size_t off,
                         int nkt) {
  for (int k = threadIdx.x; k < nkt; k += blockDim.x) {
    const T uv = u[off + k];
    s.uf[k] = uv;
    s.ur[nkt - 1 - k] = -uv;
    s.z[k] = z[off + k];
  }
}

template <typename T>
__global__ void bott_advect_kernel(const T* __restrict__ u,
                                   const T* __restrict__ z,
                                   T* __restrict__ out, int rows, int nkt,
                                   int J, double dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;
  RowSlot<T> s(smem, threadIdx.y, blockDim.y, nkt);
  const size_t off = size_t(row) * nkt;
  if (valid) load_row(s, u, z, off, nkt);
  __syncthreads();
  walk_and_split(s, valid, nkt, J, dt);
  __syncthreads();
  const int j = threadIdx.x;
  if (!valid || j >= nkt) return;

  // destination gather over the band |d| <= D, in the fixed order -D..D
  const int D = J + 2;
  T acc = T(0);
  for (int d = -D; d <= D; ++d) {
    const int i = j - d;
    if (i < 0 || i >= nkt) continue;
    const T a = s.klo[i] == j ? s.wlo[i] : T(0);
    const T b = s.khi[i] == j ? s.whi[i] : T(0);
    acc = acc + (a + b);
  }
  // off-band overshoots onto the edge bins
  if (j == 0 || j == nkt - 1) {
    T over_b = T(0), over_t = T(0);
    for (int i = 0; i < nkt; ++i) {
      const int dlo = s.klo[i] - i, dhi = s.khi[i] - i;
      over_t = over_t + ((dlo > D ? s.wlo[i] : T(0)) +
                         (dhi > D ? s.whi[i] : T(0)));
      over_b = over_b + ((dlo < -D ? s.wlo[i] : T(0)) +
                         (dhi < -D ? s.whi[i] : T(0)));
    }
    if (j == 0) acc = acc + over_b;
    if (j == nkt - 1) acc = acc + over_t;
  }
  out[off + j] = acc;
}

template <typename T>
__global__ void bott_dwsum_kernel(const T* __restrict__ u,
                                  const T* __restrict__ z,
                                  const T* __restrict__ e,
                                  T* __restrict__ out, int rows, int nkt,
                                  int J, double dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;
  RowSlot<T> s(smem, threadIdx.y, blockDim.y, nkt);
  const size_t off = size_t(row) * nkt;
  if (valid) load_row(s, u, z, off, nkt);
  __syncthreads();
  walk_and_split(s, valid, nkt, J, dt);
  __syncthreads();

  // gain - loss of water mass per source bin, then a block reduction
  const int i = threadIdx.x;
  T v = T(0);
  if (valid && i < nkt) {
    v = (s.wlo[i] * e[s.klo[i]] + s.whi[i] * e[s.khi[i]]) - s.z[i] * e[i];
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  // per-warp partials reuse the slot's wlo array (no longer read)
  __syncthreads();
  const int lane = i & 31, warp = i >> 5, nwarps = blockDim.x >> 5;
  if (lane == 0) s.wlo[warp] = v;
  __syncthreads();
  if (valid && i == 0) {
    T acc = T(0);
    for (int w = 0; w < nwarps; ++w) acc = acc + s.wlo[w];
    out[row] = acc;
  }
}

constexpr int kThreadsPerBlock = 256;

struct Launch {
  dim3 grid, block;
  size_t smem;
};

template <typename T>
Launch plan(int rows, int nkt) {
  const int tpr = ((nkt + 31) / 32) * 32;
  int per_block = kThreadsPerBlock / tpr;
  if (per_block < 1) per_block = 1;
  Launch l;
  l.block = dim3(tpr, per_block);
  l.grid = dim3((rows + per_block - 1) / per_block);
  l.smem = size_t(per_block) * nkt * (9 * sizeof(T) + 2 * sizeof(int));
  return l;
}

template <typename T>
int advect(const void* u, const void* z, void* out, int rows, int nkt, int J,
           double dt, void* stream) {
  if (rows <= 0) return 0;
  const Launch l = plan<T>(rows, nkt);
  if (l.smem > 48 * 1024) {
    cudaFuncSetAttribute(bott_advect_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(l.smem));
  }
  bott_advect_kernel<T><<<l.grid, l.block, l.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(z),
      static_cast<T*>(out), rows, nkt, J, dt);
  return int(cudaGetLastError());
}

template <typename T>
int dwsum(const void* u, const void* z, const void* e, void* out, int rows,
          int nkt, int J, double dt, void* stream) {
  if (rows <= 0) return 0;
  const Launch l = plan<T>(rows, nkt);
  if (l.smem > 48 * 1024) {
    cudaFuncSetAttribute(bott_dwsum_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(l.smem));
  }
  bott_dwsum_kernel<T><<<l.grid, l.block, l.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(z),
      static_cast<const T*>(e), static_cast<T*>(out), rows, nkt, J, dt);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// [rows, nkt] arrays (e: [nkt], dwsum out: [rows]); stream is a
// cudaStream_t.  Each returns cudaGetLastError() after the launch.
extern "C" {

int bott_advect_f32(const void* u, const void* z, void* out, int rows,
                    int nkt, int J, double dt, void* stream) {
  return advect<float>(u, z, out, rows, nkt, J, dt, stream);
}

int bott_advect_f64(const void* u, const void* z, void* out, int rows,
                    int nkt, int J, double dt, void* stream) {
  return advect<double>(u, z, out, rows, nkt, J, dt, stream);
}

int bott_dwsum_f32(const void* u, const void* z, const void* e, void* out,
                   int rows, int nkt, int J, double dt, void* stream) {
  return dwsum<float>(u, z, e, out, rows, nkt, J, dt, stream);
}

int bott_dwsum_f64(const void* u, const void* z, const void* e, void* out,
                   int rows, int nkt, int J, double dt, void* stream) {
  return dwsum<double>(u, z, e, out, rows, nkt, J, dt, stream);
}

}  // extern "C"
