// Bott spectral-bin advection along the water-mass axis, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of mistra_tpu/physics/bott_pallas.py:
//   bott_advect_kernel <- _bott_kernel  (bott_pallas.py:173; walk + Bott
//                         split + banded deposit, the spectrum written)
//   bott_dwsum_kernel  <- _dwsum_kernel (bott_pallas.py:204; walk + split +
//                         per-row water-mass change, no spectrum written)
// The arithmetic is that of the plain torch version
// (mistra_tpu_torch/physics/growth.py: _walk_prefix, _walk_searches,
// _walk_rightward_banded, _bott_split, bott_advect_plain), expression by
// expression, so the two agree to rounding; build with -fmad=false so no
// multiply-add is contracted.
//
// Bound: rows independent rows of nkt bins (rows = columns * levels * nka;
// 448,000 rows of 70 bins for 64 columns at the production grid).  advect
// reads u and z and writes psi, 3 * rows * nkt values (376.3 MB in float32
// at that shape, 0.112 ms at 3.35 TB/s); dwsum reads u and z (and e, nkt
// values) and writes one value per row (252.7 MB, 0.075 ms).  The
// arithmetic, a few operations per bin for the prefix sums and ~100 per
// significant bin for the walk and the split, is far below the card's
// rates, so the bound is bytes; everything between the loads and the
// stores lives in shared memory and registers.
//
// Design: one warp per row, up to 8 rows per 256-thread block (fewer where
// a row's slot of shared memory is large: nkt <= 1024 in float64 fits 2),
// and no block barrier: only __syncwarp() orders a warp's shared-memory
// writes and reads, and a warp whose row is past the end leaves at once.
// The row's u, its mirrored negated copy (for the leftward walk) and z are
// staged with coalesced loads, all issued before any is used.
//  1. Prefix sums.  Lane l owns the bins [l*C, l*C + C), C = ceil(nkt/32),
//     sums their 1/u in double, and a 5-step shuffle scan in double gives
//     each lane its chunk's offset; each bin's sum is rounded to T once, as
//     the plain version's float64 cumsum.  The scan's tree sums round
//     differently from a sequential sum, so an offset may fall an ulp below
//     the previous chunk's last sum: a max-scan of the chunk ends keeps S
//     non-decreasing, which the searches below rely on.  In float32 the
//     double sum hides the order; in float64 S moves by ulps against the
//     plain version, as torch.cumsum on the card already does.  A direction
//     is scanned only where a significant bin (z >= YMIN) walks that way.
//  2. Idle lanes.  A ballot lists the row's significant bins; the walk and
//     the split run over that list, 32 at a time, and skip the rest, whose
//     deposit is 0 and position unused (for dwsum this assumes a finite e,
//     whose zero products it drops).  The other phases take bins
//     i = lane + 32m: at nkt = 70 no lane has more than 3.
//  3. Searched walk.  S is non-decreasing (a sum of 1/u >= 0), so the
//     band count of S[i+d] < target is a lower bound of target in
//     S[i, i + min(J, nkt - i)), found by binary search; the run of
//     positive bins from i+1 is the distance to the next bin with
//     !(u > 0) (NaN included), clipped to J, from a backward min-scan over
//     the chunks.  Both are the integers of the band loops; everything
//     after kstar and b is the plain version's expression sequence.
//  4. Trimmed deposit (advect).  A warp max-reduction gives the row's
//     reach, the largest displacement |k - i| <= D = J+2 of a significant
//     source; each destination gathers d = -reach..reach in the fixed
//     order of the full band, whose other terms are exact zeros, so the
//     sum is that of the full band to the bit.  A step reads one index and
//     loads the deposit only on a match.  The edge bins sum the off-band
//     overshoots only when a warp ballot finds one.
// dwsum sums each lane's gain - loss terms and ends in a shuffle
// reduction.  No atomics: the result is the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr double kWalkEps = 1.0e-7;  // remaining-time cutoff of the walk
constexpr double kYmin = 1.0e-32;    // significance cutoff of a source bin
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsPerBlock = 8;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__host__ __device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__host__ __device__ __forceinline__ T tmax(T a, T b) { return b > a ? b : a; }

// The contents a source bin deposits at its two destinations.
template <typename T>
struct __align__(2 * sizeof(T)) Deposit {
  T lo, hi;
};

// Shared-memory slot of one row (one warp), 16-byte aligned.
template <typename T>
struct RowSlot {
  Deposit<T>* w;
  T *uf, *ur, *z, *Sf, *Pf, *Sr, *Pr;
  int *runf, *runr, *klo, *sig;
  __host__ __device__ static size_t bytes(int nkt) {
    return (size_t(nkt) * (9 * sizeof(T) + 4 * sizeof(int)) + 15) & ~15;
  }
  __device__ RowSlot(unsigned char* smem, int slot, int nkt) {
    w = reinterpret_cast<Deposit<T>*>(smem + size_t(slot) * bytes(nkt));
    uf = reinterpret_cast<T*>(w + nkt); ur = uf + nkt; z = ur + nkt;
    Sf = z + nkt; Pf = Sf + nkt; Sr = Pf + nkt; Pr = Sr + nkt;
    runf = reinterpret_cast<int*>(Pr + nkt);
    runr = runf + nkt; klo = runr + nkt; sig = klo + nkt;
  }
};

// Prefix sums S, P and band runs of one direction of the row (uu: the row
// or its mirrored negated copy), by chunks of C bins per lane.
template <typename T>
__device__ void scan_direction(const T* uu, T* S, T* P, int* run, int lane,
                               int nkt, int J) {
  const int C = (nkt + 31) >> 5;
  const int lo = tmin(lane * C, nkt), hi = tmin(lo + C, nkt);
  // the chunk's 1/u (held in P until the last pass), their double sum and
  // the chunk's first bin with !(u > 0)
  double loc = 0.0;
  int first = nkt;
  for (int k = lo; k < hi; ++k) {
    const T x = uu[k];
    const T inv = x > T(0) ? T(1) / x : T(0);
    P[k] = inv;
    loc = loc + double(inv);
    if (!(x > T(0)) && first == nkt) first = k;
  }
  // chunk offsets (inclusive sum scan, shifted) and the first non-positive
  // bin after the chunk (suffix min scan, shifted)
  double incl = loc;
  int next = first;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, o);
    const int m = __shfl_down_sync(kFull, next, o);
    if (lane >= o) incl = y + incl;
    if (lane + o < 32) next = tmin(next, m);
  }
  double base = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) base = 0.0;
  int np = __shfl_down_sync(kFull, next, 1);
  if (lane == 31) np = nkt;
  // each bin's sum rounded once, then raised to the largest chunk end
  // before this chunk (exclusive max scan; rounding is monotone, so this
  // is the rounded maximum of the double sums)
  double acc = base;
  for (int k = lo; k < hi; ++k) {
    acc = acc + double(P[k]);
    S[k] = T(acc);
  }
  T end = T(acc);
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, end, o);
    if (lane >= o) end = tmax(end, y);
  }
  T floor_sum = __shfl_up_sync(kFull, end, 1);
  if (lane == 0) floor_sum = T(0);
  for (int k = lo; k < hi; ++k) {
    const T sk = tmax(S[k], floor_sum);
    S[k] = sk;
    P[k] = sk - P[k];
  }
  // run of positive bins from k+1: distance to the next !(u > 0), clipped
  for (int k = hi - 1; k >= lo; --k) {
    run[k] = tmin(J, np - (k + 1));
    if (!(uu[k] > T(0))) np = k;
  }
}

// Rightward characteristic walk of bin i with u[i] > 0 over a band of J
// bins (growth._walk_rightward_banded).  u, S, P, run are one direction of
// the row in shared memory; dt_eps = T(dt - eps) as in ``P + (dt - eps)``.
template <typename T>
__device__ T walk_right(const T* u, const T* S, const T* P, const int* run,
                        int i, int nkt, int J, T dt, T dt_eps) {
  const T eps = T(kWalkEps);
  const T target = P[i] + dt_eps;
  // count = lower bound of target in S[i, i + min(J, nkt - i))
  int k = i, len = tmin(J, nkt - i);
  while (len > 0) {
    const int half = len >> 1;
    if (S[k + half] < target) {
      k += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  const int kstar = k;
  const int b = i + 1 + run[i];
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

// Final position of source bin i (growth._walk_banded).
template <typename T>
__device__ T position(const RowSlot<T>& s, int i, int nkt, int J, T dt,
                      T dt_eps) {
  const T ui = s.uf[i];
  if (ui == T(0)) return T(i);
  if (ui > T(0)) {
    return walk_right(s.uf, s.Sf, s.Pf, s.runf, i, nkt, J, dt, dt_eps);
  }
  const int j = nkt - 1 - i;
  return T(nkt - 1) - walk_right(s.ur, s.Sr, s.Pr, s.runr, j, nkt, J, dt,
                                 dt_eps);
}

// Upper destination of a source whose lower one is klo.
__device__ __forceinline__ int upper(int klo, int nkt) {
  return klo + 1 > nkt - 1 ? nkt - 1 : klo + 1;
}

// Bott polynomial split of significant source bin i at position x0
// (growth._bott_split): the lower destination klo (the upper one is
// upper(klo)) and the contents deposited at each.
template <typename T>
__device__ Deposit<T> split(const T* z, int i, int nkt, T x0, int& klo) {
  const T fl = floor(x0);
  const T c0 = x0 - fl;
  int k_low = int(fl);
  klo = k_low < 0 ? 0 : (k_low > nkt - 1 ? nkt - 1 : k_low);

  const T zi = z[i];
  const T al = T(1) - T(2) * c0;
  const T al2 = al * al;
  const T al3 = al2 * al;
  T x1;
  if (i == 0 || i == nkt - 1) {
    x1 = c0 * zi;
  } else if (i == 1 || i == nkt - 2) {
    const T zm1 = z[i - 1], zp1 = z[i + 1];
    const T a0 = (T(26) * zi - zp1 - zm1) / T(24);
    const T a1 = (zp1 - zm1) / T(16);
    const T a2 = (zp1 + zm1 - T(2) * zi) / T(48);
    x1 = tmin(zi, a0 * c0 + a1 * (T(1) - al2) + a2 * (T(1) - al2 * al));
  } else {
    const T zm2 = z[i - 2], zm1 = z[i - 1], zp1 = z[i + 1], zp2 = z[i + 2];
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
  return {zi - x1, x1};
}

// Stages the row in its slot (u, its mirrored negated copy, z, and the
// significant bins, z >= YMIN, in ascending order in s.sig[0, n)), calling
// init(k, z_k) for every bin; then builds the prefix sums and runs of each
// direction in which a significant bin walks (none where no bin does).
// Returns n.
template <typename T, typename Init>
__device__ int front(RowSlot<T>& s, const T* u, const T* z, size_t off,
                     int lane, int nkt, int J, Init init) {
  // the loads first, all in flight together; the ballots read them back
#pragma unroll 4
  for (int k = lane; k < nkt; k += 32) {
    const T uv = u[off + k];
    const T zv = z[off + k];
    s.uf[k] = uv;
    s.ur[nkt - 1 - k] = -uv;
    s.z[k] = zv;
    init(k, zv);
  }
  int n = 0;
  bool right = false, left = false;
  for (int k0 = 0; k0 < nkt; k0 += 32) {
    const int k = k0 + lane;
    bool sig = false;
    if (k < nkt) {
      const T uv = s.uf[k];
      sig = s.z[k] >= T(kYmin);
      right = right || (sig && uv > T(0));
      left = left || (sig && !(uv > T(0)) && !(uv == T(0)));
    }
    const unsigned m = __ballot_sync(kFull, sig);
    if (sig) s.sig[n + __popc(m & ((1u << lane) - 1u))] = k;
    n += __popc(m);
  }
  right = __any_sync(kFull, right);
  left = __any_sync(kFull, left);
  __syncwarp();
  if (right) scan_direction(s.uf, s.Sf, s.Pf, s.runf, lane, nkt, J);
  if (left) scan_direction(s.ur, s.Sr, s.Pr, s.runr, lane, nkt, J);
  if (right || left) __syncwarp();
  return n;
}

template <typename T>
__global__ void __launch_bounds__(256)
bott_advect_kernel(const T* __restrict__ u, const T* __restrict__ z,
                   T* __restrict__ out, int rows, int nkt, int J, double dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  RowSlot<T> s(smem, warp, nkt);
  const size_t off = size_t(row) * nkt;
  // a bin below YMIN deposits nothing (where it lands does not matter)
  const int n = front(s, u, z, off, lane, nkt, J, [&](int k, T) {
    s.klo[k] = k;
    s.w[k] = Deposit<T>{T(0), T(0)};
  });

  const T dtT = T(dt), dt_eps = T(dt - kWalkEps);
  const int D = J + 2;
  int reach = 0;
  bool over = false;
  for (int t = lane; t < n; t += 32) {
    const int i = s.sig[t];
    int klo;
    const Deposit<T> w = split(s.z, i, nkt,
                               position(s, i, nkt, J, dtT, dt_eps), klo);
    const int khi = upper(klo, nkt);
    const int dl = klo > i ? klo - i : i - klo;
    const int dh = khi > i ? khi - i : i - khi;
    over = over || dl > D || dh > D;
    if (dl <= D) reach = tmax(reach, dl);
    if (dh <= D) reach = tmax(reach, dh);
    s.klo[i] = klo;
    s.w[i] = w;
  }
  for (int o = 16; o > 0; o >>= 1) {
    reach = tmax(reach, __shfl_xor_sync(kFull, reach, o));
  }
  over = __any_sync(kFull, over);
  __syncwarp();

  // destination gather over sources i = j - d, |d| <= reach, 0 <= i < nkt,
  // in the fixed order of d = -D..D.  Source i lands on j where klo = j or
  // upper(klo) = j, that is j - klo in {0, 1}; any other adds +0 to a sum
  // >= +0, which is skipped
  for (int j = lane; j < nkt; j += 32) {
    T acc = T(0);
    const int i_hi = tmin(j + reach, nkt - 1), i_lo = tmax(j - reach, 0);
#pragma unroll 4
    for (int i = i_hi; i >= i_lo; --i) {
      const int kl = s.klo[i];
      if (unsigned(j - kl) <= 1u) {
        const Deposit<T> w = s.w[i];
        acc = acc + ((kl == j ? w.lo : T(0))
                     + (upper(kl, nkt) == j ? w.hi : T(0)));
      }
    }
    // off-band overshoots onto the edge bins
    if (over && (j == 0 || j == nkt - 1)) {
      T over_b = T(0), over_t = T(0);
      for (int i = 0; i < nkt; ++i) {
        const int dlo = s.klo[i] - i, dhi = upper(s.klo[i], nkt) - i;
        const Deposit<T> w = s.w[i];
        over_t = over_t + ((dlo > D ? w.lo : T(0)) + (dhi > D ? w.hi : T(0)));
        over_b = over_b + ((dlo < -D ? w.lo : T(0)) +
                           (dhi < -D ? w.hi : T(0)));
      }
      if (j == 0) acc = acc + over_b;
      if (j == nkt - 1) acc = acc + over_t;
    }
    out[off + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
bott_dwsum_kernel(const T* __restrict__ u, const T* __restrict__ z,
                  const T* __restrict__ e, T* __restrict__ out, int rows,
                  int nkt, int J, double dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;
  RowSlot<T> s(smem, warp, nkt);

  // gain - loss of water mass per source bin, then a warp reduction; a
  // bin below YMIN deposits nothing: (0 e + 0 e) - z e, for a finite e
  T v = T(0);
  const int n = front(s, u, z, size_t(row) * nkt, lane, nkt, J,
                      [&](int k, T zk) {
    if (!(zk >= T(kYmin))) v = v + (T(0) - zk * __ldg(e + k));
  });
  const T dtT = T(dt), dt_eps = T(dt - kWalkEps);
  for (int t = lane; t < n; t += 32) {
    const int i = s.sig[t];
    int klo;
    const Deposit<T> w = split(s.z, i, nkt,
                               position(s, i, nkt, J, dtT, dt_eps), klo);
    v = v + ((w.lo * __ldg(e + klo) + w.hi * __ldg(e + upper(klo, nkt)))
             - s.z[i] * __ldg(e + i));
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) out[row] = v;
}

struct Launch {
  dim3 grid, block;
  size_t smem;
};

// One warp per row, as many rows per block as shared memory allows (<= 8).
template <typename T>
Launch plan(int rows, int nkt) {
  const size_t per_row = RowSlot<T>::bytes(nkt);
  const int per_block = int(tmax<size_t>(
      1, tmin<size_t>(kMaxRowsPerBlock, kMaxSmem / per_row)));
  Launch l;
  l.block = dim3(32 * per_block);
  l.grid = dim3((rows + per_block - 1) / per_block);
  l.smem = size_t(per_block) * per_row;
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
