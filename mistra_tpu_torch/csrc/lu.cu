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
// device memory.
//
// What bounds it on this card.  Neither device memory nor arithmetic: at
// [8192, 80, 80] float64 the bytes take 0.25 ms and the FP64 multiplies
// and subtracts ~0.5 ms on the CUDA cores.  A first design held the matrix
// in shared memory (one block per matrix, kept below for m > 128): every
// step read and wrote all m^2 entries there, with three block barriers
// and a block-wide argmax per step, and its 81.6 KB at m = 101 left room
// for two blocks per SM.  The design below holds the matrix in registers;
// what bounds it then is the serial chain of each step (pivot search,
// reciprocal, the division of the pivot row, the update of the next
// column: dependent FP64 operations, warp reductions and a barrier; about
// 2,000 cycles per step on an H100, PERF.md) times m steps, with only as
// many matrices in flight per SM as their registers allow: two at m = 80,
// one at m = 101.
//
// Design (gj_inverse_kernel, m <= 128).  A block of NW warps owns one
// matrix; lane l of warp w holds the RY x RX tile of rows l + 32 a and
// columns w + NW b (rows or columns beyond m are padding that never feeds
// a real entry).  So a column lies in one warp and a row in one lane of
// every warp.  The tile shape is a template parameter, so every loop over
// it is unrolled and every register index static.  Step k:
//   - the warp that owns column k (the producer) has already updated it,
//     found the pivot in its registers (the largest |c[i, k]| among the
//     unused rows, NaN above all, the lower row on a tie: integer keys, a
//     warp max and ballots), and published the column, p, piv and 1 / piv
//     to shared memory, then arrived at the step's named barrier;
//   - every other warp waits there: one barrier per step, and the step's
//     buffers are double-buffered by its parity;
//   - in every warp, lane p % 32 hands its RX pivot-row values to lanes
//     0..RX-1, which divide them by piv (1 / piv at column k) through a
//     per-warp buffer: each warp scales only its own columns;
//   - every thread reads its RY multipliers and updates its tile,
//     c - f * rowp (column k: 0 - f * rowp), and lane p % 32 sets its row
//     p to the scaled row.  The producer of step k + 1 updates column
//     k + 1 first, publishes it and arrives, then updates the rest.
// Column k sits in tile slot 0 of warp k % NW: after each round of NW
// steps every thread rotates its tile by one slot, so one copy of the
// step's code serves every column.
// Rows are not swapped: the pivot order is recorded and undone when the
// result is written.  The eliminated column k holds, from step k on, the
// inverse's column that the augmented form [A | I] would carry on its
// right (the classic in-place Gauss-Jordan), so one m x m array suffices.
// A and the result pass through a shared-memory strip of 32 rows, so that
// both are read and written row by row, coalesced.  A zero pivot gives
// non-finite output, as in the plain version; the Ros3 integrator treats
// it as a rejected step.
//
// The launch plan (which variant, tile and grid for m) is computed here
// and, identically, in chemistry/lu_cuda.py (launch_plan); batched_inv_plan
// reports this side's plan with the blocks that fit on one SM.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kSmemThreads = 256;
constexpr int kSlots = 32;                 // warp-result slots in smem
constexpr size_t kMaxSmem = 232448;        // 227 KB: a block's opt-in limit

// Is (va, ia) a better pivot candidate than (vb, ib)?  The larger value,
// NaN above all (as torch.argmax), and the lower row on a tie.
template <typename T>
__device__ __forceinline__ bool better(T va, int ia, T vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// ---------------------------------------------------------------------------
// m <= 128: the matrix in registers
// ---------------------------------------------------------------------------

// named barriers 1 and 2 (0 is __syncthreads); bar.arrive does not wait
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Pivot search key of a candidate: the bits of |v| plus one, with every
// NaN mapped to one value above inf; 0 marks a used row.  Integer order of
// the keys is the order of better() (the lower row wins a tie of keys).
__device__ __forceinline__ unsigned long long pivot_key(double v) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(v)) &
      0x7fffffffffffffffull;
  return (u < 0x7ff0000000000001ull ? u : 0x7ff0000000000001ull) + 1ull;
}

__device__ __forceinline__ unsigned long long pivot_key(float v) {
  const unsigned u = __float_as_uint(v) & 0x7fffffffu;
  return (u < 0x7f800001u ? u : 0x7f800001u) + 1ull;
}

// the largest key over the warp (redux.sync works on 32-bit words)
template <typename T>
__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
  if constexpr (sizeof(T) == 4) {
    return __reduce_max_sync(0xffffffffu, unsigned(k));
  } else {
    const unsigned hi = __reduce_max_sync(0xffffffffu, unsigned(k >> 32));
    const unsigned lo = __reduce_max_sync(
        0xffffffffu, unsigned(k >> 32) == hi ? unsigned(k) : 0u);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
  }
}

// a / b rounded to nearest from y = RN(1 / b): a product and two fma
// corrections (Markstein: with y correctly rounded and q within an ulp,
// q + y (a - b q) rounds to RN(a / b)).  slow is set where the exponents
// leave the range in which the residuals are exact and nothing under- or
// overflows; the caller then divides.  A zero a gives a * y, which has
// the sign of a / b.
__device__ __forceinline__ int biased_exp(double x) {
  return (__double2hiint(x) >> 20) & 0x7ff;
}
__device__ __forceinline__ int biased_exp(float x) {
  return (__float_as_int(x) >> 23) & 0xff;
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <typename T>
struct DivRange;                 // biased exponents of the fast path
template <>
struct DivRange<double> {        // |a| in [2^-900, 2^1001), |q| in
  static constexpr int a_lo = 123, a_hi = 2023, q_lo = 63, q_hi = 2023,
                       b_lo = 23, b_hi = 2023;   // [2^-960, 2^1001)
};
template <>
struct DivRange<float> {         // |a| in [2^-70, 2^121), |q| in
  static constexpr int a_lo = 57, a_hi = 247, q_lo = 27, q_hi = 247,
                       b_lo = 7, b_hi = 247;     // [2^-100, 2^121)
};

template <typename T>
__device__ __forceinline__ T div_rn(T a, T b, T y, bool& slow) {
  using R = DivRange<T>;
  T q = a * y;
  T r = fma_rn(-b, q, a);
  q = fma_rn(r, y, q);
  r = fma_rn(-b, q, a);
  q = fma_rn(r, y, q);
  if (a == T(0)) return a * y;
  const int ea = biased_exp(a), eq = biased_exp(q);
  slow |= ea < R::a_lo || ea > R::a_hi || eq < R::q_lo || eq > R::q_hi;
  return q;
}

// f(integral_constant<int, i>) for i = 0, 1, ..., in order
template <typename F, int... I>
__device__ __forceinline__ void each_index(F&& f,
                                           std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// The producer of step kn (the warp owning column kn, tile slot BN) finds
// the pivot in its registers and publishes the column (signed), p, piv and
// 1 / piv to the buffers of kn's parity; the column is then zeroed in the
// tile (the update makes it the inverse's column).
template <typename T, int RY, int RX, int BN>
__device__ __forceinline__ void publish(T (&c)[RY][RX], unsigned used,
                                        int kn, int lane, T* colbuf,
                                        T* pivbuf, int* pbuf) {
  constexpr int MY = 32 * RY;
  const int s = kn & 1;
  unsigned long long key[RY], kmax = 0;
#pragma unroll
  for (int a = 0; a < RY; ++a) {
    colbuf[s * MY + lane + 32 * a] = c[a][BN];
    key[a] = ((used >> a) & 1u) ? 0ull : pivot_key(c[a][BN]);
    kmax = key[a] > kmax ? key[a] : kmax;
  }
  kmax = warp_max_key<T>(kmax);
  int p = 0;                               // the lowest row holding kmax
#pragma unroll
  for (int a = RY - 1; a >= 0; --a) {
    const unsigned hit = __ballot_sync(0xffffffffu, key[a] == kmax);
    if (hit) p = 32 * a + __ffs(hit) - 1;
  }
  // the pivot is read back from the buffer: selecting it from the tile by
  // p would make the compiler index the tile at run time (local memory)
  __syncwarp();
  if (lane == 0) {
    const T v = colbuf[s * MY + p];
    pbuf[s] = p;
    pivbuf[2 * s] = v;
    pivbuf[2 * s + 1] = T(1) / v;
  }
#pragma unroll
  for (int a = 0; a < RY; ++a) c[a][BN] = T(0);
}

// rank-1 update of the tile's columns b != SKIP; then lane pl sets its
// row slot pa (row p) to the scaled pivot row
template <typename T, int RY, int RX, int SKIP>
__device__ __forceinline__ void update(T (&c)[RY][RX], const T (&f)[RY],
                                       const T (&rp)[RX], int lane, int pl,
                                       int pa) {
#pragma unroll
  for (int b = 0; b < RX; ++b) {
    if (b == SKIP) continue;
#pragma unroll
    for (int a = 0; a < RY; ++a) c[a][b] = c[a][b] - f[a] * rp[b];
  }
  if (lane == pl) {
#pragma unroll
    for (int a = 0; a < RY; ++a) {
      if (a == pa) {
#pragma unroll
        for (int b = 0; b < RX; ++b) {
          if (b != SKIP) c[a][b] = rp[b];
        }
      }
    }
  }
}

// the producer of step kn: column BN first, published (arriving at kn's
// barrier), then the rest of its tile
template <typename T, int NW, int RY, int RX, int BN>
__device__ __forceinline__ void produce(T (&c)[RY][RX], const T (&f)[RY],
                                        const T (&rp)[RX], unsigned used,
                                        int kn, int lane, int pl, int pa,
                                        T* colbuf, T* pivbuf, int* pbuf) {
#pragma unroll
  for (int a = 0; a < RY; ++a) {
    c[a][BN] = c[a][BN] - f[a] * rp[BN];
    if (lane == pl && a == pa) c[a][BN] = rp[BN];
  }
  publish<T, RY, RX, BN>(c, used, kn, lane, colbuf, pivbuf, pbuf);
  bar_arrive(1 + (kn & 1), 32 * NW);
  update<T, RY, RX, BN>(c, f, rp, lane, pl, pa);
}

template <typename T, int NW, int RY, int RX>
__global__ void __launch_bounds__(32 * NW, NW <= 8 ? 2 : 1)
gj_inverse_kernel(const T* __restrict__ a_in, T* __restrict__ out, int m) {
  constexpr int NT = 32 * NW;
  constexpr int MY = 32 * RY;              // padded rows
  static_assert(RY <= 32 && RX <= 32, "masks and divider lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  T* colbuf = reinterpret_cast<T*>(smem);  // [2][MY] pivot column, signed
  T* wbuf = colbuf + 2 * MY;               // [NW][RX] scaled pivot row
  T* pivbuf = wbuf + NW * RX;              // [2][2] pivot, 1 / pivot
  T* strip = colbuf;                       // [32][ms] at load and store
  const int ms = m | 1;                    // odd row stride of the strip
  const int nt = 32 * ms > 2 * MY + NW * RX + 4 ? 32 * ms
                                                : 2 * MY + NW * RX + 4;
  int* pbuf = reinterpret_cast<int*>(colbuf + nt);  // [2] pivot row
  int* perm = pbuf + 2;                    // [m] pivot row of step k
  int* iperm = perm + m;                   // [m] iperm[perm[q]] = q

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t mm = size_t(m) * m;
  const T* A = a_in + blockIdx.x * mm;
  T* O = out + blockIdx.x * mm;

  // ---- load: 32 rows at a time through the strip, coalesced -----------
  T c[RY][RX];
  each_index([&](auto a_const) {
    constexpr int a = decltype(a_const)::value;
    for (int r = w; r < 32; r += NW) {
      const int i = 32 * a + r;
      for (int j = lane; j < m; j += 32) {
        strip[r * ms + j] = i < m ? A[size_t(i) * m + j] : T(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int j = w + NW * b;
      c[a][b] = j < m ? strip[lane * ms + j] : T(0);
    }
    __syncthreads();
  }, std::make_integer_sequence<int, RY>{});

  unsigned used = 0;                       // bit a: row lane + 32 a is used
#pragma unroll
  for (int a = 0; a < RY; ++a) {
    if (lane + 32 * a >= m) used |= 1u << a;
  }
  if (w == 0) publish<T, RY, RX, 0>(c, used, 0, lane, colbuf, pivbuf, pbuf);
  __syncthreads();

  // step k: column k is in tile slot 0 of warp k % NW
#pragma unroll 1
  for (int k = 0; k < m; ++k) {
    const int wk = k % NW, s = k & 1;
    if (k > 0 && w != wk) bar_sync(1 + s, NT);     // step k is published
    __syncwarp();
    const int p = pbuf[s];
    const T piv = pivbuf[2 * s], y = pivbuf[2 * s + 1];
    const int pl = p & 31, pa = p >> 5;
    if (lane == pl) used |= 1u << pa;
    if (tid == 0) perm[k] = p;

    // ---- this warp's columns of the scaled pivot row: lane pl hands over
    // its values, lane b < RX divides slot b (1 / piv at column k)
    T* wb = wbuf + w * RX;
    if (lane == pl) {
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        if (a == pa) {
#pragma unroll
          for (int b = 0; b < RX; ++b) wb[b] = c[a][b];
        }
      }
    }
    __syncwarp();
    if (lane < RX) {
      const T raw = wb[lane];
      const int eb = biased_exp(piv);
      bool slow = eb < DivRange<T>::b_lo || eb > DivRange<T>::b_hi;
      T q = div_rn(raw, piv, y, slow);
      if (slow) q = raw / piv;
      wb[lane] = (w == wk && lane == 0) ? y : q;
    }
    __syncwarp();
    T f[RY], rp[RX];
#pragma unroll
    for (int a = 0; a < RY; ++a) f[a] = colbuf[s * MY + lane + 32 * a];
#pragma unroll
    for (int b = 0; b < RX; ++b) rp[b] = wb[b];

    // the producer of step k + 1: slot 0 of the next warp, or slot 1 of
    // warp 0 at the end of the round (slot 0 once rotated)
    const int wn = wk + 1 < NW ? wk + 1 : 0;
    if (k + 1 < m && w == wn) {
      if (wk + 1 < NW) {
        produce<T, NW, RY, RX, 0>(c, f, rp, used, k + 1, lane, pl, pa,
                                  colbuf, pivbuf, pbuf);
      } else {
        produce<T, NW, RY, RX, (RX > 1 ? 1 : 0)>(c, f, rp, used, k + 1,
                                                 lane, pl, pa, colbuf,
                                                 pivbuf, pbuf);
      }
    } else {
      update<T, RY, RX, -1>(c, f, rp, lane, pl, pa);
    }
    if (wk == NW - 1) {
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        const T c0 = c[a][0];
#pragma unroll
        for (int b = 0; b + 1 < RX; ++b) c[a][b] = c[a][b + 1];
        c[a][RX - 1] = c0;
      }
    }
  }

  // ---- undo the pivot order: out[iperm[i], perm[j]] = c[i, j], through
  // the strip 32 rows at a time
  __syncthreads();                         // the step buffers are free
  for (int q = tid; q < m; q += NT) iperm[perm[q]] = q;
  __syncthreads();
  int pj[RX];
#pragma unroll
  for (int b = 0; b < RX; ++b) {
    const int j = w + NW * ((b + m / NW) % RX);    // slot b's column, after
                                                   // m / NW rotations
    pj[b] = j < m ? perm[j] : -1;
  }
  each_index([&](auto a_const) {
    constexpr int a = decltype(a_const)::value;
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      if (pj[b] >= 0) strip[lane * ms + pj[b]] = c[a][b];
    }
    __syncthreads();
    for (int r = w; r < 32; r += NW) {
      const int i = 32 * a + r;
      if (i < m) {
        T* orow = O + size_t(iperm[i]) * m;
        for (int j = lane; j < m; j += 32) orow[j] = strip[r * ms + j];
      }
    }
    __syncthreads();
  }, std::make_integer_sequence<int, RY>{});
}

// ---------------------------------------------------------------------------
// 128 < m: the matrix in shared memory (the first design)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
gj_inverse_smem_kernel(const T* __restrict__ a, T* __restrict__ out, int m) {
  constexpr int kWarps = kSmemThreads / 32;
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
  for (int e = tid; e < mm; e += kSmemThreads) c[e] = A[e];
  for (int i = tid; i < m; i += kSmemThreads) used[i] = 0;
  // this thread's first entry (i0, j0) and its stride in (rows, cols)
  const int i0 = tid / m, j0 = tid - i0 * m;
  const int di = kSmemThreads / m, dj = kSmemThreads - di * m;
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    // ---- pivot: argmax |c[i, k]| over the unused rows -----------------
    T bv = T(-1);
    int bi = m;
    for (int i = tid; i < m; i += kSmemThreads) {
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
    for (int j = tid; j < m; j += kSmemThreads) {
      rowp[j] = j == k ? T(1) / piv : c[p * m + j] / piv;
      f[j] = j == p ? T(0) : c[j * m + k];
    }
    __syncthreads();

    // ---- rank-1 update; column k becomes the inverse's column ----------
    int i = i0, j = j0;
    for (int e = tid; e < mm; e += kSmemThreads) {
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
  for (int q = tid; q < m; q += kSmemThreads) iperm[perm[q]] = q;
  __syncthreads();
  int r = i0, s = j0;
  for (int e = tid; e < mm; e += kSmemThreads) {
    O[e] = c[perm[r] * m + iperm[s]];
    r += di;
    s += dj;
    if (s >= m) { s -= m; ++r; }
  }
}

// ---------------------------------------------------------------------------
// launch plan (mirrored by chemistry/lu_cuda.py: launch_plan)
// ---------------------------------------------------------------------------

enum Variant { kRegs = 0, kSmem = 1 };

// The thread grid is ty lanes (rows) x tx warps (columns) and each
// thread's tile ry x rx (zeros for kSmem); tile indexes kTiles.
struct Plan {
  int variant, ty, tx, ry, rx, threads, tile;
  size_t smem;
};

// the register tiles: the largest m each takes, its warps and its tile
struct Tile {
  int max_m, nw, ry, rx;
};
constexpr Tile kTiles[] = {{32, 8, 1, 4},   {64, 8, 2, 8},   {80, 8, 3, 10},
                           {96, 16, 3, 6},  {112, 16, 4, 7}, {128, 16, 4, 8}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// false if no variant takes m
template <typename T>
bool plan_for(int m, Plan* p) {
  if (m < 1) return false;
  for (int q = 0; q < kNumTiles; ++q) {
    const Tile& t = kTiles[q];
    if (m > t.max_m) continue;
    p->variant = kRegs;
    p->tile = q;
    p->ty = 32;
    p->tx = t.nw;
    p->ry = t.ry;
    p->rx = t.rx;
    p->threads = 32 * t.nw;
    // the strip (32 rows of stride m | 1) holds the step buffers: two
    // pivot columns, the warps' scaled rows, two (pivot, 1 / pivot); then
    // two pivot rows, perm and iperm (int)
    const int steps = 2 * 32 * t.ry + t.nw * t.rx + 4;
    const int nt = 32 * (m | 1) > steps ? 32 * (m | 1) : steps;
    p->smem = size_t(nt) * sizeof(T) + (2 + 2 * size_t(m)) * sizeof(int);
    return true;
  }
  p->variant = kSmem;
  p->ty = p->tx = p->ry = p->rx = p->tile = 0;
  p->threads = kSmemThreads;
  p->smem = (size_t(m) * m + 2 * size_t(m) + kSlots) * sizeof(T) +
            (2 * size_t(m) + kSlots) * sizeof(int);
  return p->smem <= kMaxSmem;
}

template <typename T>
using KernelFn = void (*)(const T*, T*, int);

template <typename T, size_t... Q>
KernelFn<T> regs_kernel(int tile, std::index_sequence<Q...>) {
  const KernelFn<T> fns[] = {
      gj_inverse_kernel<T, kTiles[Q].nw, kTiles[Q].ry, kTiles[Q].rx>...};
  return fns[tile];
}

template <typename T>
KernelFn<T> kernel_for(const Plan& p) {
  if (p.variant == kSmem) return gj_inverse_smem_kernel<T>;
  return regs_kernel<T>(p.tile, std::make_index_sequence<kNumTiles>{});
}

// the kernel of m's plan, with its shared-memory limit raised where the
// plan needs more than the default 48 KB
template <typename T>
cudaError_t prepare(int m, Plan* p, KernelFn<T>* fn) {
  if (!plan_for<T>(m, p)) return cudaErrorInvalidValue;
  *fn = kernel_for<T>(*p);
  if (p->smem > 48 * 1024) {
    return cudaFuncSetAttribute(*fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(p->smem));
  }
  return cudaSuccess;
}

template <typename T>
int inverse(const void* a, void* out, int n, int m, void* stream) {
  if (n <= 0) return 0;
  Plan p;
  KernelFn<T> fn;
  const cudaError_t err = prepare<T>(m, &p, &fn);
  if (err != cudaSuccess) return int(err);
  fn<<<n, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(out), m);
  return int(cudaGetLastError());
}

// plan[0..7] = variant (0 registers, 1 shared memory), ty, tx, ry, rx,
// threads, shared-memory bytes, blocks per SM
template <typename T>
int describe(int m, int* plan) {
  Plan p;
  KernelFn<T> fn;
  cudaError_t err = prepare<T>(m, &p, &fn);
  if (err != cudaSuccess) return int(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, p.threads,
                                                      p.smem);
  if (err != cudaSuccess) return int(err);
  const int vals[8] = {p.variant, p.ty, p.tx, p.ry, p.rx, p.threads,
                       int(p.smem), blocks};
  for (int q = 0; q < 8; ++q) plan[q] = vals[q];
  return 0;
}

}  // namespace

// Plain C interface for ctypes.  a and out are device pointers of
// contiguous [n, m, m] arrays (out may not alias a); stream is a
// cudaStream_t.  Each returns cudaGetLastError() after the launch, or the
// error of a refused configuration.  batched_inv_plan_* fills plan[8] (see
// describe) for m, or returns the error of a refused m.
extern "C" {

int batched_inv_f32(const void* a, void* out, int n, int m, void* stream) {
  return inverse<float>(a, out, n, m, stream);
}

int batched_inv_f64(const void* a, void* out, int n, int m, void* stream) {
  return inverse<double>(a, out, n, m, stream);
}

int batched_inv_plan_f32(int m, int* plan) { return describe<float>(m, plan); }

int batched_inv_plan_f64(int m, int* plan) {
  return describe<double>(m, plan);
}

}  // extern "C"
