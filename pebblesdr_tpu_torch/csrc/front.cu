// Fused wideband front end for Hopper (sm_90a): DC blocker + NCO mix +
// composed-FIR decimation, on one lane-packed [T, 2C] float32 or int16 plane
// (re in lanes [0, C), im in lanes [C, 2C)).
//
// Replaces the TPU kernel _front_kernel / fused_front_packed
// (pebblesdr_tpu/ops/pallas_kernels.py:119, :516) at fold 1 with its
// switches: int16 entry (in_scale, :181-187), static IQ balance (iqbal,
// :212-216), the NB1/NB2 noise blanker (nb_mode, :218-312), the FM
// discriminator (disc_gain, :352-361), the trailing-window y output
// (y_tail_rows, :344-351) and the hq composite decimation by 2 (comp_taps,
// :362-372).  The plain PyTorch version is fused_front_reference in
// ops/front.py.
//
// What bounds it: the input plane is read once (512 MiB per headline
// dispatch of 32 x 32768 rows x 128 lanes in float32, half that in int16),
// and the FIR costs (D+1) FMAs per output lane: D = 710 for the factor-32
// AM plan, about 3 GFMA a dispatch; D = 282 for the factor-8 WFM plan, about
// 4.75 GFMA.
// The TPU kernel walks 2048-row sub-blocks in order and carries the DC
// estimate and the FIR history from one grid step to the next; a Hopper grid
// runs in no order, so the carried state becomes closed forms:
//   1. front_means: per-chunk (512-row) means of every lane, in parallel over
//      chunks; it also copies each block's trailing raw rows (display tails).
//   2. front_dc_scan: the chunk EWMA m_k = a m_{k-1} + (1-a) mu_k as a
//      two-level scan (32 segments per lane, then the 32 segment seeds).
//   2b. with the noise blanker: front_nb_means re-reads the plane, forms
//      z = IQbal(x - m_k) and writes the chunk means of |z|^2 (both lane
//      halves), and front_dc_scan turns them into the blanker's chunk EWMA
//      with a = (1-alpha)^512.  The blanker's average is a linear EWMA of
//      these means, so it too has a closed form and the tiles stay
//      parallel; chunk k compares against the value after chunk k-1 (the
//      carried nb_avg for chunk 0).
//   3. front_fir: tiles of 24 decimated outputs x 8 channels, two blocks per
//      SM, consecutive blocks on the channel groups of one time tile (so each
//      512-byte input row is fetched once from DRAM).  Each block re-reads a
//      halo of D input rows (mostly from L2) into shared memory with
//      asynchronous copies, all in flight at once (int16: plain loads, 16
//      in flight per thread, scaled by 2^-15); while they land it builds the DC estimates of the
//      covered chunks and the oscillator's phasor tables; then it
//      DC-removes, IQ-balances and mixes the tile in place (rows before
//      t = 0 come from the carried post-mix tail, already blanked) and runs
//      the FIR in polyphase form: each of 16 thread groups holds one
//      branch's taps in registers while that branch's column of staged
//      samples streams past once, fully unrolled (one shared load per up to
//      24 FMAs); the groups' partial sums meet in shared memory.
//      With the noise blanker the block also stages the blank_width - 1
//      input rows above its tile, computes every row's spike flags (a
//      16-bit word per row: one bit per lane, gathered by warp ballots;
//      rows before t = 0 take the carried flags), and after the mix ORs
//      each row's word with those of the rows before it (the causal
//      dilation), zeroing (NB1) or RMS-scaling (NB2) the flagged lanes.
//   4. front_tail: the post-mix history carried to the next dispatch (the
//      same DC, IQ balance, dilation and blanking per row), and with the
//      blanker the last 16 rows of undilated flags.
//   5. front_disc (WFM only): the FM discriminator of every decimated row,
//      atan2(y[o] conj(y[o-1])) * gain with y[-1] the carried disc_last, the
//      next disc_last, and each block's trailing y_tail_rows rows of y.  The
//      TPU kernel carries y[o-1] across its sequential grid steps; here the
//      FIR writes all of y to scratch and this pass reads it back (64 MiB
//      per WFM headline dispatch), so no tile needs its neighbour's output.
//      The conj product uses round-to-nearest intrinsics so no contraction
//      changes a zero's sign: the first row after a zero seed lands on
//      atan2(+-0, -0) = +-pi exactly as the plain version does.
//      With comp_taps it writes no full-rate plane, only the last hr rows
//      of the discriminator output (the next dispatch's comp_hist).
//   6. front_comp (hq only): the composite decimation by 2, disc[j] =
//      sum_{i<tc} ct[i] d[2j - i].  The TPU kernel carries d's last rows
//      from one sequential grid step to the next; here each tile of 64
//      half-rate outputs x 32 channels recomputes the d rows it needs
//      (128 + tc - 1: one atan2 per row and channel, from the y scratch)
//      into shared memory, rows before t = 0 from the carried comp_hist,
//      and runs the tc-tap FIR from there.  The full-rate d plane (64 MiB
//      per wfm_hq_64ch dispatch) never goes to device memory; the cost is
//      a second read of the y scratch and (tc - 1) / 128 extra atan2s.
// The oscillator is factored as in the TPU kernel: a coarse phasor per
// 128 rows times a fine phasor per row within them, with the phases in the
// split form (t = 2048 s + 128 q + r, f_hi on the 2^-12 grid).  The phase
// arithmetic uses round-to-nearest intrinsics, so no FMA contraction changes
// its rounding: the plain PyTorch version computes the same float32 phases
// bit for bit.  So do the IQ balance and the blanker's |z|^2, threshold and
// NB2 scale: a spike flag is a comparison, and a contraction that moved one
// product by an ulp could flip it.  Every dot is IEEE float32.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDcChunk = 512;   // DC-estimate chunk (ops.iir.dc_removal_chunked)
constexpr int kSub = 2048;      // phase decomposition: t = kSub*s + kQ*q + r
constexpr int kQ = 128;
constexpr int kCg = 8;          // channels per FIR block
constexpr int kLanes = 2 * kCg; // re + im lanes per FIR block
constexpr int kGroups = 16;     // phase groups per FIR block
constexpr int kThreads = kLanes * kGroups;
constexpr int kM = 24;          // decimated outputs per FIR block (two
                                // blocks fit an SM's shared memory)
constexpr int kMaxSmem = 232448;
constexpr int kNbTailRows = 16; // carried spike-flag rows
constexpr int kNbHalo = kNbTailRows - 1;  // most flag rows above a tile
constexpr float kI16Scale = 1.0f / 32768.0f;  // int16 full scale -> 1.0

// The entry plane's element as float32: int16 is dequantized on load (the
// product by 2^-15 is exact).
__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load_x(const int16_t* x, size_t i) {
  return (float)x[i] * kI16Scale;
}

constexpr int kI16Batch = 16;   // int16 staging loads in flight per thread
constexpr int kI16VecBatch = 6; // the same for 16-byte loads (8 lanes each)

// Static IQ balance: re' = g re, im' = im + p re (no contraction, as the
// plain version's separate float32 ops).
struct Iq {
  const float* g;   // scalar gain on the device, or null (off)
  const float* p;   // scalar phase on the device
};

struct IqVals {
  bool on;
  float g, p;
  __device__ explicit IqVals(const Iq& iq)
      : on(iq.g != nullptr), g(on ? *iq.g : 1.0f), p(on ? *iq.p : 0.0f) {}
  __device__ __forceinline__ void apply(float* zr, float* zi) const {
    if (on) {
      const float r = *zr;
      *zr = __fmul_rn(r, g);
      *zi = __fadd_rn(*zi, __fmul_rn(p, r));
    }
  }
};

// The noise blanker's arguments (mode 0 = off).
struct Nb {
  int mode;              // 1 = NB1 (blank), 2 = NB2 (scale to the average)
  int bw;                // blank width: a spike blanks itself and bw-1 rows
  float thr2;            // threshold^2
  const float* seq;      // [T/512, 2C] the average after each chunk
  const float* avg_in;   // [1, 2C] the carried average
  const float* tail_in;  // [16, 2C] the carried undilated flags
  unsigned char* mask;   // [T, 2C] dilated flags out (for checking), or null
};

__device__ __forceinline__ float mag2(float zr, float zi) {
  return __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi));
}

// The average entering chunk k of one lane.
__device__ __forceinline__ float nb_avg_entering(const Nb& nb, int k,
                                                 size_t c2, size_t lane) {
  return k ? nb.seq[(size_t)(k - 1) * c2 + lane] : nb.avg_in[lane];
}

__device__ __forceinline__ bool nb_spike(float m2, float avg, float thr2) {
  return m2 > __fmul_rn(thr2, fmaxf(avg, 1e-18f));
}

// NB2's substitution scale, sqrt(avg / max(|z|^2, 1e-24)) in IEEE division
// and square root, as the plain version.
__device__ __forceinline__ float nb_scale(float avg, float m2) {
  return __fsqrt_rn(__fdiv_rn(avg, fmaxf(m2, 1e-24f)));
}

__device__ __forceinline__ float mod1(float v) {
  // floor-mod by 1 (jnp.mod / torch.remainder): v - floor(v) is the same
  // single rounding of the exact result as fmod-then-shift
  return v - floorf(v);
}

// exp(-j 2 pi phase) factors of row t, in the TPU kernel's split form:
// coarse (sub-block start + 128-row step) and fine (row within 128).  The
// phase arithmetic uses round-to-nearest intrinsics (no FMA contraction), so
// it rounds exactly as the plain version's separate float32 ops do.
__device__ __forceinline__ float coarse_phase(int t, float ph, float fh,
                                              float fl) {
  const float k0 = (float)((t / kSub) * kSub);
  const float qq = (float)(((t % kSub) / kQ) * kQ);
  const float ph0 = mod1(__fadd_rn(__fadd_rn(ph, mod1(__fmul_rn(k0, fh))),
                                   __fmul_rn(k0, fl)));
  return mod1(__fadd_rn(__fadd_rn(ph0, mod1(__fmul_rn(qq, fh))),
                        __fmul_rn(qq, fl)));
}

__device__ __forceinline__ float fine_phase(int r, float fh, float fl) {
  const float rr = (float)r;
  return mod1(__fadd_rn(mod1(__fmul_rn(rr, fh)), __fmul_rn(rr, fl)));
}

// u = z * exp(-j 2 pi (coarse + fine)) with the phasor as coarse x fine.
__device__ __forceinline__ void mix(float zr, float zi, float cr, float ci,
                                    float fr, float fi, float* ur, float* ui) {
  const float a = cr * fr - ci * fi;   // cos of the summed phase
  const float b = cr * fi + ci * fr;   // sin of the summed phase
  *ur = zr * a + zi * b;
  *ui = zi * a - zr * b;
}

// The carried spike flags (re lane, im lane) of row t < 0, channel c.
__device__ __forceinline__ void nb_carried(const Nb& nb, int t, int c, int C,
                                           bool* fr, bool* fi) {
  const size_t r = (size_t)(kNbTailRows + t) * 2 * (size_t)C;
  *fr = t >= -kNbTailRows && nb.tail_in[r + c] > 0.0f;
  *fi = t >= -kNbTailRows && nb.tail_in[r + C + c] > 0.0f;
}

// One sample's detection: z = IQbal(x - m) and its spike flags against
// the re and im lanes' entering averages.
__device__ __forceinline__ void nb_detect(float xr, float xi, float mr,
                                          float mi, float avr, float avi,
                                          const IqVals& iq, float thr2,
                                          float* zr, float* zi, bool* fr,
                                          bool* fi) {
  *zr = xr - mr;
  *zi = xi - mi;
  iq.apply(zr, zi);
  const float m2 = mag2(*zr, *zi);
  *fr = nb_spike(m2, avr, thr2);
  *fi = nb_spike(m2, avi, thr2);
}

// The spike flags of row t, channel c, straight from the plane
// (front_tail's rows).
template <typename Tx>
__device__ __forceinline__ void nb_flags_at(const Tx* __restrict__ x, int t,
                                            int c, int C,
                                            const float* __restrict__ mseq,
                                            const IqVals& iq, const Nb& nb,
                                            bool* fr, bool* fi) {
  if (t < 0) {
    nb_carried(nb, t, c, C, fr, fi);
    return;
  }
  const size_t c2 = 2 * (size_t)C;
  const int k = t / kDcChunk;
  const size_t row = (size_t)t * c2, mr = (size_t)k * c2;
  float zr, zi;
  nb_detect(load_x(x, row + c), load_x(x, row + C + c), mseq[mr + c],
            mseq[mr + C + c], nb_avg_entering(nb, k, c2, c),
            nb_avg_entering(nb, k, c2, C + c), iq, nb.thr2, &zr, &zi, fr, fi);
}

// grid (nchunk, ceil(2C/32)), block (32, 8)
template <typename Tx>
__global__ void front_means(const Tx* __restrict__ x, int c2, int n,
                            int r_rows, float* __restrict__ means,
                            float* __restrict__ raw) {
  __shared__ float part[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = blockIdx.y * 32 + tx;
  const int k = blockIdx.x;
  float acc = 0.0f;
  if (lane < c2) {
#pragma unroll 8
    for (int i = ty; i < kDcChunk; i += 8) {
      const int t = k * kDcChunk + i;
      const float v = load_x(x, (size_t)t * c2 + lane);
      acc += v;
      const int b = t / n;
      const int off = t - b * n - (n - r_rows);
      if (off >= 0) raw[((size_t)b * r_rows + off) * c2 + lane] = v;
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && lane < c2) {
    float s = 0.0f;
    for (int j = 0; j < 8; ++j) s += part[j][tx];
    means[(size_t)k * c2 + lane] = s * (1.0f / kDcChunk);
  }
}

// grid ceil(2C/32), block (32, 32).  In place: means in, DC estimates out.
__global__ void front_dc_scan(float* __restrict__ mseq, int nchunk, int c2,
                              const float* __restrict__ dc_in,
                              float* __restrict__ dc_out, float a, float b) {
  __shared__ float seg_r[32][33], seg_p[32][33], seed[32][33];
  const int tx = threadIdx.x, s = threadIdx.y;
  const int lane = blockIdx.x * 32 + tx;
  const int len = (nchunk + 31) / 32;
  const int k0 = min(s * len, nchunk), k1 = min(k0 + len, nchunk);
  float r = 0.0f, p = 1.0f;
  if (lane < c2) {
    for (int k = k0; k < k1; ++k) {
      r = a * r + b * mseq[(size_t)k * c2 + lane];
      p *= a;
    }
  }
  seg_r[s][tx] = r;
  seg_p[s][tx] = p;
  __syncthreads();
  if (s == 0 && lane < c2) {
    float m = dc_in[lane];
    for (int j = 0; j < 32; ++j) {
      seed[j][tx] = m;
      m = seg_p[j][tx] * m + seg_r[j][tx];
    }
    dc_out[lane] = m;
  }
  __syncthreads();
  if (lane < c2) {
    float m = seed[s][tx];
    for (int k = k0; k < k1; ++k) {
      const size_t i = (size_t)k * c2 + lane;
      m = a * m + b * mseq[i];
      mseq[i] = m;
    }
  }
}

// grid (nchunk, ceil(C/32)), block (32, 8).  The noise blanker's chunk
// means of |z|^2, z = IQbal(x - m_k), written to both lane halves.
template <typename Tx>
__global__ void front_nb_means(const Tx* __restrict__ x, int C,
                               const float* __restrict__ mseq, Iq iq_args,
                               float* __restrict__ nbseq) {
  __shared__ float part[8][32];
  const IqVals iq(iq_args);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * 32 + tx;
  const int k = blockIdx.x;
  const size_t c2 = 2 * (size_t)C;
  float acc = 0.0f;
  if (c < C) {
    const float mr = mseq[(size_t)k * c2 + c], mi = mseq[(size_t)k * c2 + C + c];
#pragma unroll 8
    for (int i = ty; i < kDcChunk; i += 8) {
      const size_t row = (size_t)(k * kDcChunk + i) * c2;
      float zr = load_x(x, row + c) - mr;
      float zi = load_x(x, row + C + c) - mi;
      iq.apply(&zr, &zi);
      acc += mag2(zr, zi);
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < C) {
    float s = 0.0f;
    for (int j = 0; j < 8; ++j) s += part[j][tx];
    s *= 1.0f / kDcChunk;
    nbseq[(size_t)k * c2 + c] = s;
    nbseq[(size_t)k * c2 + C + c] = s;
  }
}

// Where element e of a FIR block's staged rows [t0, t0 + rows) comes from:
// its lane's column, and the source row (input row t, or carried tail row
// d_rows + t for -d_rows <= t < 0); false when it is zero.
__device__ __forceinline__ bool stage_src(int e, int t0, int T, int C, int c0,
                                          int d_rows, size_t* col, int* t) {
  const int row = e / kLanes, l = e - row * kLanes;
  const int c = c0 + (l < kCg ? l : l - kCg);
  *col = (l < kCg ? 0 : (size_t)C) + c;
  *t = t0 + row;
  return c < C && *t >= -d_rows && *t < T;
}

// Stage rows [t0, t0 + rows) of the block's channels into dst[rows][kLanes]
// (rows before t = 0 from the carried tail, d_rows = 0 for none; rows
// outside both are zero).  float32: asynchronous copies, all in flight at
// once (the caller commits and waits).
// (One copy call per source: selecting the source pointer first made
// front_fir 7 % slower on the H100.)
__device__ __forceinline__ void stage_rows(float* dst, const float* x,
                                           const float* tail_in, int d_rows,
                                           int t0, int rows, int T, int C,
                                           int c0, int tid, bool) {
  const size_t c2 = 2 * (size_t)C;
  for (int e = tid; e < rows * kLanes; e += kThreads) {
    const int row = e / kLanes, l = e - row * kLanes;
    const int c = c0 + (l < kCg ? l : l - kCg);
    const size_t col = (l < kCg ? 0 : (size_t)C) + c;
    const int t = t0 + row;
    if (c < C && t >= 0 && t < T)
      __pipeline_memcpy_async(dst + e, x + (size_t)t * c2 + col,
                              sizeof(float));
    else if (c < C && t < 0 && t >= -d_rows)
      __pipeline_memcpy_async(dst + e,
                              tail_in + (size_t)(d_rows + t) * c2 + col,
                              sizeof(float));
    else
      dst[e] = 0.0f;
  }
}

// int16: cp.async moves 4 bytes or more, so plain loads in flight before
// their dequantized stores.  When C % 8 == 0 and the plane is 16-byte
// aligned (vec), a row's 8 re (or 8 im) values of the block's channels are
// one 16-byte load, kI16VecBatch of them in flight per thread; otherwise
// element by element, kI16Batch in flight.
__device__ __forceinline__ void stage_rows(float* dst, const int16_t* x,
                                           const float* tail_in, int d_rows,
                                           int t0, int rows, int T, int C,
                                           int c0, int tid, bool vec) {
  const size_t c2 = 2 * (size_t)C;
  if (vec) {
    const int n = rows * 2;                        // (row, lane half) pairs
    for (int e0 = tid; e0 < n; e0 += kThreads * kI16VecBatch) {
      int4 v[kI16VecBatch];
#pragma unroll
      for (int j = 0; j < kI16VecBatch; ++j) {
        const int e = e0 + j * kThreads, t = t0 + (e >> 1);
        if (e < n && t >= 0 && t < T)
          v[j] = *reinterpret_cast<const int4*>(
              x + (size_t)t * c2 + (e & 1) * (size_t)C + c0);
      }
#pragma unroll
      for (int j = 0; j < kI16VecBatch; ++j) {
        const int e = e0 + j * kThreads, t = t0 + (e >> 1);
        if (e >= n) continue;
        float* d = dst + (e >> 1) * kLanes + (e & 1) * kCg;
        if (t >= 0 && t < T) {
          const int w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[2 * i] = (float)(short)(w[i] & 0xffff) * kI16Scale;
            d[2 * i + 1] = (float)(w[i] >> 16) * kI16Scale;
          }
        } else {
          const float* tl = tail_in + (size_t)(d_rows + t) * c2
                            + (e & 1) * (size_t)C + c0;
#pragma unroll
          for (int i = 0; i < kCg; ++i)
            d[i] = (t < 0 && t >= -d_rows) ? tl[i] : 0.0f;
        }
      }
    }
    return;
  }
  const int n = rows * kLanes;
  for (int e0 = tid; e0 < n; e0 += kThreads * kI16Batch) {
    float v[kI16Batch];
#pragma unroll
    for (int j = 0; j < kI16Batch; ++j) {
      const int e = e0 + j * kThreads;
      size_t col;
      int t;
      v[j] = 0.0f;
      if (e < n && stage_src(e, t0, T, C, c0, d_rows, &col, &t))
        v[j] = t >= 0 ? load_x(x, (size_t)t * c2 + col)
                      : tail_in[(size_t)(d_rows + t) * c2 + col];
    }
#pragma unroll
    for (int j = 0; j < kI16Batch; ++j)
      if (e0 + j * kThreads < n) dst[e0 + j * kThreads] = v[j];
  }
}

// Shared-memory layout of the FIR block (floats), all offsets 32-aligned.
// The u area first stages the span input rows, then holds the groups'
// partial sums [kGroups][kM][kLanes], so it is sized for the larger.  With
// the noise blanker: the entering averages of the covered chunks, up to
// kNbHalo input rows above the tile, and a 16-bit flag word per row.
// ops/front.py mirrors this layout (fir_smem_layout).
struct FirSmem {
  int h, fine_c, fine_s, coarse_c, coarse_s, dc, avg, halo, flags, u, total;
  __host__ __device__ FirSmem(int F, int dp, bool nb) {
    const int span = F * (kM + dp - 1);
    const int rows = span + (nb ? kNbHalo : 0);
    h = 0;
    fine_c = align32(h + F * dp);
    fine_s = fine_c + kQ * kCg;
    coarse_c = fine_s + kQ * kCg;
    coarse_s = coarse_c + align32(max_q(span) * kCg);
    dc = coarse_s + align32(max_q(span) * kCg);
    avg = dc + align32(max_chunks(rows) * kLanes);
    halo = avg + (nb ? align32(max_chunks(rows) * kLanes) : 0);
    flags = halo + (nb ? align32(kNbHalo * kLanes) : 0);
    u = flags + (nb ? align32((rows + 1) / 2) : 0);
    total = u + (span > kGroups * kM ? span : kGroups * kM) * kLanes;
  }
  __host__ __device__ static int align32(int v) { return (v + 31) & ~31; }
  __host__ __device__ static int max_q(int span) { return span / kQ + 2; }
  __host__ __device__ static int max_chunks(int rows) {
    return rows / kDcChunk + 2;
  }
};

// grid (ceil(C/kCg), ceil((T/F)/kM)), block (kLanes, kGroups).
// y[o] = sum_{j=0..D} h[j] u[F o - j], u[t < 0] = tail[d_rows + t].
// DP taps per polyphase branch (h zero-padded to F*DP taps).  NB: the
// noise blanker is on (nb.mode != 0); a separate instantiation, so the
// blanker's passes cost the plain form nothing.
template <typename Tx, int DP, bool NB>
__global__ void __launch_bounds__(kThreads)
front_fir(const Tx* __restrict__ x, int T, int C,
          const float* __restrict__ mseq, const float* __restrict__ tail_in,
          int d_rows, const float* __restrict__ phase0,
          const float* __restrict__ fhi, const float* __restrict__ flo,
          const float* __restrict__ h, int ntaps, int F, Iq iq_args, Nb nb,
          bool x_vec, float* __restrict__ y) {
  extern __shared__ float smem[];
  constexpr bool nb_on = NB;
  const FirSmem lay(F, DP, nb_on);
  const IqVals iq(iq_args);
  float* h_s = smem + lay.h;                      // [F][DP]: h[F i + p]
  float* u_s = smem + lay.u;                      // [span][kLanes]
  float* halo_s = smem + lay.halo;                // [halo][kLanes]
  unsigned short* flag_s =                        // [halo + span] lane bits
      reinterpret_cast<unsigned short*>(smem + lay.flags);
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const size_t c2 = 2 * (size_t)C;
  const int c0 = blockIdx.x * kCg;
  const int o0 = blockIdx.y * kM;
  const int span = F * (kM + DP - 1);
  const int t_base = F * o0 - F * DP + 1;         // row of u_s[0]
  const int t_lo = max(t_base, 0);
  const int t_hi = min(t_base + span, T);         // rows [t_lo, t_hi) are input
  const int halo = nb_on ? nb.bw - 1 : 0;         // flag rows above the tile
  const int t_flag = t_base - halo;               // row of flag_s[0]
  const int q_base = t_lo / kQ;
  const int k_base = max(t_flag, 0) / kDcChunk;   // first chunk of the tables

  // 1. Raw input rows [t_base, t_base + span) -> u_s by asynchronous copies,
  // all in flight at once (rows before t = 0 come from the carried post-mix
  // tail, rows outside both are zero), and with the blanker the rows
  // [t_flag, t_base) -> halo_s ...
  stage_rows(u_s, x, tail_in, d_rows, t_base, span, T, C, c0, tid, x_vec);
  if (nb_on)
    stage_rows(halo_s, x, tail_in, 0, t_flag, halo, T, C, c0, tid, x_vec);
  __pipeline_commit();

  // ... while they land: the taps, the DC estimates (and the blanker's
  // entering averages) of the covered chunks, and the oscillator's fine
  // (row within 128) and coarse (per 128 rows) phasors of this block's
  // channels.
  for (int i = tid; i < F * DP; i += kThreads) {
    const int p = i / DP, k = i - p * DP, j = F * k + p;
    h_s[i] = j < ntaps ? h[j] : 0.0f;
  }
  {
    const int nk = (t_hi - 1) / kDcChunk - k_base + 1;
    for (int i = tid; i < nk * kLanes; i += kThreads) {
      const int k = i / kLanes, l = i - k * kLanes;
      const int c = c0 + (l < kCg ? l : l - kCg);
      const size_t lane = (l < kCg ? 0 : (size_t)C) + c;
      smem[lay.dc + i] = c < C ? mseq[(size_t)(k_base + k) * c2 + lane] : 0.0f;
      if (nb_on)
        smem[lay.avg + i] = c < C ? nb_avg_entering(nb, k_base + k, c2, lane)
                                  : 0.0f;
    }
    for (int i = tid; i < kQ * kCg; i += kThreads) {
      const int r = i / kCg, c = c0 + i % kCg;
      float sn = 0.0f, cs = 1.0f;
      if (c < C) sincospif(2.0f * fine_phase(r, fhi[c], flo[c]), &sn, &cs);
      smem[lay.fine_c + i] = cs;
      smem[lay.fine_s + i] = sn;
    }
    const int nq = (t_hi - 1) / kQ - q_base + 1;
    for (int i = tid; i < nq * kCg; i += kThreads) {
      const int q = i / kCg, c = c0 + i % kCg;
      float sn = 0.0f, cs = 1.0f;
      if (c < C)
        sincospif(2.0f * coarse_phase((q_base + q) * kQ, phase0[c], fhi[c],
                                      flo[c]), &sn, &cs);
      smem[lay.coarse_c + i] = cs;
      smem[lay.coarse_s + i] = sn;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2a. The blanker: z = IQbal(x - m) in place for the tile's input rows,
  // and the spike flags of every row from max(t_flag, -halo): a warp holds
  // 4 rows x 8 channels, so one ballot per lane half gives 4 rows' words.
  // Rows before t = 0 take the carried flags.
  if (nb_on) {
    const int t_a = max(t_flag, -halo);
    const int n_e = (t_hi - t_a) * kCg;           // a multiple of 8
    for (int e0 = 0; e0 < n_e; e0 += kThreads) {  // uniform: ballots below
      const int e = e0 + tid;
      const int t = t_a + e / kCg, cc = e % kCg;
      const int c = c0 + cc;
      bool fr = false, fi = false;
      if (e < n_e && c < C) {
        if (t < 0) {
          nb_carried(nb, t, c, C, &fr, &fi);
        } else {
          float* pr = t < t_base ? halo_s + (t - t_flag) * kLanes + cc
                                 : u_s + (t - t_base) * kLanes + cc;
          const int k = t / kDcChunk - k_base;
          const float* m = smem + lay.dc + k * kLanes + cc;
          const float* av = smem + lay.avg + k * kLanes + cc;
          float zr, zi;
          nb_detect(pr[0], pr[kCg], m[0], m[kCg], av[0], av[kCg], iq,
                    nb.thr2, &zr, &zi, &fr, &fi);
          if (t >= t_base) {
            pr[0] = zr;
            pr[kCg] = zi;
          }
        }
      }
      const unsigned br = __ballot_sync(0xffffffffu, fr);
      const unsigned bi = __ballot_sync(0xffffffffu, fi);
      if (e < n_e && cc == 0) {
        const int sh = tid & 24;                  // (lane / 8) * 8
        flag_s[t - t_flag] = (unsigned short)(((br >> sh) & 0xffu)
                                              | (((bi >> sh) & 0xffu) << 8));
      }
    }
    __syncthreads();
  }

  // 2b. DC removal, IQ balance and mix of the input rows, in place, from
  // shared memory; with the blanker the rows hold z already, and the
  // dilated flags (this row's word ORed with the bw-1 words before it)
  // zero (NB1) or scale (NB2) the mixed lanes.
  for (int e = tid; e < (t_hi - t_lo) * kCg; e += kThreads) {
    const int t = t_lo + e / kCg, cc = e % kCg;
    if (c0 + cc >= C) continue;
    const int q = t / kQ - q_base, r = t % kQ, k = t / kDcChunk - k_base;
    float* ur = u_s + (t - t_base) * kLanes + cc;
    float* ui = ur + kCg;
    float zr = *ur, zi = *ui;
    if (!nb_on) {
      const float* m = smem + lay.dc + k * kLanes + cc;
      zr -= m[0];
      zi -= m[kCg];
      iq.apply(&zr, &zi);
    }
    float vr, vi;
    mix(zr, zi, smem[lay.coarse_c + q * kCg + cc],
        smem[lay.coarse_s + q * kCg + cc], smem[lay.fine_c + r * kCg + cc],
        smem[lay.fine_s + r * kCg + cc], &vr, &vi);
    if (nb_on) {
      const int j = t - t_flag;
      unsigned w = 0;
      for (int s = 0; s < nb.bw; ++s) w |= flag_s[j - s];
      const bool br = (w >> cc) & 1u, bi = (w >> (kCg + cc)) & 1u;
      if (nb.mask) {     // rows shared by neighbouring tiles get equal words
        nb.mask[(size_t)t * c2 + c0 + cc] = br;
        nb.mask[(size_t)t * c2 + C + c0 + cc] = bi;
      }
      if (nb.mode == 1) {
        if (br) vr = 0.0f;
        if (bi) vi = 0.0f;
      } else if (br || bi) {
        const float m2 = mag2(zr, zi);
        const float* av = smem + lay.avg + k * kLanes + cc;
        if (br) vr = __fmul_rn(vr, nb_scale(av[0], m2));
        if (bi) vi = __fmul_rn(vi, nb_scale(av[kCg], m2));
      }
    }
    *ur = vr;
    *ui = vi;
  }
  __syncthreads();

  // 3. Polyphase FIR: group g takes branches p = g, g + kGroups, ...; branch p's DP
  // taps sit in registers while its column of u streams past once:
  // tap i of local output ol reads shared row F (ol - i + DP) - 1 - p.
  // With F < kGroups (F = 8, the WFM plan) groups F.. have no branch and
  // idle; splitting a branch's taps over several groups is later speed work.
  const int lx = threadIdx.x, g = threadIdx.y;
  float acc[kM];
#pragma unroll
  for (int ol = 0; ol < kM; ++ol) acc[ol] = 0.0f;
  for (int p = g; p < F; p += kGroups) {
    float hr[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) hr[i] = h_s[p * DP + i];
    const float* col = u_s + (F - 1 - p) * kLanes + lx;   // row F m - 1 - p
    const int stride = F * kLanes;
#pragma unroll
    for (int m = 1; m < kM + DP; ++m) {
      const float v = col[(m - 1) * stride];
#pragma unroll
      for (int ol = 0; ol < kM; ++ol) {
        const int i = ol + DP - m;
        if (i >= 0 && i < DP) acc[ol] = fmaf(hr[i], v, acc[ol]);
      }
    }
  }
  __syncthreads();
  float* red = u_s;                                // [kGroups][kM][kLanes]
#pragma unroll
  for (int ol = 0; ol < kM; ++ol) red[(g * kM + ol) * kLanes + lx] = acc[ol];
  __syncthreads();
  const int n_out = T / F;
  for (int e = tid; e < kM * kLanes; e += kThreads) {
    const int ol = e / kLanes, l = e - ol * kLanes;
    const int cch = c0 + (l < kCg ? l : l - kCg);
    const int o = o0 + ol;
    if (cch < C && o < n_out) {
      float s = 0.0f;
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) s += red[(gg * kM + ol) * kLanes + l];
      y[(size_t)o * c2 + (l < kCg ? (size_t)cch : (size_t)C + cch)] = s;
    }
  }
}

// grid ceil((d_rows + nb_rows) * C / 256), block 256: the last d_rows
// post-mix rows, then (with the blanker, nb_rows = 16) the last 16 rows of
// undilated spike flags.
template <typename Tx>
__global__ void front_tail(const Tx* __restrict__ x, int T, int C,
                           const float* __restrict__ mseq,
                           const float* __restrict__ tail_in, int d_rows,
                           const float* __restrict__ phase0,
                           const float* __restrict__ fhi,
                           const float* __restrict__ flo, Iq iq_args, Nb nb,
                           float* __restrict__ tail_out,
                           float* __restrict__ nb_tail_out) {
  const IqVals iq(iq_args);
  const int nb_rows = nb.mode ? kNbTailRows : 0;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (d_rows + nb_rows) * C) return;
  const int i = idx / C, c = idx % C;
  const size_t c2 = 2 * (size_t)C;
  if (i >= d_rows) {                               // nb_tail' row
    const int j = i - d_rows;
    bool fr, fi;
    nb_flags_at(x, T - kNbTailRows + j, c, C, mseq, iq, nb, &fr, &fi);
    nb_tail_out[j * c2 + c] = fr ? 1.0f : 0.0f;
    nb_tail_out[j * c2 + C + c] = fi ? 1.0f : 0.0f;
    return;
  }
  const int t = T - d_rows + i;
  float ur, ui;
  if (t >= 0) {
    const size_t xr = (size_t)t * c2;
    const int k = t / kDcChunk;
    const size_t mr = (size_t)k * c2;
    float cr, ci, fr, fi;
    sincospif(2.0f * coarse_phase(t, phase0[c], fhi[c], flo[c]), &ci, &cr);
    sincospif(2.0f * fine_phase(t % kQ, fhi[c], flo[c]), &fi, &fr);
    float zr = load_x(x, xr + c) - mseq[mr + c];
    float zi = load_x(x, xr + C + c) - mseq[mr + C + c];
    iq.apply(&zr, &zi);
    mix(zr, zi, cr, ci, fr, fi, &ur, &ui);
    if (nb.mode) {
      bool br = false, bi = false;
      for (int s = 0; s < nb.bw; ++s) {
        bool a, b;
        nb_flags_at(x, t - s, c, C, mseq, iq, nb, &a, &b);
        br |= a;
        bi |= b;
      }
      if (nb.mask) {
        nb.mask[xr + c] = br;
        nb.mask[xr + C + c] = bi;
      }
      if (nb.mode == 1) {
        if (br) ur = 0.0f;
        if (bi) ui = 0.0f;
      } else if (br || bi) {
        const float m2 = mag2(zr, zi);
        if (br) ur = __fmul_rn(ur, nb_scale(nb_avg_entering(nb, k, c2, c), m2));
        if (bi)
          ui = __fmul_rn(ui, nb_scale(nb_avg_entering(nb, k, c2, C + c), m2));
      }
    }
  } else {
    const size_t tr = (size_t)(d_rows + t) * c2;
    ur = tail_in[tr + c];
    ui = tail_in[tr + C + c];
  }
  tail_out[i * c2 + c] = ur;
  tail_out[i * c2 + C + c] = ui;
}

// The FM discriminator of decimated row o >= 0, channel c:
// atan2(y[o] conj(y[o-1])) * gain, y[-1] the carried disc_last.
__device__ __forceinline__ float disc_at(const float* __restrict__ y, int o,
                                         int C, int c,
                                         const float* __restrict__ disc_last,
                                         float gain) {
  const size_t c2 = 2 * (size_t)C;
  const float yr = y[o * c2 + c], yi = y[o * c2 + C + c];
  const float* prev = o ? y + (o - 1) * c2 : disc_last;
  const float pr = prev[c], pi = prev[C + c];
  const float im = __fsub_rn(__fmul_rn(yi, pr), __fmul_rn(yr, pi));
  const float re = __fadd_rn(__fmul_rn(yr, pr), __fmul_rn(yi, pi));
  return __fmul_rn(atan2f(im, re), gain);
}

// grid ceil(M*C/256), block 256, M = T/F decimated rows.  FM discriminator
// of the decimated composite (into disc, when not null), the carried
// sample, the y-tail windows, and (hist_out not null, the hq form) the
// last hr rows of the discriminator output [hr, C].
__global__ void front_disc(const float* __restrict__ y, int M, int C,
                           const float* __restrict__ disc_last, float gain,
                           int mb, int y_tail_rows, float* __restrict__ disc,
                           float* __restrict__ dlast,
                           float* __restrict__ ytail,
                           float* __restrict__ hist_out, int hr) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const int o = idx / C, c = idx % C;
  const size_t c2 = 2 * (size_t)C;
  const float yr = y[o * c2 + c], yi = y[o * c2 + C + c];
  const int h = o - (M - hr);                      // row of hist_out
  if (disc != nullptr || (hist_out != nullptr && h >= 0)) {
    const float d = disc_at(y, o, C, c, disc_last, gain);
    if (disc != nullptr) disc[(size_t)o * C + c] = d;
    if (hist_out != nullptr && h >= 0) hist_out[(size_t)h * C + c] = d;
  }
  if (o == M - 1) {
    dlast[c] = yr;
    dlast[C + c] = yi;
  }
  const int b = o / mb, w = o - b * mb - (mb - y_tail_rows);
  if (ytail != nullptr && w >= 0) {
    float* dst = ytail + ((size_t)b * y_tail_rows + w) * c2;
    dst[c] = yr;
    dst[C + c] = yi;
  }
}

constexpr int kCompTile = 64;     // half-rate outputs per front_comp block
constexpr int kCompCh = 32;       // channels per front_comp block
constexpr int kCompRowsY = 8;     // threadIdx.y extent of front_comp
constexpr int kMaxCompTaps = 32;  // most composite-decimator taps

// grid (ceil(C/kCompCh), ceil((M/2)/kCompTile)), block (kCompCh,
// kCompRowsY).  The hq composite decimation by 2 of the discriminator
// output d of the M decimated rows: disc[j] = sum_{i<tc} ct[i] d[2j - i],
// d[t < 0] = comp_hist[hr + t] (hr >= tc - 1).  Each block computes the
// 2 kCompTile + tc - 1 rows of d its outputs read (recomputing the tc - 1
// rows its neighbour also needs) into shared memory, then each thread
// runs the FIR for one channel and every kCompRowsY-th output, in plain
// float32 FMAs from the newest tap to the oldest.
__global__ void __launch_bounds__(kCompCh * kCompRowsY)
front_comp(const float* __restrict__ y, int M, int C,
           const float* __restrict__ disc_last, float gain,
           const float* __restrict__ ct, int tc,
           const float* __restrict__ comp_hist, int hr,
           float* __restrict__ disc) {
  __shared__ float d_s[2 * kCompTile + kMaxCompTaps - 1][kCompCh];
  __shared__ float ct_s[kMaxCompTaps];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kCompCh + tx;
  const int j0 = blockIdx.y * kCompTile;
  const int t_base = 2 * j0 - (tc - 1);           // d row of d_s[0]
  const int rows = 2 * kCompTile + tc - 1;
  if (ty == 0 && tx < tc) ct_s[tx] = ct[tx];
  for (int r = ty; r < rows; r += kCompRowsY) {
    const int t = t_base + r;
    float v = 0.0f;
    if (c < C && t < M)
      v = t >= 0 ? disc_at(y, t, C, c, disc_last, gain)
                 : comp_hist[(size_t)(hr + t) * C + c];
    d_s[r][tx] = v;
  }
  __syncthreads();
  const int mh = M / 2;
  if (c >= C) return;
  for (int jl = ty; jl < kCompTile && j0 + jl < mh; jl += kCompRowsY) {
    const float* col = &d_s[2 * jl + tc - 1][tx];  // d[2j]
    float acc = 0.0f;
    for (int i = 0; i < tc; ++i) acc = fmaf(ct_s[i], col[-i * kCompCh], acc);
    disc[(size_t)(j0 + jl) * C + c] = acc;
  }
}

// Taps per polyphase branch that the FIR kernel is instantiated for
// (ops/front.py mirrors this list in FIR_BRANCH_TAPS).
int fir_branch_taps(int ntaps, int F) {
  const int dp = (ntaps + F - 1) / F;
  for (int inst : {8, 16, 24, 32, 40})
    if (dp <= inst) return inst;
  return 0;
}

size_t fir_smem_bytes(int ntaps, int F, bool nb) {
  const int dp = fir_branch_taps(ntaps, F);
  if (!dp) return 0;
  return (size_t)FirSmem(F, dp, nb).total * sizeof(float);
}

// Everything front_forward takes besides the plane.
struct Fwd {
  int T, C, n, r_rows, d_rows, ntaps, F, y_tail_rows;
  const float *dc_in, *tail_in, *phase0, *fhi, *flo, *h, *disc_last;
  const float *comp_taps, *comp_hist;  // the hq form (comp_taps not null)
  int comp_tc, comp_hr;
  float* comp_hist_out;
  float a, b, disc_gain;
  float *mseq, *y, *dc_out, *tail_out, *raw, *disc, *dlast, *ytail;
  Iq iq;
  Nb nb;
  float nb_a, nb_b;
  float *nb_avg_out, *nb_tail_out;
  cudaStream_t st;
};

template <typename Tx, int DP, bool NB>
cudaError_t launch_fir(const Tx* x, const Fwd& f, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      front_fir<Tx, DP, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((f.C + kCg - 1) / kCg),
                  (unsigned)((f.T / f.F + kM - 1) / kM));
  front_fir<Tx, DP, NB><<<grid, dim3(kLanes, kGroups), smem, f.st>>>(
      x, f.T, f.C, f.mseq, f.tail_in, f.d_rows, f.phase0, f.fhi, f.flo, f.h,
      f.ntaps, f.F, f.iq, f.nb,
      f.C % kCg == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0, f.y);
  return cudaGetLastError();
}

template <typename Tx>
int forward(const Tx* x, const Fwd& f) {
  cudaError_t err;
  const int c2 = 2 * f.C;
  const int nchunk = f.T / kDcChunk;
  const unsigned lane_groups = (unsigned)((c2 + 31) / 32);

  front_means<Tx><<<dim3((unsigned)nchunk, lane_groups), dim3(32, 8), 0,
                    f.st>>>(x, c2, f.n, f.r_rows, f.mseq, f.raw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  front_dc_scan<<<dim3(lane_groups), dim3(32, 32), 0, f.st>>>(
      f.mseq, nchunk, c2, f.dc_in, f.dc_out, f.a, f.b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (f.nb.mode) {
    front_nb_means<Tx><<<dim3((unsigned)nchunk, (unsigned)((f.C + 31) / 32)),
                         dim3(32, 8), 0, f.st>>>(x, f.C, f.mseq, f.iq,
                                                 const_cast<float*>(f.nb.seq));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    front_dc_scan<<<dim3(lane_groups), dim3(32, 32), 0, f.st>>>(
        const_cast<float*>(f.nb.seq), nchunk, c2, f.nb.avg_in, f.nb_avg_out,
        f.nb_a, f.nb_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t smem = fir_smem_bytes(f.ntaps, f.F, f.nb.mode != 0);
  if (smem == 0 || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  switch (fir_branch_taps(f.ntaps, f.F)) {
#define FRONT_FIR_CASE(DP)                                                   \
  case DP:                                                                   \
    err = f.nb.mode ? launch_fir<Tx, DP, true>(x, f, smem)                   \
                    : launch_fir<Tx, DP, false>(x, f, smem);                 \
    break;
    FRONT_FIR_CASE(8)
    FRONT_FIR_CASE(16)
    FRONT_FIR_CASE(24)
    FRONT_FIR_CASE(32)
    FRONT_FIR_CASE(40)
#undef FRONT_FIR_CASE
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  const int nt = (f.d_rows + (f.nb.mode ? kNbTailRows : 0)) * f.C;
  front_tail<Tx><<<(unsigned)((nt + 255) / 256), 256, 0, f.st>>>(
      x, f.T, f.C, f.mseq, f.tail_in, f.d_rows, f.phase0, f.fhi, f.flo, f.iq,
      f.nb, f.tail_out, f.nb_tail_out);
  if ((err = cudaGetLastError()) != cudaSuccess || f.disc_gain == 0.0f)
    return err;

  const int M = f.T / f.F;
  const bool comp = f.comp_taps != nullptr;
  front_disc<<<(unsigned)(((size_t)M * f.C + 255) / 256), 256, 0, f.st>>>(
      f.y, M, f.C, f.disc_last, f.disc_gain, f.n / f.F, f.y_tail_rows,
      comp ? nullptr : f.disc, f.dlast,
      f.y_tail_rows > 0 ? f.ytail : nullptr,
      comp ? f.comp_hist_out : nullptr, f.comp_hr);
  if ((err = cudaGetLastError()) != cudaSuccess || !comp) return err;

  const dim3 grid((unsigned)((f.C + kCompCh - 1) / kCompCh),
                  (unsigned)((M / 2 + kCompTile - 1) / kCompTile));
  front_comp<<<grid, dim3(kCompCh, kCompRowsY), 0, f.st>>>(
      f.y, M, f.C, f.disc_last, f.disc_gain, f.comp_taps, f.comp_tc,
      f.comp_hist, f.comp_hr, f.disc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the FIR kernel needs for a composed response of ntaps taps
// decimating by F, with (nb != 0) or without the noise blanker; 0 when no
// instantiation covers it.
size_t front_fir_smem_bytes(int ntaps, int F, int nb) {
  return fir_smem_bytes(ntaps, F, nb != 0);
}

const char* front_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One fused front-end dispatch of T rows (T * 2C < 2^31; T a multiple of
// 512, of F and of n; T / F / kM < 65536; r_rows <= n) of a float32 plane,
// or of an int16 plane when x_int16 != 0.  Scratch mseq: [T/512, 2C].
// IQ balance when iq_gain/iq_phase (device scalars) are not null.  The noise
// blanker when nb_mode is 1 (NB1) or 2 (NB2): threshold^2 nb_thr2, blank
// width nb_bw <= 16, chunk EWMA (nb_a, nb_b) = (a, 1 - a), carried
// nb_avg_in [1, 2C] and nb_tail_in [16, 2C], scratch nbseq [T/512, 2C], and
// nb_avg_out [1, 2C], nb_tail_out [16, 2C], and, when nb_mask is not null,
// the dilated flags of every row into nb_mask [T, 2C] (uint8).  With disc_gain != 0 also the
// discriminator: disc [T/F, C], dlast [1, 2C] from disc_last [1, 2C], and,
// when y_tail_rows > 0, ytail [T/n, y_tail_rows, 2C] (y is then the
// full-rate scratch the FIR writes).  With comp_taps (comp_tc <= 32 taps,
// the hq form; needs disc_gain, T/F even and >= comp_hr, comp_hr >=
// comp_tc - 1) disc is the [T/(2F), C] composite decimated by 2, with
// the carried comp_hist [comp_hr, C] and comp_hist_out [comp_hr, C].
// Returns the first CUDA error.
int front_forward(int device, const void* x, int x_int16, int T, int C,
                  int n, int r_rows, const float* dc_in, const float* tail_in,
                  int d_rows, const float* phase0, const float* fhi,
                  const float* flo, const float* h, int ntaps, int F, float a,
                  float b, float* mseq, float* y, float* dc_out,
                  float* tail_out, float* raw, const float* iq_gain,
                  const float* iq_phase, int nb_mode, float nb_thr2,
                  int nb_bw, float nb_a, float nb_b, const float* nb_avg_in,
                  const float* nb_tail_in, float* nbseq, float* nb_avg_out,
                  float* nb_tail_out, unsigned char* nb_mask,
                  float disc_gain, const float* disc_last,
                  int y_tail_rows, float* disc, float* dlast, float* ytail,
                  const float* comp_taps, int comp_tc, const float* comp_hist,
                  int comp_hr, float* comp_hist_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb_mode && (nb_bw < 1 || nb_bw > kNbTailRows)) return cudaErrorInvalidValue;
  if (comp_taps != nullptr
      && (disc_gain == 0.0f || comp_tc < 2 || comp_tc > kMaxCompTaps
          || comp_hr < comp_tc - 1 || (T / F) % 2 || T / F < comp_hr))
    return cudaErrorInvalidValue;
  Fwd f;
  f.T = T; f.C = C; f.n = n; f.r_rows = r_rows; f.d_rows = d_rows;
  f.ntaps = ntaps; f.F = F; f.y_tail_rows = y_tail_rows;
  f.dc_in = dc_in; f.tail_in = tail_in; f.phase0 = phase0; f.fhi = fhi;
  f.flo = flo; f.h = h; f.disc_last = disc_last;
  f.comp_taps = comp_taps; f.comp_hist = comp_hist; f.comp_tc = comp_tc;
  f.comp_hr = comp_hr; f.comp_hist_out = comp_hist_out;
  f.a = a; f.b = b; f.disc_gain = disc_gain;
  f.mseq = mseq; f.y = y; f.dc_out = dc_out; f.tail_out = tail_out;
  f.raw = raw; f.disc = disc; f.dlast = dlast; f.ytail = ytail;
  f.iq = Iq{iq_gain, iq_phase};
  f.nb = Nb{nb_mode, nb_bw, nb_thr2, nbseq, nb_avg_in, nb_tail_in, nb_mask};
  f.nb_a = nb_a; f.nb_b = nb_b;
  f.nb_avg_out = nb_avg_out; f.nb_tail_out = nb_tail_out;
  f.st = (cudaStream_t)stream;
  return x_int16 ? forward(static_cast<const int16_t*>(x), f)
                 : forward(static_cast<const float*>(x), f);
}

}  // extern "C"
