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
//      Its bound is bytes (the plane read once): one persistent block per
//      SM slot walks its chunks, and one thread keeps 1D bulk copies of
//      R-row stages in flight on a ring in shared memory (bulk_ring.cuh)
//      across chunk boundaries, while the block sums the landed stages
//      from shared memory, 16 bytes (4 float32 or 8 int16 lanes) per load
//      (float32; int16 in int32, exact), and writes each stage's rows that
//      lie in its block's raw tail.
//   2. front_dc_scan: the chunk EWMA m_k = a m_{k-1} + (1-a) mu_k as a
//      two-level scan (32 segments per lane, then the 32 segment seeds), in
//      a fixed association; each thread first fetches its whole segment
//      (into registers, or a long one into shared memory), all loads in
//      flight at once, so the dependent chains wait on no memory load.
//   2b. with the noise blanker: front_nb_means re-reads the plane, forms
//      z = IQbal(x - m_k) and writes the chunk means of |z|^2 (both lane
//      halves), and front_dc_scan turns them into the blanker's chunk EWMA
//      with a = (1-alpha)^512.  The blanker's average is a linear EWMA of
//      these means, so it too has a closed form and the work items stay
//      parallel; chunk k compares against the value after chunk k-1 (the
//      carried nb_avg for chunk 0).
//   3. front_fir: the DC removal, IQ balance, blanking, mix and polyphase
//      FIR, as one time march.  Its bound is bytes (the plane read once,
//      y written once: 0.166 ms at the AM headline) until F is small: the
//      FIR's 2 taps operations per output lane are 0.16 ms of the float32
//      peak at F = 8 and F = 4 as well.  A work item is one channel group
//      (8 channels, 16 lanes) x one time segment; a persistent grid of one
//      block per SM walks the items (march_plan sizes the segments so that
//      every SM gets about equal rows, at least two items each), and each
//      item marches in steps of km outputs (km F new rows; km = 24 at
//      F = 32, 384 rows a step below):
//      - each input row is staged and mixed once: a step's new rows are
//        DC-removed, balanced, blanked and mixed into a ring of mixed rows
//        that keeps the F (DP - 1) rows of history the next step's FIR
//        needs; only an item's prologue re-reads and re-mixes the history
//        rows before its segment (2-5 % of the plane at the cells);
//      - staging is by the Tensor Memory Accelerator: one thread keeps
//        several steps in flight, each two 2D tensor-map boxes (the re and
//        im lanes of the channel group, up to 256 rows x 8 lanes) landing
//        on a stage's mbarrier (bulk_ring.cuh load_2d), across the item
//        boundaries of the block's stream; a box must start on a 16-byte
//        boundary, so a plane whose im lanes do not (C elem not a multiple
//        of 16 bytes: float32 C % 4 != 0, int16 C % 8 != 0) stages element
//        by element instead, chosen by shape;
//      - copies overlap the mix and the FIR: steps j + 1 .. j + stages - 1
//        land while step j is mixed and filtered;
//      - set-up is paid once per item (the fine phasors) or per block (the
//        taps), and per step only the coarse phasors and DC (and blanker
//        average) entries of the next step's rows, loaded before and formed
//        after the FIR so that their latency hides behind it;
//      - no thread group idles at small F: a block's 32 groups of 16
//        lanes (16 warps share the SM's latencies) split a step's outputs
//        into parts of 12, each made by min(F, 16) groups, one per branch
//        (two at F = 32): 4 parts at F = 8, 8 at F = 4, 16 at F = 2, and
//        the step grows to 12 x 32 / min(F, 16) outputs.  Splitting each
//        branch's taps into slices over the groups instead reorders each
//        output's sum, and the FM discriminator's check reads that at
//        outputs that NB1 left near zero; the parts keep the tiled pass's
//        order and bits.
//      The ring is rewound by copying its last F (DP - 1) rows to its front
//      when the next step would overrun it (every step at the cells'
//      plans: the ring holds the history and the fewest whole steps), so
//      the FIR's fully unrolled loop reads compile-time offsets.  With the noise blanker each row's
//      16-bit flag word (one bit per lane, warp ballots) is formed once and
//      its causal dilation once per row, from a flag ring that carries the
//      15 words before each unit (the prologue's first words come from the
//      plane or the carried flags).
//      Long composed responses (factor 64 / 2007 taps for SSB, CW and DIG,
//      factor 32 / 1159 taps for NONE) keep F (DP - 1) = 1984 or 1248 rows
//      of history: 8 channels' ring of them and the stages of a step do
//      not fit the block's 227 KB.  There a work item is 4 channels (8
//      lanes; march_cg picks 8 wherever that layout fits, so the AM, WFM
//      and hq forms keep their geometry and bits): the ring halves, the
//      block's 64 groups of 8 lanes each run one branch at F = 64 (the step
//      stays 12 outputs, 768 rows), and an int16 plane's stage rows are the
//      16-byte box of 8 channels, of which the item reads its 4.
//   4. K1's carried history, written by front_fir (no launch of its own):
//      tail' (the last d_rows post-mix, post-blank rows) and with the
//      blanker nb_tail' (the last 16 rows of undilated flags), element by
//      element with the arithmetic of the pass it replaced, front_tail
//      (the row's own phasors, and its mix with the FMAs the card compiled
//      there written out, mix_history), spread over the persistent grid
//      before each block's first item.  The ring's rows, mixed with the
//      tables, differ from it in ulps where the compiler contracts the
//      mix's products otherwise; the item that ends the dispatch, which
//      holds the last rows, would also add the work to the end of the
//      kernel (PERF.md section 6, PR 11).
//   5. front_disc (WFM only): the FM discriminator of every decimated row,
//      atan2(y[o] conj(y[o-1])) * gain with y[-1] the carried disc_last, the
//      next disc_last, and each block's trailing y_tail_rows rows of y.  The
//      TPU kernel carries y[o-1] across its sequential grid steps; here the
//      FIR writes all of y to scratch and this pass reads it back (64 MiB
//      per WFM headline dispatch), so no work item needs another.s output.
//      The conj product uses round-to-nearest intrinsics so no contraction
//      changes a zero's sign: the first row after a zero seed lands on
//      atan2(+-0, -0) = +-pi exactly as the plain version does.
//   6. front_comp (hq only, in place of front_disc): the one pass over the
//      y scratch (128 MiB per wfm_hq_64ch dispatch).  From it, d[o] =
//      atan2(y[o] conj(y[o-1])) * gain, the composite decimation by 2
//      disc[j] = sum_{i<tc} ct[i] d[2j - i], the next comp_hist (the last
//      hr rows of d), disc_last and the y-tail windows.  The TPU kernel
//      carries d's last rows from one sequential grid step to the next; here
//      the work is a time march like front_fir's.  A work item is one
//      channel group (32 channels, a warp's lanes) x one segment of
//      half-rate outputs, on a persistent grid; one thread keeps units of
//      2D tensor-map boxes (the group's re and im lanes, 32 rows each) in
//      flight on an mbarrier ring, so each y row lands in shared memory
//      once; each row's d is formed once (its y[o-1] from the staged row
//      before it) into a ring that keeps the 32 rows of history the next
//      step's FIR needs, and only an item's 32-row prologue is formed twice
//      (1.6 % of the rows at wfm_hq_64ch); the y-tail rows and disc_last
//      leave from the staged rows (the y-tails as bulk tensor stores of
//      whole boxes, clipped to the windows by a 3D map), and the item that
//      ends the dispatch writes the next comp_hist from its ring.  Bound:
//      bytes (y read, the half-rate plane and the y-tails written); the
//      atan2s (two IEEE divisions each, dependent chains) run on two blocks
//      of 16 warps per SM while the next units land.  A plane whose C
//      elements are not a multiple of 16 bytes stages element by element.
// The oscillator is factored as in the TPU kernel: a coarse phasor per
// 128 rows times a fine phasor per row within them, with the phases in the
// split form (t = 2048 s + 128 q + r, f_hi on the 2^-12 grid).  The phase
// arithmetic uses round-to-nearest intrinsics, so no FMA contraction changes
// its rounding: the plain PyTorch version computes the same float32 phases
// bit for bit.  So do the IQ balance and the blanker's |z|^2, threshold and
// NB2 scale: a spike flag is a comparison, and a contraction that moved one
// product by an ulp could flip it.  Every dot is IEEE float32, and y keeps
// the bits of the tiled pass that front_fir replaced (the same phasors,
// mix and per-output order of taps and branch sums): the FM discriminator
// of an output whose filter main lobe a blanked gap has emptied (|y| near
// 1e-5) reads the ulps of y as angles.

#include <cuda.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bulk_ring.cuh"
#include "polyphase.cuh"
#include "launch.cuh"

namespace {

constexpr int kDcChunk = 512;   // DC-estimate chunk (ops.iir.dc_removal_chunked)
constexpr int kSub = 2048;      // phase decomposition: t = kSub*s + kQ*q + r
constexpr int kQ = 128;
constexpr int kCg = 8;          // channels per FIR work item
constexpr int kLanes = 2 * kCg; // re + im lanes per FIR work item
constexpr int kGroups = 16;     // thread groups of each FIR half
constexpr int kMaxSmem = 232448;
constexpr int kMaxBlocksPerSm = 32;  // Hopper's resident blocks per SM
constexpr int kNbTailRows = 16; // carried spike-flag rows
constexpr int kNbHalo = kNbTailRows - 1;  // flag rows of context before a unit
constexpr float kI16Scale = 1.0f / 32768.0f;  // int16 full scale -> 1.0

// The entry plane's element as float32: int16 is dequantized on load (the
// product by 2^-15 is exact).
__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return x[i];
}
__device__ __forceinline__ float load_x(const int16_t* x, size_t i) {
  return (float)x[i] * kI16Scale;
}


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
// it rounds exactly as the plain version's separate float32 ops do.  The
// K1 probes split at their own sub-block (sub).
__device__ __forceinline__ float coarse_phase(int t, float ph, float fh,
                                              float fl, int sub = kSub) {
  const float k0 = (float)((t / sub) * sub);
  const float qq = (float)(((t % sub) / kQ) * kQ);
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

// mix with its contraction written out: the FMAs the card compiled for the
// separate history pass (front_tail) that K1's carried history keeps, so
// that the history rounds the same wherever it is inlined.
__device__ __forceinline__ void mix_history(float zr, float zi, float cr,
                                            float ci, float fr, float fi,
                                            float* ur, float* ui) {
  const float a = __fmaf_rn(cr, fr, -__fmul_rn(ci, fi));
  const float b = __fmaf_rn(cr, fi, __fmul_rn(ci, fr));
  *ur = __fmaf_rn(a, zr, __fmul_rn(b, zi));
  *ui = __fmaf_rn(a, zi, -__fmul_rn(b, zr));
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

// The spike flags of row t, channel c, straight from the plane (the rows
// above an item's prologue).
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

// front_means' ring: one block per SM with two 32 KB stages (on the H100
// that read the AM cells' planes faster than deeper rings, 16 KB stages or
// more blocks per SM; PERF.md section 6).
constexpr int kMeansThreads = 256;
constexpr int kMeansBlocksPerSm = 1;
constexpr int kMeansStageBytes = 32768;  // largest stage of whole rows...
constexpr int kMeansRingBytes = 65536;   // ... and ring, unless a row forces
constexpr int kMeansMaxStages = 8;       // more (at least 2 stages)
constexpr int kMeansRingOff = 128;       // the barriers sit below the ring

// front_means' shared-memory plan for a plane of c2 lanes of elem bytes:
// stages of `rows` rows (a power of two dividing 512, at least 16 bytes of
// each lane, so a stage is a multiple of 16 bytes), `stages` of them, read
// w lanes at a time (one 16-byte load, w = 16 / elem, when c2 % w == 0;
// else one lane), and one accumulator per lane of each (lane group, row
// slice) pair: thread tid owns the pairs p = tid, tid + kMeansThreads, ...,
// lane group p mod groups (groups = c2 / w), row slice p / groups, with
// `slices` = kMeansThreads / groups row slices when there are fewer groups
// than threads.  ok() is false when two stages do not fit.
struct MeansGeom {
  int rows, stages, stage_bytes, w, groups, slices, acc_off, smem;
  __host__ __device__ MeansGeom(int c2, int elem) {
    const int row = c2 * elem;
    rows = kDcChunk;
    while (rows * elem > (int)bulk::kBulkAlign
           && rows * row > kMeansStageBytes)
      rows /= 2;
    stage_bytes = rows * row;
    stages = kMeansRingBytes / stage_bytes;
    stages = stages < 2 ? 2 : stages > kMeansMaxStages ? kMeansMaxStages
                                                       : stages;
    w = c2 % (16 / elem) ? 1 : 16 / elem;
    groups = c2 / w;
    slices = groups < kMeansThreads ? kMeansThreads / groups : 1;
    acc_off = kMeansRingOff + stages * stage_bytes;
    smem = acc_off + c2 * slices * 4;
  }
  __host__ __device__ bool ok() const {
    return smem <= kMaxSmem && stage_bytes <= (int)bulk::kMaxTxBytes;
  }
};

template <typename Tx> struct MeansAcc { using type = float; };
template <> struct MeansAcc<int16_t> { using type = int; };

// a[0..W) += the W lanes at p (W > 1: one 16-byte shared-memory load)
template <int W>
__device__ __forceinline__ void add_lanes(const float* p, float* a) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
  } else {
    a[0] += *p;
  }
}
template <int W>
__device__ __forceinline__ void add_lanes(const int16_t* p, int* a) {
  if constexpr (W == 8) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] += (short)(u[i] & 0xffff);
      a[2 * i + 1] += u[i] >> 16;
    }
  } else {
    a[0] += *p;
  }
}

__device__ __forceinline__ float chunk_mean(float sum) {
  return sum * (1.0f / kDcChunk);
}
// int16: the int32 sum is exact and so is its scaling by 2^-15 / 512
__device__ __forceinline__ float chunk_mean(int sum) {
  return (float)sum * (kI16Scale / kDcChunk);
}

// grid min(nchunk, resident blocks), block kMeansThreads, g.smem bytes of
// dynamic shared memory, W = g.w.  Block b walks chunks b, b + gridDim.x,
// ...; its i-th stage is rows [512 k + R s, 512 k + R (s + 1)) of its
// (i / spc)-th chunk k, s = i % spc, spc = 512 / R stages per chunk.
// Thread 0 keeps g.stages stages in flight; each stage is summed per pair
// (W lanes, row slice) in registers and added to the pair's accumulators,
// its rows that lie in their block's last r_rows rows are written to raw,
// and after a chunk's last stage the slices of each lane are added and
// its mean written.
template <typename Tx, int W>
__global__ void __launch_bounds__(kMeansThreads)
front_means(const Tx* __restrict__ x, int nchunk, int c2, int n, int r_rows,
            MeansGeom g, float* __restrict__ means, float* __restrict__ raw) {
  using Acc = typename MeansAcc<Tx>::type;
  extern __shared__ __align__(128) unsigned char means_smem[];
  const bulk::Ring ring{reinterpret_cast<uint64_t*>(means_smem),
                        means_smem + kMeansRingOff, (uint32_t)g.stage_bytes,
                        g.stages};
  Acc* acc = reinterpret_cast<Acc*>(means_smem + g.acc_off);
  const int tid = threadIdx.x;
  const int spc = kDcChunk / g.rows;
  const int items =
      ((nchunk - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * spc;
  const size_t stage_elems = (size_t)g.rows * c2;
  auto src = [&](int i) {               // the block's i-th stage in the plane
    const size_t k = blockIdx.x + (size_t)(i / spc) * gridDim.x;
    return x + (k * spc + i % spc) * stage_elems;
  };
  if (tid == 0) {
    ring.init();
    for (int i = 0; i < g.stages && i < items; ++i)
      ring.issue(i, src(i), g.stage_bytes);
  }
  __syncthreads();
  const int pairs = g.groups * g.slices;
  for (int i = 0; i < items; ++i) {
    const int k = blockIdx.x + (i / spc) * gridDim.x, s = i % spc;
    const int t0 = k * kDcChunk + s * g.rows;     // the stage's first row
    ring.wait(i);
    const Tx* st = reinterpret_cast<const Tx*>(ring.stage(i));
    for (int p = tid; p < pairs; p += kMeansThreads) {
      const Tx* col = st + (p % g.groups) * W;
      Acc a[W] = {};
#pragma unroll 4
      for (int r = p / g.groups; r < g.rows; r += g.slices)
        add_lanes<W>(col + r * c2, a);
#pragma unroll
      for (int j = 0; j < W; ++j)
        acc[p * W + j] = s ? acc[p * W + j] + a[j] : a[j];
    }
    if (raw != nullptr) {         // the stage's rows in its block's raw tail
      const int b = t0 / n, r0 = b * n + n - r_rows;
      const int lo = max(t0, r0), hi = min(t0 + g.rows, b * n + n);
      if (lo < hi) {
        float* dst = raw + ((size_t)b * r_rows + (lo - r0)) * c2;
        const Tx* from = st + (size_t)(lo - t0) * c2;
        for (int e = tid; e < (hi - lo) * c2; e += kMeansThreads)
          dst[e] = load_x(from, e);
      }
    }
    if (s == spc - 1) {           // the chunk is summed: add its row slices
      __syncthreads();
      for (int l = tid; l < c2; l += kMeansThreads) {
        Acc v = 0;                // lane l of slice j is acc[j c2 + l]
        for (int j = 0; j < g.slices; ++j) v += acc[j * c2 + l];
        means[(size_t)k * c2 + l] = chunk_mean(v);
      }
    }
    __syncthreads();              // stage i and the accumulators are free
    if (tid == 0 && i + g.stages < items)
      ring.issue(i + g.stages, src(i + g.stages), g.stage_bytes);
  }
}

// front_means over a [T, c2] plane (T a multiple of 512, 16-byte aligned):
// means [T/512, c2]; with raw, the last r_rows rows of each n-row block
// (n a multiple of 512, r_rows <= n) into raw [T/n, r_rows, c2].
template <typename Tx>
cudaError_t launch_means(const Tx* x, int T, int c2, int n, int r_rows,
                         float* means, float* raw, int device,
                         cudaStream_t st) {
  const MeansGeom g(c2, (int)sizeof(Tx));
  if (!g.ok() || T <= 0 || T % kDcChunk || n <= 0 || n % kDcChunk || T % n
      || r_rows < 0 || r_rows > n
      || reinterpret_cast<uintptr_t>(x) % bulk::kBulkAlign)
    return cudaErrorInvalidValue;
  auto kernel = g.w > 1 ? front_means<Tx, 16 / sizeof(Tx)>
                        : front_means<Tx, 1>;
  int slots = 0;
  cudaError_t err = launch::resident_blocks(
      kernel, device, kMeansThreads, g.smem, kMeansBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  const int nchunk = T / kDcChunk;
  kernel<<<(unsigned)min(nchunk, slots), kMeansThreads, g.smem, st>>>(
      x, nchunk, c2, n, r_rows, g, means, r_rows ? raw : nullptr);
  return cudaGetLastError();
}

// front_dc_scan: the chunk EWMA m_k = a m_{k-1} + b mu_k of every lane, in
// place over the chunk means [nchunk, c2] (replaces the TPU kernel's
// sequential recurrence, pallas_kernels.py:193-203).  The association is
// fixed, since y reads the ulps of m: each lane's chunks are cut into 32
// segments of len = ceil(nchunk / 32); each segment's (r, p) = (its EWMA
// from 0, a^len) is taken serially, r = fma(a, r, b mu_k), p = p a; the 32
// seeds are chained serially from dc_in, m = fma(p, m, r); each segment is
// walked from its seed, m = fma(a, m, b mu_k) (ops/front.py
// dc_scan_emulate mirrors it in numpy).  Bound: bytes (the means read and
// written once, 0.6 us at am_64ch), but the chains are ~2 len dependent
// FMAs (< 1 us): what costs is waiting on each chain's operands.  So each
// thread (one segment of one lane) has its whole segment fetched before
// its chains start, every load in flight at once: a segment of up to
// kScanHeld chunks into registers (HELD >= len, unrolled; holding 128
// spilled), a longer one as part of the block's tile, landed by 16-byte
// cp.async (4-byte where the lanes are not 16-byte aligned) into shared
// memory [32 segments][len][kScanLanes] with kScanLanes floats between
// segments (a warp's 4 segments x 8 lanes then read 32 banks), which the
// chains read in batches of kScanBatch at fixed offsets (a tile that does
// not fit a block leaves the chains on device memory).  Blocks are
// kScanLanes lanes x 32 segments, so even 16 channels spread over several
// SMs.
constexpr int kScanSegs = 32;            // segments per lane
constexpr int kScanLanes = 8;            // lanes per block at most
constexpr int kScanHeld = 64;            // chunks a thread holds at most
constexpr int kScanBatch = 16;           // chunks a long chain reads at once
constexpr int kScanMaxStage = kMaxSmem - 8192;  // beside the static arrays

// The scan's launch: lanes per block (a power of two <= kScanLanes, no
// more than the plane needs), 32 threads (one per segment) per lane, the
// chunks a thread holds (the instantiation: the least of 8, 16, ...,
// kScanHeld covering len; 0 for a longer segment), the segment length,
// and for a longer segment the tile's shared memory (0 when it does not
// fit a block).
struct ScanGeom {
  int lanes, blocks, threads, held, len, smem;
  __host__ __device__ ScanGeom(int nchunk, int c2) {
    lanes = kScanLanes;
    while (lanes > 1 && lanes / 2 >= c2) lanes /= 2;
    blocks = (c2 + lanes - 1) / lanes;
    threads = kScanSegs * lanes;
    len = (nchunk + kScanSegs - 1) / kScanSegs;
    held = 8;
    while (held < len && held < kScanHeld) held *= 2;
    if (held < len) held = 0;
    const long long tile = (long long)kScanSegs * seg_stride() * 4;
    smem = held == 0 && tile <= kScanMaxStage ? (int)tile : 0;
  }
  // floats from one segment's tile to the next: len chunks and one more,
  // so that neighbouring segments' rows fall in other banks
  __host__ __device__ int seg_stride() const {
    return (len + 1) * kScanLanes;
  }
};

// grid g.blocks, block g.threads, g.smem bytes of dynamic shared memory.
// Thread t is segment t / lanes of lane t % lanes of the block's lanes;
// HELD = g.held.
template <int HELD>
__global__ void __launch_bounds__(kScanSegs * kScanLanes)
front_dc_scan(float* __restrict__ mseq, int nchunk, int c2, ScanGeom g,
              const float* __restrict__ dc_in, float* __restrict__ dc_out,
              float a, float b) {
  extern __shared__ __align__(16) float scan_tile[];  // [32][len + 1][8]
  __shared__ float seg_r[kScanSegs][kScanLanes + 1];
  __shared__ float seg_p[kScanSegs][kScanLanes + 1];
  __shared__ float seed[kScanSegs][kScanLanes + 1];
  const int tx = threadIdx.x % g.lanes, s = threadIdx.x / g.lanes;
  const int lane = blockIdx.x * g.lanes + tx;
  const bool in = lane < c2;
  const int k0 = min(s * g.len, nchunk), k1 = min(k0 + g.len, nchunk);
  const int n = in ? k1 - k0 : 0;                // the segment's chunks
  float* col = mseq + (size_t)k0 * c2 + lane;    // chunk k0 + j at j c2
  constexpr int kHeld = HELD > 0 ? HELD : 1;
  float v[kHeld];                  // the segment's means, all loads first
  // a longer segment: its means from src (the tile, or device memory) a
  // batch at a time, with f(j, mean) applied in order
  auto batches = [&](const float* src, int stride, auto f) {
    for (int j0 = 0; j0 < n; j0 += kScanBatch) {
      float x[kScanBatch];
#pragma unroll
      for (int i = 0; i < kScanBatch; ++i)
        x[i] = j0 + i < n ? src[(j0 + i) * stride] : 0.0f;
#pragma unroll
      for (int i = 0; i < kScanBatch; ++i)
        if (j0 + i < n) f(j0 + i, x[i]);
    }
  };
  const float* tile = scan_tile + s * g.seg_stride() + tx;
  if (HELD > 0) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      v[j] = j < n ? col[(size_t)j * c2] : 0.0f;
  } else if (g.smem) {
    // the block's tile: chunk k of lane l0 + q at [k / len][k % len][q];
    // a row is `pieces` copies, and thread t copies piece t % pieces of
    // rows t / pieces, + step, ... (its segment and row carried along)
    const int l0 = blockIdx.x * g.lanes, width = min(g.lanes, c2 - l0);
    const int per = c2 % 4 == 0 && width % 4 == 0 ? 4 : 1;   // lanes a copy
    const int pieces = width / per, step = g.threads / pieces;
    const int q = threadIdx.x % pieces * per;
    int k = threadIdx.x / pieces, sk = k / g.len, jk = k - sk * g.len;
    for (; k < nchunk && threadIdx.x < step * pieces; k += step) {
      __pipeline_memcpy_async(
          scan_tile + sk * g.seg_stride() + jk * kScanLanes + q,
          mseq + (size_t)k * c2 + l0 + q, per * sizeof(float));
      for (jk += step; jk >= g.len; jk -= g.len) ++sk;
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  float r = 0.0f, p = 1.0f;
  auto summary = [&](int, float mu) {
    r = __fmaf_rn(a, r, __fmul_rn(b, mu));
    p = __fmul_rn(p, a);
  };
  if (HELD > 0) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j < n) summary(j, v[j]);
  } else if (g.smem) {
    batches(tile, kScanLanes, summary);
  } else {
    batches(col, c2, summary);
  }
  seg_r[s][tx] = r;
  seg_p[s][tx] = p;
  __syncthreads();
  if (s == 0 && in) {              // the seeds: their loads first
    float m = dc_in[lane];
#pragma unroll
    for (int q = 0; q < kScanSegs; ++q) {
      seed[q][tx] = m;
      m = __fmaf_rn(seg_p[q][tx], m, seg_r[q][tx]);
    }
    dc_out[lane] = m;
  }
  __syncthreads();
  float m = seed[s][tx];
  auto walk = [&](int j, float mu) {
    m = __fmaf_rn(a, m, __fmul_rn(b, mu));
    col[(size_t)j * c2] = m;
  };
  if (HELD > 0) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j < n) walk(j, v[j]);
  } else if (g.smem) {
    batches(tile, kScanLanes, walk);
  } else {
    batches(col, c2, walk);
  }
}

// front_dc_scan over mseq [nchunk, c2] (in place) from dc_in [c2] into
// dc_out [c2].
cudaError_t launch_scan(float* mseq, int nchunk, int c2, const float* dc_in,
                        float* dc_out, float a, float b, int device,
                        cudaStream_t st) {
  if (nchunk <= 0 || c2 <= 0) return cudaErrorInvalidValue;
  const ScanGeom g(nchunk, c2);
  if (g.smem > 0) {
    // the stage may pass 48 KB once the kernel allows it (per device)
    static int allowed[64] = {};
    int& most = allowed[device & 63];
    if (g.smem > most) {
      const cudaError_t err = cudaFuncSetAttribute(
          front_dc_scan<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kScanMaxStage);
      if (err != cudaSuccess) return err;
      most = kScanMaxStage;
    }
  }
  switch (g.held) {
#define FRONT_SCAN_CASE(H)                                                   \
  case H:                                                                    \
    front_dc_scan<H><<<(unsigned)g.blocks, g.threads, g.smem, st>>>(         \
        mseq, nchunk, c2, g, dc_in, dc_out, a, b);                           \
    break;
    FRONT_SCAN_CASE(0)
    FRONT_SCAN_CASE(8)
    FRONT_SCAN_CASE(16)
    FRONT_SCAN_CASE(32)
    FRONT_SCAN_CASE(64)
#undef FRONT_SCAN_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// ---------------------------------------------------------------------------
// front_fir: the time-marching FIR pass (header comment, point 3).

constexpr int kPartM = 12;               // decimated outputs of one FIR part
constexpr int kMarchStageBytes = 49152;  // the raw stages' budget
constexpr int kMarchMaxStages = 8;
constexpr int kMarchBlocksPerSm = 1;     // resident march blocks per SM
constexpr int kMarchPersistent = 1;      // 0: one block per work item
constexpr int kMarchMaxBox = 256;        // rows of a tensor-map box at most
constexpr int kHalves = 2;               // a block is two sets of kGroups
constexpr int kThreads = kLanes * kGroups * kHalves;

// Channels per FIR work item: kCg where the block's layout fits, else
// kCgNarrow (the long composed responses, F (DP - 1) rows of history that
// 8 channels' ring of mixed rows cannot hold in 227 KB: factor 64 / 2007
// taps, factor 32 / 1159 taps).  A narrow item's 8 lanes make the block
// 64 thread groups of 8 lanes.
constexpr int kCgNarrow = 4;

// The FIR's map of a block's thread groups (2 cg lanes each: 32 at cg = 8,
// 64 at cg = 4): `busy` = min(F, busy_max) groups make one part of kPartM
// outputs, group b of a part summing branches b, b + busy_max, ... < F
// into one accumulator per output (at cg = 8 the order of the tiled pass
// before it, so that y keeps its bits), and parts = groups / busy parts
// make a step of km = kPartM parts outputs: no group idles at F = 8, 4, 2
// (cg = 8) or F = 64, 32 (cg = 4).  busy_max is 16 at cg = 8 (two
// branches a group at F = 32) and every group at cg = 4 (one branch a
// group at F = 64, so the step stays 12 outputs, 768 rows).
__host__ __device__ constexpr int march_groups(int cg) {
  return kThreads / (2 * cg);
}
__host__ __device__ constexpr int march_busy_max(int cg) {
  return cg == kCg ? kGroups : march_groups(cg);
}
__host__ __device__ inline int march_busy(int F, int cg = kCg) {
  return F < march_busy_max(cg) ? F : march_busy_max(cg);
}
__host__ __device__ inline int march_parts(int F, int cg = kCg) {
  return march_groups(cg) / march_busy(F, cg);
}

// Lanes of a stage row (the tensor-map box's width): the item's cg
// channels, or at cg = 4 in int16 the 8 channels of the 16 bytes a box
// must span (the item reads its 4; the neighbouring item the other 4).
__host__ __device__ constexpr int march_box_lanes(int cg, int elem) {
  return cg * elem >= 16 ? cg : 16 / elem;
}

// Taps per polyphase branch that front_fir is instantiated for (ops/front.py
// mirrors the list in FIR_BRANCH_TAPS); 0 when none covers ntaps taps at
// decimation F.
__host__ __device__ inline int march_branch_taps(int ntaps, int F) {
  if (F < 1) return 0;
  const int need = (ntaps + F - 1) / F;
  const int insts[] = {8, 16, 24, 32, 40};
  for (int inst : insts)
    if (need <= inst) return inst;
  return 0;
}

__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

// front_fir's geometry and shared-memory layout (bytes; ops/front.py
// mirrors it in fir_march_layout) for items of cg channels.  A step makes
// km = kPartM parts outputs from step_rows = km F new input rows.  Its raw
// rows land in one of `stages` stages, [2][step_rows][bw] elements (the re
// lanes of the block's channel group, then its im lanes; bw =
// march_box_lanes), as boxes of box_rows rows.  The mix pass writes them,
// mixed, into the ring: two planes (re, im) of [ring_rows][cg] float32,
// hist = F (DP - 1) rows of history then the fewest steps that keep the
// history's copy-down off its own source; the im plane sits 16 floats off
// the re plane's banks so that the two branch columns a warp reads never
// share a bank.  Then the oscillator's fine phasors, the item's phase
// parameters, the taps [F][DP], two sets (this unit's, the next step's) of
// the coarse phasors, DC (and blanker average) entries, the groups'
// partial sums [parts][busy][kPartM][2 cg] (red_bytes; in the stage the
// step has just mixed when it is that large, else a region of their own),
// and with the blanker the flag words (15 rows of context + one unit) and
// the dilated words of one unit.  A unit is the prologue (hist rows) or a
// step.
struct MarchGeom {
  int F, dp, cg, bw, busy, parts, km, elem, step_rows, box_rows, stage_bytes;
  int stages, hist, ring_rows, unit, nq, nk, table_bytes, red_bytes;
  int stage_off, ring_re, ring_im, fine, params, taps, tables, red, flags;
  int dil, smem;
  __host__ __device__ MarchGeom(int F_, int dp_, int elem_, bool nb,
                                int cg_ = kCg) {
    F = F_;
    dp = dp_;
    cg = cg_;
    bw = march_box_lanes(cg, elem_);
    busy = march_busy(F, cg);
    parts = march_parts(F, cg);
    elem = elem_;
    km = kPartM * parts;
    step_rows = km * F;
    int nbox = (step_rows + kMarchMaxBox - 1) / kMarchMaxBox;
    while (step_rows % nbox) ++nbox;
    box_rows = step_rows / nbox;
    stage_bytes = step_rows * 2 * bw * elem;
    stages = kMarchStageBytes / stage_bytes;
    stages = stages < 2 ? 2 : stages > kMarchMaxStages ? kMarchMaxStages
                                                       : stages;
    hist = F * (dp - 1);
    const int x = (hist + step_rows - 1) / step_rows;
    ring_rows = hist + (x < 1 ? 1 : x) * step_rows;
    unit = hist > step_rows ? hist : step_rows;
    nq = unit / kQ + 2;
    nk = unit / kDcChunk + 2;
    // one set of tables: coarse cos, sin [nq][cg]; DC [nk][2 cg]; average
    // [nk][2 cg] with the blanker
    table_bytes = align128(2 * nq * cg * 4) + align128(nk * 2 * cg * 4)
                  + (nb ? align128(nk * 2 * cg * 4) : 0);
    stage_off = 128;                          // the stage barriers below
    int o = stage_off + stages * stage_bytes;
    const int plane = align128(ring_rows * cg * 4);
    ring_re = o;
    ring_im = o + plane + 64;
    o = align128(ring_im + plane);
    fine = o;
    o += 2 * kQ * cg * 4;
    params = o;
    o += 128;                                 // phase0, f_hi, f_lo [3][cg]
    taps = o;
    o = align128(o + F * dp * 4);
    tables = o;
    o += 2 * table_bytes;
    red_bytes = parts * busy * kPartM * 2 * cg * 4;
    red = stage_bytes >= red_bytes ? -1 : o;  // -1: in the mixed stage
    if (red >= 0) o = align128(o + red_bytes);
    flags = o;
    if (nb) o = align128(o + (kNbHalo + unit) * 2);
    dil = o;
    if (nb) o = align128(o + unit * 2);
    smem = o;
  }
  __host__ __device__ int box_bytes() const { return box_rows * bw * elem; }
  __host__ __device__ bool ok() const {
    return dp > 0 && smem <= kMaxSmem
           && stage_bytes <= (int)bulk::kMaxTxBytes && box_bytes() % 128 == 0;
  }
};

// The channels per item front_fir takes for this response and plane: kCg
// where that layout fits, else kCgNarrow where it does, else 0 (refused).
inline int march_cg(int F, int dp, int elem, bool nb) {
  if (MarchGeom(F, dp, elem, nb, kCg).ok()) return kCg;
  if (MarchGeom(F, dp, elem, nb, kCgNarrow).ok()) return kCgNarrow;
  return 0;
}

// The work items: a channel group (cg channels) x a time segment of ms
// outputs (the last one shorter; a segment's last step stores only its
// own outputs), item i = segment i / groups, channel group i % groups, so
// the channel groups of one segment run side by side and each plane row is
// fetched once from DRAM.  ms is chosen for the fewest rows on the busiest
// of `slots` resident blocks, among the choices with at least two items
// per slot where the shape has them (ops/front.py mirrors this in
// fir_march_plan).
struct MarchPlan {
  int ms, nseg, items, grid;
};

inline MarchPlan march_plan(int T, int C, const MarchGeom& g, int slots) {
  const int M = T / g.F, groups = (C + g.cg - 1) / g.cg;
  const int max_seg = (M + g.km - 1) / g.km;
  const int n_lo = min(max((2 * slots + groups - 1) / groups, 1), max_seg);
  MarchPlan best{M, 1, groups, 0};
  long long best_cost = -1;
  for (int n = n_lo; n <= min(4 * n_lo, max_seg); ++n) {
    const int ms = (M + n - 1) / n;
    const int nseg = (M + ms - 1) / ms;
    const int items = groups * nseg;
    if (nseg < n_lo) continue;
    const long long waves = (items + slots - 1) / slots;
    const long long cost =
        waves * ((long long)(ms + g.km - 1) / g.km * g.step_rows
                 + g.hist + g.step_rows);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = MarchPlan{ms, nseg, items, 0};
    }
  }
  best.grid = kMarchPersistent ? min(best.items, slots) : best.items;
  return best;
}

// Everything front_fir takes besides the plane and its tensor map.
struct March {
  int T, C, d_rows, ntaps, F, ms, items;
  bool tma;                         // stage by tensor-map boxes (else
                                    // element by element)
  const float *mseq, *tail_in, *phase0, *fhi, *flo, *h;
  Iq iq;
  Nb nb;
  float* y;
  float *tail_out, *nb_tail_out;    // K1's carried history (header, 4)
};

// One set of a unit's tables: coarse phasors of its 128-row blocks from
// row block q_base, DC (and blanker average) entries of its chunks from
// chunk k_base.
struct MarchTables {
  float *coarse_c, *coarse_s, *dc, *avg;
  int q_base, k_base;
};

// One block's shared-memory regions and the item it works on.
struct MarchCtx {
  float *ring_re, *ring_im, *fine_c, *fine_s, *params, *h_s, *red;
  unsigned short *flags_s, *dil_s;
  unsigned char* tables;            // the two sets of tables
  int c0;
};

// Stage rows [t0, t0 + rows) of channels [c0, c0 + CG) element by element
// into dst ([2][rows][bw] with the item's lanes at c0 % bw, zeros outside
// the plane), for planes whose lanes a tensor map cannot box
// (march_tma_ok): float32 by asynchronous 4-byte copies, int16 by plain
// loads.  The caller commits and waits.
__device__ __forceinline__ void stage_elem(float* d, const float* s) {
  __pipeline_memcpy_async(d, s, sizeof(float));
}
__device__ __forceinline__ void stage_elem(int16_t* d, const int16_t* s) {
  *d = *s;
}

template <typename Tx, int CG>
__device__ void stage_elements(Tx* dst, const Tx* __restrict__ x, int T,
                               int C, int c0, int t0, int rows) {
  constexpr int bw = march_box_lanes(CG, (int)sizeof(Tx));
  const size_t c2 = 2 * (size_t)C;
  const int half = rows * CG, cb = CG == bw ? 0 : c0 % bw;
  for (int e = threadIdx.x; e < 2 * half; e += kThreads) {
    const int hf = e / half, k = e - hf * half, i = k / CG;
    const int c = c0 + k % CG, t = t0 + i;
    Tx* d = dst + (CG == bw ? e : (hf * rows + i) * bw + cb + k % CG);
    if (c < C && t >= 0 && t < T)
      stage_elem(d, x + (size_t)t * c2 + (hf ? (size_t)C : 0) + c);
    else
      *d = Tx(0);
  }
}

// Table set `set` (0 or 1) for rows from t_lo (inside the plane).
template <int CG>
__device__ __forceinline__ MarchTables table_set(const MarchCtx& m,
                                                 const MarchGeom& g, int set,
                                                 int t_lo) {
  float* t = reinterpret_cast<float*>(m.tables + set * g.table_bytes);
  MarchTables tb;
  tb.coarse_c = t;
  tb.coarse_s = t + g.nq * CG;
  tb.dc = t + align128(2 * g.nq * CG * 4) / 4;
  tb.avg = tb.dc + align128(g.nk * 2 * CG * 4) / 4;
  tb.q_base = t_lo / kQ;
  tb.k_base = t_lo / kDcChunk;
  return tb;
}

// Thread `tid`'s DC (and blanker average) entry of the tables for rows
// [t_lo, t_hi): entry tid = chunk tid / (2 CG), lane tid % (2 CG); false
// past them.
template <bool NB, int CG>
__device__ __forceinline__ bool table_entry(const March& a, int c0, int t_lo,
                                            int t_hi, int tid, float* dc,
                                            float* avg) {
  constexpr int lanes = 2 * CG;
  if (t_lo >= t_hi) return false;
  const int k0 = t_lo / kDcChunk;
  const int nk = (t_hi - 1) / kDcChunk - k0 + 1;
  if (tid >= nk * lanes) return false;
  const size_t c2 = 2 * (size_t)a.C;
  const int k = tid / lanes, l = tid - k * lanes;
  const int c = c0 + (l & (CG - 1));
  const size_t lane = (l < CG ? 0 : (size_t)a.C) + c;
  const bool in = c < a.C;
  *dc = in ? a.mseq[(size_t)(k0 + k) * c2 + lane] : 0.0f;
  if (NB) *avg = in ? nb_avg_entering(a.nb, k0 + k, c2, lane) : 0.0f;
  return true;
}

// The coarse phasors of the tables for rows [t_lo, t_hi), the entries
// i = i0, i0 + stride, ... (128-row block i / CG, channel i % CG), from the
// item's phase parameters in shared memory.
template <int CG>
__device__ __forceinline__ void table_coarse(const MarchCtx& m,
                                            const MarchTables& tb, int t_lo,
                                            int t_hi, int i0, int stride) {
  if (t_lo >= t_hi) return;
  const int nq = (t_hi - 1) / kQ - t_lo / kQ + 1;
  for (int i = i0; i < nq * CG; i += stride) {
    const int q = i / CG, cc = i % CG;
    float sn, cs;
    sincospif(2.0f * coarse_phase((tb.q_base + q) * kQ, m.params[cc],
                                  m.params[CG + cc], m.params[2 * CG + cc]),
              &sn, &cs);
    tb.coarse_c[i] = cs;
    tb.coarse_s[i] = sn;
  }
}

// Build the tables for rows [t_lo, t_hi) (all threads; the caller
// synchronizes before they are read).
template <bool NB, int CG>
__device__ void march_tables(const March& a, const MarchCtx& m,
                             const MarchTables& tb, int t_lo, int t_hi) {
  float dc, avg;
  for (int i = threadIdx.x;
       table_entry<NB, CG>(a, m.c0, t_lo, t_hi, i, &dc, &avg);
       i += kThreads) {
    tb.dc[i] = dc;
    if (NB) tb.avg[i] = avg;
  }
  table_coarse<CG>(m, tb, t_lo, t_hi, threadIdx.x, kThreads);
}

// Unit rows [t0, t0 + n) -> ring rows [dst, dst + n): DC removal, IQ
// balance and the mix, once per row, from the tables tb; rows before t = 0
// take the carried post-mix tail (already blanked), rows outside both and
// lanes of channels >= C are zero.  The raw rows come from a stage
// (stage != null: [2][n][8] of Tx) or, for the prologue, straight from the
// plane.  Thread tid mixes channel tid % CG of rows tid / CG, tid / CG +
// kThreads / CG, ...  With the blanker: each row's flag word is formed once
// (warp ballots), its dilated word once from the bw - 1 words before it
// (the flag ring carries the 15 words before the unit), and the flagged
// lanes are zeroed (NB1) or scaled (NB2); step rows also go to nb.mask.
// Ends with a barrier (the ring is written; the stage and the flag ring
// are free).
template <typename Tx, bool NB, int CG>
__device__ void march_mix(const March& a, MarchCtx& m, const MarchTables& tb,
                          const Tx* __restrict__ x, const Tx* stage, int t0,
                          int n, int dst, bool write_mask) {
  constexpr int rows = kThreads / CG;            // rows one pass mixes
  constexpr int bw = march_box_lanes(CG, (int)sizeof(Tx));
  const IqVals iq(a.iq);
  const int C = a.C, tid = threadIdx.x;
  const size_t c2 = 2 * (size_t)C;
  const int cc = tid & (CG - 1), c = m.c0 + cc;
  const int sl = (CG == bw ? 0 : m.c0 % bw) + cc;   // the lane in a stage row
  const bool in = c < C;
  auto raw = [&](int i, int t, float* xr, float* xi) {
    if (stage != nullptr) {
      *xr = load_x(stage, (size_t)i * bw + sl);
      *xi = load_x(stage, (size_t)(n + i) * bw + sl);
    } else {
      *xr = load_x(x, (size_t)t * c2 + c);
      *xi = load_x(x, (size_t)t * c2 + C + c);
    }
  };
  if (NB) {
    // the undilated flag word of every row: a warp holds 32 / CG rows x
    // CG channels, so one ballot per lane half gives 32 / CG rows' words
    for (int i0 = 0; i0 < n; i0 += rows) {        // uniform: ballots
      const int i = i0 + tid / CG, t = t0 + i;
      bool fr = false, fi = false;
      if (i < n && in) {
        if (t < 0) {
          nb_carried(a.nb, t, c, C, &fr, &fi);
        } else if (t < a.T) {
          float xr, xi, zr, zi;
          raw(i, t, &xr, &xi);
          const int k = (t / kDcChunk - tb.k_base) * 2 * CG + cc;
          nb_detect(xr, xi, tb.dc[k], tb.dc[k + CG], tb.avg[k],
                    tb.avg[k + CG], iq, a.nb.thr2, &zr, &zi, &fr, &fi);
        }
      }
      const unsigned br = __ballot_sync(0xffffffffu, fr);
      const unsigned bi = __ballot_sync(0xffffffffu, fi);
      if (i < n && cc == 0) {
        constexpr unsigned mask = (1u << CG) - 1u;
        const int sh = tid & (32 - CG);           // (lane / CG) * CG
        m.flags_s[kNbHalo + i] = (unsigned short)(((br >> sh) & mask)
                                                  | (((bi >> sh) & mask) << CG));
      }
    }
    __syncthreads();
    // the causal dilation, once per row
    for (int i = tid; i < n; i += kThreads) {
      unsigned w = 0;
      for (int s = 0; s < a.nb.bw; ++s) w |= m.flags_s[kNbHalo + i - s];
      m.dil_s[i] = (unsigned short)w;
    }
    __syncthreads();
    if (tid < kNbHalo)          // the next unit's context (n >= kNbHalo)
      m.flags_s[tid] = m.flags_s[n + tid];
  }
#pragma unroll 4
  for (int i = tid / CG; i < n; i += rows) {
    const int t = t0 + i;
    float vr = 0.0f, vi = 0.0f;
    if (in && t < 0) {
      if (t >= -a.d_rows) {
        const size_t r = (size_t)(a.d_rows + t) * c2;
        vr = a.tail_in[r + c];
        vi = a.tail_in[r + C + c];
      }
    } else if (in && t < a.T) {
      float zr, zi;
      raw(i, t, &zr, &zi);
      const int k = (t / kDcChunk - tb.k_base) * 2 * CG + cc;
      zr = zr - tb.dc[k];
      zi = zi - tb.dc[k + CG];
      iq.apply(&zr, &zi);
      const int q = (t / kQ - tb.q_base) * CG + cc, r = (t % kQ) * CG + cc;
      mix(zr, zi, tb.coarse_c[q], tb.coarse_s[q], m.fine_c[r], m.fine_s[r],
          &vr, &vi);
      if (NB) {
        const unsigned w = m.dil_s[i];
        const bool br = (w >> cc) & 1u, bi = (w >> (CG + cc)) & 1u;
        if (write_mask && a.nb.mask != nullptr) {
          // a row in two items' steps gets the same word from both
          a.nb.mask[(size_t)t * c2 + c] = br;
          a.nb.mask[(size_t)t * c2 + C + c] = bi;
        }
        if (a.nb.mode == 1) {
          if (br) vr = 0.0f;
          if (bi) vi = 0.0f;
        } else if (br || bi) {
          const float m2 = mag2(zr, zi);
          if (br) vr = __fmul_rn(vr, nb_scale(tb.avg[k], m2));
          if (bi) vi = __fmul_rn(vi, nb_scale(tb.avg[k + CG], m2));
        }
      }
    }
    m.ring_re[(dst + i) * CG + cc] = vr;
    m.ring_im[(dst + i) * CG + cc] = vi;
  }
  __syncthreads();
}

// K1's carried history (header comment, point 4), spread over front_fir's
// persistent grid: element e = (row i, channel c) of tail' [d_rows, C]
// (both lanes), then with the blanker of nb_tail' [16, C], for e =
// blockIdx.x kThreads + tid, stride gridDim.x kThreads; each with the
// arithmetic of the pass it replaced, front_tail: the row's own coarse
// and fine phasors, DC, IQ balance, mix and the blanker's dilation over
// nb_flags_at (rows >= 0 also to nb.mask, the values the steps write),
// the mix as mix_history.  Called before a block's first item (a call of a
// function of its own cost the march 8-10 us, PERF.md section 6).
template <typename Tx, bool NB>
__device__ __forceinline__ void march_history(const Tx* __restrict__ x,
                                              const March& a) {
  const IqVals iq(a.iq);
  const Nb& nb = a.nb;
  const int C = a.C, T = a.T, d_rows = a.d_rows;
  const size_t c2 = 2 * (size_t)C;
  const int n = (d_rows + (NB ? kNbTailRows : 0)) * C;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n;
       e += gridDim.x * kThreads) {
    const int i = e / C, c = e - i * C;
    if (NB && i >= d_rows) {                     // nb_tail' row
      const int j = i - d_rows;
      bool fr, fi;
      nb_flags_at(x, T - kNbTailRows + j, c, C, a.mseq, iq, nb, &fr, &fi);
      a.nb_tail_out[(size_t)j * c2 + c] = fr ? 1.0f : 0.0f;
      a.nb_tail_out[(size_t)j * c2 + C + c] = fi ? 1.0f : 0.0f;
      continue;
    }
    const int t = T - d_rows + i;
    float ur, ui;
    if (t >= 0) {
      const size_t xr = (size_t)t * c2;
      const int k = t / kDcChunk;
      const size_t mr = (size_t)k * c2;
      float cr, ci, fr, fi;
      sincospif(2.0f * coarse_phase(t, a.phase0[c], a.fhi[c], a.flo[c]),
                &ci, &cr);
      sincospif(2.0f * fine_phase(t % kQ, a.fhi[c], a.flo[c]), &fi, &fr);
      float zr = load_x(x, xr + c) - a.mseq[mr + c];
      float zi = load_x(x, xr + C + c) - a.mseq[mr + C + c];
      iq.apply(&zr, &zi);
      mix_history(zr, zi, cr, ci, fr, fi, &ur, &ui);
      if (NB) {
        bool br = false, bi = false;
        for (int s = 0; s < nb.bw; ++s) {
          bool f0, f1;
          nb_flags_at(x, t - s, c, C, a.mseq, iq, nb, &f0, &f1);
          br |= f0;
          bi |= f1;
        }
        if (nb.mask != nullptr) {
          nb.mask[xr + c] = br;
          nb.mask[xr + C + c] = bi;
        }
        if (nb.mode == 1) {
          if (br) ur = 0.0f;
          if (bi) ui = 0.0f;
        } else if (br || bi) {
          const float m2 = mag2(zr, zi);
          if (br)
            ur = __fmul_rn(ur, nb_scale(nb_avg_entering(nb, k, c2, c), m2));
          if (bi)
            ui = __fmul_rn(ui,
                           nb_scale(nb_avg_entering(nb, k, c2, C + c), m2));
        }
      }
    } else {
      const size_t tr = (size_t)(d_rows + t) * c2;
      ur = a.tail_in[tr + c];
      ui = a.tail_in[tr + C + c];
    }
    a.tail_out[(size_t)i * c2 + c] = ur;
    a.tail_out[(size_t)i * c2 + C + c] = ui;
  }
}

// grid plan.grid, block kThreads, g.smem bytes of dynamic shared memory.
// y[o] = sum_{j=0..D} h[j] u[F o - j], u[t < 0] = tail[d_rows + t]; DP
// taps per polyphase branch (h zero-padded to F DP taps); items of CG
// channels (march_cg).  Block b walks
// items b, b + gridDim.x, ...; for each it sets up the fine phasors and
// phase parameters of its channels (the taps once per block), mixes the
// prologue (the hist rows before the segment's first step, from the plane)
// into the ring's history, then marches in steps of km outputs.  Step j
// waits for its stage (thread 0 keeps `stages` steps of the block's stream
// of items in flight by tensor-map boxes, across item boundaries; with
// a.tma false the block stages each step element by element first), mixes
// its rows into the ring after the history, and runs the FIR over the
// ring's last hist + step_rows rows: each of the step's parts of kPartM
// outputs is made by `busy` groups, group b holding the taps of branches
// b, b + busy_max, ... in registers while their columns stream past
// (polyphase.cuh); the groups' partial sums meet in shared memory and each
// output adds them in group order.  The next step's DC (and average)
// entries are loaded before the FIR and its coarse phasors formed after
// it, into the other set of tables; the stage is refilled once the step's
// outputs are stored (the partial sums may sit in it).  When the next step
// would overrun the ring, the last hist rows are copied down to its front
// first.  Before its first item each block writes its share of K1's
// carried history (march_history).  NB: the noise blanker is on; a
// separate instantiation, so its passes cost the plain form nothing.
template <typename Tx, int DP, bool NB, int CG>
__global__ void __launch_bounds__(kThreads, 1)
front_fir(const __grid_constant__ CUtensorMap map, const Tx* __restrict__ x,
          March a) {
  extern __shared__ __align__(128) unsigned char fir_smem[];
  constexpr int L = 2 * CG;                      // lanes of an item
  const MarchGeom g(a.F, DP, (int)sizeof(Tx), NB, CG);
  const int tid = threadIdx.x, F = a.F, C = a.C;
  const size_t c2 = 2 * (size_t)C;
  const int groups = (C + CG - 1) / CG, M = a.T / F;
  uint64_t* full = reinterpret_cast<uint64_t*>(fir_smem);
  unsigned char* stages = fir_smem + g.stage_off;
  auto region = [&](int off) {
    return reinterpret_cast<float*>(fir_smem + off);
  };
  MarchCtx m;
  m.ring_re = region(g.ring_re);
  m.ring_im = region(g.ring_im);
  m.fine_c = region(g.fine);
  m.fine_s = m.fine_c + kQ * CG;
  m.params = region(g.params);
  m.h_s = region(g.taps);
  m.red = g.red < 0 ? nullptr : region(g.red);
  m.flags_s = reinterpret_cast<unsigned short*>(fir_smem + g.flags);
  m.dil_s = reinterpret_cast<unsigned short*>(fir_smem + g.dil);
  m.tables = fir_smem + g.tables;

  auto seg_start = [&](int item) { return (item / groups) * a.ms; };
  auto item_steps = [&](int item) {
    const int o_s = seg_start(item);
    return (min(o_s + a.ms, M) - o_s + g.km - 1) / g.km;
  };
  // the block's stream of steps, and (thread 0) the next one to issue
  int total = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x) total += item_steps(i);
  int p_item = blockIdx.x, p_step = 0;
  auto issue = [&](int s) {                      // stream entry s
    uint64_t* bar = full + s % g.stages;
    unsigned char* dst = stages + (size_t)(s % g.stages) * g.stage_bytes;
    const int c0 = (p_item % groups) * CG;
    const int cx = CG == g.bw ? c0 : c0 - c0 % g.bw;   // the box's first lane
    const int t0 = F * seg_start(p_item) - F + 1 + p_step * g.step_rows;
    const int half = g.step_rows * g.bw * (int)sizeof(Tx);
    bulk::mbar_arrive_expect_tx(bar, (uint32_t)g.stage_bytes);
    for (int r = 0; r < g.step_rows; r += g.box_rows) {
      const int off = r * g.bw * (int)sizeof(Tx);
      bulk::load_2d(dst + off, &map, cx, t0 + r, bar);
      bulk::load_2d(dst + half + off, &map, C + cx, t0 + r, bar);
    }
    if (++p_step == item_steps(p_item)) {
      p_item += gridDim.x;
      p_step = 0;
    }
  };
  if (a.tma && tid == 0) {
    for (int s = 0; s < g.stages; ++s) bulk::mbar_init(full + s, 1);
    bulk::fence_mbar_init();
    for (int s = 0; s < g.stages && s < total; ++s) issue(s);
  }
  march_history<Tx, NB>(x, a);        // K1's carried history
  // the taps, h_s[p DP + i] = h[F i + p] (read after the prologue's
  // barriers)
  for (int i = tid; i < F * g.dp; i += kThreads) {
    const int p = i / g.dp, k = i - p * g.dp, j = F * k + p;
    m.h_s[i] = j < a.ntaps ? a.h[j] : 0.0f;
  }

  // this thread's lane, FIR part and group within it (march_busy)
  const int lx = tid % L, part = tid / L / g.busy;
  const int gp = tid / L % g.busy;
  const float* plane = (lx < CG ? m.ring_re : m.ring_im) + (lx & (CG - 1));
  int s = 0;                                     // the block's stream entry
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    m.c0 = (item % groups) * CG;
    const int o_s = seg_start(item), o_e = min(o_s + a.ms, M);
    const int nsteps = item_steps(item);
    const int t_first = F * o_s - F + 1;         // step 0's first new row
    // the item's set-up: its channels' phase parameters and fine phasors,
    // and with the blanker the undilated flags of the bw - 1 rows above
    // the prologue
    if (tid < 3 * CG) {
      const int c = m.c0 + tid % CG;
      const float* src = tid < CG ? a.phase0 : tid < 2 * CG ? a.fhi : a.flo;
      m.params[tid] = c < C ? src[c] : 0.0f;
    }
    for (int i = tid; i < kQ * CG; i += kThreads) {
      const int r = i / CG, c = m.c0 + i % CG;
      float sn = 0.0f, cs = 1.0f;
      if (c < C) sincospif(2.0f * fine_phase(r, a.fhi[c], a.flo[c]), &sn, &cs);
      m.fine_c[i] = cs;
      m.fine_s[i] = sn;
    }
    if (NB && tid < a.nb.bw - 1) {
      const int t = t_first - g.hist - (a.nb.bw - 1) + tid;
      const IqVals iq(a.iq);
      unsigned w = 0;
      for (int cc = 0; cc < CG && m.c0 + cc < C; ++cc) {
        bool fr, fi;
        nb_flags_at(x, t, m.c0 + cc, C, a.mseq, iq, a.nb, &fr, &fi);
        w |= (fr ? 1u << cc : 0u) | (fi ? 1u << (CG + cc) : 0u);
      }
      m.flags_s[kNbHalo - (a.nb.bw - 1) + tid] = (unsigned short)w;
    }
    __syncthreads();                    // the phase parameters
    // the tables of the prologue (set 0) and of step 0 (set 1)
    const int t_h = t_first - g.hist;
    march_tables<NB, CG>(a, m, table_set<CG>(m, g, 0, max(t_h, 0)),
                         max(t_h, 0), min(t_first, a.T));
    march_tables<NB, CG>(a, m, table_set<CG>(m, g, 1, max(t_first, 0)),
                         max(t_first, 0), min(t_first + g.step_rows, a.T));
    __syncthreads();
    // the prologue: the history rows, from the plane, into ring rows
    // [0, hist)
    march_mix<Tx, NB, CG>(a, m, table_set<CG>(m, g, 0, max(t_h, 0)), x,
                          nullptr, t_h, g.hist, 0, false);
    int pos = g.hist;                            // ring row of new rows
    for (int j = 0; j < nsteps; ++j, ++s) {
      const int t0 = t_first + j * g.step_rows;
      if (pos + g.step_rows > g.ring_rows) {     // copy the history down
        const int n4 = g.hist * CG / 4, src = (pos - g.hist) * CG / 4;
        for (int e = tid; e < 2 * n4; e += kThreads) {
          float4* p4 = reinterpret_cast<float4*>(e < n4 ? m.ring_re
                                                        : m.ring_im);
          const int k = e < n4 ? e : e - n4;
          p4[k] = p4[src + k];
        }
        pos = g.hist;
        __syncthreads();
      }
      Tx* st = reinterpret_cast<Tx*>(stages
                                     + (size_t)(s % g.stages) * g.stage_bytes);
      if (a.tma) {
        bulk::mbar_wait(full + s % g.stages,
                        (uint32_t)(s / g.stages) & 1u);
      } else {
        stage_elements<Tx, CG>(st, x, a.T, C, m.c0, t0, g.step_rows);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      march_mix<Tx, NB, CG>(a, m, table_set<CG>(m, g, (j + 1) & 1,
                                                max(t0, 0)),
                            x, st, t0, g.step_rows, pos, true);

      // the next step's DC (and average) entries, in flight over the FIR
      const int n_lo = max(t0 + g.step_rows, 0);
      const int n_hi = min(t0 + 2 * g.step_rows, a.T);
      const bool more = j + 1 < nsteps;
      float pf_dc = 0.0f, pf_avg = 0.0f;
      const bool pf = more && table_entry<NB, CG>(a, m.c0, n_lo, n_hi, tid,
                                                  &pf_dc, &pf_avg);

      // the FIR over ring rows [pos - hist, pos + step_rows): this group's
      // branches gp, gp + busy_max, ... for this part's outputs kPartM part ..
      // kPartM (part + 1) - 1, each output's taps in one accumulator
      float acc[kPartM];
#pragma unroll
      for (int ol = 0; ol < kPartM; ++ol) acc[ol] = 0.0f;
      if (part < g.parts) {
        const float* win = plane + (pos - g.hist + part * kPartM * F) * CG;
        for (int p = gp; p < F; p += march_busy_max(CG)) {
          float hr[DP];
#pragma unroll
          for (int i = 0; i < DP; ++i) hr[i] = m.h_s[p * DP + i];
          poly::fir_column<kPartM, DP>(win + (F - 1 - p) * CG, F * CG, hr,
                                       acc);
        }
      }
      if (more) {
        const MarchTables next = table_set<CG>(m, g, j & 1, n_lo);
        if (pf) {
          next.dc[tid] = pf_dc;
          if (NB) next.avg[tid] = pf_avg;
        }
        table_coarse<CG>(m, next, n_lo, n_hi, kThreads - 1 - tid, kThreads);
      }
      // the partial sums [part][gp][ol][lane], in the mixed stage when it
      // holds them, then each output summed over its part's groups in order
      float* red = m.red != nullptr ? m.red : reinterpret_cast<float*>(st);
      if (part < g.parts) {
#pragma unroll
        for (int ol = 0; ol < kPartM; ++ol)
          red[((part * g.busy + gp) * kPartM + ol) * L + lx] = acc[ol];
      }
      __syncthreads();
      const int o0 = o_s + j * g.km;
      for (int e = tid; e < g.km * L; e += kThreads) {
        const int ol = e / L, l = e - ol * L;
        const int c = m.c0 + (l & (CG - 1)), o = o0 + ol;
        if (c < C && o < o_e) {
          const float* r = red + ((ol / kPartM) * g.busy * kPartM
                                  + ol % kPartM) * L + l;
          float sum = 0.0f;
          if constexpr (CG == kCg) {
            for (int b = 0; b < g.busy; ++b) sum += r[b * kPartM * L];
          } else {          // up to 64 groups: keep 8 loads in flight
#pragma unroll 8
            for (int b = 0; b < g.busy; ++b) sum += r[b * kPartM * L];
          }
          a.y[(size_t)o * c2 + (l < CG ? 0 : (size_t)C) + c] = sum;
        }
      }
      __syncthreads();                           // the stage is free
      if (a.tma && tid == 0 && s + g.stages < total) {
        bulk::fence_async_smem();
        issue(s + g.stages);
      }
      pos += g.step_rows;
    }
  }
}

// The FM discriminator of the decimated row (yr, yi) after the row (pr, pi):
// atan2(y conj(prev)) * gain.  The conj product uses round-to-nearest
// intrinsics, so no contraction changes a zero's sign.
__device__ __forceinline__ float disc_of(float yr, float yi, float pr,
                                         float pi, float gain) {
  const float im = __fsub_rn(__fmul_rn(yi, pr), __fmul_rn(yr, pi));
  const float re = __fadd_rn(__fmul_rn(yr, pr), __fmul_rn(yi, pi));
  return __fmul_rn(atan2f(im, re), gain);
}

// grid ceil(M*C/256), block 256, M = T/F decimated rows (the WFM form).  FM
// discriminator of the decimated composite into disc [M, C], the carried
// sample, and (ytail not null) the y-tail windows.
__global__ void front_disc(const float* __restrict__ y, int M, int C,
                           const float* __restrict__ disc_last, float gain,
                           int mb, int y_tail_rows, float* __restrict__ disc,
                           float* __restrict__ dlast,
                           float* __restrict__ ytail) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * C) return;
  const int o = idx / C, c = idx % C;
  const size_t c2 = 2 * (size_t)C;
  const float yr = y[o * c2 + c], yi = y[o * c2 + C + c];
  const float* prev = o ? y + (o - 1) * c2 : disc_last;
  disc[(size_t)o * C + c] = disc_of(yr, yi, prev[c], prev[C + c], gain);
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

// ---------------------------------------------------------------------------
// front_comp: the hq form's one pass over the y scratch (header comment,
// point 6).

constexpr int kCompCg = 32;          // channels per work item: a warp's lanes
constexpr int kCompWarps = 16;
constexpr int kCompThreads = 32 * kCompWarps;
constexpr int kCompStepOut = 64;     // half-rate outputs of one step
constexpr int kCompStepRows = 2 * kCompStepOut;   // y rows of one step
constexpr int kCompHist = 32;        // d rows kept before a step: the prologue
constexpr int kCompBoxRows = 32;     // rows of a tensor-map box
constexpr int kCompAlign = kCompBoxRows / 2;  // a segment's outputs divide
constexpr int kCompStageBytes = 65536;  // the stages' budget
constexpr int kCompMaxStages = 4;
constexpr int kCompRingSteps = 2;    // steps the d ring keeps after the history
constexpr int kCompBlocksPerSm = 2;  // resident front_comp blocks per SM
constexpr int kMaxCompTaps = 32;     // most composite-decimator taps
constexpr int kCompOuts = kCompStepOut / kCompWarps;  // a thread's outputs
static_assert(kMaxCompTaps <= kCompHist + 1
                  && kCompHist % kCompWarps == 0
                  && kCompStepRows % kCompWarps == 0
                  && kCompStepOut % kCompWarps == 0
                  && kCompHist % kCompBoxRows == 0
                  && kCompStepRows % kCompBoxRows == 0,
              "front_comp's units are whole boxes and whole warp shares");

// front_comp's shared-memory layout (bytes; ops/front.py mirrors it in
// comp_march_layout): the stages' barriers, `stages` stages of one unit
// ([2][stage_rows][32] float32: the group's re lanes, then its im lanes; a
// unit is the prologue, the kCompHist rows before a segment, or a step of
// kCompStepRows rows), the ring of d rows [ring_rows][32] (the history,
// then kCompRingSteps steps), the taps [32], and two rows of y [2][2][32]
// (the last row of the previous unit, by unit parity).
struct CompGeom {
  int hist, stage_rows, stage_bytes, stages, ring_rows, stage_off, ring;
  int taps, prev, smem;
  __host__ __device__ CompGeom() {
    hist = kCompHist;
    stage_rows = kCompStepRows > kCompHist ? kCompStepRows : kCompHist;
    stage_bytes = stage_rows * 2 * kCompCg * 4;
    stages = kCompStageBytes / stage_bytes;
    stages = stages < 2 ? 2 : stages > kCompMaxStages ? kCompMaxStages : stages;
    ring_rows = hist + kCompRingSteps * kCompStepRows;
    stage_off = 128;                        // the stage barriers below
    ring = stage_off + stages * stage_bytes;
    taps = ring + ring_rows * kCompCg * 4;
    prev = taps + kMaxCompTaps * 4;
    smem = align128(prev + 2 * 2 * kCompCg * 4);
  }
};

// The work items: a channel group (32 channels) x a segment of ms
// half-rate outputs (the last one shorter; a segment's last step forms and
// stores only its own rows), item i = segment i / groups, channel group
// i % groups.  ms is a multiple of kCompAlign (a segment starts on a box
// of y rows), chosen for the fewest rows on the busiest of `slots`
// resident blocks among the choices from about two items per slot where
// the shape has them (ops/front.py mirrors this in comp_march_plan).
struct CompPlan {
  int ms, nseg, items, grid;
};

inline CompPlan comp_plan(int M, int C, const CompGeom& g, int slots) {
  const int mh = M / 2, groups = (C + kCompCg - 1) / kCompCg;
  const int max_seg = (mh + kCompStepOut - 1) / kCompStepOut;
  const int n_lo = min(max((2 * slots + groups - 1) / groups, 1), max_seg);
  CompPlan best{mh, 1, groups, 0};
  long long best_cost = -1;
  for (int n = n_lo; n <= min(4 * n_lo, max_seg); ++n) {
    const int ms = ((mh + n - 1) / n + kCompAlign - 1) / kCompAlign
                   * kCompAlign;
    const int nseg = (mh + ms - 1) / ms;
    const int items = groups * nseg;
    const long long waves = (items + slots - 1) / slots;
    const long long cost =
        waves * ((long long)(ms + kCompStepOut - 1) / kCompStepOut
                     * kCompStepRows + g.hist);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = CompPlan{ms, nseg, items, 0};
    }
  }
  best.grid = min(best.items, slots);
  return best;
}

// Everything front_comp takes besides its tensor maps.
struct Comp {
  const float *y, *disc_last, *ct, *comp_hist;
  int M, C, tc, hr, mb, y_tail_rows, ms, items;
  float gain;
  bool tma;                         // stage by tensor-map boxes (else
                                    // element by element)
  bool tail_tma;                    // store the y-tails by tensor-map boxes
                                    // from the stages (else row by row):
                                    // windows of whole 32-row boxes
  float *disc, *dlast, *ytail, *hist_out;
};

// Stage rows [t0, t0 + rows) of channels [c0, c0 + 32) of y element by
// element into a stage (zeros outside the rows [0, t_end) and the channels),
// for planes whose lanes a tensor map cannot box.  The caller commits,
// waits and synchronizes.
__device__ void comp_stage_elements(float* dst, const Comp& a, int c0, int t0,
                                    int rows, int stage_rows, int t_end) {
  const size_t c2 = 2 * (size_t)a.C;
  for (int e = threadIdx.x; e < 2 * rows * kCompCg; e += kCompThreads) {
    const int hf = e / (rows * kCompCg), k = e - hf * rows * kCompCg;
    const int i = k / kCompCg, c = c0 + k % kCompCg, t = t0 + i;
    float* d = dst + (size_t)hf * stage_rows * kCompCg + k;
    if (c < a.C && t >= 0 && t < t_end)
      __pipeline_memcpy_async(d, a.y + (size_t)t * c2 + (hf ? a.C : 0) + c,
                              sizeof(float));
    else
      *d = 0.0f;
  }
}

// grid plan.grid, block kCompThreads, CompGeom().smem bytes of dynamic
// shared memory.  The hq composite decimation by 2 of the discriminator
// output d of the M decimated rows of y, disc[j] = sum_{i<tc} ct[i]
// d[2j - i] (in fmaf from the newest tap to the oldest), d[o] = atan2(y[o]
// conj(y[o-1])) * gain, d[t < 0] = comp_hist[hr + t], y[-1] = disc_last;
// and from the same pass comp_hist' (the last hr rows of d), dlast (the
// last row of y) and the y-tail windows (the last y_tail_rows rows of each
// mb-row block of y).  Block b walks items b, b + gridDim.x, ...; an
// item's units are its prologue (rows 2 j_s - 32 .. 2 j_s - 1 into ring
// rows [0, 32)) and its steps (step s: rows 2 (j_s + 64 s) + [0, 128)
// after the ring's history).  Thread 0 keeps `stages` units of the block's
// stream in flight as 32-lane x 32-row tensor-map boxes (boxes wholly
// before t = 0 or past the item's rows are not fetched); with a.tma false
// the block stages each unit element by element.  Warp w forms d of the
// unit's rows w n/16 .. (w + 1) n/16 - 1 (lane = channel), each row's
// previous row from the one before it in the stage, from the previous unit
// (prev rows in shared memory) or, for a prologue, from y; it writes dlast
// as it goes.  The y-tail rows of a step leave its stage as 32-row boxes
// of a 2D tensor map of the y-tails [K y_tail_rows, 2C] (thread 0, bulk
// stores): segments start on multiples of 32 rows, so with y_tail_rows %
// 32 == 0 every box lies wholly inside or outside its block's window
// (tail_tma); otherwise, or with a.tma false, they are written row by row
// as d is formed.  Then warp w
// makes outputs 4 w .. 4 w + 3 of the step, walking the ring rows they
// read once, newest first.  The ring is rewound (its last 32 rows copied
// to its front) when the next step would overrun it.  The item whose
// segment ends at M/2 writes comp_hist' from its ring.
__global__ void __launch_bounds__(kCompThreads, kCompBlocksPerSm)
front_comp(const __grid_constant__ CUtensorMap map,
           const __grid_constant__ CUtensorMap tail_map, Comp a) {
  extern __shared__ __align__(128) unsigned char comp_smem[];
  const CompGeom g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = a.C, M = a.M, mh = M / 2;
  const size_t c2 = 2 * (size_t)C;
  const int groups = (C + kCompCg - 1) / kCompCg;
  uint64_t* full = reinterpret_cast<uint64_t*>(comp_smem);
  float* ring = reinterpret_cast<float*>(comp_smem + g.ring);
  float* ct_s = reinterpret_cast<float*>(comp_smem + g.taps);
  float* prev_s = reinterpret_cast<float*>(comp_smem + g.prev);
  auto stage = [&](int u) {
    return reinterpret_cast<float*>(comp_smem + g.stage_off
                                    + (size_t)(u % g.stages) * g.stage_bytes);
  };
  auto seg_start = [&](int item) { return (item / groups) * a.ms; };
  auto seg_end = [&](int item) { return min(seg_start(item) + a.ms, mh); };
  auto item_steps = [&](int item) {
    return (seg_end(item) - seg_start(item) + kCompStepOut - 1) / kCompStepOut;
  };
  // unit `unit` of item: its first row and its rows
  auto unit_rows = [&](int item, int unit, int* t0) {
    const int r0 = 2 * seg_start(item);
    *t0 = unit ? r0 + (unit - 1) * kCompStepRows : r0 - g.hist;
    return unit ? kCompStepRows : g.hist;
  };
  // the block's stream of units, and (thread 0) the next one to issue
  int total = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x)
    total += 1 + item_steps(i);
  int p_item = blockIdx.x, p_unit = 0;
  auto issue = [&](int u) {                      // stream entry u
    uint64_t* bar = full + u % g.stages;
    unsigned char* dst = reinterpret_cast<unsigned char*>(stage(u));
    int t0;
    const int rows = unit_rows(p_item, p_unit, &t0);
    const int t_end = 2 * seg_end(p_item);
    const int c0 = (p_item % groups) * kCompCg;
    const int half = g.stage_rows * kCompCg * 4;
    auto wanted = [&](int r) {
      return t0 + r + kCompBoxRows > 0 && t0 + r < t_end;
    };
    uint32_t bytes = 0;
    for (int r = 0; r < rows; r += kCompBoxRows)
      if (wanted(r)) bytes += 2 * kCompBoxRows * kCompCg * 4;
    bulk::mbar_arrive_expect_tx(bar, bytes);
    for (int r = 0; r < rows; r += kCompBoxRows)
      if (wanted(r)) {
        const int off = r * kCompCg * 4;
        bulk::load_2d(dst + off, &map, c0, t0 + r, bar);
        bulk::load_2d(dst + half + off, &map, C + c0, t0 + r, bar);
      }
    if (++p_unit == 1 + item_steps(p_item)) {
      p_item += gridDim.x;
      p_unit = 0;
    }
  };
  if (a.tma && tid == 0) {
    for (int s = 0; s < g.stages; ++s) bulk::mbar_init(full + s, 1);
    bulk::fence_mbar_init();
    for (int u = 0; u < g.stages && u < total; ++u) issue(u);
  }
  if (tid < kMaxCompTaps) ct_s[tid] = tid < a.tc ? a.ct[tid] : 0.0f;
  __syncthreads();
  float ct[kMaxCompTaps];
#pragma unroll
  for (int i = 0; i < kMaxCompTaps; ++i) ct[i] = ct_s[i];

  int u = 0;                                     // the block's stream entry
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int c0 = (item % groups) * kCompCg, c = c0 + lane;
    const bool in = c < C;
    const int j_s = seg_start(item), j_e = seg_end(item);
    const int t_lo = 2 * j_s, t_end = 2 * j_e;   // the item's own rows
    const int nsteps = item_steps(item);
    const float dl_r = in ? a.disc_last[c] : 0.0f;
    const float dl_i = in ? a.disc_last[C + c] : 0.0f;
    // wait for unit u's rows (from t0) in its stage
    auto land = [&](int unit) {
      if (a.tma) {
        bulk::mbar_wait(full + u % g.stages, (uint32_t)(u / g.stages) & 1u);
      } else {
        int t0;
        const int rows = unit_rows(item, unit, &t0);
        comp_stage_elements(stage(u), a, c0, t0, rows, g.stage_rows, t_end);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
    };
    // the stage of unit u is free (its y-tail stores have read it):
    // refill it with unit u + stages
    auto refill = [&]() {
      if (a.tma && tid == 0 && u + g.stages < total) {
        if (a.tail_tma) bulk::store_wait_read<0>();
        bulk::fence_async_smem();
        issue(u + g.stages);
      }
    };
    // thread 0: the y-tail rows among step rows [t0, t0 + 128) that landed,
    // box by box from the stage: a box of block b (mb rows) in its window
    // lies at window row w = its first row's offset - (mb - y_tail_rows),
    // row b y_tail_rows + w of the y-tails
    auto store_tails = [&](int t0) {
      const unsigned char* st = reinterpret_cast<const unsigned char*>(
          stage(u));
      const int half = g.stage_rows * kCompCg * 4;
      bulk::fence_async_smem();
      for (int r = 0; r < kCompStepRows && t0 + r < t_end;
           r += kCompBoxRows) {
        const int t = t0 + r, b = t / a.mb;
        const int w = t - b * a.mb - (a.mb - a.y_tail_rows);
        if (w >= 0) {
          const unsigned char* src = st + r * kCompCg * 4;
          bulk::store_2d(&tail_map, c0, b * a.y_tail_rows + w, src);
          bulk::store_2d(&tail_map, C + c0, b * a.y_tail_rows + w,
                         src + half);
        }
      }
      bulk::store_commit();
    };
    // d of unit u's rows [t0, t0 + n) into ring rows [dst, dst + n), and
    // dlast (and without tail_tma the y-tail rows) among the item's own
    // rows; this warp's rows are i0 .. i0 + n/16 - 1, each row's previous
    // row carried in registers, the unit's last row to prev_s
    auto form = [&](int t0, int n, int dst, bool prologue) {
      const float* sre = stage(u);
      const float* sim = sre + g.stage_rows * kCompCg;
      const int per = n / kCompWarps, i0 = warp * per, tp = t0 + i0 - 1;
      float pr = 0.0f, pi = 0.0f;                // y of the row before
      if (tp >= 0 && tp < t_end) {
        if (i0 > 0) {
          pr = sre[(i0 - 1) * kCompCg + lane];
          pi = sim[(i0 - 1) * kCompCg + lane];
        } else if (prologue) {
          pr = in ? a.y[(size_t)tp * c2 + c] : 0.0f;
          pi = in ? a.y[(size_t)tp * c2 + C + c] : 0.0f;
        } else {
          const float* pv = prev_s + ((u - 1) & 1) * 2 * kCompCg;
          pr = pv[lane];
          pi = pv[kCompCg + lane];
        }
      }
      // the row's block and offset in it (the y-tail rows are each block's
      // last y_tail_rows), carried from row to row
      int bw = 0, wo = 0;
      if (t0 + i0 > 0) {
        bw = (t0 + i0) / a.mb;
        wo = t0 + i0 - bw * a.mb;
      }
      for (int q = 0; q < per; ++q) {
        const int i = i0 + q, t = t0 + i;
        const float yr = sre[i * kCompCg + lane];
        const float yi = sim[i * kCompCg + lane];
        float d = disc_of(yr, yi, t ? pr : dl_r, t ? pi : dl_i, a.gain);
        if (t < 0)
          d = in && t >= -a.hr ? a.comp_hist[(size_t)(a.hr + t) * C + c]
                               : 0.0f;
        else if (t >= t_end)
          d = 0.0f;
        if (in && t >= t_lo && t < t_end) {
          const int w = wo - (a.mb - a.y_tail_rows);
          if (!a.tail_tma && a.ytail != nullptr && w >= 0) {
            float* yt = a.ytail + ((size_t)bw * a.y_tail_rows + w) * c2;
            yt[c] = yr;
            yt[C + c] = yi;
          }
          if (t == M - 1) {
            a.dlast[c] = yr;
            a.dlast[C + c] = yi;
          }
        }
        if (t >= 0 && ++wo == a.mb) {
          wo = 0;
          ++bw;
        }
        ring[(dst + i) * kCompCg + lane] = d;
        pr = yr;
        pi = yi;
      }
      if (warp == kCompWarps - 1) {
        float* pv = prev_s + (u & 1) * 2 * kCompCg;
        pv[lane] = pr;
        pv[kCompCg + lane] = pi;
      }
    };

    __syncthreads();             // the last item is done with the ring
    land(0);                     // the prologue
    form(t_lo - g.hist, g.hist, 0, true);
    __syncthreads();
    refill();
    ++u;
    int pos = g.hist;                            // ring row of row 2 j0
    for (int s = 0; s < nsteps; ++s, ++u) {
      if (pos + kCompStepRows > g.ring_rows) {   // rewind: history down
        __syncthreads();
        const int n4 = g.hist * kCompCg / 4, src = (pos - g.hist) * kCompCg / 4;
        float4* r4 = reinterpret_cast<float4*>(ring);
        for (int e = tid; e < n4; e += kCompThreads) r4[e] = r4[src + e];
        pos = g.hist;
        __syncthreads();
      }
      const int t0 = t_lo + s * kCompStepRows;
      land(1 + s);
      if (a.tail_tma && tid == 0) store_tails(t0);
      form(t0, kCompStepRows, pos, false);
      __syncthreads();
      refill();
      if (s + 1 == nsteps && j_e == mh && a.hist_out != nullptr) {
        // comp_hist': d rows M - hr .. M - 1, at ring rows from r0
        const int r0 = pos + M - a.hr - t0;
        for (int e = tid; e < a.hr * kCompCg; e += kCompThreads) {
          const int i = e / kCompCg, l = e % kCompCg;
          if (c0 + l < C)
            a.hist_out[(size_t)i * C + c0 + l] = ring[(r0 + i) * kCompCg + l];
        }
      }
      // the FIR: outputs j0 + 4 warp + o; output j reads ring rows of d[2j
      // - i], i < tc, which lie at col[(2 o - i) 32]; each row is read once
      // (r = 2 o - i from the newest down), so each output's sum still runs
      // from the newest tap to the oldest
      const int j0 = j_s + s * kCompStepOut + warp * kCompOuts;
      const float* col = ring + (pos + 2 * warp * kCompOuts) * kCompCg + lane;
      float acc[kCompOuts];
#pragma unroll
      for (int o = 0; o < kCompOuts; ++o) acc[o] = 0.0f;
#pragma unroll
      for (int r = 2 * (kCompOuts - 1); r > -kMaxCompTaps; --r) {
        const float v = col[r * kCompCg];
#pragma unroll
        for (int o = 0; o < kCompOuts; ++o) {
          const int i = 2 * o - r;
          if (i >= 0 && i < kMaxCompTaps && i < a.tc)
            acc[o] = fmaf(ct[i], v, acc[o]);
        }
      }
      if (in) {
#pragma unroll
        for (int o = 0; o < kCompOuts; ++o)
          if (j0 + o < j_e) a.disc[(size_t)(j0 + o) * C + c] = acc[o];
      }
      pos += kCompStepRows;
    }
  }
  if (a.tail_tma && tid == 0) bulk::store_wait_read<0>();
}

// A tensor map can box a channel group's lanes of a [T, 2C] plane of
// elem-byte lanes: each box must start on a 16-byte boundary, so the im
// lanes' first byte C elem must (and then the row pitch 2C elem is a
// multiple of 16 bytes too): float32 C % 4 == 0, int16 C % 8 == 0.
inline bool march_tma_ok(int C, int elem) { return (C * elem) % 16 == 0; }

template <typename Tx, int DP, bool NB, int CG>
cudaError_t launch_march(const Tx* x, const March& args, const MarchGeom& g,
                         int device, cudaStream_t st) {
  auto kernel = front_fir<Tx, DP, NB, CG>;
  int slots = 0;
  cudaError_t err = launch::resident_blocks(
      kernel, device, kThreads, g.smem, kMarchBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  const MarchPlan p = march_plan(args.T, args.C, g, slots);
  March a = args;
  a.ms = p.ms;
  a.items = p.items;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma && (err = launch::plane_map(x, 2 * a.C, a.T, (int)sizeof(Tx), g.bw,
                                      g.box_rows, &map)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)p.grid, kThreads, g.smem, st>>>(map, x, a);
  return cudaGetLastError();
}

// front_comp over the M decimated rows of y (its work plan for the
// device's resident blocks; y's tensor map when c.tma).
cudaError_t launch_comp(const Comp& args, int device, cudaStream_t st) {
  const CompGeom g;
  int slots = 0;
  cudaError_t err = launch::resident_blocks(
      front_comp, device, kCompThreads, g.smem, kCompBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  const CompPlan p = comp_plan(args.M, args.C, g, slots);
  Comp a = args;
  a.ms = p.ms;
  a.items = p.items;
  CUtensorMap map, tail_map;
  memset(&map, 0, sizeof(map));
  memset(&tail_map, 0, sizeof(tail_map));
  if (a.tma && (err = launch::plane_map(a.y, 2 * a.C, a.M, 4, kCompCg,
                                      kCompBoxRows, &map)) != cudaSuccess)
    return err;
  if (a.tail_tma
      && (err = launch::plane_map(a.ytail, 2 * a.C,
                                  a.M / a.mb * a.y_tail_rows, 4, kCompCg,
                                  kCompBoxRows, &tail_map)) != cudaSuccess)
    return err;
  front_comp<<<(unsigned)p.grid, kCompThreads, g.smem, st>>>(map, tail_map,
                                                            a);
  return cudaGetLastError();
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
  bool fir_tma;                        // front_fir stages by tensor map
  int device;
  cudaStream_t st;
};

template <typename Tx>
int forward(const Tx* x, const Fwd& f) {
  cudaError_t err;
  const int c2 = 2 * f.C;
  const int nchunk = f.T / kDcChunk;

  if ((err = launch_means(x, f.T, c2, f.n, f.r_rows, f.mseq, f.raw, f.device,
                          f.st)) != cudaSuccess
      || (err = launch_scan(f.mseq, nchunk, c2, f.dc_in, f.dc_out, f.a, f.b,
                            f.device, f.st)) != cudaSuccess)
    return err;
  if (f.nb.mode) {
    front_nb_means<Tx><<<dim3((unsigned)nchunk, (unsigned)((f.C + 31) / 32)),
                         dim3(32, 8), 0, f.st>>>(x, f.C, f.mseq, f.iq,
                                                 const_cast<float*>(f.nb.seq));
    if ((err = cudaGetLastError()) != cudaSuccess
        || (err = launch_scan(const_cast<float*>(f.nb.seq), nchunk, c2,
                              f.nb.avg_in, f.nb_avg_out, f.nb_a, f.nb_b,
                              f.device, f.st)) != cudaSuccess)
      return err;
  }

  const int dp = march_branch_taps(f.ntaps, f.F);
  const int cg = march_cg(f.F, dp, (int)sizeof(Tx), f.nb.mode != 0);
  if (!cg || (f.fir_tma && !march_tma_ok(f.C, (int)sizeof(Tx))))
    return cudaErrorInvalidValue;
  const MarchGeom g(f.F, dp, (int)sizeof(Tx), f.nb.mode != 0, cg);
  March a;
  a.T = f.T; a.C = f.C; a.d_rows = f.d_rows; a.ntaps = f.ntaps; a.F = f.F;
  a.ms = a.items = 0;
  a.tma = f.fir_tma;
  a.mseq = f.mseq; a.tail_in = f.tail_in; a.phase0 = f.phase0;
  a.fhi = f.fhi; a.flo = f.flo; a.h = f.h;
  a.iq = f.iq; a.nb = f.nb; a.y = f.y;
  a.tail_out = f.tail_out; a.nb_tail_out = f.nb_tail_out;
  switch (dp) {
#define FRONT_FIR_CASE(DP)                                                   \
  case DP:                                                                   \
    if (cg == kCg)                                                           \
      err = f.nb.mode                                                        \
                ? launch_march<Tx, DP, true, kCg>(x, a, g, f.device, f.st)   \
                : launch_march<Tx, DP, false, kCg>(x, a, g, f.device, f.st); \
    else                                                                     \
      err = f.nb.mode ? launch_march<Tx, DP, true, kCgNarrow>(               \
                            x, a, g, f.device, f.st)                         \
                      : launch_march<Tx, DP, false, kCgNarrow>(              \
                            x, a, g, f.device, f.st);                        \
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

  if (f.disc_gain == 0.0f) return cudaSuccess;

  const int M = f.T / f.F;
  if (f.comp_taps == nullptr) {
    front_disc<<<(unsigned)(((size_t)M * f.C + 255) / 256), 256, 0, f.st>>>(
        f.y, M, f.C, f.disc_last, f.disc_gain, f.n / f.F, f.y_tail_rows,
        f.disc, f.dlast, f.y_tail_rows > 0 ? f.ytail : nullptr);
    return cudaGetLastError();
  }
  Comp c;
  c.y = f.y; c.disc_last = f.disc_last; c.ct = f.comp_taps;
  c.comp_hist = f.comp_hist;
  c.M = M; c.C = f.C; c.tc = f.comp_tc; c.hr = f.comp_hr; c.mb = f.n / f.F;
  c.y_tail_rows = f.y_tail_rows; c.ms = c.items = 0;
  c.gain = f.disc_gain;
  c.tma = march_tma_ok(f.C, 4) && reinterpret_cast<uintptr_t>(f.y) % 16 == 0;
  c.disc = f.disc; c.dlast = f.dlast;
  c.ytail = f.y_tail_rows > 0 ? f.ytail : nullptr;
  c.tail_tma = c.tma && c.ytail != nullptr
               && c.y_tail_rows % kCompBoxRows == 0 && c.mb % kCompBoxRows == 0
               && reinterpret_cast<uintptr_t>(c.ytail) % 16 == 0;
  c.hist_out = f.comp_hist_out;
  return launch_comp(c, f.device, f.st);
}

// ---------------------------------------------------------------------------
// K1 probes: the kernels of the JAX package's K1 probe bench
// (tools/kbench2.py), driven by the port's probe bench
// (pebblesdr_tpu_torch/tools/kbench2.py).  Plain versions:
// ops/kprobe.py probe_floor_reference / probe_front_reference.
//
// probe_floor_copy replaces floor_kernel / floor_call (tools/kbench2.py:82,
// two planes) and main2's fk (:307, one packed plane): per sub-block of
// each plane, y = its first sub/F rows.  It is a floor only if every input
// byte reaches the SM, as the TPU's BlockSpec DMA loads the whole (sub, c)
// block: blocks walk the plane's 16 KB tiles, each landing in a ring stage
// in shared memory by one 1D bulk copy (bulk_ring.cuh), kFloorStages - 1
// tiles ahead; the kept rows that a tile holds are contiguous in the plane
// and in y (one range per sub-block the tile meets), so each leaves the
// stage as one bulk store.  One thread per block issues every copy.
// Bound: bytes (the plane read once, 1/F of it written).
//
// probe_toeplitz replaces the front variants make_v12 (v1, v2; :144),
// make_v3 (:386) and main4's make (v4, v5; :546): K1's base form computed as
// the TPU fed its MXU, y = W^T [tail; u] per sub-block, W the composed
// Toeplitz block [d_rows + sub, sub/F] (dense), or for v5 each of kt groups
// of outputs over only its own span of rows.  The TPU walks its sub-blocks
// in order and carries DC, the post-mix tail and the phase from one to the
// next; here the DC seeds come from K1's front_means + front_dc_scan (a
// prefix over the chunk means), rows before the dispatch from the carried
// tail, and every block rebuilds the mixed rows it needs.  The JAX kernel
// runs the product on the MXU as a three-pass split (_dot3, W split on the
// host into wth + wtl); its counterpart on Hopper is 3xTF32 on the tensor
// cores: W = Wh + Wl split once per plan on the host (kprobe.py), E = Eh +
// El split as it is staged (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
// hi)), Y += Wh Eh + Wh El + Wl Eh in float32 (the dropped Wl El is ~2^-22
// of a product; one TF32 pass keeps ~3 digits, the S-meter trap of
// BENCHMARKS.md:71-84).  A block makes one sub-block's 64 outputs (wgmma's
// M) x 64 channels, so at 64 channels each extended row is mixed once per
// sub-block (v1: once per plane's product); x lands by 2D tensor-map boxes
// and W's tiles by bulk copies on a ring of stages, and the next chunk is
// mixed while the tensor cores multiply this one.  The switches (FORM):
//   v1: two planes, two products (the K range is walked once per plane, so
//       W is read twice); v2: two planes, one product over [er | ei];
//   v3: one packed plane, mixed per channel; v4 (and v5): the packed plane
//       with the packed phasor tables A = [or | or], B = [oi | -oi],
//       y = z A + swap(z) B, and a phase per lane.
// Bound: bytes (kprobe.probe_bound counts the function's own work, K1's
// base form: the plane and W read once, y and the state written; 0.0418 ms
// per call at the bench's 8 x 32768 rows x 64 ch).  The product itself is
// 2 (d_rows + sub) TF32 operations per output lane and pass dense (2 span
// for v5), three passes, against the tensor cores' 495 TFLOP/s.  The last
// sub-block's blocks write tail' (the last d_rows mixed rows, float32, in
// the variant's layout) in the same launch.

constexpr int kFloorTile = 4096;     // floats per probe_floor_copy stage
constexpr int kFloorStages = 4;      // ring stages per block
constexpr int kFloorThreads = 32;    // one warp; its first thread works
constexpr int kFloorRingOff = 128;   // the barriers sit below the ring
constexpr int kFloorSmem = kFloorRingOff + kFloorStages * kFloorTile * 4;

// grid (blocks, planes), block kFloorThreads, kFloorSmem bytes of dynamic
// shared memory.  Plane blockIdx.y: x0 -> y0, x1 -> y1, each [T, lanes] ->
// [T/sub * m, lanes], lanes % 4 == 0 and the planes 16-byte aligned, so
// every row boundary is 16-byte aligned.  Block b walks the plane's tiles
// b, b + gridDim.x, ...: thread 0 lands each in a ring stage by one bulk
// load, sends the kept range of every sub-block the tile meets (elements
// [s sub lanes, (s sub + m) lanes) of the plane, [s m lanes, ...) of y)
// out of the stage by one bulk store, and refills the stage of the tile
// before once that tile's stores have read it.
__global__ void __launch_bounds__(kFloorThreads)
probe_floor_copy(const float* __restrict__ x0, const float* __restrict__ x1,
                 long long total, int lanes, int sub, int m,
                 float* __restrict__ y0, float* __restrict__ y1) {
  extern __shared__ __align__(128) unsigned char floor_smem[];
  if (threadIdx.x != 0) return;
  const float* x = blockIdx.y ? x1 : x0;
  float* y = blockIdx.y ? y1 : y0;
  const bulk::Ring ring{reinterpret_cast<uint64_t*>(floor_smem),
                        floor_smem + kFloorRingOff, kFloorTile * 4,
                        kFloorStages};
  const long long ntiles = (total + kFloorTile - 1) / kFloorTile;
  const int items = blockIdx.x < ntiles
      ? (int)((ntiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  auto first = [&](int i) {                       // item i's first element
    return (blockIdx.x + (long long)i * gridDim.x) * kFloorTile;
  };
  auto issue = [&](int i) {
    const long long e0 = first(i);
    ring.issue(i, x + e0, (uint32_t)(min((long long)kFloorTile, total - e0)
                                     * 4));
  };
  ring.init();
  for (int i = 0; i < kFloorStages && i < items; ++i) issue(i);
  const long long sub_e = (long long)sub * lanes;
  const long long keep_e = (long long)m * lanes;
  for (int i = 0; i < items; ++i) {
    const long long e0 = first(i), e1 = min(e0 + kFloorTile, total);
    ring.wait(i);
    const float* st = reinterpret_cast<const float*>(ring.stage(i));
    bulk::fence_async_smem();
    for (long long s = e0 / sub_e; s * sub_e < e1; ++s) {
      const long long lo = max(e0, s * sub_e);
      const long long hi = min(e1, s * sub_e + keep_e);
      if (lo < hi)
        bulk::store(y + s * keep_e + (lo - s * sub_e), st + (lo - e0),
                    (uint32_t)((hi - lo) * 4));
    }
    bulk::store_commit();
    if (i >= 1 && i - 1 + kFloorStages < items) {
      bulk::store_wait_read<1>();                 // tile i-1's stores are done
      issue(i - 1 + kFloorStages);
    }
  }
  bulk::store_wait_read<0>();
}

// probe_toeplitz: the tensor-core product (header comment of the probes).
constexpr int kPm = 64;            // outputs per block (wgmma's M)
constexpr int kPch = 64;           // channels per block
constexpr int kPkc = 32;           // extended rows per chunk (4 k8 steps)
constexpr int kPThreads = 512;     // four warpgroups
constexpr int kPBox = kPkc * kPch * 4;   // one x box / one W half, bytes
constexpr int kPStage = 4 * kPBox;       // a stage: x re, x im, W hi, W lo
constexpr int kPEBytes = 2 * kPkc * 2 * kPch * 4;   // an E buffer, hi + lo
constexpr bool kPWgmma = true;     // false: the dense forms on mma.sync

enum ProbeForm { kV1 = 1, kV2 = 2, kV3 = 3, kV4 = 4 };

struct Probe {
  const float *x0, *x1;   // v1/v2: the re and im planes [T, C]; else x0 [T, 2C]
  const float *m0, *m1;   // DC estimate per chunk: [T/512, C] each; else m0
                          // [T/512, 2C]
  const float* tail;      // v1/v2 [2 d_rows, C] (re rows, then im rows);
                          // else [d_rows, 2C]
  const float *phase, *fhi, *flo;  // [C]; v4 [2C] (a phase per lane)
  const float *f0, *f1, *f2, *f3;  // fine phasors: v1-v3 (cos, sin) [128, C];
                                   // v4 [fr|fr], [fi|fi], [fi|-fi], [fr|-fr]
  const float *wh, *wl;   // W^T split into TF32 hi + lo, each [m/64 tiles]
                          // [kpad/4][64 outputs][4 rows] (kprobe.py)
  int T, C, sub, F, d_rows, kt, kpad;
  float *y0, *y1;         // v1/v2 [T/F, C] each; else y0 [T/F, 2C]
  float* tail_out;        // tail' in the tail's layout
};

// probe_toeplitz's shared memory: the stages' x and W barriers; two
// stages of [x re box | x im box | W hi | W lo] (each kPkc rows: the boxes
// [kPkc][64 lanes], the W halves [kPkc/4][64][4]); two E buffers of [hi |
// lo], each [kPkc/4][kN lanes][4] (K-major core matrices of 8 lanes x 4
// rows, the layout the wgmma descriptors name); the coarse phasors (cos,
// sin) of the block's nq 128-row blocks x kent phase lanes.  Two stages:
// four lowered the copy floor but left the L1 too small for the fine
// tables, and the probes ran slower (tools/ring_sweep.py --probe, PERF.md
// section 6); a chunk's stage and E buffer are q & 1, its barriers'
// parity (q >> 1) & 1.
struct ProbeGeom {
  int nq, kent, e_off, cc_off, smem;
  __host__ __device__ ProbeGeom(int form, int d_rows, int sub) {
    kent = form == kV4 ? 2 * kPch : kPch;
    nq = (d_rows + sub) / kQ + 2;
    e_off = 128 + 2 * kPStage;
    cc_off = e_off + 2 * kPEBytes;
    smem = align128(cc_off + 2 * nq * kent * 4);
  }
  __host__ __device__ bool ok() const { return smem <= kMaxSmem; }
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero; the low 13 bits of the mantissa cleared), as a
// float, in two integer operations instead of a conversion.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// A wgmma shared-memory matrix descriptor for a K-major operand without
// swizzle: core matrices of 8 rows x 16 bytes (4 TF32 along K, rows 16
// bytes apart); lbo = bytes between the two core matrices along K of one
// k8 step, sbo = bytes between core matrices 8 rows apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving other uses of the accumulators across an
// asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for one k8 step: A [64 outputs x 8] and B [8 x N lanes] from
// shared memory (descriptors a, b), d in the warpgroup's accumulator
// layout (4 per n8 tile per thread); acc = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wg_mma(float* d, uint64_t a, uint64_t b,
                                       int acc);

template <>
__device__ __forceinline__ void wg_mma<64>(float* d, uint64_t a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_mma<16>(float* d, uint64_t a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_mma<32>(float* d, uint64_t a, uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B for one m16n8k8 tile: a the A fragment (rows g, g + 8 x columns
// t, t + 4 of the warp's 16 x 8 tile), b the B fragment (rows t, t + 4 x
// column g), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The coarse phasor (cos, sin) of phase lane `lane` for the 128-row block
// of row t, in the variant's split form (sub-block p.sub).
__device__ __forceinline__ void probe_coarse(const Probe& p, int t, int lane,
                                             float* cr, float* ci) {
  sincospif(2.0f * coarse_phase(t, p.phase[lane], p.fhi[lane], p.flo[lane],
                                p.sub), ci, cr);
}

// What mixing four rows t .. t + 3 (t % 4 == 0) of channel c needs from
// device memory, fetched ahead of the chunk's mixing (two chunks ahead for
// v1-v3, one for v4 and v5): the DC estimate of their chunk (re and im
// lanes) and their fine phasors (v1-v3: cos, sin; v4: the four packed
// tables at the re lane, then at the im lane), each row's loads coalesced
// over a warp's 32 channels.
template <int FORM>
struct ProbeIn {
  float m[2];
  float f[FORM == kV4 ? 8 : 2][4];
};

template <int FORM>
__device__ __forceinline__ void probe_fetch(const Probe& p, int t, int c,
                                            ProbeIn<FORM>* in) {
  const int k = t / kDcChunk, r = t % kQ;
  if constexpr (FORM <= kV2) {
    const size_t j = (size_t)k * p.C + c;
    in->m[0] = p.m0[j];
    in->m[1] = p.m1[j];
  } else {
    const size_t j = (size_t)k * 2 * p.C + c;
    in->m[0] = p.m0[j];
    in->m[1] = p.m0[j + p.C];
  }
  const float* tabs[4] = {p.f0, p.f1, p.f2, p.f3};
  const size_t lanes = FORM == kV4 ? 2 * (size_t)p.C : p.C;
#pragma unroll
  for (int i = 0; i < (FORM == kV4 ? 8 : 2); ++i) {
    const size_t lane = FORM == kV4 && i >= 4 ? (size_t)p.C + c : c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      in->f[i][j] = tabs[i % 4][(size_t)(r + j) * lanes + lane];
  }
}

// The mixed values (ur, ui) of row t + r (its raw input xr, xi) from the
// fetched DC and fine phasors and the coarse phasors of its re lane (cr,
// ci) and, for v4, of its im lane (cr2, ci2): v1-v3 the mix of K1, v4 per
// lane z A + swap(z) B with A = c fr1 - s fi1, B = c fi2 + s fr2.
template <int FORM>
__device__ __forceinline__ void probe_mix(const ProbeIn<FORM>& in, int r,
                                          float xr, float xi, float cr,
                                          float ci, float cr2, float ci2,
                                          float* ur, float* ui) {
  const float zr = xr - in.m[0], zi = xi - in.m[1];
  if constexpr (FORM != kV4) {
    mix(zr, zi, cr, ci, in.f[0][r], in.f[1][r], ur, ui);
  } else {
    *ur = zr * (cr * in.f[0][r] - ci * in.f[1][r])
          + zi * (cr * in.f[2][r] + ci * in.f[3][r]);
    *ui = zi * (cr2 * in.f[4][r] - ci2 * in.f[5][r])
          + zr * (cr2 * in.f[6][r] + ci2 * in.f[7][r]);
  }
}

// grid (ceil(C / 64), (T/F) / 64), block kPThreads, g.smem bytes of dynamic
// shared memory.  A block makes 64 outputs of one sub-block (og = 64
// blockIdx.y) x 64 channels: kN = 128 lanes [ur | ui] of one product (v2-v4)
// or, for v1, 64 lanes per product, one product per plane (two passes).
// Its K range [kb, ke) is the union of its output groups' spans (all of K
// when dense), walked in chunks of kPkc extended rows, the block's stream
// (both passes for v1): thread 0 keeps two stages in flight, each two 2D
// tensor-map boxes of x (64 lanes x kPkc rows; rows before t = 0 land as
// zeros) on one mbarrier and the chunk's W hi and lo tiles by bulk copies
// on another, x issued a step before W (a stage's x is free once mixed).
// Chunk q + 1 is mixed (DC, coarse and fine phasors; rows before t = 0
// from the carried tail) and split into TF32 hi + lo E tiles while the
// tensor cores multiply chunk q: Y_q = Wh Eh + Wh El + Wl Eh into a fresh
// float32 accumulator, then added to the running sum in IEEE float32
// (each accumulator chain is 12 k8 products long).  All 16 warps mix (one
// 4-row quad of one channel per thread and chunk).  Dense forms:
// warpgroup w makes lanes [w N, (w + 1) N), N = kN / 4, of all 64
// outputs by wgmma m64nNk8 (A and B from shared memory; every path waits
// for the products before it reads the accumulators, or the compiler
// serializes them: 0.152 -> 0.137 ms per launch at v3 once it did not);
// v5 (TILED): warp w makes outputs 16 (w % 4) .. + 15 x the lanes of
// warpgroup w / 4 by mma.sync m16n8k8, only over the k8 steps of its
// group's span.  The blocks that hold the dispatch's last sub-block and
// its last 64 outputs write tail' from the float32 mixed rows of its last
// d_rows extended rows (pass 0).
template <int FORM, bool TILED>
__global__ void __launch_bounds__(kPThreads, 1)
probe_toeplitz(const __grid_constant__ CUtensorMap map0,
               const __grid_constant__ CUtensorMap map1, Probe p,
               ProbeGeom g) {
  constexpr int kN = FORM == kV1 ? kPch : 2 * kPch;  // lanes of one product
  constexpr int kNw = kN / 4;         // lanes of a warpgroup (or warp)
  constexpr int kAcc = kNw / 2;       // accumulators per thread
  constexpr int kPasses = FORM == kV1 ? 2 : 1;
  constexpr int kEnt = FORM == kV4 ? 2 * kPch : kPch;
  constexpr bool kWg = !TILED && kPWgmma;
  extern __shared__ __align__(128) unsigned char pr_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(pr_smem);
  float* cc_s = reinterpret_cast<float*>(pr_smem + g.cc_off);
  float* cs_s = cc_s + g.nq * kEnt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m = p.sub / p.F, K = p.d_rows + p.sub, mt = m / p.kt;
  const int c0 = blockIdx.x * kPch;
  const int og = blockIdx.y * kPm;                // the block's first output
  const int s = og / m, ol0 = og - s * m;         // its sub-block, local row
  // a group's K span: all of K (dense), or d_rows + mt F rows rounded up to
  // 8 from the group's first input row (v5)
  const int span = p.kt == 1 ? K : (p.d_rows + mt * p.F + 7) / 8 * 8;
  const int g_lo = ol0 / mt, g_hi = (ol0 + kPm - 1) / mt;
  const int kb = g_lo * mt * p.F, ke = min(g_hi * mt * p.F + span, K);
  const int nch = (ke - kb + kPkc - 1) / kPkc;
  const int total = kPasses * nch;                // the block's chunks
  const int t_e0 = s * p.sub - p.d_rows;          // row of extended row 0
  const bool tail_block = s == p.T / p.sub - 1 && ol0 + kPm == m;
  const size_t w_tile = (size_t)(ol0 / kPm) * p.kpad * kPm;
  // chunk q of the block's stream: its x boxes and W tiles land in stage
  // q & 1, x and W each on a barrier of their own (phase parity (q >> 1) &
  // 1); its E buffer is q & 1.  A stage's x is free once its rows are
  // mixed, a step before its product frees the W, so x is issued a step
  // earlier: chunk q + 3's x and chunk q + 2's W after step q.
  auto k0_of = [&](int q) {
    return kb + (kPasses == 1 || q < nch ? q : q - nch) * kPkc;
  };
  auto stage = [&](int q) { return pr_smem + 128 + (q & 1) * kPStage; };
  auto issue_x = [&](int q) {
    const int t0 = t_e0 + k0_of(q);
    unsigned char* dst = stage(q);
    uint64_t* bar = full + (q & 1);
    bulk::mbar_arrive_expect_tx(bar, (uint32_t)(2 * kPBox));
    bulk::load_2d(dst, &map0, c0, t0, bar);
    if (FORM <= kV2)
      bulk::load_2d(dst + kPBox, &map1, c0, t0, bar);
    else
      bulk::load_2d(dst + kPBox, &map0, p.C + c0, t0, bar);
  };
  auto issue_w = [&](int q) {
    const size_t k0 = (size_t)k0_of(q);
    unsigned char* dst = stage(q) + 2 * kPBox;
    uint64_t* bar = full + 2 + (q & 1);
    bulk::mbar_arrive_expect_tx(bar, (uint32_t)(2 * kPBox));
    bulk::load(dst, p.wh + w_tile + k0 * kPm, kPBox, bar);
    bulk::load(dst + kPBox, p.wl + w_tile + k0 * kPm, kPBox, bar);
  };
  auto wait_x = [&](int q) {
    bulk::mbar_wait(full + (q & 1), (uint32_t)(q >> 1) & 1u);
  };
  auto wait_w = [&](int q) {
    bulk::mbar_wait(full + 2 + (q & 1), (uint32_t)(q >> 1) & 1u);
  };
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) bulk::mbar_init(full + i, 1);
    bulk::fence_mbar_init();
    for (int q = 0; q < 2 && q < total; ++q) {
      issue_x(q);
      issue_w(q);
    }
  }
  // the coarse phasors of the 128-row blocks of rows [t_e0 + kb, t_e0 + ke)
  const int q0 = max(t_e0 + kb, 0) / kQ;
  const int nq = max(t_e0 + ke - 1, 0) / kQ - q0 + 1;
  for (int i = tid; i < nq * kEnt; i += kPThreads) {
    const int q = i / kEnt, j = i - q * kEnt;
    const int c = c0 + (FORM == kV4 ? j % kPch : j);
    float sn = 0.0f, cs = 1.0f;
    if (c < p.C)
      probe_coarse(p, (q0 + q) * kQ, FORM == kV4 && j >= kPch ? p.C + c : c,
                   &cs, &sn);
    cc_s[i] = cs;
    cs_s[i] = sn;
  }
  __syncthreads();

  // Mix chunk q into E buffer q & 1: thread (warp w, lane) takes channel
  // 32 (w % 2) + lane x the 4-row quad w / 2 (one 16-byte store per E
  // half: a warp's 32 channels are 512 contiguous bytes).  A quad's rows
  // share their DC chunk, their 128-row block, whether they lie before t
  // = 0 or past ke and whether they are tail' rows, so each test is made
  // once per quad; the addresses are the thread's own offsets from a
  // stage, an E buffer or a table.  fetch(q) loads what the quad needs
  // from device memory ahead of its mixing; mix_chunk(q) waits for
  // nothing more.
  const int ch = 32 * (warp & 1) + lane, c = c0 + ch, kq = warp >> 1;
  const bool in_c = c < p.C;
  const int x_off = 4 * kq * kPch + ch;           // floats from a stage
  const int e_off = (kq * kN + ch) * 4;           // floats from E's hi half
  auto fetch = [&](int q, ProbeIn<FORM>* in) {
    const int k4 = k0_of(q) + 4 * kq, t = t_e0 + k4;
    if (k4 < ke && in_c && t >= 0) probe_fetch<FORM>(p, t, c, in);
  };
  auto mix_chunk = [&](int q, const ProbeIn<FORM>* in) {
    const int k4 = k0_of(q) + 4 * kq, t4 = t_e0 + k4;
    const float* xs = reinterpret_cast<const float*>(stage(q)) + x_off;
    float* eh = reinterpret_cast<float*>(pr_smem + g.e_off
                                         + (q & 1) * kPEBytes) + e_off;
    float* el = eh + kPkc * kN;
    float ur[4] = {}, ui[4] = {};
    if (k4 < ke && in_c) {
      if (t4 < 0) {                               // the carried tail
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (FORM <= kV2) {
            ur[r] = p.tail[(size_t)(p.d_rows + t4 + r) * p.C + c];
            ui[r] = p.tail[(size_t)(2 * p.d_rows + t4 + r) * p.C + c];
          } else {
            const size_t i = (size_t)(p.d_rows + t4 + r) * 2 * p.C + c;
            ur[r] = p.tail[i];
            ui[r] = p.tail[i + p.C];
          }
        }
      } else {
        const int qi = (t4 / kQ - q0) * kEnt + ch;
        const int q2 = FORM == kV4 ? qi + kPch : qi;
        const float cr = cc_s[qi], ci = cs_s[qi];
        const float cr2 = cc_s[q2], ci2 = cs_s[q2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          probe_mix<FORM>(*in, r, xs[r * kPch], xs[(kPkc + r) * kPch], cr,
                          ci, cr2, ci2, &ur[r], &ui[r]);
      }
      if (tail_block && q < nch && k4 >= p.sub) {   // tail' rows k4 - sub
        const int i = k4 - p.sub;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (FORM <= kV2) {
            p.tail_out[(size_t)(i + r) * p.C + c] = ur[r];
            p.tail_out[(size_t)(p.d_rows + i + r) * p.C + c] = ui[r];
          } else {
            p.tail_out[(size_t)(i + r) * 2 * p.C + c] = ur[r];
            p.tail_out[(size_t)(i + r) * 2 * p.C + p.C + c] = ui[r];
          }
        }
      }
    }
    // the TF32 split: hi = rna(v), lo = rna(v - hi)
    auto put = [&](int n, const float* v) {
      float h[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        h[r] = tf32_rna(v[r]);
        l[r] = tf32_rna(__fsub_rn(v[r], h[r]));
      }
      *reinterpret_cast<float4*>(eh + n) = make_float4(h[0], h[1], h[2],
                                                       h[3]);
      *reinterpret_cast<float4*>(el + n) = make_float4(l[0], l[1], l[2],
                                                       l[3]);
    };
    if constexpr (FORM == kV1) {
      put(0, q < nch ? ur : ui);
    } else {
      put(0, ur);
      put(kPch * 4, ui);
    }
  };

  // this thread's outputs and lanes: warp w4 = w % 4 of warpgroup (or warp
  // half) wn = w / 4 holds rows 16 w4 + g (+ 8) x lanes wn kNw + 8 j + 2 t
  // (+ 1), j < kNw / 8, g = lane / 4, t = lane % 4
  const int w4 = warp % 4, n0 = (warp / 4) * kNw;
  const int gq = lane / 4, tq = lane % 4;
  // v5: the k8 steps of this warp's group's span
  const int my_kb = ((ol0 + 16 * w4) / mt) * mt * p.F;
  const int my_ke = min(my_kb + span, K);

  float sum[kAcc], acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) sum[i] = acc[i] = 0.0f;
  // chunk k's fetched values: v1-v3 in in_[k & 1], fetched two chunks
  // ahead; v4 and v5, whose 34 values a quad would then hold twice, in
  // in_[0], one chunk ahead
  constexpr bool kAhead2 = FORM != kV4;
  ProbeIn<FORM> in_[kAhead2 ? 2 : 1];
  fetch(0, &in_[0]);
  if (kAhead2 && total > 1) fetch(1, &in_[1]);
  wait_x(0);
  mix_chunk(0, &in_[0]);
  bulk::fence_async_smem();           // E's generic writes before wgmma reads
  __syncthreads();
  if (tid == 0 && total > 2) issue_x(2);
  // step q: chunk q multiplied, chunk q + 1 mixed with cur (its fetched
  // values), chunk q + 2's fetched into nxt (or chunk q + 1's into cur)
  auto step = [&](int q, ProbeIn<FORM>* cur, ProbeIn<FORM>* nxt) {
    if (kAhead2 && q + 2 < total) fetch(q + 2, nxt);
    if (!kAhead2 && q + 1 < total) fetch(q + 1, cur);
    // chunk q into acc (fresh): W from its stage, E from buffer q & 1
    const unsigned char* st = stage(q);
    const unsigned char* eb = pr_smem + g.e_off + (q & 1) * kPEBytes;
    wait_w(q);
    if constexpr (kWg) {              // issued and committed; waited below
      const uint32_t wa = bulk::smem_u32(st + 2 * kPBox);
      const uint32_t ea = bulk::smem_u32(eb) + n0 * 16;
      wg_fence_regs<kAcc>(acc);
      wg_fence();
#pragma unroll
      for (int s8 = 0; s8 < kPkc / 8; ++s8) {
        const uint64_t ah = wg_desc(wa + s8 * 2048, 1024, 128);
        const uint64_t al = wg_desc(wa + kPBox + s8 * 2048, 1024, 128);
        const uint64_t bh = wg_desc(ea + s8 * 2 * kN * 16, kN * 16, 128);
        const uint64_t bl = wg_desc(ea + kPkc * kN * 4 + s8 * 2 * kN * 16,
                                    kN * 16, 128);
        wg_mma<kNw>(acc, ah, bh, s8);
        wg_mma<kNw>(acc, ah, bl, 1);
        wg_mma<kNw>(acc, al, bh, 1);
      }
      wg_commit();
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
      const uint32_t* wh = reinterpret_cast<const uint32_t*>(st + 2 * kPBox);
      const uint32_t* wl = wh + kPBox / 4;
      const uint32_t* bh = reinterpret_cast<const uint32_t*>(eb);
      const uint32_t* bl = bh + kPkc * kN;
      const int k0 = k0_of(q);
#pragma unroll
      for (int s8 = 0; s8 < kPkc / 8; ++s8) {
        const int kk = k0 + 8 * s8;
        if (TILED && (kk + 8 <= my_kb || kk >= my_ke)) continue;
        const int o = 16 * w4 + gq;
        const int a0 = ((2 * s8) * kPm + o) * 4 + tq;
        const int a1 = ((2 * s8 + 1) * kPm + o) * 4 + tq;
        const uint32_t ah[4] = {wh[a0], wh[a0 + 32], wh[a1], wh[a1 + 32]};
        const uint32_t al[4] = {wl[a0], wl[a0 + 32], wl[a1], wl[a1 + 32]};
#pragma unroll
        for (int j = 0; j < kNw / 8; ++j) {
          const int n = n0 + 8 * j + gq;
          const int b0 = ((2 * s8) * kN + n) * 4 + tq;
          const int b1 = ((2 * s8 + 1) * kN + n) * 4 + tq;
          const uint32_t vh[2] = {bh[b0], bh[b1]}, vl[2] = {bl[b0], bl[b1]};
          mma_tf32(acc + 4 * j, ah, vh);
          mma_tf32(acc + 4 * j, ah, vl);
          mma_tf32(acc + 4 * j, al, vh);
        }
      }
    }
    if (q + 1 < total) {              // mixed while the tensor cores work
      wait_x(q + 1);
      mix_chunk(q + 1, cur);
    }
    if constexpr (kWg) {
      wg_wait_all();
      wg_fence_regs<kAcc>(acc);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] += acc[i];
    if (q + 1 == nch || q + 1 == total) {  // a product is done: outputs
      const int pass = q >= nch;
#pragma unroll
      for (int j = 0; j < kNw / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const size_t o = (size_t)og + 16 * w4 + gq + 8 * (r >> 1);
          const int n = n0 + 8 * j + 2 * tq + (r & 1);
          const bool im = FORM != kV1 && n >= kPch;
          const int cn = c0 + (im ? n - kPch : n);
          if (cn < p.C) {
            if constexpr (FORM == kV1)
              (pass ? p.y1 : p.y0)[o * p.C + cn] = sum[4 * j + r];
            else if constexpr (FORM == kV2)
              (im ? p.y1 : p.y0)[o * p.C + cn] = sum[4 * j + r];
            else
              p.y0[o * 2 * p.C + (im ? p.C : 0) + cn] = sum[4 * j + r];
          }
          sum[4 * j + r] = 0.0f;
        }
    }
    bulk::fence_async_smem();
    __syncthreads();        // chunk q's W, chunk q + 1's x, E buffer q & 1
    if (tid == 0) {         // are free
      if (q + 2 < total) issue_w(q + 2);
      if (q + 3 < total) issue_x(q + 3);
    }
  };
  for (int q = 0; q < total; q += 2) {
    step(q, &in_[kAhead2 ? 1 : 0], &in_[0]);
    if (q + 1 < total) step(q + 1, &in_[0], &in_[kAhead2 ? 1 : 0]);
  }
}

template <int FORM, bool TILED>
cudaError_t launch_probe(const Probe& p, int device, cudaStream_t st) {
  const ProbeGeom g(FORM, p.d_rows, p.sub);
  if (!g.ok()) return cudaErrorInvalidValue;
  auto kernel = probe_toeplitz<FORM, TILED>;
  int slots = 0;        // unused: the call raises the kernel's shared-memory
                        // limit once; the grid is one block per tile
  cudaError_t err = launch::resident_blocks(kernel, device, kPThreads, g.smem,
                                            1, &slots);
  if (err != cudaSuccess) return err;
  CUtensorMap map0, map1;
  memset(&map0, 0, sizeof(map0));
  memset(&map1, 0, sizeof(map1));
  const bool two = FORM <= kV2;
  if ((err = launch::plane_map(p.x0, two ? p.C : 2 * p.C, p.T, 4, kPch, kPkc,
                               &map0)) != cudaSuccess
      || (two && (err = launch::plane_map(p.x1, p.C, p.T, 4, kPch, kPkc,
                                          &map1)) != cudaSuccess))
    return err;
  const dim3 grid((unsigned)((p.C + kPch - 1) / kPch),
                  (unsigned)(p.T / p.F / kPm));
  kernel<<<grid, kPThreads, g.smem, st>>>(map0, two ? map1 : map0, p, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory front_fir needs for a composed response of ntaps taps
// decimating by F, with (nb != 0) or without the noise blanker, on a
// float32 (or, x_int16 != 0, int16) plane; 0 when no instantiation covers
// it or it does not fit a block.
size_t front_fir_smem_bytes(int ntaps, int F, int nb, int x_int16) {
  const int dp = march_branch_taps(ntaps, F), elem = x_int16 ? 2 : 4;
  const int cg = march_cg(F, dp, elem, nb != 0);
  return cg ? (size_t)MarchGeom(F, dp, elem, nb != 0, cg).smem : 0;
}

// front_fir's work items on `slots` resident blocks for a [T, 2C] plane:
// out = {segment outputs, segments, items, grid, step rows, history rows,
// ring rows, stages, box rows, channels per item}; returns 0, or -1 when
// no instantiation covers the plan.
int front_fir_plan(int T, int C, int ntaps, int F, int nb, int x_int16,
                   int slots, int* out) {
  const int dp = march_branch_taps(ntaps, F), elem = x_int16 ? 2 : 4;
  const int cg = march_cg(F, dp, elem, nb != 0);
  if (!cg || T <= 0 || C <= 0 || slots <= 0) return -1;
  const MarchGeom g(F, dp, elem, nb != 0, cg);
  const MarchPlan p = march_plan(T, C, g, slots);
  const int v[10] = {p.ms, p.nseg, p.items, p.grid, g.step_rows, g.hist,
                     g.ring_rows, g.stages, g.box_rows, g.cg};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// front_comp's shared memory (bytes).
size_t front_comp_smem_bytes() { return (size_t)CompGeom().smem; }

// front_comp's work items on `slots` resident blocks for M decimated rows
// (M even) of C channels: out = {segment outputs, segments, items, grid,
// step rows, history rows, ring rows, stages, box rows}; returns 0, or -1
// for a shape it does not take.
int front_comp_plan(int M, int C, int slots, int* out) {
  if (M <= 0 || M % 2 || C <= 0 || slots <= 0) return -1;
  const CompGeom g;
  const CompPlan p = comp_plan(M, C, g, slots);
  const int v[9] = {p.ms, p.nseg, p.items, p.grid, kCompStepRows, g.hist,
                    g.ring_rows, g.stages, kCompBoxRows};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// front_dc_scan's launch for nchunk chunk means of c2 lanes: out = {lanes
// per block, blocks, threads, chunks a thread holds in registers (0: a
// longer segment), chunks per segment, a longer segment's shared memory
// (0: its chains read device memory)}; returns 0, or -1 for a shape it
// does not take.
int front_dc_scan_plan(int nchunk, int c2, int* out) {
  if (nchunk <= 0 || c2 <= 0) return -1;
  const ScanGeom g(nchunk, c2);
  const int v[6] = {g.lanes, g.blocks, g.threads, g.held, g.len, g.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// front_dc_scan alone: the chunk EWMA m_k = a m_{k-1} + b mu_k in place
// over mseq [nchunk, c2] (chunk means in, estimates out), from dc_in [c2]
// into dc_out [c2].  Returns the first CUDA error.
int front_dc_scan_forward(int device, float* mseq, int nchunk, int c2,
                          const float* dc_in, float* dc_out, float a, float b,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)nchunk * c2 >= (1LL << 31)) return cudaErrorInvalidValue;
  return launch_scan(mseq, nchunk, c2, dc_in, dc_out, a, b, device,
                     (cudaStream_t)stream);
}

const char* front_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory front_means needs for planes of c2 lanes (int16 when
// x_int16 != 0); 0 when two of its stages do not fit a block.
size_t front_means_smem_bytes(int c2, int x_int16) {
  if (c2 <= 0) return 0;
  const MeansGeom g(c2, x_int16 ? 2 : 4);
  return g.ok() ? (size_t)g.smem : 0;
}

// front_means alone: the chunk means [T/512, c2] of a [T, c2] float32 (or,
// when x_int16 != 0, int16) plane, 16-byte aligned, T a multiple of 512;
// with r_rows > 0, the last r_rows rows of each n-row block (n a multiple
// of 512 dividing T, r_rows <= n) into raw [T/n, r_rows, c2].  Returns the
// first CUDA error.
int front_means_forward(int device, const void* x, int x_int16, int T,
                        int c2, int n, int r_rows, float* means, float* raw,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (c2 <= 0 || (long long)T * c2 >= (1LL << 31))
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return x_int16
      ? launch_means(static_cast<const int16_t*>(x), T, c2, n, r_rows, means,
                     raw, device, st)
      : launch_means(static_cast<const float*>(x), T, c2, n, r_rows, means,
                     raw, device, st);
}

// One fused front-end dispatch of T rows (T * 2C < 2^31; T a multiple of
// 512, of F and of n; r_rows <= n) of a float32 plane,
// or of an int16 plane when x_int16 != 0, 16-byte aligned.  Scratch mseq:
// [T/512, 2C].
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
// front_fir stages by tensor-map boxes when fir_tma != 0 (C elements must
// be a multiple of 16 bytes), else element by element.
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
                  int comp_hr, float* comp_hist_out, int fir_tma,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb_mode && (nb_bw < 1 || nb_bw > kNbTailRows)) return cudaErrorInvalidValue;
  if (comp_taps != nullptr
      && (disc_gain == 0.0f || comp_tc < 2 || comp_tc > kMaxCompTaps
          || comp_hr < comp_tc - 1 || comp_hr > kCompHist || (T / F) % 2
          || T / F < comp_hr))
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
  f.fir_tma = fir_tma != 0;
  f.device = device;
  f.st = (cudaStream_t)stream;
  return x_int16 ? forward(static_cast<const int16_t*>(x), f)
                 : forward(static_cast<const float*>(x), f);
}

// The copy floor: per sub-block of each [T, lanes] float32 plane (x1 null
// for one plane), y = its first m rows; the device's resident blocks split
// between the planes.  Planes and outputs 16-byte aligned; lanes % 4 == 0;
// T lanes < 2^31; T a multiple of sub.
int probe_floor_forward(int device, const float* x0, const float* x1, int T,
                        int lanes, int sub, int m, float* y0, float* y1,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long total = (long long)T * lanes;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % bulk::kBulkAlign == 0;
  };
  if (lanes <= 0 || lanes % 4 || total >= (1LL << 31) || sub <= 0 || T % sub
      || m < 1 || m > sub || !aligned(x0) || !aligned(x1) || !aligned(y0)
      || !aligned(y1))
    return cudaErrorInvalidValue;
  int slots = 0;
  if ((err = launch::resident_blocks(probe_floor_copy, device,
                                     kFloorThreads, kFloorSmem,
                                     kMaxBlocksPerSm, &slots)) != cudaSuccess)
    return err;
  const long long tiles = (total + kFloorTile - 1) / kFloorTile;
  const int planes = x1 != nullptr ? 2 : 1;
  const long long fill = max(slots / planes, 1);
  const dim3 grid((unsigned)max(1LL, min(tiles, fill)), (unsigned)planes);
  probe_floor_copy<<<grid, kFloorThreads, kFloorSmem, (cudaStream_t)stream>>>(
      x0, x1, total, lanes, sub, m, y0, y1);
  return cudaGetLastError();
}

// A front variant (form 1-4 = v1, v2, v3, v4/v5) over one dispatch of T
// rows: DC seeds (front_means + front_dc_scan per plane, into the scratch
// mseq [planes, T/512, lanes] and dc_out), then one probe_toeplitz launch:
// the Toeplitz product into y0 (and y1) and tail'.  Layouts as in struct
// Probe; dc_in/dc_out [2, C] for v1/v2, else [1, 2C]; wh/wl the split W^T
// [(sub/F)/64][kpad/4][64][4] (kpad >= d_rows + sub + 32, a multiple of
// 32); planes 16-byte aligned and C % 4 == 0 (the tensor maps' 16-byte
// rule).  Needs T % sub == 0, sub % 512 == 0, sub % F == 0, (sub/F) % 64
// == 0, (sub/F) % (16 kt) == 0 (a warp's 16 outputs in one v5 group),
// T 2C < 2^31.  Returns the first CUDA error.
int probe_front_forward(int device, int form, const float* x0,
                        const float* x1, int T, int C, int sub, int F,
                        int d_rows, int kt, const float* dc_in,
                        const float* tail_in, const float* phase,
                        const float* fhi, const float* flo, const float* f0,
                        const float* f1, const float* f2, const float* f3,
                        const float* wh, const float* wl, int kpad, float a,
                        float b, float* mseq, float* y0, float* y1,
                        float* dc_out, float* tail_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (form < kV1 || form > kV4 || sub <= 0 || F <= 0 || kt < 1 || T % sub
      || sub % kDcChunk || sub % F || (sub / F) % kPm
      || (sub / F) % (16 * kt) || C % 4 || kpad % kPkc
      || kpad < d_rows + sub + kPkc || !ProbeGeom(form, d_rows, sub).ok()
      || (long long)T * 2 * C >= (1LL << 31) || T / F / kPm >= 65536)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool two = form <= kV2;
  const int nchunk = T / kDcChunk, lanes = two ? C : 2 * C;
  for (int pl = 0; pl < (two ? 2 : 1); ++pl) {
    float* ms = mseq + (size_t)pl * nchunk * lanes;
    if ((err = launch_means(pl ? x1 : x0, T, lanes, T, 0, ms, nullptr,
                            device, st)) != cudaSuccess
        || (err = launch_scan(ms, nchunk, lanes, dc_in + pl * C,
                              dc_out + pl * C, a, b, device, st))
               != cudaSuccess)
      return err;
  }
  Probe p;
  p.x0 = x0; p.x1 = x1; p.m0 = mseq;
  p.m1 = two ? mseq + (size_t)nchunk * C : nullptr;
  p.tail = tail_in; p.phase = phase; p.fhi = fhi; p.flo = flo;
  p.f0 = f0; p.f1 = f1; p.f2 = f2; p.f3 = f3; p.wh = wh; p.wl = wl;
  p.T = T; p.C = C; p.sub = sub; p.F = F; p.d_rows = d_rows; p.kt = kt;
  p.kpad = kpad;
  p.y0 = y0; p.y1 = y1; p.tail_out = tail_out;
  switch (form) {
    case kV1: return launch_probe<kV1, false>(p, device, st);
    case kV2: return launch_probe<kV2, false>(p, device, st);
    case kV3: return launch_probe<kV3, false>(p, device, st);
    default:
      return kt > 1 ? launch_probe<kV4, true>(p, device, st)
                    : launch_probe<kV4, false>(p, device, st);
  }
}

}  // extern "C"
