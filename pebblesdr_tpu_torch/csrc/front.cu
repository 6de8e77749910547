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

#include <mutex>

#include "bulk_ring.cuh"

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
constexpr int kMaxBlocksPerSm = 32;  // Hopper's resident blocks per SM
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

// Blocks of `kernel` (threads each, smem bytes of dynamic shared memory)
// that the device holds at once, at most max_per_sm on each SM; found once
// per kernel, device and smem.
template <typename K>
cudaError_t resident_blocks(K* kernel, int device, int threads, int smem,
                            int max_per_sm, int* blocks) {
  struct Entry { const void* k; int device, smem, blocks; };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].k == key && cache[i].device == device
        && cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmem)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *blocks = max(sms * min(per_sm, max_per_sm), 1);
  if (used < 64) cache[used++] = Entry{key, device, smem, *blocks};
  return cudaSuccess;
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
  cudaError_t err = resident_blocks(kernel, device, kMeansThreads, g.smem,
                                    kMeansBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  const int nchunk = T / kDcChunk;
  kernel<<<(unsigned)min(nchunk, slots), kMeansThreads, g.smem, st>>>(
      x, nchunk, c2, n, r_rows, g, means, r_rows ? raw : nullptr);
  return cudaGetLastError();
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
  int device;
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

  if ((err = launch_means(x, f.T, c2, f.n, f.r_rows, f.mseq, f.raw, f.device,
                          f.st)) != cudaSuccess)
    return err;
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
// tail, and every block rebuilds the mixed rows it needs.  A block takes
// kTm outputs of one sub-block x kTl lanes and walks its K range in steps of
// kKc rows: it stages the Toeplitz rows and the extended input rows (DC
// removed and mixed with the NCO as they are staged: coarse phasors once per
// block, fine phasors from the host tables), the next step's loads in
// flight, and each thread accumulates a 4 x 4 tile of outputs in plain
// float32 FMAs (no tensor cores, no TF32).  The mixing is redone by each of
// the C/16 lane tiles and sub/F/64 output tiles that read a row.
// The switches (FORM):
//   v1: two planes, two products (the K range is walked once per plane, so
//       W is read twice); v2: two planes, one product over [er | ei];
//   v3: one packed plane, mixed per channel; v4 (and v5): the packed plane
//       with the packed phasor tables A = [or | or], B = [oi | -oi],
//       y = z A + swap(z) B, and a phase per lane.
// Bound: operations, 2 (d_rows + sub) per output lane dense (2 span for
// v5), against float32's 67 TFLOP/s.  probe_tail writes tail' (the last
// d_rows mixed rows) in the variant's layout.

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

constexpr int kTm = 64;            // outputs per probe_toeplitz block
constexpr int kTl = 32;            // lanes per probe_toeplitz block
constexpr int kKc = 32;            // extended-input rows per step
constexpr int kToepThreads = 128;  // 8 lane quads x 16 output quads

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
  const float* wt;        // [sub/F, d_rows + sub]
  int T, C, sub, F, d_rows, kt;
  float *y0, *y1;         // v1/v2 [T/F, C] each; else y0 [T/F, 2C]
  float* tail_out;        // tail' in the tail's layout
};

// What one extended row of channel c needs before it is mixed: its input
// (re, im) and DC estimate, or the carried post-mix values (t < 0); and the
// fine phasors of its row within 128 (v1-v3: cos, sin; v4: the four packed
// tables at its re lane, then at its im lane).
struct ProbeRaw {
  float a, b, ma, mb;
  float f[8];
};

template <int FORM>
__device__ __forceinline__ void probe_load(const Probe& p, int t, int c,
                                           ProbeRaw* r) {
  if (t < 0) {                                    // the carried tail
    if constexpr (FORM <= kV2) {
      r->a = p.tail[(size_t)(p.d_rows + t) * p.C + c];
      r->b = p.tail[(size_t)(2 * p.d_rows + t) * p.C + c];
    } else {
      const size_t i = (size_t)(p.d_rows + t) * 2 * p.C + c;
      r->a = p.tail[i];
      r->b = p.tail[i + p.C];
    }
    return;
  }
  const int k = t / kDcChunk, q = t % kQ;
  if constexpr (FORM <= kV2) {
    const size_t i = (size_t)t * p.C + c, j = (size_t)k * p.C + c;
    r->a = p.x0[i];
    r->b = p.x1[i];
    r->ma = p.m0[j];
    r->mb = p.m1[j];
  } else {
    const size_t c2 = 2 * (size_t)p.C;
    const size_t i = (size_t)t * c2 + c, j = (size_t)k * c2 + c;
    r->a = p.x0[i];
    r->b = p.x0[i + p.C];
    r->ma = p.m0[j];
    r->mb = p.m0[j + p.C];
  }
  if constexpr (FORM != kV4) {
    const size_t f = (size_t)q * p.C + c;
    r->f[0] = p.f0[f];
    r->f[1] = p.f1[f];
  } else {
    const size_t f = (size_t)q * 2 * p.C + c, g = f + p.C;
    r->f[0] = p.f0[f]; r->f[1] = p.f1[f]; r->f[2] = p.f2[f]; r->f[3] = p.f3[f];
    r->f[4] = p.f0[g]; r->f[5] = p.f1[g]; r->f[6] = p.f2[g]; r->f[7] = p.f3[g];
  }
}

// The mixed values of a loaded row t >= 0, from the coarse phasor of its re
// lane (cr, ci) and, for v4, of its im lane (cr2, ci2).
template <int FORM>
__device__ __forceinline__ void probe_mix(const ProbeRaw& r, float cr,
                                          float ci, float cr2, float ci2,
                                          float* ur, float* ui) {
  const float zr = r.a - r.ma, zi = r.b - r.mb;
  if constexpr (FORM != kV4) {
    mix(zr, zi, cr, ci, r.f[0], r.f[1], ur, ui);
  } else {      // per lane: z A + swap(z) B, A = c fr1 - s fi1, B = c fi2 + s fr2
    *ur = zr * (cr * r.f[0] - ci * r.f[1]) + zi * (cr * r.f[2] + ci * r.f[3]);
    *ui = zi * (cr2 * r.f[4] - ci2 * r.f[5])
          + zr * (cr2 * r.f[6] + ci2 * r.f[7]);
  }
}

// The coarse phasor (cos, sin) of phase lane `lane` for the 128-row block
// of row t, in the variant's split form (sub-block p.sub).
__device__ __forceinline__ void probe_coarse(const Probe& p, int t, int lane,
                                             float* cr, float* ci) {
  sincospif(2.0f * coarse_phase(t, p.phase[lane], p.fhi[lane], p.flo[lane],
                                p.sub), ci, cr);
}

constexpr int kMaxQ = 80;   // 128-row blocks one probe_toeplitz block spans

// grid (ceil(C / kCh), (T/F) / kTm), block kToepThreads.  A block holds
// kTm outputs of one sub-block and kCh channels: one plane's lanes of kTl
// channels per product for v1, the re and im lanes of kTl/2 channels
// otherwise.  Its K range is the union of its output groups' spans (all of
// K when dense), at most kMaxQ 128-row blocks: it first computes the coarse
// phasors of all of them, then walks the range in steps of kKc rows.  Each
// step mixes the rows loaded by the step before into shared memory, stores
// the Toeplitz rows, then issues the next step's loads (to registers, in
// flight during the products) and multiplies; a thread skips the steps
// outside its own group's span (v5).  Thread (tx, ty) = (tid % 8, tid / 8)
// accumulates outputs 4 ty .. 4 ty + 3 x lanes 4 tx .. 4 tx + 3; a warp's
// 16 outputs lie in one group (the wrapper requires (sub/F/kt) % 4 == 0).
template <int FORM>
__global__ void __launch_bounds__(kToepThreads) probe_toeplitz(Probe p) {
  constexpr int kCh = FORM == kV1 ? kTl : kTl / 2;
  constexpr int kEnt = FORM == kV4 ? kTl : kCh;   // coarse phasors per row
  constexpr int kPairs = kKc * kCh / kToepThreads;   // rows x channels each
  constexpr int kW4 = kTm * kKc / 4 / kToepThreads;  // 16-byte W loads each
  __shared__ __align__(16) float e_s[kKc][kTl];
  __shared__ __align__(16) float w_s[kKc][kTm];
  __shared__ float cc_s[kMaxQ][kEnt], cs_s[kMaxQ][kEnt];
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int m = p.sub / p.F, K = p.d_rows + p.sub, mt = m / p.kt;
  const int c0 = blockIdx.x * kCh;
  const int og = blockIdx.y * kTm;                // the block's first output
  const int s = og / m, ol0 = og - s * m;         // its sub-block, local row
  // a group's K span: all of K (dense), or d_rows + mt F rows rounded up to
  // 8 from the group's first input row (v5)
  const int span = p.kt == 1 ? K : (p.d_rows + mt * p.F + 7) / 8 * 8;
  const int g_lo = ol0 / mt, g_hi = (ol0 + kTm - 1) / mt;
  const int kb = g_lo * mt * p.F, ke = min(g_hi * mt * p.F + span, K);
  const int my_kb = ((ol0 + 4 * ty) / mt) * mt * p.F;
  const int my_ke = min(my_kb + span, K);
  const int t_e0 = s * p.sub - p.d_rows;          // row of extended row 0
  const int q0 = max(t_e0 + kb, 0) / kQ;          // first 128-row block
  const int nq = max(t_e0 + ke - 1, 0) / kQ - q0 + 1;
  for (int i = tid; i < nq * kEnt; i += kToepThreads) {
    const int q = i / kEnt, j = i - q * kEnt;
    const int c = c0 + (FORM == kV4 ? j % kCh : j);
    float sn = 0.0f, cs = 1.0f;
    if (c < p.C)
      probe_coarse(p, (q0 + q) * kQ, FORM == kV4 && j >= kCh ? p.C + c : c,
                   &cs, &sn);
    cc_s[q][j] = cs;
    cs_s[q][j] = sn;
  }
  ProbeRaw raw[kPairs];
  float4 wr[kW4];
  auto load = [&](int k0) {                       // step k0's loads
#pragma unroll
    for (int it = 0; it < kW4; ++it) {
      const int i = tid + it * kToepThreads;
      const int o = i / (kKc / 4), k = 4 * (i - o * (kKc / 4));
      wr[it] = k0 + k < ke ? *reinterpret_cast<const float4*>(
                                 p.wt + (size_t)(ol0 + o) * K + k0 + k)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int it = 0; it < kPairs; ++it) {
      const int i = tid + it * kToepThreads, k = i / kCh, c = c0 + i % kCh;
      if (k0 + k < ke && c < p.C) probe_load<FORM>(p, t_e0 + k0 + k, c, &raw[it]);
    }
  };
  for (int pass = 0; pass < (FORM == kV1 ? 2 : 1); ++pass) {
    float acc[4][4] = {};
    load(kb);
    for (int k0 = kb; k0 < ke; k0 += kKc) {
      __syncthreads();                            // coarse table / last step read
#pragma unroll
      for (int it = 0; it < kW4; ++it) {
        const int i = tid + it * kToepThreads;
        const int o = i / (kKc / 4), k = 4 * (i - o * (kKc / 4));
        w_s[k][o] = wr[it].x;
        w_s[k + 1][o] = wr[it].y;
        w_s[k + 2][o] = wr[it].z;
        w_s[k + 3][o] = wr[it].w;
      }
#pragma unroll
      for (int it = 0; it < kPairs; ++it) {
        const int i = tid + it * kToepThreads, k = i / kCh, j = i % kCh;
        const int t = t_e0 + k0 + k;
        float ur = 0.0f, ui = 0.0f;
        if (k0 + k < ke && c0 + j < p.C) {
          if (t < 0) {
            ur = raw[it].a;
            ui = raw[it].b;
          } else {
            const int q = t / kQ - q0, j2 = FORM == kV4 ? j + kCh : j;
            probe_mix<FORM>(raw[it], cc_s[q][j], cs_s[q][j], cc_s[q][j2],
                            cs_s[q][j2], &ur, &ui);
          }
        }
        if constexpr (FORM == kV1) {
          e_s[k][j] = pass ? ui : ur;
        } else {
          e_s[k][j] = ur;
          e_s[k][j + kCh] = ui;
        }
      }
      __syncthreads();
      if (k0 + kKc < ke) load(k0 + kKc);          // in flight while we multiply
      if (k0 + kKc <= my_kb || k0 >= my_ke) continue;   // outside my span
#pragma unroll 8
      for (int k = 0; k < kKc; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&w_s[k][4 * ty]);
        const float4 e = *reinterpret_cast<const float4*>(&e_s[k][4 * tx]);
        const float wv[4] = {w.x, w.y, w.z, w.w}, ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(wv[a], ev[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t o = (size_t)og + 4 * ty + a;   // output row of the dispatch
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tx + b;
        const bool im = FORM != kV1 && j >= kCh;
        const int c = c0 + (im ? j - kCh : j);
        if (c >= p.C) continue;
        if constexpr (FORM == kV1)
          (pass ? p.y1 : p.y0)[o * p.C + c] = acc[a][b];
        else if constexpr (FORM == kV2)
          (im ? p.y1 : p.y0)[o * p.C + c] = acc[a][b];
        else
          p.y0[o * 2 * p.C + (im ? p.C : 0) + c] = acc[a][b];
      }
    }
  }
}

// grid ceil(d_rows C / 256), block 256: tail' = the last d_rows mixed rows
// of the dispatch (rows before it from the carried tail).
template <int FORM>
__global__ void probe_tail(Probe p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.d_rows * p.C) return;
  const int i = idx / p.C, c = idx % p.C, t = p.T - p.d_rows + i;
  ProbeRaw r;
  probe_load<FORM>(p, t, c, &r);
  float ur = r.a, ui = r.b;
  if (t >= 0) {
    float cr, ci, cr2 = 0.0f, ci2 = 0.0f;
    probe_coarse(p, t, c, &cr, &ci);
    if (FORM == kV4) probe_coarse(p, t, p.C + c, &cr2, &ci2);
    probe_mix<FORM>(r, cr, ci, cr2, ci2, &ur, &ui);
  }
  if constexpr (FORM <= kV2) {
    p.tail_out[(size_t)i * p.C + c] = ur;
    p.tail_out[(size_t)(p.d_rows + i) * p.C + c] = ui;
  } else {
    p.tail_out[(size_t)i * 2 * p.C + c] = ur;
    p.tail_out[(size_t)i * 2 * p.C + p.C + c] = ui;
  }
}

template <int FORM>
cudaError_t launch_probe(const Probe& p, cudaStream_t st) {
  constexpr int kCh = FORM == kV1 ? kTl : kTl / 2;
  const dim3 grid((unsigned)((p.C + kCh - 1) / kCh),
                  (unsigned)(p.T / p.F / kTm));
  probe_toeplitz<FORM><<<grid, kToepThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  probe_tail<FORM><<<(unsigned)((p.d_rows * p.C + 255) / 256), 256, 0, st>>>(
      p);
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
// 512, of F and of n; T / F / kM < 65536; r_rows <= n) of a float32 plane,
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
  if ((err = resident_blocks(probe_floor_copy, device, kFloorThreads,
                             kFloorSmem, kMaxBlocksPerSm, &slots))
      != cudaSuccess)
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
// mseq [planes, T/512, lanes] and dc_out), the Toeplitz product into y0
// (and y1) and tail'.  Layouts as in struct Probe; dc_in/dc_out [2, C] for
// v1/v2, else [1, 2C]; planes 16-byte aligned.  Needs T % sub == 0, sub %
// 512 == 0, sub % F == 0, (sub/F) % 64 == 0, (sub/F) % (4 kt) == 0, T 2C <
// 2^31.  Returns the first CUDA error.
int probe_front_forward(int device, int form, const float* x0,
                        const float* x1, int T, int C, int sub, int F,
                        int d_rows, int kt, const float* dc_in,
                        const float* tail_in, const float* phase,
                        const float* fhi, const float* flo, const float* f0,
                        const float* f1, const float* f2, const float* f3,
                        const float* wt, float a, float b, float* mseq,
                        float* y0, float* y1, float* dc_out, float* tail_out,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (form < kV1 || form > kV4 || sub <= 0 || F <= 0 || kt < 1 || T % sub
      || sub % kDcChunk || sub % F || (sub / F) % kTm || (sub / F) % (4 * kt)
      || (d_rows + sub) / kQ + 2 > kMaxQ
      || (long long)T * 2 * C >= (1LL << 31) || T / F / kTm >= 65536)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool two = form <= kV2;
  const int nchunk = T / kDcChunk, lanes = two ? C : 2 * C;
  const unsigned lane_groups = (unsigned)((lanes + 31) / 32);
  for (int pl = 0; pl < (two ? 2 : 1); ++pl) {
    float* ms = mseq + (size_t)pl * nchunk * lanes;
    if ((err = launch_means(pl ? x1 : x0, T, lanes, T, 0, ms, nullptr,
                            device, st)) != cudaSuccess)
      return err;
    front_dc_scan<<<dim3(lane_groups), dim3(32, 32), 0, st>>>(
        ms, nchunk, lanes, dc_in + pl * C, dc_out + pl * C, a, b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  Probe p;
  p.x0 = x0; p.x1 = x1; p.m0 = mseq;
  p.m1 = two ? mseq + (size_t)nchunk * C : nullptr;
  p.tail = tail_in; p.phase = phase; p.fhi = fhi; p.flo = flo;
  p.f0 = f0; p.f1 = f1; p.f2 = f2; p.f3 = f3; p.wt = wt;
  p.T = T; p.C = C; p.sub = sub; p.F = F; p.d_rows = d_rows; p.kt = kt;
  p.y0 = y0; p.y1 = y1; p.tail_out = tail_out;
  switch (form) {
    case kV1: return launch_probe<kV1>(p, st);
    case kV2: return launch_probe<kV2>(p, st);
    case kV3: return launch_probe<kV3>(p, st);
    default: return launch_probe<kV4>(p, st);
  }
}

}  // extern "C"
