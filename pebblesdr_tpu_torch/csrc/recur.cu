// Per-sample recurrences for Hopper (sm_90a): the second-order carrier loop
// (K3 pll_scan, four phase detectors), the same loop at the chunk rate (K3c
// pll_chunk_scan), the scan AGC's attack / decay / hang smoother (K4
// agc_scan), the adaptive IQ balance's LMS loop (K5 iq_lms_scan), the OOK
// detector's envelopes, decision and debounce over Goertzel frames (K6
// ook_scan), the test generator's frequency sweep (K7 sweep_scan) and the
// ANF's leaky block LMS (K8 anf_scan).
//
// Replaces no Pallas kernel: in the JAX package each is a jax.lax.scan,
// pll.pll_run (pebblesdr_tpu/ops/pll.py:116), the loop of
// pll.pll_run_blockwise (:182), the scan of agc.agc_apply
// (pebblesdr_tpu/ops/agc.py:298), scanops.auto_iq_balance
// (pebblesdr_tpu/ops/scanops.py:164), goertzel.ook_detect
// (pebblesdr_tpu/ops/goertzel.py:375), siggen.sweep
// (pebblesdr_tpu/core/siggen.py:119) and scanops.anf (scanops.py:257).
// The plain PyTorch versions are pll_scan_plain and pll_chunk_scan_plain
// in ops/pll.py, agc_scan_plain in ops/agc.py, iq_lms_scan_plain and
// anf_plain in ops/scanops.py, ook_detect_plain in ops/goertzel.py and
// sweep_plain in core/siggen.py: a Python loop over time of the same
// arithmetic on [C] (or 0-d) tensors (anf_plain: over the updates, each a
// few batched matmuls).
//
// What bounds K3, K3c, K4, K6 and K7: the latency of one step's dependent
// chain, times the steps.  Each channel's state (three to six scalars)
// feeds the next sample, so a channel is one thread that carries its state
// in registers; the bytes (x read once, two float32 outputs written once)
// would take ~4 us at 3.35 TB/s for [64, 32768], the chain ~0.1 us a step.
// The design keeps memory off that chain:
//   * a block serves kCb = 8 channels (64 channels: 8 blocks on 8 SMs);
//     warp 0's first 8 lanes run the recurrences, warps 1-3 stage data;
//   * the [C, N] rows are channel-major, so one thread walking its own row
//     would read 8 rows N apart per warp step: instead the stagers copy
//     tiles of [8 channels x kTile samples] into shared memory with
//     cp.async (whole rows of kTile samples, coalesced), double-buffered,
//     while the 8 lanes run the previous tile from shared memory (rows
//     padded by 16 bytes, so the 8 lanes' reads fall in distinct banks);
//   * outputs go to a shared tile of the same shape, and the stagers write
//     the previous tile's rows to device memory while the next runs;
//   * the arithmetic is the JAX step's in IEEE float32: products and sums
//     with round-to-nearest intrinsics (no FMA contraction, so each value
//     is the plain version's op by op), sincosf / atan2f / hypotf / fmodf
//     (no fast-math intrinsics): the phase integrates every step's
//     rounding.  The wrap mod(a + pi, 2 pi) - pi takes an exact fast path
//     for a + pi in [0, 4 pi) (one subtraction, exact by Sterbenz) and
//     fmodf otherwise.
// K7 has one sequence and no input: one thread runs the chain into
// shared-memory tiles and the block's other warps turn each finished tile
// into samples (recur_sweep_kernel).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCb = 8;            // channels per block, one thread each
constexpr int kThreads = 128;     // warp 0: the recurrences; 1-3: staging
constexpr int kStagers = kThreads - 32;
constexpr int kTile = 128;        // samples per staged tile
constexpr int kPad = 16;          // bytes of padding per staged row

constexpr float kPi = 3.14159265358979f;       // float32(pi)
constexpr float kTwoPi = 6.28318530717959f;    // float32(2 pi)
constexpr float kQuarterPi = 0.785398163397448f;

enum Detector { kAtan2 = 0, kCross = 1, kCostas = 2, kPilot = 3 };

// jnp.mod(a + pi, 2 pi) - pi in float32: fmod, plus 2 pi where the
// remainder is negative.
__device__ __forceinline__ float wrap_pi(float a) {
  const float x = __fadd_rn(a, kPi);
  float r;
  if (x >= 0.f && x < 2.f * kTwoPi) {
    r = x >= kTwoPi ? __fsub_rn(x, kTwoPi) : x;
  } else {
    r = fmodf(x, kTwoPi);
    if (r < 0.f) r = __fadd_rn(r, kTwoPi);
  }
  return __fsub_rn(r, kPi);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One channel's view of a launch: its input row, output rows and state.
struct Io {
  const void* x;        // [C, N] input (float, float2 or float4 rows)
  float* out[2];        // [C, N] output rows
  const void* st_in[6];
  void* st_out[6];
  int C, N;
};

// K3: the loop of pll.pll_run.  Per sample: amp' = amp + 1e-3 (|x| - amp);
// the detector's error; fdev' = clip(fdev + beta err); phase' =
// wrap(phase + (wc + fdev') + alpha err).  Outputs the phase used on the
// sample and fdev' + wc.
template <int DET>
struct PllStep {
  using In = float2;
  static constexpr int kOut = 2;
  float alpha, beta, wc, dev_lo, dev_hi;
  float phase, fdev, amp;

  __device__ void load(const Io& io, int c) {
    phase = static_cast<const float*>(io.st_in[0])[c];
    fdev = static_cast<const float*>(io.st_in[1])[c];
    amp = static_cast<const float*>(io.st_in[2])[c];
  }
  __device__ void store(const Io& io, int c) const {
    static_cast<float*>(io.st_out[0])[c] = phase;
    static_cast<float*>(io.st_out[1])[c] = fdev;
    static_cast<float*>(io.st_out[2])[c] = amp;
  }
  __device__ __forceinline__ void step(float2 x, float* o) {
    const float amp2 = __fadd_rn(
        amp, __fmul_rn(1e-3f, __fsub_rn(hypotf(x.x, x.y), amp)));
    float err;
    if (DET == kPilot) {
      // x ~= A sin(phase): Re(x) cos(phase) / max((pi/4) amp', 1e-6)
      const float a_half = fmaxf(__fmul_rn(kQuarterPi, amp2), 1e-6f);
      err = __fdiv_rn(__fmul_rn(x.x, cosf(phase)), a_half);
    } else {
      // z = x e^{-j phase}
      float s, c;
      sincosf(phase, &s, &c);
      const float zr = __fadd_rn(__fmul_rn(x.x, c), __fmul_rn(x.y, s));
      const float zi = __fsub_rn(__fmul_rn(x.y, c), __fmul_rn(x.x, s));
      if (DET == kAtan2) {
        err = atan2f(zi, zr);
      } else if (DET == kCostas) {
        err = __fdiv_rn(__fmul_rn(zr, zi),
                        fmaxf(__fmul_rn(amp2, amp2), 1e-12f));
      } else {  // cross: Im(z) sign(Re(z)), sign(0) = 0
        const float sg = zr > 0.f ? 1.f : (zr < 0.f ? -1.f : 0.f);
        err = __fmul_rn(zi, sg);
      }
    }
    const float fdev2 = clampf(__fadd_rn(fdev, __fmul_rn(beta, err)), dev_lo,
                               dev_hi);
    o[0] = phase;
    o[1] = __fadd_rn(fdev2, wc);
    phase = wrap_pi(__fadd_rn(__fadd_rn(phase, __fadd_rn(wc, fdev2)),
                              __fmul_rn(alpha, err)));
    fdev = fdev2;
    amp = amp2;
  }
};

// K3c: the loop of pll.pll_run_blockwise over chunk phasors z.  amp' = amp
// + 0.05 (|z| - amp); zz = z e^{-j phase} (times j for the pilot); err =
// atan2(zz); fdev' = clip(fdev + beta err); phase' = wrap(phase + fdev' +
// alpha err).  Outputs the phase at the chunk and fdev'.
struct ChunkStep {
  using In = float2;
  static constexpr int kOut = 2;
  float alpha, beta, dev_lo, dev_hi;
  int pilot;
  float phase, fdev, amp;

  __device__ void load(const Io& io, int c) {
    phase = static_cast<const float*>(io.st_in[0])[c];
    fdev = static_cast<const float*>(io.st_in[1])[c];
    amp = static_cast<const float*>(io.st_in[2])[c];
  }
  __device__ void store(const Io& io, int c) const {
    static_cast<float*>(io.st_out[0])[c] = phase;
    static_cast<float*>(io.st_out[1])[c] = fdev;
    static_cast<float*>(io.st_out[2])[c] = amp;
  }
  __device__ __forceinline__ void step(float2 z, float* o) {
    const float amp2 = __fadd_rn(
        amp, __fmul_rn(0.05f, __fsub_rn(hypotf(z.x, z.y), amp)));
    float s, c;
    sincosf(phase, &s, &c);
    float zr = __fadd_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s));
    float zi = __fsub_rn(__fmul_rn(z.y, c), __fmul_rn(z.x, s));
    if (pilot) {          // zz * 1j = (-Im, Re)
      const float t = zr;
      zr = -zi;
      zi = t;
    }
    const float err = atan2f(zi, zr);
    const float fdev2 = clampf(__fadd_rn(fdev, __fmul_rn(beta, err)), dev_lo,
                               dev_hi);
    o[0] = phase;
    o[1] = fdev2;
    phase = wrap_pi(__fadd_rn(__fadd_rn(phase, fdev2), __fmul_rn(alpha, err)));
    fdev = fdev2;
    amp = amp2;
  }
};

// K4: the scan AGC's smoother.  The attack average rises at `rise` and
// falls at `fall`; the decay average rises at `drise` and, with the hang
// on, holds until `hang` steps have passed without a rise, then falls at
// `dfall` (without the hang it falls at once).  Outputs max(att', dec').
template <bool HANG>
struct AgcStep {
  using In = float;
  static constexpr int kOut = 1;
  float rise, fall, drise, dfall;
  int hang_samples;
  float att, dec;
  int hang;

  __device__ void load(const Io& io, int c) {
    att = static_cast<const float*>(io.st_in[0])[c];
    dec = static_cast<const float*>(io.st_in[1])[c];
    hang = static_cast<const int*>(io.st_in[2])[c];
  }
  __device__ void store(const Io& io, int c) const {
    static_cast<float*>(io.st_out[0])[c] = att;
    static_cast<float*>(io.st_out[1])[c] = dec;
    static_cast<int*>(io.st_out[2])[c] = hang;
  }
  __device__ __forceinline__ void step(float p, float* o) {
    const float da = __fsub_rn(p, att);
    const float att2 = __fadd_rn(att, __fmul_rn(p > att ? rise : fall, da));
    const bool rising = p > dec;
    const float dd = __fsub_rn(p, dec);
    float dec2;
    if (HANG) {
      hang = rising ? 0 : hang + 1;
      const float fall_to = __fadd_rn(dec, __fmul_rn(dfall, dd));
      dec2 = rising ? __fadd_rn(dec, __fmul_rn(drise, dd))
                    : (hang > hang_samples ? fall_to : dec);
    } else {
      dec2 = __fadd_rn(dec, __fmul_rn(rising ? drise : dfall, dd));
    }
    o[0] = fmaxf(att2, dec2);
    att = att2;
    dec = dec2;
  }
};

// K6: goertzel.ook_detect's step over one frame's powers (main, low, high;
// the fourth lane pads the frame to 16 bytes).  The peak envelope moves
// toward the power at aa (rising) or da, the floor at aa (falling) or fa =
// 0.1 da (the noise mode holds it during mark), the mean at va; the mode's
// threshold gives the raw decision, then the asymmetric debounce: attack
// consecutive raw marks turn the state on, decay raw spaces turn it off.
// The constants arrive as the JAX step rounds them (each Python-float
// product folded in float64, then cast once); ratio is the mode's one
// parameter.  Outputs the state after the frame (1 or 0).
enum OokMode { kCompare = 0, kPeak = 1, kAverage = 2, kMinMax = 3,
               kManual = 4, kNoise = 5 };

template <int MODE>
struct OokStep {
  using In = float4;
  static constexpr int kOut = 1;
  float aa, da, fa, keep, va, ratio;
  int attack_frames, decay_frames;
  float peak, floor_, avg;
  int st, att, dec;

  __device__ void load(const Io& io, int c) {
    peak = static_cast<const float*>(io.st_in[0])[c];
    floor_ = static_cast<const float*>(io.st_in[1])[c];
    avg = static_cast<const float*>(io.st_in[2])[c];
    st = static_cast<const unsigned char*>(io.st_in[3])[c];
    att = static_cast<const int*>(io.st_in[4])[c];
    dec = static_cast<const int*>(io.st_in[5])[c];
  }
  __device__ void store(const Io& io, int c) const {
    static_cast<float*>(io.st_out[0])[c] = peak;
    static_cast<float*>(io.st_out[1])[c] = floor_;
    static_cast<float*>(io.st_out[2])[c] = avg;
    static_cast<unsigned char*>(io.st_out[3])[c] =
        static_cast<unsigned char>(st);
    static_cast<int*>(io.st_out[4])[c] = att;
    static_cast<int*>(io.st_out[5])[c] = dec;
  }
  __device__ __forceinline__ void step(float4 p, float* o) {
    const float pm = p.x;
    const float peak2 =
        __fadd_rn(peak, __fmul_rn(pm > peak ? aa : da, __fsub_rn(pm, peak)));
    float floor2 = __fadd_rn(
        floor_, __fmul_rn(pm < floor_ ? aa : fa, __fsub_rn(pm, floor_)));
    if (MODE == kNoise && st) floor2 = floor_;
    const float avg2 = __fadd_rn(__fmul_rn(keep, avg), __fmul_rn(va, pm));
    bool raw;
    if (MODE == kCompare) {
      const float mean = __fmul_rn(__fadd_rn(p.y, p.z), 0.5f);
      raw = pm > __fmul_rn(ratio, fmaxf(mean, 1e-18f));
    } else if (MODE == kPeak) {
      const float delta = __fsub_rn(peak2, floor2);
      const float up = __fadd_rn(floor2, __fmul_rn(0.67f, delta));
      const float down = __fadd_rn(floor2, __fmul_rn(0.33f, delta));
      raw = pm >= up ? true : (pm <= down ? false : st != 0);
    } else if (MODE == kAverage) {
      raw = pm > __fmul_rn(ratio, avg2);
    } else if (MODE == kMinMax) {
      const bool valid = peak2 > __fmul_rn(ratio, fmaxf(floor2, 1e-18f));
      raw = valid &&
            pm > __fadd_rn(floor2, __fmul_rn(0.6f, __fsub_rn(peak2, floor2)));
    } else if (MODE == kManual) {
      raw = pm > ratio;
    } else {  // noise
      raw = pm > __fmul_rn(ratio, fmaxf(floor2, 1e-18f));
    }
    int att2 = (raw && !st) ? att + 1 : 0;
    int dec2 = (!raw && st) ? dec + 1 : 0;
    const bool on = att2 >= attack_frames, off = dec2 >= decay_frames;
    st = on ? 1 : (off ? 0 : st);
    att = on ? 0 : att2;
    dec = off ? 0 : dec2;
    o[0] = st ? 1.f : 0.f;
    peak = peak2;
    floor_ = floor2;
    avg = avg2;
  }
};

// K7: siggen.sweep's step.  The phase advances by f / fs as XLA compiles
// the JAX step (the product with the float32 reciprocal fused with the add:
// one rounding), modulo 1 as jnp.mod takes it (fmod, plus 1 where the
// remainder is negative); the frequency steps by d df and wraps to start
// past stop (mode 1), clips to [lo, hi] (mode 0) or turns at either edge
// and clips to [start, stop] (mode 2); with period > 0 the sample is on
// for the first pulse_on of each period (the counter's jnp.mod as a
// compare, % only for a counter out of range: an integer % every step
// doubled the pulsed kernel's time).  Outputs the sample's phase, or -1
// where it is off: what the kernel stores, so the chain probe keeps the
// phase's and the counter's chains.
struct SweepStep {
  using In = float;  // no input stream: the probe's filler
  static constexpr int kOut = 1;
  float inv_fs, df, start, stop, lo, hi;
  int mode, pulse_on, period;
  float ph, f, d;
  int pc;

  __device__ __forceinline__ void step(float, float* o) {
    ph = fmodf(__fmaf_rn(f, inv_fs, ph), 1.f);
    if (ph < 0.f) ph = __fadd_rn(ph, 1.f);
    float f2 = __fadd_rn(f, __fmul_rn(d, df));
    if (mode == 0) {
      f2 = fminf(fmaxf(f2, lo), hi);
    } else if (mode == 1) {
      if (f2 > stop) f2 = start;
    } else {
      if (f2 > stop || f2 < start) d = -d;
      f2 = fminf(fmaxf(f2, start), stop);
    }
    bool on = true;
    if (period > 0) {
      on = pc < pulse_on;
      if (++pc >= period || pc < 0) {
        pc %= period;
        if (pc < 0) pc += period;
      }
    }
    o[0] = on ? ph : -1.f;
    f = f2;
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block: kCb channels from blockIdx.x * kCb, all N samples.
template <class Step>
__global__ void __launch_bounds__(kThreads) recur_kernel(Io io, Step s) {
  using In = typename Step::In;
  constexpr int kInPitch = kTile + kPad / static_cast<int>(sizeof(In));
  constexpr int kOutPitch = kTile + kPad / 4;
  __shared__ __align__(16) In in_s[2][kCb][kInPitch];
  __shared__ __align__(16) float out_s[2][Step::kOut][kCb][kOutPitch];

  const int c0 = blockIdx.x * kCb;
  const int cb = min(kCb, io.C - c0);
  const int N = io.N;
  const int tiles = (N + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int st = tid - 32;      // stager index (warps 1-3)
  const In* x = static_cast<const In*>(io.x);

  auto load_tile = [&](int i) {
    const int t0 = i * kTile, len = min(kTile, N - t0);
    for (int c = 0; c < cb; ++c) {
      const In* src = x + static_cast<size_t>(c0 + c) * N + t0;
      for (int t = st; t < len; t += kStagers)
        cp_async(&in_s[i & 1][c][t], src + t, sizeof(In));
    }
    cp_async_commit_wait();
  };
  auto store_tile = [&](int i) {
    const int t0 = i * kTile, len = min(kTile, N - t0);
    for (int k = 0; k < Step::kOut; ++k)
      for (int c = 0; c < cb; ++c) {
        float* dst = io.out[k] + static_cast<size_t>(c0 + c) * N + t0;
        for (int t = st; t < len; t += kStagers)
          dst[t] = out_s[i & 1][k][c][t];
      }
  };

  if (tid < cb) s.load(io, c0 + tid);
  if (st >= 0 && tiles > 0) load_tile(0);
  __syncthreads();
  for (int i = 0; i < tiles; ++i) {
    if (st >= 0) {
      if (i + 1 < tiles) load_tile(i + 1);
      if (i > 0) store_tile(i - 1);
    } else if (tid < cb) {
      const int len = min(kTile, N - i * kTile);
      const In* src = in_s[i & 1][tid];
      float o[2];
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        s.step(src[t], o);
        out_s[i & 1][0][tid][t] = o[0];
        if (Step::kOut > 1) out_s[i & 1][Step::kOut - 1][tid][t] = o[1];
      }
    }
    __syncthreads();
  }
  if (st >= 0 && tiles > 0) store_tile(tiles - 1);
  if (tid < cb) s.store(io, c0 + tid);
}

// K7's design: one sequence, no input.  Thread 0 runs the chain over
// tiles of kSwTile samples into a shared buffer (the phase, or -1 where the
// pulse is off); the other warps turn the tile before it into samples,
// amp (cos 2 pi ph, sin 2 pi ph), and store them, double-buffered with one
// barrier a tile.  The chain (~10 dependent operations a sample) bounds it;
// the samples' sincosf and 8-byte stores are spread over 96 threads.
constexpr int kSwTile = 1024;

__global__ void __launch_bounds__(kThreads)
    recur_sweep_kernel(SweepStep s, int n, float two_pi, float amp,
                       const float* __restrict__ ph_in,
                       const float* __restrict__ f_in,
                       const float* __restrict__ d_in,
                       const int* __restrict__ pc_in,
                       float2* __restrict__ y, float* __restrict__ ph_out,
                       float* __restrict__ f_out, float* __restrict__ d_out,
                       int* __restrict__ pc_out) {
  __shared__ float ph_s[2][kSwTile];
  const int tiles = (n + kSwTile - 1) / kSwTile;
  const int tid = threadIdx.x;
  const int wk = tid - 32;           // writer index (warps 1-3)
  if (tid == 0) {
    s.ph = *ph_in;
    s.f = *f_in;
    s.d = *d_in;
    s.pc = *pc_in;
  }
  for (int i = 0; i <= tiles; ++i) {
    if (tid == 0 && i < tiles) {
      const int len = min(kSwTile, n - i * kSwTile);
      float* dst = ph_s[i & 1];
#pragma unroll 4
      for (int t = 0; t < len; ++t) s.step(0.f, &dst[t]);
    } else if (wk >= 0 && i > 0) {
      const int j = i - 1, t0 = j * kSwTile, len = min(kSwTile, n - t0);
      const float* src = ph_s[j & 1];
      for (int t = wk; t < len; t += kStagers) {
        const float p = src[t];
        float2 v = make_float2(0.f, 0.f);
        if (p >= 0.f) {
          float sn, cs;
          sincosf(__fmul_rn(two_pi, p), &sn, &cs);
          v = make_float2(__fmul_rn(cs, amp), __fmul_rn(sn, amp));
        }
        y[t0 + t] = v;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    *ph_out = s.ph;
    *f_out = s.f;
    *d_out = s.d;
    *pc_out = s.pc;
  }
}

// K7's serial floor: recur_sweep_kernel's chain loop alone, one thread
// storing each step's output into a shared ring as the kernel stores its
// tile (no writers, no device stores; the ring is summed at the end so no
// store is dead).  The generic probe_kernel's dependent sum of the outputs
// compiles to a slower loop than the kernel's own.
__global__ void __launch_bounds__(1)
    probe_sweep_kernel(SweepStep s, int steps, float* out) {
  __shared__ float ring[kSwTile];
#pragma unroll 4
  for (int t = 0; t < steps; ++t) s.step(0.f, &ring[t & (kSwTile - 1)]);
  float acc = 0.f;
  for (int t = 0; t < min(steps, kSwTile); ++t) acc = __fadd_rn(acc, ring[t]);
  out[0] = acc;
}

// K5: the adaptive IQ balance (scanops.auto_iq_balance) per group of
// kIqGroup samples: the group's y = x + w conj(x) with w held, then w' = w
// - mu mean(y^2).  mean(y^2) = S2 + 2 w P + w^2 conj(S2) with S2 = mean(x^2)
// and P = mean(|x|^2), which do not depend on w, so the chain is this step
// on the group sums (s2r, s2i, p, unused).  Outputs the w the group used.
struct IqStep {
  using In = float4;
  static constexpr int kOut = 2;
  float mu;
  float wr, wi;

  __device__ __forceinline__ void step(float4 s, float* o) {
    o[0] = wr;
    o[1] = wi;
    const float w2r = __fsub_rn(__fmul_rn(wr, wr), __fmul_rn(wi, wi));
    const float w2i = __fmul_rn(2.f, __fmul_rn(wr, wi));
    const float mr = __fadd_rn(
        __fadd_rn(s.x, __fmul_rn(2.f, __fmul_rn(wr, s.z))),
        __fadd_rn(__fmul_rn(w2r, s.x), __fmul_rn(w2i, s.y)));
    const float mi = __fadd_rn(
        __fadd_rn(s.y, __fmul_rn(2.f, __fmul_rn(wi, s.z))),
        __fsub_rn(__fmul_rn(w2i, s.x), __fmul_rn(w2r, s.y)));
    wr = __fsub_rn(wr, __fmul_rn(mu, mr));
    wi = __fsub_rn(wi, __fmul_rn(mu, mi));
  }
};

// K5's design.  The loop is serial over a channel's groups but its sums
// and its output are not, so a block serves one channel row and splits the
// work by warps: warp 0's lane 0 runs the chain, warps 1-8 (kIqWorkers
// threads) stream the row in tiles of kIqTile samples, as float4 pairs of
// samples: worker w takes float4 w + kIqWorkers k of the tile, so each
// access of a warp is 32 consecutive float4 (coalesced in device memory,
// no bank conflict in shared memory) and covers exactly one group of 64
// samples, whose sums a warp reduction forms.  Iteration i of the block's
// loop, with one barrier at its end:
//   * the workers issue the cp.async copies of tile i + 1 into shared
//     buffer (i + 1) % 4, wait for their own copies of tile i, form its
//     group sums into sums[i % 2], and write tile i - 2's y from buffer
//     (i - 2) % 4 with the weights ws[(i - 2) % 2];
//   * the chain thread runs tile i - 1's groups from sums[(i - 1) % 2]
//     into ws[(i - 1) % 2].
// So a tile's copies are in flight for a whole iteration, its sums and
// stores overlap the chain of the tile before, and x is read from device
// memory once.  What bounds it: x read and y written once (1 GiB at
// [64, 1048576], 0.32 ms at 3.35 TB/s) and, about as long, the chain's
// 16,384 dependent steps per channel.
constexpr int kIqGroup = 64;
constexpr int kIqWorkers = 256;
constexpr int kIqThreads = kIqWorkers + 32;
constexpr int kIqTile = 4096;                       // samples per tile
constexpr int kIqVecs = kIqTile / 2;                // float4 per tile
constexpr int kIqPer = kIqVecs / kIqWorkers;        // float4 per worker: 8
constexpr int kIqTileGroups = kIqTile / kIqGroup;   // 64
constexpr int kIqBufs = 4;
constexpr size_t kIqSmem = kIqBufs * kIqTile * sizeof(float2) +
                           2 * 3 * kIqTileGroups * sizeof(float) +
                           2 * kIqTileGroups * sizeof(float2);

__global__ void __launch_bounds__(kIqThreads)
    recur_iq_lms_kernel(const float2* __restrict__ x, int N, float mu,
                        const float2* __restrict__ w_in,
                        float2* __restrict__ y, float2* __restrict__ w_out) {
  extern __shared__ __align__(16) unsigned char iq_smem[];
  float2* xs = reinterpret_cast<float2*>(iq_smem);           // [3][tile]
  float* sums = reinterpret_cast<float*>(xs + kIqBufs * kIqTile);
  float2* ws = reinterpret_cast<float2*>(sums + 2 * 3 * kIqTileGroups);

  const int c = blockIdx.x;
  const float2* xrow = x + static_cast<size_t>(c) * N;
  float2* yrow = y + static_cast<size_t>(c) * N;
  const int tiles = (N + kIqTile - 1) / kIqTile;
  const int tid = threadIdx.x;
  const int wk = tid - 32;                 // worker index (warps 1-8)
  IqStep chain{mu, 0.f, 0.f};
  if (tid == 0) {
    chain.wr = w_in[c].x;
    chain.wi = w_in[c].y;
  }

  auto stage = [&](int i) {    // tile i's float4s into buffer i % 4
    if (i < tiles) {
      const int len = min(kIqTile, N - i * kIqTile);
      const float4* src = reinterpret_cast<const float4*>(xrow + i * kIqTile);
      float4* dst = reinterpret_cast<float4*>(xs + (i % kIqBufs) * kIqTile);
#pragma unroll
      for (int k = 0; k < kIqPer; ++k) {
        const int q = wk + k * kIqWorkers;
        if (2 * q < len) cp_async(dst + q, src + q, 16);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);   // empty past the end
  };
  if (wk >= 0) stage(0);

  for (int i = 0; i < tiles + 2; ++i) {
    if (wk >= 0) {
      if (i < tiles) {
        stage(i + 1);
        // tile i's copies (this thread's own float4s) have landed
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        const int t0 = i * kIqTile, len = min(kIqTile, N - t0);
        const float4* xv =
            reinterpret_cast<const float4*>(xs + (i % kIqBufs) * kIqTile);
        float* sm = sums + (i & 1) * 3 * kIqTileGroups;
#pragma unroll
        for (int k = 0; k < kIqPer; ++k) {
          const int q = wk + k * kIqWorkers;
          if (2 * q >= len) break;
          const float4 v = xv[q];
          float ar = __fadd_rn(
              __fsub_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
              __fsub_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
          float ai = __fadd_rn(__fmul_rn(2.f, __fmul_rn(v.x, v.y)),
                               __fmul_rn(2.f, __fmul_rn(v.z, v.w)));
          float ap = __fadd_rn(
              __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
              __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            ar = __fadd_rn(ar, __shfl_xor_sync(0xffffffffu, ar, off));
            ai = __fadd_rn(ai, __shfl_xor_sync(0xffffffffu, ai, off));
            ap = __fadd_rn(ap, __shfl_xor_sync(0xffffffffu, ap, off));
          }
          if ((wk & 31) == 0) {
            const int g = q >> 5;              // 32 float4 per group
            constexpr float inv = 1.f / kIqGroup;
            sm[g] = __fmul_rn(ar, inv);
            sm[kIqTileGroups + g] = __fmul_rn(ai, inv);
            sm[2 * kIqTileGroups + g] = __fmul_rn(ap, inv);
          }
        }
      }
      if (i >= 2) {
        const int j = i - 2, t0 = j * kIqTile, len = min(kIqTile, N - t0);
        const float4* src =
            reinterpret_cast<const float4*>(xs + (j % kIqBufs) * kIqTile);
        float4* dst = reinterpret_cast<float4*>(yrow + t0);
        const float2* wj = ws + (j & 1) * kIqTileGroups;
#pragma unroll
        for (int k = 0; k < kIqPer; ++k) {
          const int q = wk + k * kIqWorkers;
          if (2 * q >= len) break;
          const float2 w = wj[q >> 5];
          const float4 v = src[q];
          // y = x + w conj(x) = (xr + (wr xr + wi xi), xi + (wi xr - wr xi))
          float4 o;
          o.x = __fadd_rn(v.x, __fadd_rn(__fmul_rn(w.x, v.x),
                                         __fmul_rn(w.y, v.y)));
          o.y = __fadd_rn(v.y, __fsub_rn(__fmul_rn(w.y, v.x),
                                         __fmul_rn(w.x, v.y)));
          o.z = __fadd_rn(v.z, __fadd_rn(__fmul_rn(w.x, v.z),
                                         __fmul_rn(w.y, v.w)));
          o.w = __fadd_rn(v.w, __fsub_rn(__fmul_rn(w.y, v.z),
                                         __fmul_rn(w.x, v.w)));
          dst[q] = o;
        }
      }
    } else if (tid == 0 && i >= 1 && i <= tiles) {
      const int j = i - 1;
      const int groups = min(kIqTile, N - j * kIqTile) / kIqGroup;
      const float* sm = sums + (j & 1) * 3 * kIqTileGroups;
      float2* wo = ws + (j & 1) * kIqTileGroups;
      float o[2];
#pragma unroll 4
      for (int g = 0; g < groups; ++g) {
        chain.step(make_float4(sm[g], sm[kIqTileGroups + g],
                               sm[2 * kIqTileGroups + g], 0.f),
                   o);
        wo[g] = make_float2(o[0], o[1]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) w_out[c] = make_float2(chain.wr, chain.wi);
}

// K8: the ANF's leaky block LMS (scanops.anf) on one real row.  full = [the
// carried history (H = delay + taps - 1 samples), x]; for update i of U
// samples, with the weights w held:
//   pred[m] = sum_k full[iU + m + k] w[k]    (x delayed by delay..H)
//   err[m]  = x[iU + m] - pred[m]            (the output is pred)
//   w'      = leak w + alpha sum_m err[m] full[iU + m + k],  alpha = 2 rate/U.
// The frames never depend on w and output m reads x only up to m - delay,
// so the one serial state is the taps-long weight vector: updates run one
// after another, the work inside an update does not.
//
// Design: one block of kAnfThreads per row (2C rows for C complex
// channels).  The row streams through a shared ring of kAnfRing floats in
// slabs of kAnfSlab samples by cp.async, issued as far ahead as the ring
// allows (16-byte copies where N % 4 == 0, else 4-byte); the history sits
// just below x in the ring, so every frame is a ring read.  An update runs
// in pieces of at most kAnfPiece outputs (the U = 16 of the staged front
// is one piece; U = 1024 of the batched graph one; larger U several, the
// gradient summed across them), each in two phases with a barrier after
// each:
//   * predictions: G lanes per output (G = 32 ... 1 as U grows, so a small
//     update still spreads over the block), each lane a stride-G share of
//     the taps, summed by G-lane shuffles; the output goes to y, the error
//     to shared memory;
//   * gradient: thread k (< taps) of each of kAnfSlices slices sums err[m]
//     frame[m][k] over its slice of the piece; after the barrier thread k
//     adds the slices and, at the update's last piece, sets w'[k] (held in
//     its register and in shared memory for the next predictions).
// No atomics: every sum has a fixed order, so a launch repeats its bits.
// What bounds it: at U = 16 the chain of 2048 updates per dispatch, each
// ~14 dependent float32 operations (probe_anf_kernel); at large U the ~4
// float32 operations per tap and sample; the bytes (x read, y written
// once) are ~0.01 ms at [128, 32768].  This design adds three barriers of
// four warps and the shuffles to every update, far above that chain.
constexpr int kAnfThreads = 128;
constexpr int kAnfMaxTaps = 64;
constexpr int kAnfSlices = kAnfThreads / kAnfMaxTaps;   // 2
constexpr int kAnfSlab = 1024;        // samples per staged slab
constexpr int kAnfRing = 8192;        // ring floats (32 KB)
constexpr int kAnfMask = kAnfRing - 1;
constexpr int kAnfPiece = 2048;       // outputs per piece at most
constexpr int kAnfMaxHist = 124;      // H, so that H rounded up to 4 <= 128
static_assert(kAnfPiece + kAnfSlab + kAnfMaxHist <= kAnfRing,
              "a piece's window and the slab after it must fit the ring");

struct AnfShared {
  float ring[kAnfRing];            // full[p] at ring[(p + o) & kAnfMask]
  float err[kAnfPiece];            // the piece's errors
  float w[kAnfMaxTaps];            // the weights the predictions read
  float part[kAnfSlices][kAnfMaxTaps];   // the gradient slices' sums
};

// One piece of an update: outputs base .. base + len - 1 (x indices) with
// the weights in sm.w; o = HP - H places full position p at ring p + o and
// x index j at j + HP.  Thread k < taps keeps w[k] in wk and the update's
// gradient so far in gacc; at the update's last piece (last) it sets w'.
__device__ __forceinline__ void anf_piece(AnfShared& sm, float* y, int base,
                                          int len, bool last, int taps,
                                          int o, int hp, float alpha,
                                          float leak, float& wk,
                                          float& gacc) {
  const int tid = threadIdx.x;
  int g = 32;
  while (g > 1 && g * len > kAnfThreads) g >>= 1;
  const int per = kAnfThreads / g, sub = tid % g, slot = tid / g;
  for (int m0 = 0; m0 < len; m0 += per) {
    const int m = m0 + slot;
    float acc = 0.f;
    if (m < len) {
      const int p = base + m + o;
#pragma unroll 4
      for (int k = sub; k < taps; k += g)
        acc = fmaf(sm.ring[(p + k) & kAnfMask], sm.w[k], acc);
    }
    for (int d = g >> 1; d > 0; d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (m < len && sub == 0) {
      sm.err[m] = sm.ring[(base + m + hp) & kAnfMask] - acc;
      y[base + m] = acc;
    }
  }
  __syncthreads();
  const int k = tid % kAnfMaxTaps, q = tid / kAnfMaxTaps;
  const int span = (len + kAnfSlices - 1) / kAnfSlices;
  const int lo = q * span, hi = min(len, lo + span);
  float gs = 0.f;
  if (k < taps) {
    const int p = base + k + o;
#pragma unroll 4
    for (int m = lo; m < hi; ++m)
      gs = fmaf(sm.err[m], sm.ring[(p + m) & kAnfMask], gs);
  }
  sm.part[q][k] = gs;
  __syncthreads();
  if (tid < taps) {
    float s = sm.part[0][tid];
#pragma unroll
    for (int j = 1; j < kAnfSlices; ++j) s += sm.part[j][tid];
    gacc += s;
    if (last) {
      wk = fmaf(alpha, gacc, leak * wk);
      sm.w[tid] = wk;
      gacc = 0.f;
    }
  }
  __syncthreads();
}

struct AnfArgs {
  const float* x;       // [R, N]
  const float* w;       // [R, taps]
  const float* hist;    // [R, H]
  float* y;             // [R, N]
  float* w_out;         // [R, taps]
  float* hist_out;      // [R, H]
  int N, U, taps, H;
  float alpha, leak;
};

__global__ void __launch_bounds__(kAnfThreads) recur_anf_kernel(AnfArgs a) {
  __shared__ __align__(16) AnfShared sm;
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* xr = a.x + static_cast<size_t>(r) * a.N;
  float* yr = a.y + static_cast<size_t>(r) * a.N;
  const int hp = (a.H + 3) & ~3, o = hp - a.H;
  const bool vec = (a.N % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  for (int h = tid; h < a.H; h += kAnfThreads)
    sm.ring[o + h] = a.hist[static_cast<size_t>(r) * a.H + h];
  float wk = 0.f, gacc = 0.f;
  if (tid < a.taps) {
    wk = a.w[static_cast<size_t>(r) * a.taps + tid];
    sm.w[tid] = wk;
  }
  const int slabs = (a.N + kAnfSlab - 1) / kAnfSlab;
  int issued = 0, landed = 0;
  const int updates = a.U > 0 ? a.N / a.U : 0;
  for (int i = 0; i < updates; ++i) {
    for (int m0 = 0; m0 < a.U; m0 += kAnfPiece) {
      const int len = min(kAnfPiece, a.U - m0);
      const int base = i * a.U + m0;
      // issue every slab whose ring slots no longer hold a sample this
      // piece or a later one reads (full positions >= base)
      while (issued < slabs &&
             (issued + 1) * kAnfSlab + a.H - base <= kAnfRing) {
        const int j0 = issued * kAnfSlab, n = min(kAnfSlab, a.N - j0);
        if (vec) {
          for (int q = 4 * tid; q < n; q += 4 * kAnfThreads)
            cp_async(&sm.ring[(hp + j0 + q) & kAnfMask], xr + j0 + q, 16);
        } else {
          for (int q = tid; q < n; q += kAnfThreads)
            cp_async(&sm.ring[(hp + j0 + q) & kAnfMask], xr + j0 + q, 4);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        ++issued;
      }
      const int need = (base + len + kAnfSlab - 1) / kAnfSlab;
      if (landed < need) {
        // the slabs after `need` may stay in flight (at most two waited
        // on: wait_group takes a constant)
        const int pend = issued - need;
        if (pend >= 2) {
          asm volatile("cp.async.wait_group 2;\n" ::: "memory");
          landed = issued - 2;
        } else if (pend == 1) {
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          landed = issued - 1;
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          landed = issued;
        }
        __syncthreads();
      }
      anf_piece(sm, yr, base, len, m0 + len == a.U, a.taps, o, hp, a.alpha,
                a.leak, wk, gacc);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid < a.taps) a.w_out[static_cast<size_t>(r) * a.taps + tid] = wk;
  // hist' = the last H samples of full = [hist, x]
  for (int h = tid; h < a.H; h += kAnfThreads) {
    const int p = a.N + h;
    a.hist_out[static_cast<size_t>(r) * a.H + h] =
        p < a.H ? a.hist[static_cast<size_t>(r) * a.H + p] : xr[p - a.H];
  }
}

// K8's serial floor: one thread runs `steps` updates' dependent chain on
// registers, with no barriers, no shuffles and no memory inside the loop.
// Only the weights carry from one update to the next, so the chain of an
// update is what no design can take off it: a tap's product w[k] f[k] and
// the 6 levels of the 45-tap sum's tree (the prediction), the error, a
// gradient term err f[k] and the Lg = ceil(log2 U) levels of the U-term
// sum's tree, and the leaky FMA (leak w[k] is off the chain).  The other
// taps and outputs are independent of this chain and are counted as
// operations (utils/roofline.py anf_scan_bound), not here.  Each tree
// level is one dependent add (with __fadd_rn, which the compiler neither
// contracts nor reassociates); the constants keep w finite.
template <int Lg>
__global__ void __launch_bounds__(1) probe_anf_kernel(int steps,
                                                      float* out) {
  const float f = 0.37f, x = 0.5f, alpha = 2e-3f, leak = 1.f - 1e-5f;
  float w = 0.f;
  for (int t = 0; t < steps; ++t) {
    float s = __fmul_rn(w, f);
#pragma unroll
    for (int l = 0; l < 6; ++l) s = __fadd_rn(s, 1e-3f * (l + 1));
    float g = __fmul_rn(__fsub_rn(x, s), f);
#pragma unroll
    for (int l = 0; l < Lg; ++l) g = __fadd_rn(g, 1e-4f * (l + 1));
    w = __fmaf_rn(alpha, g, __fmul_rn(leak, w));
  }
  out[0] = w;
}

// The serial floor's probe: one thread runs `steps` steps of a Step's
// chain on inputs held in registers (x fixed for the loops, which then
// lock, a square wave for the AGC), with no shared or device memory inside
// the loop, and writes a sum of its outputs at the end (so the compiler
// keeps every step).  One thread, so no divergence in the math library's
// branches; its time over `steps` is the latency of one step's dependent
// chain.
__device__ __forceinline__ void probe_input(float2& x, int) {
  x = make_float2(0.5f, 0.1f);
}
__device__ __forceinline__ void probe_input(float& x, int t) {
  x = (t & 256) ? -1.f : -3.f;
}
__device__ __forceinline__ void probe_input(float4& x, int) {
  x = make_float4(0.25f, 0.1f, 1.f, 0.f);   // group sums S2, P
}

template <class Step>
__global__ void __launch_bounds__(1) probe_kernel(Step s, int steps,
                                                  float* out) {
  typename Step::In x;
  float acc = 0.f, o[2];
  for (int t = 0; t < steps; ++t) {
    probe_input(x, t);
    s.step(x, o);
    acc = __fadd_rn(acc, o[Step::kOut - 1]);
  }
  out[0] = acc;
}

template <class Step>
int probe(const Step& s, int steps, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  probe_kernel<Step><<<1, 1, 0, (cudaStream_t)stream>>>(s, steps, out);
  return cudaGetLastError();
}

template <class Step>
int launch(const Io& io, const Step& s, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (io.C <= 0 || io.N < 0) return cudaErrorInvalidValue;
  const int grid = (io.C + kCb - 1) / kCb;
  recur_kernel<Step><<<grid, kThreads, 0, (cudaStream_t)stream>>>(io, s);
  return cudaGetLastError();
}

// The chain probe of ook_scan in threshold mode `mode` (ratio 4; the
// probe's input is one frame of powers held in registers).
int probe_ook(int mode, int steps, float* out, int device, void* stream) {
  switch (mode) {
#define OOK_PROBE(M)                                                       \
  case M:                                                                  \
    return probe(OokStep<M>{0.4f, 0.02f, 0.002f, 0.99f, 0.01f, 4.f, 2, 2,  \
                            1e-6f, 1e-6f, 1e-6f, 0, 0, 0},                 \
                 steps, out, device, stream);
    OOK_PROBE(kCompare)
    OOK_PROBE(kPeak)
    OOK_PROBE(kAverage)
    OOK_PROBE(kMinMax)
    OOK_PROBE(kManual)
    OOK_PROBE(kNoise)
#undef OOK_PROBE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* recur_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Channels per block and threads per block of every launch (the wrappers
// report them; the grid is ceil(C / channels)).
int recur_channels_per_block() { return kCb; }
int recur_threads_per_block() { return kThreads; }

// K3: x [C, N] complex64 (re, im interleaved), state phase / fdev / amp
// [C] -> phases, freqs [C, N] and state'.  det: 0 atan2, 1 cross, 2 costas,
// 3 pilot.  Returns the first CUDA error.
int recur_pll_scan(int device, int det, const void* x, int C, int N,
                   float alpha, float beta, float wc, float dev_lo,
                   float dev_hi, const float* phase, const float* fdev,
                   const float* amp, float* phases, float* freqs,
                   float* phase_out, float* fdev_out, float* amp_out,
                   void* stream) {
  Io io{x, {phases, freqs}, {phase, fdev, amp},
        {phase_out, fdev_out, amp_out}, C, N};
  switch (det) {
#define PLL_CASE(D)                                                      \
  case D: {                                                              \
    PllStep<D> s{alpha, beta, wc, dev_lo, dev_hi, 0.f, 0.f, 0.f};        \
    return launch(io, s, device, stream);                                \
  }
    PLL_CASE(kAtan2)
    PLL_CASE(kCross)
    PLL_CASE(kCostas)
    PLL_CASE(kPilot)
#undef PLL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// K3c: z [C, F] complex64 chunk phasors, state [C] -> offs, fdevs [C, F]
// and state'; pilot != 0 rotates each derotated phasor by j.
int recur_pll_chunk_scan(int device, int pilot, const void* z, int C, int F,
                         float alpha, float beta, float dev_lo, float dev_hi,
                         const float* phase, const float* fdev,
                         const float* amp, float* offs, float* fdevs,
                         float* phase_out, float* fdev_out, float* amp_out,
                         void* stream) {
  Io io{z, {offs, fdevs}, {phase, fdev, amp}, {phase_out, fdev_out, amp_out},
        C, F};
  ChunkStep s{alpha, beta, dev_lo, dev_hi, pilot, 0.f, 0.f, 0.f};
  return launch(io, s, device, stream);
}

// K4: env [C, M] float32, state att / dec [C] float32 and hang [C] int32 ->
// levels [C, M] and state'; hang != 0 runs the hang timer (hold while
// hang' <= hang_samples).
int recur_agc_scan(int device, int hang, const float* env, int C, int M,
                   float rise, float fall, float drise, float dfall,
                   int hang_samples, const float* att, const float* dec,
                   const int* hang_in, float* levels, float* att_out,
                   float* dec_out, int* hang_out, void* stream) {
  Io io{env, {levels, nullptr}, {att, dec, hang_in},
        {att_out, dec_out, hang_out}, C, M};
  if (hang) {
    AgcStep<true> s{rise, fall, drise, dfall, hang_samples, 0.f, 0.f, 0};
    return launch(io, s, device, stream);
  }
  AgcStep<false> s{rise, fall, drise, dfall, hang_samples, 0.f, 0.f, 0};
  return launch(io, s, device, stream);
}

// K5: x [C, N] complex64 (N a multiple of 64, 16-byte aligned), the weight
// w [C] complex64 -> y [C, N] complex64 and w' [C]; mu the LMS step.  One
// block per channel.  Returns the first CUDA error.
int recur_iq_lms_scan(int device, const void* x, int C, int N, float mu,
                      const void* w, void* y, void* w_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C <= 0 || N < 0 || N % kIqGroup) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(recur_iq_lms_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kIqSmem));
  if (err != cudaSuccess) return err;
  recur_iq_lms_kernel<<<C, kIqThreads, kIqSmem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(x), N, mu, static_cast<const float2*>(w),
      static_cast<float2*>(y), static_cast<float2*>(w_out));
  return cudaGetLastError();
}

// K6: p [C, F] float4 frames (main, low, high, 0 bin powers), the state
// peak / floor / avg [C] float32, st [C] uint8, att / dec [C] int32 ->
// marks [C, F] float32 (1 or 0) and state'.  mode: 0 compare, 1 peak, 2
// average, 3 min_max, 4 manual, 5 noise; ratio is the mode's parameter.
int recur_ook_scan(int device, int mode, const void* p, int C, int F,
                   float aa, float da, float fa, float keep, float va,
                   float ratio, int attack_frames, int decay_frames,
                   const float* peak, const float* floor_, const float* avg,
                   const unsigned char* st, const int* att, const int* dec,
                   float* marks, float* peak_out, float* floor_out,
                   float* avg_out, unsigned char* st_out, int* att_out,
                   int* dec_out, void* stream) {
  Io io{p, {marks, nullptr}, {peak, floor_, avg, st, att, dec},
        {peak_out, floor_out, avg_out, st_out, att_out, dec_out}, C, F};
  switch (mode) {
#define OOK_CASE(M)                                                        \
  case M: {                                                                \
    OokStep<M> s{aa, da, fa, keep, va, ratio, attack_frames, decay_frames, \
                 0.f, 0.f, 0.f, 0, 0, 0};                                  \
    return launch(io, s, device, stream);                                  \
  }
    OOK_CASE(kCompare)
    OOK_CASE(kPeak)
    OOK_CASE(kAverage)
    OOK_CASE(kMinMax)
    OOK_CASE(kManual)
    OOK_CASE(kNoise)
#undef OOK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// K7: n samples of the sweep from the state ph / f / d (float32 scalars)
// and pc (int32), all on the device -> y [n] complex64 (interleaved) and
// state'.  mode: 0 single, 1 repeat, 2 repeat_reverse; period 0: no
// pulses.  One block.
int recur_sweep_scan(int device, int mode, int n, float inv_fs, float df,
                     float start, float stop, float lo, float hi,
                     float two_pi, float amp, int pulse_on, int period,
                     const float* ph, const float* f, const float* d,
                     const int* pc, void* y, float* ph_out, float* f_out,
                     float* d_out, int* pc_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || mode < 0 || mode > 2 || period < 0)
    return cudaErrorInvalidValue;
  SweepStep s{inv_fs, df, start, stop, lo, hi, mode, pulse_on, period,
              0.f, 0.f, 0.f, 0};
  recur_sweep_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      s, n, two_pi, amp, ph, f, d, pc, static_cast<float2*>(y), ph_out,
      f_out, d_out, pc_out);
  return cudaGetLastError();
}

// K8: x [R, N] float32 rows, the weights w [R, taps] and the history hist
// [R, H] (H = delay + taps - 1) -> y [R, N] (the predictions), w' and hist';
// one weight update every U samples (N a multiple of U), alpha = 2 rate /
// U, leak the weights' leak.  One block per row.  Returns the first CUDA
// error.
int recur_anf_scan(int device, const float* x, int R, int N, int U,
                   int taps, int H, float alpha, float leak, const float* w,
                   const float* hist, float* y, float* w_out,
                   float* hist_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R <= 0 || N < 0 || U <= 0 || N % U || taps <= 0 ||
      taps > kAnfMaxTaps || H < taps - 1 || H > kAnfMaxHist)
    return cudaErrorInvalidValue;
  AnfArgs a{x, w, hist, y, w_out, hist_out, N, U, taps, H, alpha, leak};
  recur_anf_kernel<<<R, kAnfThreads, 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// K8's limits (the wrapper reads them): taps and history length at most.
int recur_anf_max_taps() { return kAnfMaxTaps; }
int recur_anf_max_hist() { return kAnfMaxHist; }

// Samples per K5 group and per tile (the wrapper and the tests read them).
int recur_iq_group() { return kIqGroup; }
int recur_iq_tile() { return kIqTile; }

// The serial floor's probe (probe_kernel) of one form: 0-3 pll_scan with
// detector 0-3, 4 pll_chunk_scan, 5 its pilot form, 6 agc_scan with the
// hang, 7 without, 8 iq_lms_scan, 9-14 ook_scan in the threshold mode 0-5,
// 15-17 sweep_scan in the mode 0-2 (no pulses: the floor of a pulsed call
// too, which only adds the counter), 18-20 anf_scan's update at U = 1, 16
// and 1024 (probe_anf_kernel: the time per step is per update); out [1]
// float32.  Time it over many
// steps: the time per step is the latency of the form's dependent chain.
int recur_probe(int device, int form, int steps, float* out, void* stream) {
  const float a = 0.0139f, b = 9.6e-5f, lo = -0.098f, hi = 0.098f;
  switch (form) {
    case 0: return probe(PllStep<kAtan2>{a, b, 0.03f, lo, hi, 0.f, 0.f, 1.f},
                         steps, out, device, stream);
    case 1: return probe(PllStep<kCross>{a, b, 0.03f, lo, hi, 0.f, 0.f, 1.f},
                         steps, out, device, stream);
    case 2: return probe(PllStep<kCostas>{a, b, 0.03f, lo, hi, 0.f, 0.f, 1.f},
                         steps, out, device, stream);
    case 3: return probe(PllStep<kPilot>{a, b, 0.03f, lo, hi, 0.f, 0.f, 1.f},
                         steps, out, device, stream);
    case 4:
    case 5:
      return probe(ChunkStep{0.1f, 0.01f, -0.5f, 0.5f, form == 5, 0.f, 0.f,
                             1.f},
                   steps, out, device, stream);
    case 6:
      return probe(AgcStep<true>{0.03f, 0.012f, 0.002f, 0.04f, 100, -8.f,
                                 -8.f, 0},
                   steps, out, device, stream);
    case 7:
      return probe(AgcStep<false>{0.03f, 0.012f, 0.002f, 0.002f, 0, -8.f,
                                  -8.f, 0},
                   steps, out, device, stream);
    case 8:
      return probe(IqStep{0.0025f, 0.f, 0.f}, steps, out, device, stream);
    case 15:
    case 16:
    case 17: {
      cudaError_t err = cudaSetDevice(device);
      if (err != cudaSuccess) return err;
      probe_sweep_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
          SweepStep{1.f / 48000.f, 2.0833333f, 100.f, 2000.f, 100.f, 2000.f,
                    form - 15, 0, 0, 0.f, 100.f, 1.f, 0},
          steps, out);
      return cudaGetLastError();
    }
    case 18:
    case 19:
    case 20: {
      cudaError_t err = cudaSetDevice(device);
      if (err != cudaSuccess) return err;
      if (form == 18)           // U = 1: no gradient tree
        probe_anf_kernel<0><<<1, 1, 0, (cudaStream_t)stream>>>(steps, out);
      else if (form == 19)      // U = 16
        probe_anf_kernel<4><<<1, 1, 0, (cudaStream_t)stream>>>(steps, out);
      else                      // U = 1024
        probe_anf_kernel<10><<<1, 1, 0, (cudaStream_t)stream>>>(steps, out);
      return cudaGetLastError();
    }
    default:
      if (form >= 9 && form <= 14) return probe_ook(form - 9, steps, out,
                                                   device, stream);
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
