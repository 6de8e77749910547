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
// would take ~0.01 ms at 3.35 TB/s for [64, 32768], the chain ~0.1-0.3 us
// a step.  The arithmetic is the JAX step's in IEEE float32: products and
// sums with round-to-nearest intrinsics (no FMA contraction, so each value
// is the plain version's op by op), sincosf / atan2f / hypotf / fmodf (no
// fast-math intrinsics): the phase integrates every step's rounding.  The
// wrap mod(a + pi, 2 pi) - pi takes an exact fast path for a + pi in
// [0, 4 pi) (one subtraction, exact by Sterbenz) and fmodf otherwise.
// K3 and K3c run on the loop kernel (recur_loop_kernel), K4 and K6, whose
// steps are shorter, on the short-chain kernel (recur_short_kernel): a
// chain warp whose lanes carry a channel each and a copy warp that feeds
// them through mbarrier stages, both below.
// K7 has one sequence and no input: one thread runs the chain into
// shared-memory tiles and the block's other warps turn each finished tile
// into samples (recur_sweep_kernel).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 128;     // K7: the chain thread's warp, 3 writers
constexpr int kStagers = kThreads - 32;

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
// sample and fdev' + wc.  The step is split where the loop state enters:
// amp_next and denom read no phase or fdev (the amp EWMA, and the costas
// and pilot detectors' denominators from amp'), so the loop kernel's copy
// warp computes them, and its chain lane runs chain alone, which carries
// phase and fdev.
template <int DET>
struct PllStep {
  using In = float2;
  static constexpr int kOut = 2;
  // whether chain reads denom's q (costas, pilot)
  static constexpr bool kDenom = DET == kCostas || DET == kPilot;
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
  static __device__ __forceinline__ float amp_next(float a, float2 x) {
    return __fadd_rn(a, __fmul_rn(1e-3f, __fsub_rn(hypotf(x.x, x.y), a)));
  }
  // costas: max(amp'^2, 1e-12); pilot: max((pi/4) amp', 1e-6)
  static __device__ __forceinline__ float denom(float amp2) {
    if (DET == kCostas) return fmaxf(__fmul_rn(amp2, amp2), 1e-12f);
    if (DET == kPilot) return fmaxf(__fmul_rn(kQuarterPi, amp2), 1e-6f);
    return 0.f;
  }
  // the state-dependent part: the detector on x and q = denom(amp'), the
  // clip, the add and the wrap
  __device__ __forceinline__ void chain(float2 x, float q, float* o) {
    float err;
    if (DET == kPilot) {
      // x ~= A sin(phase): Re(x) cos(phase) / max((pi/4) amp', 1e-6)
      err = __fdiv_rn(__fmul_rn(x.x, cosf(phase)), q);
    } else {
      // z = x e^{-j phase}
      float s, c;
      sincosf(phase, &s, &c);
      const float zr = __fadd_rn(__fmul_rn(x.x, c), __fmul_rn(x.y, s));
      const float zi = __fsub_rn(__fmul_rn(x.y, c), __fmul_rn(x.x, s));
      if (DET == kAtan2) {
        err = atan2f(zi, zr);
      } else if (DET == kCostas) {
        err = __fdiv_rn(__fmul_rn(zr, zi), q);
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
  }
  __device__ __forceinline__ void step(float2 x, float* o) {
    const float amp2 = amp_next(amp, x);
    chain(x, denom(amp2), o);
    amp = amp2;
  }
};

// K3c: the loop of pll.pll_run_blockwise over chunk phasors z.  amp' = amp
// + 0.05 (|z| - amp); zz = z e^{-j phase} (times j for the pilot); err =
// atan2(zz); fdev' = clip(fdev + beta err); phase' = wrap(phase + fdev' +
// alpha err).  Outputs the phase at the chunk and fdev'.  Split as
// PllStep (no detector reads amp').
template <bool PILOT>
struct ChunkStep {
  using In = float2;
  static constexpr int kOut = 2;
  static constexpr bool kDenom = false;
  float alpha, beta, dev_lo, dev_hi;
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
  static __device__ __forceinline__ float amp_next(float a, float2 z) {
    return __fadd_rn(a, __fmul_rn(0.05f, __fsub_rn(hypotf(z.x, z.y), a)));
  }
  static __device__ __forceinline__ float denom(float) { return 0.f; }
  __device__ __forceinline__ void chain(float2 z, float, float* o) {
    float s, c;
    sincosf(phase, &s, &c);
    float zr = __fadd_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s));
    float zi = __fsub_rn(__fmul_rn(z.y, c), __fmul_rn(z.x, s));
    if (PILOT) {          // zz * 1j = (-Im, Re)
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
  }
  __device__ __forceinline__ void step(float2 z, float* o) {
    const float amp2 = amp_next(amp, z);
    chain(z, 0.f, o);
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

// K6: goertzel.ook_detect's step over one frame's powers (main, low, high
// in the first three lanes; the fourth is unused).  The peak envelope moves
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

// K4's and K6's design: the short-chain kernel (recur_short_kernel).  Their
// steps are short chains of compares, selects and single float32
// operations (~12-38 ns a step on the H100, ops/pll.py chain_probe fed from
// memory), so a step's chain, not the bytes, bounds them; their first
// design (a tiled kernel: chain lanes beside staging warps, a block barrier
// a tile) lost 26-59 % of a launch to the chain lane's own shared-memory
// load and store each step (tools/recur_cells.py --sweep).
// Everything but the chain stays off it here:
//   * one block = kShLanes = 16 channels: a chain warp (lane r carries
//     channel c0 + r, its state in registers from before its first wait to
//     its last step) and a copy warp; 64 channels take 4 SMs, 256 take 16;
//   * the copy warp brings each segment of kShL frames (the whole row where
//     it is at most kShL frames long: the "pass" form, one load round trip
//     while the chain lanes load their state; else the "ring" form, rows
//     streamed through kShStages stages) into shared memory: lane r copies
//     row r's segment by one cp.async.bulk of the
//     16-byte lines the segment covers wholly, the <= 3 floats before and
//     after them element by element (bulk_ring.cuh; the row lands at its
//     slot's start plus its float offset in its 16-byte line), then lane 0
//     completes the stage's full mbarrier (two arrivals: one with the
//     stage's bytes before the copies, one after the element copies).  It
//     refills a stage once the chain warp has handed it back (its done
//     mbarrier, polled with a back-off so that its probes leave the
//     shared-memory pipe to the chain's loads);
//   * the chain lanes wait only on their stage's full barrier; no block
//     barrier inside the time loop.  Frames are read into registers one
//     group of kShU steps ahead of the chain, and each step's output goes
//     to the stage's output rows in shared memory (a store a group from
//     32 lanes to 32 rows of device memory held the chain up by 30-50 %:
//     the sweep's no_out variant of that design);
//   * in the ring form the copy warp writes a stage's outputs out once the
//     chain warp hands the stage back (a bulk store per row where the
//     row's segment is 16-byte sized and aligned); in the pass form the
//     chain warp writes the block's whole output region itself (its rows
//     are contiguous in both memories: the output rows' pitch is the row)
//     by coalesced 16-byte stores, with no hand-off at the end;
//   * the step (AgcStep, OokStep) is the plain version's float32 arithmetic
//     op for op: K4 and K6 equal their plain versions bit for bit.
// The input is one stream: row c's frame t at in + c cs + t fs (floats), a
// frame being fs floats (K4's envelope and a K6 plane: 1; the three columns
// of one [C, F, 3] tensor, the layout goertzel_power writes: 3).  K6 reads
// its powers where they lie: the main power is a frame's first float, and
// in compare mode low and high are its second and third ("the trio"; a
// plane has no compare bins: zero powers there).
// channels per block: the chain warp's lanes (the others leave), the rows
// of a stage (the sweep: 8 or 16 a block ran K4 and K6 up to 20 % faster
// than 32 in one warp, or than 32 in two or four warps of a block)
constexpr int kShLanes = 16;
constexpr int kShThreads = 64;    // the chain warp, then the copy warp
constexpr unsigned kShMask = 0xffffffffu >> (32 - kShLanes);   // chain lanes
constexpr int kShU = 4;           // steps per register group
constexpr int kShL = 128;         // frames per stage in the ring form
constexpr int kShStages = 3;      // stages in the ring form
constexpr int kShSmemMax = 227 * 1024;   // a block's shared memory at most
constexpr int kShPinBytes = 32;   // the pinned constants (sh_pin), first

// The launch's plan (short_plan): form 1 pass, 2 ring; L frames a stage;
// the dynamic shared memory holds the pinned constants, the stages' full
// and done mbarriers, the input stages (kShLanes rows of pitch floats
// each) and the output stages;
// pitch: floats per staged row (= 4 mod 32: the rows start in banks as
// far apart as 16-byte rows allow; room for the row's float offset in its
// 16-byte line and a register group read past the segment); out_pitch:
// bytes per output row in a stage (the pass form: the row itself, so the
// block's rows are contiguous; the ring form: 16-byte multiples, never a
// multiple of 128, so that the rows do not all start in one bank).
struct ShPlan {
  int form, L, stages, pitch, out_pitch, smem;
};

__host__ __device__ inline int sh_round(int v, int m) {
  return (v + m - 1) / m * m;
}

// The plan for N frames of fs floats and esz-byte outputs (the Python
// mirror: ops/short_chain.py short_plan).
inline ShPlan short_plan(int N, int fs, int esz) {
  ShPlan p{};
  p.form = N <= kShL ? 1 : 2;
  p.L = p.form == 1 ? N : kShL;
  p.stages = N <= 0 ? 0 : (p.form == 1 ? 1 : kShStages);
  p.pitch = sh_round((p.L + 2 * kShU) * fs, 32) + 4;
  if (p.form == 1) {
    p.out_pitch = p.L * esz;
  } else {
    p.out_pitch = sh_round(p.L * esz, 16);
    if (p.out_pitch % 128 == 0) p.out_pitch += 16;
  }
  // at most 86 KB (K6 in compare mode on the trio)
  p.smem = kShPinBytes + sh_round(2 * p.stages * 8, 16) +
           p.stages * kShLanes * (p.pitch * 4 + p.out_pitch);
  return p;
}

// The float offset of p in its 16-byte line.
__device__ __forceinline__ int sh_lead(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The bytes of floats [src, src + n) that sh_copy moves by a bulk copy.
__device__ __forceinline__ uint32_t sh_bulk_bytes(const float* src, int n) {
  const int h = sh_lead(src);
  const int head = h ? min(4 - h, n) : 0;
  return static_cast<uint32_t>((n - head) & ~3) * 4u;
}

// Floats [src, src + n) to slot + sh_lead(src) (slot 16-byte aligned): the
// whole 16-byte lines by one bulk copy completing on bar, the floats before
// and after them element by element.
__device__ __forceinline__ void sh_copy(float* slot, const float* src, int n,
                                        uint64_t* bar) {
  const int h = sh_lead(src);
  const int head = h ? min(4 - h, n) : 0;
  const int body = (n - head) & ~3;
  float* dst = slot + h;
  if (body) bulk::load(dst + head, src + head, body * 4u, bar);
  for (int j = 0; j < head; ++j) dst[j] = src[j];
  for (int j = head + body; j < n; ++j) dst[j] = src[j];
}

// A register group's frames: main, and in compare mode low and high.
struct ShFrames {
  float m[kShU], l[kShU], h[kShU];
};

// Frames t .. t + kShU - 1 of the lane's staged row x, one 4-byte shared
// load a power (16-byte loads, where the rows allowed them, made the chain
// slower in every mode: tools/recur_cells.py --sweep).  TRIO: main, low
// and high as a frame's three floats; else the main power alone, a
// frame's first float (low and high zero).
template <bool TRIO>
__device__ __forceinline__ void sh_fetch(ShFrames& v, const float* x, int fs,
                                         int t) {
#pragma unroll
  for (int j = 0; j < kShU; ++j) {
    if (TRIO) {
      const float* f = x + (t + j) * 3;
      v.m[j] = f[0];
      v.l[j] = f[1];
      v.h[j] = f[2];
    } else {
      v.m[j] = x[(t + j) * fs];
      v.l[j] = v.h[j] = 0.f;
    }
  }
}

__device__ __forceinline__ void sh_in(float& x, const ShFrames& v, int j) {
  x = v.m[j];
}
__device__ __forceinline__ void sh_in(float4& x, const ShFrames& v, int j) {
  x = make_float4(v.m[j], v.l[j], v.h[j], 0.f);
}

// A step's output: K4's level (the step's o[0]); K6's mark, the decision
// after the step (the step's o[0] holds it as 1.f or 0.f: read as a float
// it took a select, a compare and a select a step on the integer pipe,
// which sets K6's rate in its short-chained modes).
template <bool HANG>
__device__ __forceinline__ float sh_out(const AgcStep<HANG>&,
                                        const float* o) {
  return o[0];
}
template <int MODE>
__device__ __forceinline__ uint32_t sh_out(const OokStep<MODE>& s,
                                           const float*) {
  return static_cast<uint32_t>(s.st);
}

// A step's output to its place in a stage's output row: a float level
// (K4) or a mark's byte (K6), one shared store each (a group's outputs in
// one 16- or 4-byte store ran no faster: the sweep).
__device__ __forceinline__ void sh_put(float* o, float v) { *o = v; }
__device__ __forceinline__ void sh_put(unsigned char* o, uint32_t v) {
  *o = static_cast<unsigned char>(v);
}

// The step's constants into registers for the launch: thread 0 writes them
// to shared memory (the first kShPinWords words of the block's dynamic
// shared memory) before the block's barrier, and every chain lane reads
// them back through a volatile pointer,
// so that the compiler cannot load them again from the parameter bank
// inside the loop (it did, once a register group, on the chain:
// tools/recur_cells.py --sass; an empty asm statement did not stop it,
// ptxas saw through it).
constexpr int kShPinWords = 8;
static_assert(kShPinWords * 4 <= kShPinBytes, "the pinned words' area");

template <bool HANG>
__device__ __forceinline__ void sh_pin_write(const AgcStep<HANG>& s,
                                             uint32_t* w) {
  w[0] = __float_as_uint(s.rise);
  w[1] = __float_as_uint(s.fall);
  w[2] = __float_as_uint(s.drise);
  w[3] = __float_as_uint(s.dfall);
  w[4] = static_cast<uint32_t>(s.hang_samples);
}
template <bool HANG>
__device__ __forceinline__ void sh_pin_read(AgcStep<HANG>& s,
                                            const volatile uint32_t* v) {
  s.rise = __uint_as_float(v[0]);
  s.fall = __uint_as_float(v[1]);
  s.drise = __uint_as_float(v[2]);
  s.dfall = __uint_as_float(v[3]);
  s.hang_samples = static_cast<int>(v[4]);
}
template <int MODE>
__device__ __forceinline__ void sh_pin_write(const OokStep<MODE>& s,
                                             uint32_t* w) {
  w[0] = __float_as_uint(s.aa);
  w[1] = __float_as_uint(s.da);
  w[2] = __float_as_uint(s.fa);
  w[3] = __float_as_uint(s.keep);
  w[4] = __float_as_uint(s.va);
  w[5] = __float_as_uint(s.ratio);
  w[6] = static_cast<uint32_t>(s.attack_frames);
  w[7] = static_cast<uint32_t>(s.decay_frames);
}
template <int MODE>
__device__ __forceinline__ void sh_pin_read(OokStep<MODE>& s,
                                            const volatile uint32_t* v) {
  s.aa = __uint_as_float(v[0]);
  s.da = __uint_as_float(v[1]);
  s.fa = __uint_as_float(v[2]);
  s.keep = __uint_as_float(v[3]);
  s.va = __uint_as_float(v[4]);
  s.ratio = __uint_as_float(v[5]);
  s.attack_frames = static_cast<int>(v[6]);
  s.decay_frames = static_cast<int>(v[7]);
}

// The pass form's outputs: a chain warp's rows, contiguous in both
// memories (the output rows' pitch is the row), from the output stage os
// to device memory by the warp's n lanes: 16-byte stores where both ends
// of the region are 16-byte aligned and it is 16-byte sized, else bytes.
__device__ __forceinline__ void sh_region_out(unsigned char* dst,
                                              const unsigned char* os,
                                              uint32_t bytes, int lane,
                                              int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(os) & 15) == 0 && (bytes & 15) == 0) {
    for (uint32_t j = lane; j < bytes / 16; j += n)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(os)[j];
  } else {
    for (uint32_t j = lane; j < bytes; j += n) dst[j] = os[j];
  }
}

struct ShArgs {
  const float* in;     // row c's frame t at in + c cs + t fs (floats)
  long long cs;
  int fs;
  ShPlan plan;
  void* out;           // [C, N] levels (float) or marks (uint8)
  int C, N;
};

// One block: channels c0 = blockIdx.x kShLanes ..., all N frames.  Io
// carries the state pointers (Step::load / store).  One block per SM at
// least (a launch takes 4 to 16 SMs): without that bound ptxas kept K4's
// loop in 40 registers and issued the next group's loads at its end, on
// the chain (tools/recur_cells.py --sweep, variant no_min_blocks).
template <class Step, class Out, bool TRIO>
__global__ void __launch_bounds__(kShThreads, 1)
    recur_short_kernel(ShArgs a, Io io, Step s) {
  extern __shared__ __align__(128) unsigned char sh_smem[];
  const ShPlan& p = a.plan;
  const int S = p.stages, L = p.L, N = a.N, fs = a.fs;
  const int stage_floats = kShLanes * p.pitch;
  uint32_t* pin_w = reinterpret_cast<uint32_t*>(sh_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(sh_smem + kShPinBytes);
  uint64_t* done = full + S;
  float* in_s = reinterpret_cast<float*>(sh_smem + kShPinBytes +
                                         sh_round(2 * S * 8, 16));
  unsigned char* out_s =
      reinterpret_cast<unsigned char*>(in_s + S * stage_floats);
  const int tid = threadIdx.x, lane = tid & 31;
  const int c0 = blockIdx.x * kShLanes;
  const int cb = min(kShLanes, a.C - c0);
  const int segs = L > 0 ? (N + L - 1) / L : 0;
  // a lane's row (the chain warp's lanes below kShLanes, the copy warp's
  // too); a chain lane's state loads in flight across the block's barrier
  const bool chain = tid < 32;
  const int c = c0 + lane;
  const bool mine = lane < cb;
  const float* row = a.in + c * a.cs;   // read by the lanes of mine only
  if (chain && mine) s.load(io, c);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      bulk::mbar_init(&full[i], 2);
      bulk::mbar_init(&done[i], 1);
    }
    bulk::fence_mbar_init();
    sh_pin_write(s, pin_w);
  }
  __syncthreads();

  if (!chain) {
    // the copy warp: lane r copies row r in and out
    auto fill = [&](int i) {
      const int slot = i % S, t0 = i * L, n = min(L, N - t0);
      const float* src = row + static_cast<long long>(t0) * fs;
      uint32_t tx = mine ? sh_bulk_bytes(src, n * fs) : 0u;
      tx = __reduce_add_sync(0xffffffffu, tx);
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[slot], tx);
      __syncwarp();
      if (mine)
        sh_copy(in_s + slot * stage_floats + lane * p.pitch, src, n * fs,
                &full[slot]);
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[slot], 0);
    };
    // the ring form's outputs: a bulk store per row where its segment is
    // 16-byte sized and aligned, else element by element
    auto drain = [&](int i) {
      const int slot = i % S, t0 = i * L, n = min(L, N - t0);
      const unsigned char* os =
          out_s + static_cast<size_t>(slot) * kShLanes * p.out_pitch;
      if (mine) {
        Out* dst = static_cast<Out*>(a.out) + static_cast<size_t>(c) * N + t0;
        const Out* src = reinterpret_cast<const Out*>(os + lane * p.out_pitch);
        const uint32_t bytes = n * sizeof(Out);
        if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (bytes & 15) == 0)
          bulk::store(dst, src, bytes);
        else
          for (int j = 0; j < n; ++j) dst[j] = src[j];
      }
      bulk::store_commit();
      bulk::store_wait_read<0>();
      __syncwarp();
    };
    for (int i = 0; i < min(S, segs); ++i) fill(i);
    // the pass form's one segment is written out by the chain warp
    for (int i = 0; i < (p.form == 1 ? 0 : segs); ++i) {
      // segment i handed its stage back
      while (!bulk::mbar_try_wait(&done[i % S],
                                  static_cast<uint32_t>(i / S) & 1u))
        __nanosleep(256);
      drain(i);
      if (i + S < segs) fill(i + S);
    }
    return;
  }

  // the chain warp: lanes below kShLanes carry a row each, the others
  // leave; the constants pinned in registers
  if (lane >= kShLanes) return;
  sh_pin_read(s, pin_w);
  const float* base = in_s + lane * p.pitch + (mine ? sh_lead(row) : 0);
  typename Step::In x;
  float o2[2];
  for (int i = 0; i < segs; ++i) {
    const int slot = i % S, t0 = i * L, n = min(L, N - t0);
    bulk::mbar_wait(&full[slot], static_cast<uint32_t>(i / S) & 1u);
    const float* xs = base + slot * stage_floats;
    Out* orow_i = reinterpret_cast<Out*>(
        out_s + (static_cast<size_t>(slot) * kShLanes + lane) * p.out_pitch);
    ShFrames cur, nxt;
    sh_fetch<TRIO>(cur, xs, fs, 0);
    int t = 0;
    for (; t + kShU <= n; t += kShU) {
      sh_fetch<TRIO>(nxt, xs, fs, t + kShU);
#pragma unroll
      for (int j = 0; j < kShU; ++j) {
        sh_in(x, cur, j);
        s.step(x, o2);
        sh_put(orow_i + t + j, sh_out(s, o2));
      }
      cur = nxt;
    }
    // the segment's last < kShU frames (the row's last segment only)
    for (; t < n; ++t) {
      ShFrames one;
      sh_fetch<TRIO>(one, xs, fs, t);
      sh_in(x, one, 0);
      s.step(x, o2);
      sh_put(orow_i + t, sh_out(s, o2));
    }
    if (p.form == 1) {
      // the pass form: the block's rows straight out, no hand-off
      __syncwarp(kShMask);
      sh_region_out(reinterpret_cast<unsigned char*>(
                        static_cast<Out*>(a.out) + static_cast<size_t>(c0) * N),
                    out_s, cb * N * sizeof(Out), lane, kShLanes);
      break;
    }
    bulk::fence_async_smem();
    __syncwarp(kShMask);
    if (lane == 0) bulk::mbar_arrive_expect_tx(&done[slot], 0);
  }
  if (mine) s.store(io, c);
}

template <class Step, class Out, bool TRIO>
int short_launch(ShArgs& a, const Io& io, const Step& s, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.C <= 0 || a.N < 0) return cudaErrorInvalidValue;
  auto kernel = recur_short_kernel<Step, Out, TRIO>;
  if (a.plan.smem > 48 * 1024) {
    // once per device: the most any plan of this kernel asks for
    static unsigned set = 0;
    if (device >= 32 || !(set >> device & 1u)) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kShSmemMax);
      if (err != cudaSuccess) {
        cudaGetLastError();     // no error left for the next launch's check
        return err;
      }
      if (device < 32) set |= 1u << device;
    }
  }
  const int grid = (a.C + kShLanes - 1) / kShLanes;
  kernel<<<grid, kShThreads, a.plan.smem, (cudaStream_t)stream>>>(a, io, s);
  return cudaGetLastError();
}

// K3's and K3c's design: the loop kernel (recur_loop_kernel).  What bounds
// them is the latency of one step's chain: sincosf, the derotation, the
// detector (atan2f, or a division), the clip, the add and the wrap, each
// waiting on the phase or fdev the step before left (~100-200 ns a step on
// the H100; utils/roofline.py pll_scan_bound, the chain-only probe fed from
// memory).  Their first design (the tiled kernel: 8 chain lanes of one
// warp beside three staging warps, a block barrier every 128 samples) ran
// each form ~60-100 ns a step above that probe, and so did this kernel
// while its chain lane also computed |x| by hypotf, the amp EWMA and the
// denominators, in line or a register group ahead (the sweep's "inline";
// tools/recur_cells.py --sweep): that work, off the phase chain but on the
// chain lane, serialized with it.  Here the chain lane carries only the
// state-dependent chain:
//   * one block = kPlWarps chain warps of kPlLanes chains (lane r of warp w
//     carries channel c0 + w kPlLanes + r, its phase and fdev in registers
//     from before the first wait to the last step; built: one chain, thread
//     0) and a copy warp; the step's constants pinned in registers
//     (sh_pin);
//   * the copy warp brings each segment of kPlL complex frames of the
//     block's rows into a stage (the whole row where it is at most kPlL
//     frames: the "pass" form; else the "ring" form, kPlStages stages):
//     per row one cp.async.bulk of the 16-byte lines the segment covers
//     wholly, the <= 1 frame before and after element by element (sh_copy,
//     as the short-chain kernel), on the stage's full mbarrier;
//   * then, its lane l on rows l, l + 32, ..., it runs what reads no loop
//     state over the landed stage (Step::amp_next: |x| and the amp EWMA,
//     whose state it carries and writes out; Step::denom: the costas and
//     pilot denominators, into the stage's q rows) and completes the
//     stage's ready mbarrier, which the chain lanes wait on; it refills a
//     stage once every chain warp has handed it back (its done mbarrier);
//     no block barrier inside the time loop (kPlPrep; false: the chain
//     lane runs the whole step, the sweep's "inline");
//   * frames (and q) are read into registers one group of kPlU steps
//     ahead; the two float outputs go to the stage's output rows in shared
//     memory (phases, freqs; offs, fdevs for K3c); in the ring form the
//     copy warp writes a stage's rows out (a bulk store per row where its
//     segment is 16-byte sized and aligned), in the pass form each chain
//     warp writes its rows' region itself;
//   * the step keeps its IEEE float32 arithmetic op for op: K3 and K3c
//     equal pll_scan_plain and pll_chunk_scan_plain bit for bit.
// The layout (chains a warp, chain warps a block) is the sweep's pick
// (tools/recur_cells.py --sweep, on the H100): one chain a block (64
// channels on 64 SMs), 1-6 % a step faster than 16 chains in one warp,
// whose lanes the math library's branches made reconverge every step.
constexpr int kPlLanes = 1;       // chains a chain warp
constexpr int kPlWarps = 1;       // chain warps a block
constexpr int kPlRows = kPlLanes * kPlWarps;       // channels a block
constexpr int kPlThreads = 32 * (kPlWarps + 1);   // the chain warps, a copy warp
constexpr unsigned kPlMask = 0xffffffffu >> (32 - kPlLanes);
constexpr int kPlU = 4;           // steps per register group
constexpr int kPlL = 128;         // frames per stage in the ring form
constexpr int kPlStages = 3;      // stages in the ring form
constexpr bool kPlPrep = true;    // the stateless terms on the copy warp

// The launch's plan (loop_plan): form 1 pass, 2 ring; L frames a stage;
// pitch: floats per staged row (= 4 mod 32; room for the row's float offset
// in its 16-byte line and a register group read past the segment);
// qpitch: floats per q row (= 1 mod 32: the rows start in distinct banks;
// room for a register group read past the segment); out_pitch: bytes per
// output row in a stage (the pass form: the row itself, so that a warp's
// rows are contiguous as in device memory; the ring form: 16-byte
// multiples, never a multiple of 128); smem: the pinned constants, the
// full, ready and done mbarriers, the input stages (kPlRows rows of pitch
// floats), the q stages (kPlRows rows of qpitch floats, to a 16-byte
// line) and the output stages (two outputs of kPlRows rows each).
struct PlPlan {
  int form, L, stages, pitch, qpitch, out_pitch, smem;
};

inline PlPlan loop_plan(int N) {
  PlPlan p{};
  p.form = N <= kPlL ? 1 : 2;
  p.L = p.form == 1 ? N : kPlL;
  p.stages = N <= 0 ? 0 : (p.form == 1 ? 1 : kPlStages);
  p.pitch = sh_round((p.L + 2 * kPlU) * 2, 32) + 4;
  p.qpitch = sh_round(p.L + kPlU, 32) + 1;
  if (p.form == 1) {
    p.out_pitch = p.L * 4;
  } else {
    p.out_pitch = sh_round(p.L * 4, 16);
    if (p.out_pitch % 128 == 0) p.out_pitch += 16;
  }
  p.smem = kShPinBytes + sh_round(3 * p.stages * 8, 16) +
           p.stages * kPlRows * (p.pitch * 4 + 2 * p.out_pitch) +
           sh_round(p.stages * kPlRows * p.qpitch * 4, 16);
  return p;
}

static_assert(kPlLanes >= 1 && kPlLanes <= 32 && kPlWarps >= 1,
              "a chain warp's lanes");

template <int DET>
__device__ __forceinline__ void sh_pin_write(const PllStep<DET>& s,
                                             uint32_t* w) {
  w[0] = __float_as_uint(s.alpha);
  w[1] = __float_as_uint(s.beta);
  w[2] = __float_as_uint(s.wc);
  w[3] = __float_as_uint(s.dev_lo);
  w[4] = __float_as_uint(s.dev_hi);
}
template <int DET>
__device__ __forceinline__ void sh_pin_read(PllStep<DET>& s,
                                            const volatile uint32_t* v) {
  s.alpha = __uint_as_float(v[0]);
  s.beta = __uint_as_float(v[1]);
  s.wc = __uint_as_float(v[2]);
  s.dev_lo = __uint_as_float(v[3]);
  s.dev_hi = __uint_as_float(v[4]);
}
template <bool PILOT>
__device__ __forceinline__ void sh_pin_write(const ChunkStep<PILOT>& s,
                                             uint32_t* w) {
  w[0] = __float_as_uint(s.alpha);
  w[1] = __float_as_uint(s.beta);
  w[2] = __float_as_uint(s.dev_lo);
  w[3] = __float_as_uint(s.dev_hi);
}
template <bool PILOT>
__device__ __forceinline__ void sh_pin_read(ChunkStep<PILOT>& s,
                                            const volatile uint32_t* v) {
  s.alpha = __uint_as_float(v[0]);
  s.beta = __uint_as_float(v[1]);
  s.dev_lo = __uint_as_float(v[2]);
  s.dev_hi = __uint_as_float(v[3]);
}

// A register group: kPlU frames and their denominators q.
struct PlFrames {
  float2 x[kPlU];
  float q[kPlU];
};

struct PlArgs {
  const float2* x;     // [C, N] complex64 rows
  float* out0;         // [C, N] phases (K3c: offs)
  float* out1;         // [C, N] freqs (K3c: fdevs)
  PlPlan plan;
  int C, N;
};

// One block: channels c0 = blockIdx.x kPlRows ..., all N frames.  Io
// carries the state pointers.  One block per SM at least, as the
// short-chain kernel (ptxas otherwise keeps the loop in fewer registers
// and issues the next group's loads at its end).
template <class Step>
__global__ void __launch_bounds__(kPlThreads, 1)
    recur_loop_kernel(PlArgs a, Io io, Step s) {
  extern __shared__ __align__(128) unsigned char pl_smem[];
  const PlPlan& p = a.plan;
  const int S = p.stages, L = p.L, N = a.N;
  const int stage_floats = kPlRows * p.pitch;
  const int stage_q = kPlRows * p.qpitch;
  const size_t stage_out = static_cast<size_t>(2) * kPlRows * p.out_pitch;
  uint32_t* pin_w = reinterpret_cast<uint32_t*>(pl_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(pl_smem + kShPinBytes);
  uint64_t* ready = full + S;
  uint64_t* done = ready + S;
  float* in_s = reinterpret_cast<float*>(pl_smem + kShPinBytes +
                                         sh_round(3 * S * 8, 16));
  float* q_s = in_s + S * stage_floats;
  // the output stages start on a 16-byte line (bulk stores read them)
  unsigned char* out_s = reinterpret_cast<unsigned char*>(in_s) +
                         S * stage_floats * 4 + sh_round(S * stage_q * 4, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kPlRows;
  const int cb = min(kPlRows, a.C - c0);
  const int segs = L > 0 ? (N + L - 1) / L : 0;
  const bool chain = warp < kPlWarps;
  // a chain lane's row in the block; its state loads in flight across the
  // block's barrier
  const int r = warp * kPlLanes + lane;
  const bool mine = chain && lane < kPlLanes && r < cb;
  auto row = [&](int rr) {
    return reinterpret_cast<const float*>(a.x + static_cast<size_t>(c0 + rr) *
                                                    N);
  };
  if (mine) s.load(io, c0 + r);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      bulk::mbar_init(&full[i], 2);
      bulk::mbar_init(&ready[i], 1);
      bulk::mbar_init(&done[i], kPlWarps);
    }
    bulk::fence_mbar_init();
    sh_pin_write(s, pin_w);
  }
  __syncthreads();

  if (!chain) {
    // the copy warp: lane l copies rows l, l + 32, ... in and out, and
    // carries their amp
    constexpr int kMine = (kPlRows + 31) / 32;
    float amp[kMine];
#pragma unroll
    for (int k = 0; k < kMine; ++k) {
      const int rr = lane + 32 * k;
      amp[k] = kPlPrep && rr < cb
                   ? static_cast<const float*>(io.st_in[2])[c0 + rr]
                   : 0.f;
    }
    auto fill = [&](int i) {
      const int slot = i % S, t0 = i * L, n = min(L, N - t0);
      uint32_t tx = 0;
      for (int rr = lane; rr < cb; rr += 32)
        tx += sh_bulk_bytes(row(rr) + 2 * t0, 2 * n);
      tx = __reduce_add_sync(0xffffffffu, tx);
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[slot], tx);
      __syncwarp();
      for (int rr = lane; rr < cb; rr += 32)
        sh_copy(in_s + slot * stage_floats + rr * p.pitch, row(rr) + 2 * t0,
                2 * n, &full[slot]);
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive_expect_tx(&full[slot], 0);
    };
    // what reads no loop state, over a landed stage: the amp EWMA of each
    // row and its denominators q; then the stage is ready for the chain
    auto prep = [&](int i) {
      const int slot = i % S, n = min(L, N - i * L);
      bulk::mbar_wait(&full[slot], static_cast<uint32_t>(i / S) & 1u);
#pragma unroll
      for (int k = 0; k < kMine; ++k) {
        const int rr = lane + 32 * k;
        if (rr < cb) {
          const float2* xs = reinterpret_cast<const float2*>(
              in_s + slot * stage_floats + rr * p.pitch + sh_lead(row(rr)));
          float* q = q_s + slot * stage_q + rr * p.qpitch;
          float am = amp[k];
#pragma unroll 4
          for (int t = 0; t < n; ++t) {
            am = Step::amp_next(am, xs[t]);
            if (Step::kDenom) q[t] = Step::denom(am);
          }
          amp[k] = am;
        }
      }
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive_expect_tx(&ready[slot], 0);
    };
    // the ring form's outputs: a bulk store per row where its segment is
    // 16-byte sized and aligned, else element by element
    auto drain = [&](int i) {
      const int slot = i % S, t0 = i * L, n = min(L, N - t0);
      const unsigned char* os = out_s + slot * stage_out;
      const uint32_t bytes = n * 4u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float* out = k ? a.out1 : a.out0;
        for (int rr = lane; rr < cb; rr += 32) {
          float* dst = out + static_cast<size_t>(c0 + rr) * N + t0;
          const float* src = reinterpret_cast<const float*>(
              os + static_cast<size_t>(k * kPlRows + rr) * p.out_pitch);
          if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
              (bytes & 15) == 0)
            bulk::store(dst, src, bytes);
          else
            for (int j = 0; j < n; ++j) dst[j] = src[j];
        }
      }
      bulk::store_commit();
      bulk::store_wait_read<0>();
      __syncwarp();
    };
    for (int i = 0; i < min(S, segs); ++i) fill(i);
    if (kPlPrep)
      for (int i = 0; i < min(S, segs); ++i) prep(i);
    // the pass form's one segment is written out by the chain warps
    for (int i = 0; i < (p.form == 1 ? 0 : segs); ++i) {
      while (!bulk::mbar_try_wait(&done[i % S],
                                  static_cast<uint32_t>(i / S) & 1u))
        __nanosleep(256);
      drain(i);
      if (i + S < segs) {
        fill(i + S);
        if (kPlPrep) prep(i + S);
      }
    }
    if (kPlPrep) {
#pragma unroll
      for (int k = 0; k < kMine; ++k) {
        const int rr = lane + 32 * k;
        if (rr < cb) static_cast<float*>(io.st_out[2])[c0 + rr] = amp[k];
      }
    }
    return;
  }

  // one chain a block: thread 0 alone
  if (kPlRows == 1 ? tid != 0 : lane >= kPlLanes) return;
  sh_pin_read(s, pin_w);
  // a lane past the block's channels runs row 0's frames from a zero state
  // (finite values: no stray slow path of the math library in the warp)
  if (!mine) {
    s.phase = 0.f;
    s.fdev = 0.f;
    s.amp = 1.f;
  }
  const int rr = mine ? r : 0;
  const float2* base = reinterpret_cast<const float2*>(
      in_s + rr * p.pitch + sh_lead(row(rr)));
  float o[2];
  for (int i = 0; i < segs; ++i) {
    const int slot = i % S, t0 = i * L, n = min(L, N - t0);
    bulk::mbar_wait(kPlPrep ? &ready[slot] : &full[slot],
                    static_cast<uint32_t>(i / S) & 1u);
    const float2* xs = base + slot * (stage_floats / 2);
    const float* qs = q_s + slot * stage_q + rr * p.qpitch;
    float* o0 = reinterpret_cast<float*>(
        out_s + slot * stage_out + static_cast<size_t>(r) * p.out_pitch);
    float* o1 = reinterpret_cast<float*>(
        out_s + slot * stage_out +
        static_cast<size_t>(kPlRows + r) * p.out_pitch);
    PlFrames cur, nxt;
#pragma unroll
    for (int j = 0; j < kPlU; ++j) {
      cur.x[j] = xs[j];
      cur.q[j] = kPlPrep && Step::kDenom ? qs[j] : 0.f;
    }
    int t = 0;
    for (; t + kPlU <= n; t += kPlU) {
#pragma unroll
      for (int j = 0; j < kPlU; ++j) {
        nxt.x[j] = xs[t + kPlU + j];
        nxt.q[j] = kPlPrep && Step::kDenom ? qs[t + kPlU + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPlU; ++j) {
        if (kPlPrep)
          s.chain(cur.x[j], cur.q[j], o);
        else
          s.step(cur.x[j], o);
        o0[t + j] = o[0];
        o1[t + j] = o[1];
      }
      cur = nxt;
    }
    // the segment's last < kPlU frames (the row's last segment only)
    for (; t < n; ++t) {
      if (kPlPrep)
        s.chain(xs[t], Step::kDenom ? qs[t] : 0.f, o);
      else
        s.step(xs[t], o);
      o0[t] = o[0];
      o1[t] = o[1];
    }
    if (p.form == 1) {
      // the pass form: each chain warp writes its rows straight out, no
      // hand-off
      const int r0 = warp * kPlLanes, nr = min(kPlLanes, cb - r0);
      if (kPlLanes > 1) __syncwarp(kPlMask);
      if (nr > 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          sh_region_out(
              reinterpret_cast<unsigned char*>((k ? a.out1 : a.out0) +
                                               static_cast<size_t>(c0 + r0) *
                                                   N),
              out_s + static_cast<size_t>(k * kPlRows + r0) * p.out_pitch,
              nr * N * 4u, lane, kPlLanes);
      }
      break;
    }
    bulk::fence_async_smem();
    if (kPlLanes > 1) __syncwarp(kPlMask);    // one chain a warp: no need
    if (lane == 0) bulk::mbar_arrive_expect_tx(&done[slot], 0);
  }
  if (mine) {
    // with kPlPrep the copy warp writes amp'
    static_cast<float*>(io.st_out[0])[c0 + r] = s.phase;
    static_cast<float*>(io.st_out[1])[c0 + r] = s.fdev;
    if (!kPlPrep) static_cast<float*>(io.st_out[2])[c0 + r] = s.amp;
  }
}

template <class Step>
int loop_launch(const float2* x, float* out0, float* out1, int C, int N,
                const Io& io, const Step& s, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C <= 0 || N < 0) return cudaErrorInvalidValue;
  PlArgs a{x, out0, out1, loop_plan(N), C, N};
  if (a.plan.smem > kShSmemMax) return cudaErrorInvalidValue;
  auto kernel = recur_loop_kernel<Step>;
  if (a.plan.smem > 48 * 1024) {
    // once per device: the most any plan of this kernel asks for
    static unsigned set = 0;
    if (device >= 32 || !(set >> device & 1u)) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kShSmemMax);
      if (err != cudaSuccess) {
        cudaGetLastError();     // no error left for the next launch's check
        return err;
      }
      if (device < 32) set |= 1u << device;
    }
  }
  const int grid = (C + kPlRows - 1) / kPlRows;
  kernel<<<grid, kPlThreads, a.plan.smem, (cudaStream_t)stream>>>(a, io, s);
  return cudaGetLastError();
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
// What bounds it (utils/roofline.py anf_scan_bound): the bytes (x read, y
// written once) take ~0.01 ms at [128, 32768]; at small U the chain of N/U
// updates, each at least probe_anf_kernel's dependent chain (a product,
// the 45-tap sum's 6 levels, the error, the U-term sum's log2 U levels,
// the leaky FMA); at large U the ~4 float32 operations per tap and sample
// over the whole card.  Two forms of one kernel family, picked from U by
// the launcher (anf_form: the chain form up to kAnfChainMaxU, where it
// beats the wide form: at U = 32 by 1.9x on the H100):
//   * the chain form (recur_anf_chain<P, kReuse>, P = U rounded up to a
//     power of two): one warp runs a row's chain with no block barrier on
//     it.  What bounds it is that warp: its dependent shuffles and the
//     issue of its shared-memory loads and shuffles (about four cycles
//     each), not the card.  Lane L holds w[L] and w[L + 32] in registers
//     for the whole launch and its P outputs in a slot order of its own
//     (slot j: output j ^ mine, mine = the output the lane ends with), so
//     that the butterfly needs no select: per update it forms its two
//     taps' products for all P slots; recursive halving over lane bits 4,
//     3, ... (P/2 + P/4 + ... + 1 exchanges, each slot below the half
//     plus the partner's slot above it) and xor levels over the lower
//     bits (5 levels in all, 8 + 4 + 2 + 1 + 1 exchanges at U = 16) leave
//     output mine's sum in the lane; each slot's error comes by one xor
//     shuffle, and each lane sums err frame for its two taps in min(4, P)
//     split accumulators over the slots, then takes w = fmaf(alpha, g,
//     leak w) in its register.  The next update's frames are loaded from
//     the ring into registers between the butterfly and the gradient, by
//     lane offsets held in registers over a warp-uniform base (one load
//     instruction each); at U = 16 a frame at tap L + 32 is the frame at
//     tap L two updates on (2U = 32), so only those are loaded (kReuse,
//     four register arrays in turn).  The lanes' constants are pinned in
//     registers (anf_pin).  A copy warp keeps the row's slabs landing in
//     the ring ahead of the chain (a 1D bulk copy per slab and a full
//     mbarrier per slot, bulk_ring.cuh, where N % 4 == 0 and x is 16-byte
//     aligned; else 4-byte cp.async and an arrival); the chain releases a
//     slot through its empty mbarrier once no later frame reads it.  One
//     row per block of two warps: the 128 rows of 64 complex channels take
//     128 SMs, one chain each.
//   * the wide form (recur_anf_wide, every U above kAnfChainMaxU): the
//     whole block (U rounded up to a warp, 64 to kAnfWideMax threads)
//     works on one update of one row, in pieces of blockDim outputs.  What
//     bounds it is shared-memory traffic, so each frame load serves two
//     products: a thread predicts two neighbouring outputs (8-byte frame
//     loads, four split accumulators over the taps each); the gradient is
//     per warp (lane L: taps 2L and 2L + 1 over the warp's 32 outputs,
//     four split accumulators that run on across the pieces), then across
//     warps through shared memory (thread k: four accumulators over the
//     warps).  No dependent chain is longer than 12 terms (8 a piece in
//     the gradient).  Every thread stages the row into the ring by
//     cp.async as far ahead as the ring allows; three barriers a piece and
//     one an update.
// Both keep one ring layout: x[j] at ring[(j + kAnfSlab) & kAnfMask], so
// slab s fills slot s + 1 and the history sits at the top of slot 0; a
// slab into slot 0 also fills the pad after the ring with its first
// kAnfPad samples, so a frame window is read unmasked from its start.
// No atomics: every sum has a fixed order, so a launch repeats its bits;
// ops/scanops.py anf_emulate takes the same order in torch, and equals the
// kernel bit for bit on the card (tests/test_torch_gpu.py).
constexpr int kAnfMaxTaps = 64;
constexpr int kAnfSlab = 1024;        // samples per staged slab (a slot)
constexpr int kAnfSlots = 8;
constexpr int kAnfRing = kAnfSlab * kAnfSlots;   // ring floats (32 KB)
constexpr int kAnfMask = kAnfRing - 1;
// floats past the ring that repeat the start of slot 0, so that no frame
// window wraps: a window starts at a masked index and reads on unmasked
constexpr int kAnfPad = 128;
constexpr int kAnfMaxHist = 124;      // H at most
constexpr int kAnfChainMaxU = 32;     // the chain form's U at most
constexpr int kAnfChainThreads = 64;  // the chain warp and the copy warp
constexpr int kAnfWideMax = 1024;     // the wide form's threads at most
constexpr int kAnfWideMin = 64;
// the chain form's window: two updates and the history behind them, clear
// of the slot being refilled; the wide form's: a piece, its history and
// the slab being issued
static_assert(2 * kAnfChainMaxU + kAnfMaxHist <= (kAnfSlots - 1) * kAnfSlab,
              "the chain's window must leave a slot free");
static_assert(kAnfWideMax + kAnfSlab + kAnfMaxHist <= kAnfRing,
              "a piece's window and the slab after it must fit the ring");
static_assert(kAnfMaxHist <= kAnfSlab, "the history must fit slot 0");
// the chain form's window (2 x 32 taps' frames of 32 outputs), the wide
// form's prediction pair (taps + 2) and gradient lanes (62 + 34)
static_assert(2 * 32 <= kAnfPad && kAnfMaxTaps + 2 <= kAnfPad &&
                  62 + 34 <= kAnfPad,
              "a frame window must fit the pad");

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

// hist' = the last H samples of full = [hist, x], by `threads` threads
// from `t`.
__device__ __forceinline__ void anf_hist_out(const AnfArgs& a, int r, int t,
                                             int threads) {
  const float* xr = a.x + static_cast<size_t>(r) * a.N;
  for (int h = t; h < a.H; h += threads) {
    const int p = a.N + h;
    a.hist_out[static_cast<size_t>(r) * a.H + h] =
        p < a.H ? a.hist[static_cast<size_t>(r) * a.H + p] : xr[p - a.H];
  }
}

template <int P>
struct AnfLg {
  static constexpr int value = P <= 1 ? 0 : 1 + AnfLg<P / 2>::value;
};

struct AnfChainShared {
  float ring[kAnfRing + kAnfPad];  // x[j] at ring[(j + kAnfSlab) & mask]
  uint64_t full[kAnfSlots];        // item q (slab q - 1) landed in slot q % 8
  uint64_t empty[kAnfSlots];       // item q released by the chain
  int pin[32][kAnfChainMaxU + 5];  // the chain lanes' constants (anf_pin)
  float pinf[2];
};

// The chain warp's per-lane constants, read back from shared memory through
// a volatile pointer: a value the compiler cannot reload stays in its
// register for the launch (without this it reloads the kernel's parameters
// and the thread index inside every update, on the chain).  What the whole
// warp shares (U, H, the cursor) stays in uniform registers.
template <int P>
struct AnfLane {
  int lane, mine;           // mine: the output whose sum the lane ends with
  int o[P];                 // bytes to slot j's frame: 4 (lane + (j ^ mine))
  float alpha, leak;
  bool mine_ok, ha, hb;     // mine < U; the filter has tap lane / lane + 32
};

template <int P>
__device__ __forceinline__ AnfLane<P> anf_pin(AnfChainShared& sm,
                                              const AnfArgs& a, int lane) {
  constexpr int kLg = AnfLg<P>::value;
  int* pin = sm.pin[lane];
  // anf_halve's levels give lane bit 4 the output's top bit, and so on
  const int mine = lane >> (5 - kLg);
  pin[0] = lane;
  pin[1] = mine;
  pin[2] = mine < a.U;
  pin[3] = lane < a.taps;
  pin[4] = lane + 32 < a.taps;
  for (int j = 0; j < P; ++j) pin[5 + j] = 4 * (lane + (j ^ mine));
  if (lane == 0) {
    sm.pinf[0] = a.alpha;
    sm.pinf[1] = a.leak;
  }
  __syncwarp();
  const volatile int* v = pin;
  const volatile float* vf = sm.pinf;
  AnfLane<P> c;
  c.lane = v[0];
  c.mine = v[1];
  c.mine_ok = v[2];
  c.ha = v[3];
  c.hb = v[4];
#pragma unroll
  for (int j = 0; j < P; ++j) c.o[j] = v[5 + j];
  c.alpha = vf[0];
  c.leak = vf[1];
  return c;
}

// One array of an update's frames in the lane's slot order: slot j holds
// output j ^ mine (so that the butterfly needs no select) at tap lane
// (f = the update's first frame in the ring) or lane + 32 (f + 32); read
// whether or not the filter has the tap or U the output (the ring is
// zeroed first, so every value is finite; an absent tap's weight stays 0
// and an output past U gets no error).  The window starts at a masked
// index and the pad takes the rest.
template <int P>
__device__ __forceinline__ void anf_chain_load(const float* f,
                                               const AnfLane<P>& c,
                                               float (&fr)[P]) {
  const char* b = reinterpret_cast<const char*>(f);
#pragma unroll
  for (int j = 0; j < P; ++j)
    fr[j] = *reinterpret_cast<const float*>(b + c.o[j]);
}

// The butterfly's recursive halving from level Lev on (lane bit 16 >>
// Lev), on the slot order: the lane keeps slots below the half, adds the
// partner's (lane ^ d) upper half to them (the same outputs), and goes on
// with the lower half.  Template recursion, so every index is a constant.
template <int P, int Lev>
__device__ __forceinline__ void anf_halve(float (&v)[P]) {
  constexpr int kHalf = P >> (Lev + 1), d = 16 >> Lev;
  if constexpr (kHalf >= 1) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j + kHalf], d);
    anf_halve<P, Lev + 1>(v);
  }
}

// The first half of an update of the chain form (lane's taps lane and
// lane + 32): the products and the butterfly; the lane's output's sum.
template <int P>
__device__ __forceinline__ float anf_chain_sum(const float (&fa)[P],
                                               const float (&fb)[P], float w0,
                                               float w1) {
  constexpr int kGroup = 32 / P;              // lanes that end with one sum
  float v[P];
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = fmaf(fb[j], w1, fa[j] * w0);
  anf_halve<P, 0>(v);
  float s = v[0];
#pragma unroll
  for (int d = kGroup >> 1; d > 0; d >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, d);
  return s;
}

// The second half: the error, y (yl: this lane's output of the update),
// the broadcast, the gradient and the leaky step.
template <int P>
__device__ __forceinline__ void anf_chain_learn(
    const float (&fa)[P], const float (&fb)[P], float xv, float s, float& w0,
    float& w1, const AnfLane<P>& c, float* yl) {
  constexpr int kGroup = 32 / P;
  constexpr int kAcc = P < 4 ? P : 4;         // the gradient's accumulators
  // an output past U adds nothing to the gradient
  const float e = c.mine_ok ? xv - s : 0.f;
  if (c.mine_ok && (c.lane & (kGroup - 1)) == 0) *yl = s;
  float ga[kAcc], gb[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) ga[j] = gb[j] = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    // slot j's output j ^ mine: its error is in lanes (j ^ mine) * kGroup
    // + anything below kGroup, so lane ^ (j kGroup) holds it
    const float em = j ? __shfl_xor_sync(0xffffffffu, e, j * kGroup) : e;
    ga[j % kAcc] = fmaf(em, fa[j], ga[j % kAcc]);
    gb[j % kAcc] = fmaf(em, fb[j], gb[j % kAcc]);
  }
  float g0 = ga[0], g1 = gb[0];
  if (kAcc == 2) {
    g0 += ga[1 % kAcc];
    g1 += gb[1 % kAcc];
  } else if (kAcc == 4) {
    g0 = (ga[0] + ga[1 % kAcc]) + (ga[2 % kAcc] + ga[3 % kAcc]);
    g1 = (gb[0] + gb[1 % kAcc]) + (gb[2 % kAcc] + gb[3 % kAcc]);
  }
  // a tap the filter lacks keeps its zero weight
  w0 = c.ha ? fmaf(c.alpha, g0, c.leak * w0) : 0.f;
  w1 = c.hb ? fmaf(c.alpha, g1, c.leak * w1) : 0.f;
}

// The chain warp's position in the row: update i's first x index (base),
// the x index below which the ring holds every sample (avail; items below
// `landed` have landed: item q is slab q - 1, item 0 the history, and lands
// in slot q % kAnfSlots in that slot's (q / kAnfSlots)-th phase), and the
// next item to release (freed) with its end (free_at).
struct AnfCursor {
  int base, landed, avail, freed, free_at;
};

// Until x[hi] has landed.
__device__ __forceinline__ void anf_chain_wait(AnfChainShared& sm,
                                               AnfCursor& k, int hi) {
  while (k.avail <= hi) {
    bulk::mbar_wait(&sm.full[k.landed % kAnfSlots],
                    static_cast<uint32_t>(k.landed / kAnfSlots) & 1u);
    ++k.landed;
    k.avail += kAnfSlab;
  }
}

// Update k.base of the chain warp from (fa, fb, xv), the next update's
// frames loaded between its two halves (where the warp waits on the
// butterfly's shuffles, not before the products): into (na, nb) and nx,
// or (kFbOnly: U = P = 16, the next update's fa is the fb of the update
// before this one, already in registers) into nb and nx; then the items
// that no later frame reads (x below the next update's base - H) go back
// to the copy warp.
template <int P, bool kFbOnly>
__device__ __forceinline__ void anf_chain_step(
    AnfChainShared& sm, const AnfArgs& a, const AnfLane<P>& c, AnfCursor& k, float*& yl, const float (&fa)[P], const float (&fb)[P],
    float xv, float (&na)[P], float (&nb)[P], float& nx, float& w0,
    float& w1) {
  const int next = k.base + a.U;
  // past the last update the loads read finite ring values nobody uses
  if (next < a.N) anf_chain_wait(sm, k, next + a.U - 1);
  const float s = anf_chain_sum<P>(fa, fb, w0, w1);
  asm volatile("" ::: "memory");
  const float* f = sm.ring + ((next + kAnfSlab - a.H) & kAnfMask);
  if (!kFbOnly) anf_chain_load<P>(f, c, na);
  anf_chain_load<P>(f + 32, c, nb);
  nx = sm.ring[((next + kAnfSlab) & kAnfMask) + c.mine];
  anf_chain_learn<P>(fa, fb, xv, s, w0, w1, c, yl);
  yl += a.U;
  k.base = next;
  if (k.free_at <= next - a.H) {
    __syncwarp();
    do {
      if (c.lane == 0)
        bulk::mbar_arrive_expect_tx(&sm.empty[k.freed % kAnfSlots], 0);
      ++k.freed;
      k.free_at += kAnfSlab;
    } while (k.free_at <= next - a.H);
  }
}

template <int P, bool kReuse>
__global__ void __launch_bounds__(kAnfChainThreads)
    recur_anf_chain(AnfArgs a) {
  __shared__ __align__(128) AnfChainShared sm;
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* xr = a.x + static_cast<size_t>(r) * a.N;
  for (int q = tid; q < (kAnfRing + kAnfPad) / 4; q += kAnfChainThreads)
    reinterpret_cast<float4*>(sm.ring)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int h = tid; h < a.H; h += kAnfChainThreads)
    sm.ring[kAnfSlab - a.H + h] = a.hist[static_cast<size_t>(r) * a.H + h];
  if (tid == 0) {
    for (int s = 0; s < kAnfSlots; ++s) {
      bulk::mbar_init(&sm.full[s], 1);
      bulk::mbar_init(&sm.empty[s], 1);
    }
    bulk::fence_mbar_init();
  }
  __syncthreads();
  const int slabs = (a.N + kAnfSlab - 1) / kAnfSlab;
  if (tid >= 32) {
    // the copy warp: slab s is item q = s + 1, into slot q % kAnfSlots once
    // the chain has released the slot's item q - kAnfSlots
    const bool vec = (a.N % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(a.x) % bulk::kBulkAlign == 0);
    for (int s = 0; s < slabs; ++s) {
      const int q = s + 1, slot = q % kAnfSlots;
      // the chain is slots behind: poll its release slowly, so that the
      // copy warp's barrier probes leave the shared-memory pipe to the
      // chain's loads and shuffles
      if (q >= kAnfSlots)
        while (!bulk::mbar_try_wait(
            &sm.empty[slot], static_cast<uint32_t>(q / kAnfSlots - 1) & 1u))
          __nanosleep(1024);
      const int j0 = s * kAnfSlab, n = min(kAnfSlab, a.N - j0);
      const int pad = slot == 0 ? min(n, kAnfPad) : 0;
      float* dst = sm.ring + slot * kAnfSlab;
      if (vec) {
        if (lane == 0) {
          bulk::mbar_arrive_expect_tx(&sm.full[slot], (n + pad) * 4);
          bulk::load(dst, xr + j0, n * 4, &sm.full[slot]);
          if (pad)
            bulk::load(sm.ring + kAnfRing, xr + j0, pad * 4, &sm.full[slot]);
        }
      } else {
        for (int j = lane; j < n; j += 32) cp_async(dst + j, xr + j0 + j, 4);
        for (int j = lane; j < pad; j += 32)
          cp_async(sm.ring + kAnfRing + j, xr + j0 + j, 4);
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) bulk::mbar_arrive_expect_tx(&sm.full[slot], 0);
      }
    }
    return;
  }
  // the chain warp; item 0 (the history, written above) completes slot 0's
  // first phase
  if (lane == 0) bulk::mbar_arrive_expect_tx(&sm.full[0], 0);
  const AnfLane<P> c = anf_pin<P>(sm, a, lane);
  const float* wr = a.w + static_cast<size_t>(r) * a.taps;
  float w0 = c.ha ? wr[lane] : 0.f, w1 = c.hb ? wr[lane + 32] : 0.f;
  float* yl = a.y + static_cast<size_t>(r) * a.N + c.mine;
  const int updates = a.N / a.U;
  AnfCursor k{0, 1, 0, 0, 0};
  float F[4][P], X[4];
  if (updates > 0) {
    anf_chain_wait(sm, k, a.U - 1);
    const float* f = sm.ring + ((kAnfSlab - a.H) & kAnfMask);
    X[0] = sm.ring[kAnfSlab + c.mine];
    if (kReuse) {
      // update i: fa = F[(i + 2) % 4] (the fb of update i - 2: 2U = 32),
      // fb = F[i % 4]; update 0's fa in F[2], update 1's in F[3]
      anf_chain_load<P>(f, c, F[2]);
      anf_chain_load<P>(f + 32, c, F[0]);
      if (updates > 1) {
        anf_chain_wait(sm, k, 2 * a.U - 1);
        anf_chain_load<P>(f + a.U, c, F[3]);
      }
    } else {
      anf_chain_load<P>(f, c, F[0]);
      anf_chain_load<P>(f + 32, c, F[1]);
    }
  }
  if (kReuse) {
    for (int i = 0; i < updates; i += 4) {
      anf_chain_step<P, true>(sm, a, c, k, yl, F[2], F[0], X[0],
                              F[3], F[1], X[1], w0, w1);
      if (i + 1 >= updates) break;
      anf_chain_step<P, true>(sm, a, c, k, yl, F[3], F[1], X[1],
                              F[0], F[2], X[2], w0, w1);
      if (i + 2 >= updates) break;
      anf_chain_step<P, true>(sm, a, c, k, yl, F[0], F[2], X[2],
                              F[1], F[3], X[3], w0, w1);
      if (i + 3 >= updates) break;
      anf_chain_step<P, true>(sm, a, c, k, yl, F[1], F[3], X[3],
                              F[2], F[0], X[0], w0, w1);
    }
  } else {
    for (int i = 0; i < updates; i += 2) {
      anf_chain_step<P, false>(sm, a, c, k, yl, F[0], F[1], X[0],
                               F[2], F[3], X[1], w0, w1);
      if (i + 1 >= updates) break;
      anf_chain_step<P, false>(sm, a, c, k, yl, F[2], F[3], X[1],
                               F[0], F[1], X[0], w0, w1);
    }
  }
  float* wo = a.w_out + static_cast<size_t>(r) * a.taps;
  if (c.ha) wo[lane] = w0;
  if (c.hb) wo[lane + 32] = w1;
  anf_hist_out(a, r, lane, 32);
}

struct AnfWideShared {
  float ring[kAnfRing + kAnfPad];        // x[j] at ring[(j + kAnfSlab) & mask]
  float err[kAnfWideMax];                // the piece's errors
  float w[kAnfMaxTaps];                  // the weights the predictions read
  float part[kAnfWideMax / 32][kAnfMaxTaps];   // the warps' gradients
};

// Two neighbours ring[off + idx], ring[off + idx + 1]: one 8-byte load
// where off + idx is even (kPair), else two.
template <bool kPair>
__device__ __forceinline__ float2 anf_pair(const float* ring, int off,
                                           int idx) {
  if (kPair) return *reinterpret_cast<const float2*>(ring + off + idx);
  return make_float2(ring[off + idx], ring[off + idx + 1]);
}

// The wide form's predictions of two neighbouring outputs from the frame of
// the first at off (the second's is one sample on): per output four
// accumulators over k mod 4, then (a0 + a1) + (a2 + a3).  kPair: off
// even.
template <bool kPair>
__device__ __forceinline__ void anf_wide_pred(const float* ring, int off,
                                              const float* w, int taps,
                                              float& p0, float& p1) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
  float2 f0 = anf_pair<kPair>(ring, off, 0), f1;
  int k = 0;
  for (; k + 4 <= taps; k += 4) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k);
    f1 = anf_pair<kPair>(ring, off, k + 2);
    const float2 f2 = anf_pair<kPair>(ring, off, k + 4);
    a0 = fmaf(f0.x, wv.x, a0);
    b0 = fmaf(f0.y, wv.x, b0);
    a1 = fmaf(f0.y, wv.y, a1);
    b1 = fmaf(f1.x, wv.y, b1);
    a2 = fmaf(f1.x, wv.z, a2);
    b2 = fmaf(f1.y, wv.z, b2);
    a3 = fmaf(f1.y, wv.w, a3);
    b3 = fmaf(f2.x, wv.w, b3);
    f0 = f2;
  }
  if (k < taps) {
    a0 = fmaf(f0.x, w[k], a0);
    b0 = fmaf(f0.y, w[k], b0);
  }
  if (k + 1 < taps) {
    f1 = anf_pair<kPair>(ring, off, k + 2);
    a1 = fmaf(f0.y, w[k + 1], a1);
    b1 = fmaf(f1.x, w[k + 1], b1);
  }
  if (k + 2 < taps) {
    a2 = fmaf(f1.x, w[k + 2], a2);
    b2 = fmaf(f1.y, w[k + 2], b2);
  }
  p0 = (a0 + a1) + (a2 + a3);
  p1 = (b0 + b1) + (b2 + b3);
}

// The wide form's gradient terms of one warp's cnt outputs (errors e, the
// lane's frame at off = the outputs' first frame + 2 lane): taps 2 lane
// into g0 and 2 lane + 1 into g1, output m into accumulator m mod 4.
// kFull: a whole warp of 32 outputs and off even: 8-byte frame loads and
// 16-byte error loads.
template <bool kFull>
__device__ __forceinline__ void anf_wide_grad(const float* ring, int off,
                                              const float* e, int cnt,
                                              float (&g0)[4],
                                              float (&g1)[4]) {
  if (kFull) {
    float2 fa = anf_pair<true>(ring, off, 0);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 ev = reinterpret_cast<const float4*>(e)[q];
      const float2 fb = anf_pair<true>(ring, off, 4 * q + 2);
      const float2 fc = anf_pair<true>(ring, off, 4 * q + 4);
      g0[0] = fmaf(ev.x, fa.x, g0[0]);
      g1[0] = fmaf(ev.x, fa.y, g1[0]);
      g0[1] = fmaf(ev.y, fa.y, g0[1]);
      g1[1] = fmaf(ev.y, fb.x, g1[1]);
      g0[2] = fmaf(ev.z, fb.x, g0[2]);
      g1[2] = fmaf(ev.z, fb.y, g1[2]);
      g0[3] = fmaf(ev.w, fb.y, g0[3]);
      g1[3] = fmaf(ev.w, fc.x, g1[3]);
      fa = fc;
    }
    return;
  }
  for (int m = 0; m < cnt; m += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m + j < cnt) {
        const float ej = e[m + j];
        g0[j] = fmaf(ej, ring[off + m + j], g0[j]);
        g1[j] = fmaf(ej, ring[off + m + j + 1], g1[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kAnfWideMax) recur_anf_wide(AnfArgs a) {
  __shared__ __align__(128) AnfWideShared sm;
  const int r = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, wi = tid >> 5, warps = T >> 5;
  const float* xr = a.x + static_cast<size_t>(r) * a.N;
  float* yr = a.y + static_cast<size_t>(r) * a.N;
  const int H = a.H, taps = a.taps, U = a.U;
  const bool vec = (a.N % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  for (int h = tid; h < H; h += T)
    sm.ring[kAnfSlab - H + h] = a.hist[static_cast<size_t>(r) * H + h];
  float wk = 0.f;
  if (tid < kAnfMaxTaps) {
    wk = tid < taps ? a.w[static_cast<size_t>(r) * taps + tid] : 0.f;
    sm.w[tid] = wk;
  }
  float ga[4] = {0.f, 0.f, 0.f, 0.f}, gb[4] = {0.f, 0.f, 0.f, 0.f};
  const int slabs = (a.N + kAnfSlab - 1) / kAnfSlab;
  const int updates = a.N / U;
  int issued = 0, landed = 0;
  __syncthreads();
  for (int i = 0; i < updates; ++i) {
    for (int m0 = 0; m0 < U; m0 += T) {
      const int len = min(T, U - m0), base = i * U + m0;
      const bool last = m0 + len == U;
      // issue every slab whose slot holds no sample this piece or a later
      // one reads (x indices >= base - H): slab s replaces slab s - 8
      while (issued < slabs &&
             (issued + 1 - kAnfSlots) * kAnfSlab <= base - H) {
        const int j0 = issued * kAnfSlab, n = min(kAnfSlab, a.N - j0);
        float* dst = sm.ring + ((j0 + kAnfSlab) & kAnfMask);
        const int pad = dst == sm.ring ? min(n, kAnfPad) : 0;
        if (vec) {
          for (int q = 4 * tid; q < n; q += 4 * T)
            cp_async(dst + q, xr + j0 + q, 16);
          for (int q = 4 * tid; q < pad; q += 4 * T)
            cp_async(sm.ring + kAnfRing + q, xr + j0 + q, 16);
        } else {
          for (int q = tid; q < n; q += T) cp_async(dst + q, xr + j0 + q, 4);
          for (int q = tid; q < pad; q += T)
            cp_async(sm.ring + kAnfRing + q, xr + j0 + q, 4);
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
      // predictions: outputs base + 2 tid and the next, four accumulators
      // over k mod 4 each
      const bool even = ((base - H) & 1) == 0;
      if (2 * tid < len) {
        const int lo = (base + 2 * tid + kAnfSlab - H) & kAnfMask;
        float p0, p1;
        if (even)
          anf_wide_pred<true>(sm.ring, lo, sm.w, taps, p0, p1);
        else
          anf_wide_pred<false>(sm.ring, lo, sm.w, taps, p0, p1);
        const int xj = base + 2 * tid + kAnfSlab;
        sm.err[2 * tid] = sm.ring[xj & kAnfMask] - p0;
        yr[base + 2 * tid] = p0;
        if (2 * tid + 1 < len) {
          sm.err[2 * tid + 1] = sm.ring[(xj + 1) & kAnfMask] - p1;
          yr[base + 2 * tid + 1] = p1;
        }
      }
      __syncthreads();
      // the warp's gradient over its 32 outputs of the piece: lane L, taps
      // 2L and 2L + 1, accumulator (output mod 4), running on across pieces
      const int mw = wi * 32, cnt = min(32, len - mw);
      if (cnt > 0) {
        const int lo = (base + mw + 2 * lane + kAnfSlab - H) & kAnfMask;
        if (cnt == 32 && even)
          anf_wide_grad<true>(sm.ring, lo, sm.err + mw, cnt, ga, gb);
        else
          anf_wide_grad<false>(sm.ring, lo, sm.err + mw, cnt, ga, gb);
      }
      if (last) {
        sm.part[wi][2 * lane] = (ga[0] + ga[1]) + (ga[2] + ga[3]);
        sm.part[wi][2 * lane + 1] = (gb[0] + gb[1]) + (gb[2] + gb[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) ga[j] = gb[j] = 0.f;
      }
      __syncthreads();
      if (last) {
        // across warps: thread k < taps, four accumulators over the warps
        if (tid < taps) {
          float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
          for (int j = 0; j < warps; j += 4) {
            s0 += sm.part[j][tid];
            if (j + 1 < warps) s1 += sm.part[j + 1][tid];
            if (j + 2 < warps) s2 += sm.part[j + 2][tid];
            if (j + 3 < warps) s3 += sm.part[j + 3][tid];
          }
          const float g = (s0 + s1) + (s2 + s3);
          wk = fmaf(a.alpha, g, a.leak * wk);
          sm.w[tid] = wk;
        }
        __syncthreads();
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid < taps) a.w_out[static_cast<size_t>(r) * taps + tid] = wk;
  anf_hist_out(a, r, tid, T);
}

// K8's form for U (1 the chain form, 2 the wide form) and its threads per
// block.
inline int anf_form(int U) {
  return U <= kAnfChainMaxU ? 1 : 2;
}
inline int anf_threads(int form, int U) {
  if (form == 1) return kAnfChainThreads;
  const int t = (U + 31) / 32 * 32;
  return t < kAnfWideMin ? kAnfWideMin : t > kAnfWideMax ? kAnfWideMax : t;
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

// The serial floor's probe fed from memory, of K4 and K6: one lane of
// recur_short_kernel's chain loop as it runs there (the step's constants
// pinned, sh_pin; frames read from shared memory a register group ahead,
// sh_fetch; each step's output to shared memory, sh_put) over a small
// input pattern staged once into shared memory (data: n frames of fs
// floats, n a power of two and a multiple of kShU: a pattern of marks and
// spaces, or of rising and falling envelopes), so that the compiler folds
// no step of the chain on constant inputs and the step's chain is the
// kernel's own.  The warp stages the pattern; lane 0 then runs `steps`
// steps (a multiple of kShU) and writes a sum of the outputs at the end
// (so the compiler keeps every step).
template <class Step, class Out, bool TRIO>
__global__ void __launch_bounds__(32)
    probe_fed_kernel(Step s, const float* __restrict__ data, int n, int fs,
                     int steps, float* out) {
  extern __shared__ __align__(16) unsigned char pr_smem[];
  uint32_t* pin = reinterpret_cast<uint32_t*>(pr_smem);
  float* x = reinterpret_cast<float*>(pr_smem + kShPinBytes);
  Out* o = reinterpret_cast<Out*>(x + n * fs);
  for (int i = threadIdx.x; i < n * fs; i += 32) x[i] = data[i];
  for (int i = threadIdx.x; i < n; i += 32) o[i] = 0;
  if (threadIdx.x == 0) sh_pin_write(s, pin);
  __syncwarp();
  if (threadIdx.x) return;
  sh_pin_read(s, pin);
  const int mask = n - 1;
  typename Step::In xin;
  float o2[2];
  ShFrames cur, nxt;
  sh_fetch<TRIO>(cur, x, fs, 0);
  for (int t = 0; t < steps; t += kShU) {
    const int b = t & mask;
    sh_fetch<TRIO>(nxt, x, fs, (b + kShU) & mask);
#pragma unroll
    for (int j = 0; j < kShU; ++j) {
      sh_in(xin, cur, j);
      s.step(xin, o2);
      sh_put(o + b + j, sh_out(s, o2));
    }
    cur = nxt;
  }
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, static_cast<float>(o[i]));
  out[0] = acc;
}

// The chain-only probe of K3 and K3c, fed from memory: one lane runs the
// state-dependent part of the loop kernel's step (Step::chain: sincosf and
// the derotation, or cosf and one product for the pilot; the detector, the
// clip, the add and the wrap), its constants pinned (sh_pin), over a small
// pattern staged once in shared memory (data: n frames of [re, im, amp',
// q], n a power of two and a multiple of kPlU: ops/pll.py probe_pattern)
// with what reads no loop state precomputed there (amp' and the costas /
// pilot denominator q); frames read a register group ahead, each step's two
// outputs stored to shared memory as the kernel stores them.  The
// arithmetic is the kernel's chain op for op on inputs the compiler cannot
// fold, so no bit-equal design runs a step faster: its time over `steps`
// is K3's and K3c's serial floor (utils/roofline.py pll_scan_bound).  Lane
// 0 writes a sum of the outputs at the end (so every step stays).
template <class Step>
__global__ void __launch_bounds__(32)
    probe_loop_fed_kernel(Step s, const float4* __restrict__ data, int n,
                          int steps, float* out) {
  extern __shared__ __align__(16) unsigned char pl_pr_smem[];
  uint32_t* pin = reinterpret_cast<uint32_t*>(pl_pr_smem);
  float4* f = reinterpret_cast<float4*>(pl_pr_smem + kShPinBytes);
  float* o = reinterpret_cast<float*>(f + n);
  for (int i = threadIdx.x; i < n; i += 32) f[i] = data[i];
  for (int i = threadIdx.x; i < 2 * n; i += 32) o[i] = 0.f;
  if (threadIdx.x == 0) sh_pin_write(s, pin);
  __syncwarp();
  if (threadIdx.x) return;
  sh_pin_read(s, pin);
  const int mask = n - 1;
  float o2[2];
  PlFrames cur, nxt;
  auto fetch = [&](PlFrames& v, int t) {
#pragma unroll
    for (int j = 0; j < kPlU; ++j) {
      const float4 w = f[t + j];
      v.x[j] = make_float2(w.x, w.y);
      v.q[j] = w.w;
    }
  };
  fetch(cur, 0);
  for (int t = 0; t < steps; t += kPlU) {
    const int b = t & mask;
    fetch(nxt, (b + kPlU) & mask);
#pragma unroll
    for (int j = 0; j < kPlU; ++j) {
      s.chain(cur.x[j], cur.q[j], o2);
      o[b + j] = o2[0];
      o[n + b + j] = o2[1];
    }
    cur = nxt;
  }
  float acc = 0.f;
  for (int i = 0; i < 2 * n; ++i) acc = __fadd_rn(acc, o[i]);
  out[0] = acc;
}

template <class Step>
int probe_loop_fed(const Step& s, const void* data, int n, int steps,
                   float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = kShPinBytes + static_cast<size_t>(n) * 16 +
                      static_cast<size_t>(n) * 8;
  if (n < kPlU || (n & (n - 1)) || steps < 0 || steps % kPlU ||
      smem > 48 * 1024)
    return cudaErrorInvalidValue;
  probe_loop_fed_kernel<Step><<<1, 32, smem, (cudaStream_t)stream>>>(
      s, static_cast<const float4*>(data), n, steps, out);
  return cudaGetLastError();
}

template <class Step, class Out, bool TRIO>
int probe_fed(const Step& s, const void* data, int n, int fs, int steps,
              float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = kShPinBytes + static_cast<size_t>(n) * fs * 4 +
                      static_cast<size_t>(n) * sizeof(Out);
  if (n < kShU || (n & (n - 1)) || steps < 0 || steps % kShU ||
      smem > 48 * 1024)
    return cudaErrorInvalidValue;
  probe_fed_kernel<Step, Out, TRIO><<<1, 32, smem, (cudaStream_t)stream>>>(
      s, static_cast<const float*>(data), n, fs, steps, out);
  return cudaGetLastError();
}

template <class Step>
int probe(const Step& s, int steps, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  probe_kernel<Step><<<1, 1, 0, (cudaStream_t)stream>>>(s, steps, out);
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

// K6's constants as the wrapper caches them per configuration (ops/
// goertzel.py: the JAX step's roundings of the envelope and mean
// coefficients, the mode's ratio, the debounce lengths).
struct OokConsts {
  float aa, da, fa, keep, va, ratio;
  int attack_frames, decay_frames;
};

}  // namespace

extern "C" {

const char* recur_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K3: x [C, N] complex64 (re, im interleaved), state phase / fdev / amp
// [C] -> phases, freqs [C, N] and state'.  det: 0 atan2, 1 cross, 2 costas,
// 3 pilot.  The loop kernel.  Returns the first CUDA error.
int recur_pll_scan(int device, int det, const void* x, int C, int N,
                   float alpha, float beta, float wc, float dev_lo,
                   float dev_hi, const float* phase, const float* fdev,
                   const float* amp, float* phases, float* freqs,
                   float* phase_out, float* fdev_out, float* amp_out,
                   void* stream) {
  Io io{x, {phases, freqs}, {phase, fdev, amp},
        {phase_out, fdev_out, amp_out}, C, N};
  const float2* xf = static_cast<const float2*>(x);
  switch (det) {
#define PLL_CASE(D)                                                      \
  case D: {                                                              \
    PllStep<D> s{alpha, beta, wc, dev_lo, dev_hi, 0.f, 0.f, 0.f};        \
    return loop_launch(xf, phases, freqs, C, N, io, s, device, stream);  \
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
// and state'; pilot != 0 rotates each derotated phasor by j.  The loop
// kernel.
int recur_pll_chunk_scan(int device, int pilot, const void* z, int C, int F,
                         float alpha, float beta, float dev_lo, float dev_hi,
                         const float* phase, const float* fdev,
                         const float* amp, float* offs, float* fdevs,
                         float* phase_out, float* fdev_out, float* amp_out,
                         void* stream) {
  Io io{z, {offs, fdevs}, {phase, fdev, amp}, {phase_out, fdev_out, amp_out},
        C, F};
  const float2* zf = static_cast<const float2*>(z);
  if (pilot) {
    ChunkStep<true> s{alpha, beta, dev_lo, dev_hi, 0.f, 0.f, 0.f};
    return loop_launch(zf, offs, fdevs, C, F, io, s, device, stream);
  }
  ChunkStep<false> s{alpha, beta, dev_lo, dev_hi, 0.f, 0.f, 0.f};
  return loop_launch(zf, offs, fdevs, C, F, io, s, device, stream);
}

// K3's and K3c's launch plan (loop_plan) for n frames, into out[10]: form
// (1 pass, 2 ring), frames per stage, stages, the staged row's pitch
// (floats), the q row's pitch (floats), the output row's pitch (bytes),
// the shared-memory bytes, chains a warp, chain warps a block and threads
// per block.
int recur_loop_plan(int n, int* out) {
  if (n < 0) return cudaErrorInvalidValue;
  const PlPlan p = loop_plan(n);
  const int v[10] = {p.form,   p.L,         p.stages, p.pitch,
                     p.qpitch, p.out_pitch, p.smem,   kPlLanes,
                     kPlWarps, kPlThreads};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// K4: env [C, M] float32 (contiguous), state att / dec [C] float32 and
// hang [C] int32 -> levels [C, M] and state'; hang != 0 runs the hang
// timer (hold while hang' <= hang_samples).  The short-chain kernel.
int recur_agc_scan(int device, int hang, const float* env, int C, int M,
                   float rise, float fall, float drise, float dfall,
                   int hang_samples, const float* att, const float* dec,
                   const int* hang_in, float* levels, float* att_out,
                   float* dec_out, int* hang_out, void* stream) {
  Io io{env, {levels, nullptr}, {att, dec, hang_in},
        {att_out, dec_out, hang_out}, C, M};
  ShArgs a{};
  a.in = env;
  a.cs = M;
  a.fs = 1;
  a.plan = short_plan(M, 1, 4);
  a.out = levels;
  a.C = C;
  a.N = M;
  if (hang) {
    AgcStep<true> s{rise, fall, drise, dfall, hang_samples, 0.f, 0.f, 0};
    return short_launch<AgcStep<true>, float, false>(a, io, s, device,
                                                     stream);
  }
  AgcStep<false> s{rise, fall, drise, dfall, hang_samples, 0.f, 0.f, 0};
  return short_launch<AgcStep<false>, float, false>(a, io, s, device,
                                                    stream);
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

// K6: the powers [C, F] float32, the main power of row c's frame t at
// p[c cs + t fs] (floats); bins != 0: the compare bins' low and high powers
// are that frame's next two floats (fs 3: the three columns of one
// [C, F, 3] tensor, as goertzel_power writes them), read in compare mode
// only; bins 0: zero powers there.  The state peak / floor / avg [C]
// float32, st [C] uint8, att / dec [C] int32 -> marks [C, F] (uint8 0 / 1)
// and state' in one block of six [C] rows of 4-byte words (peak, floor,
// avg as float32, attack, decay as int32, then the decisions as C bytes
// at the start of the sixth).  mode: 0 compare, 1 peak, 2 average, 3
// min_max, 4 manual, 5 noise; k: the step's constants (OokConsts).
// Returns the first CUDA error.
int recur_ook_scan(int device, int mode, const void* k, int C, int F,
                   const float* p, long long cs, int fs, int bins,
                   const float* peak, const float* floor_, const float* avg,
                   const unsigned char* st, const int* att, const int* dec,
                   unsigned char* marks, void* state_out, void* stream) {
  if (!k || mode < 0 || mode > kNoise || fs < 1 || (bins && fs != 3))
    return cudaErrorInvalidValue;
  const OokConsts& q = *static_cast<const OokConsts*>(k);
  int* w = static_cast<int*>(state_out);
  Io io{p, {nullptr, nullptr}, {peak, floor_, avg, st, att, dec},
        {w, w + C, w + 2 * C, w + 5 * C, w + 3 * C, w + 4 * C}, C, F};
  ShArgs a{};
  a.in = p;
  a.cs = cs;
  a.fs = fs;
  a.out = marks;
  a.C = C;
  a.N = F;
  a.plan = short_plan(F, fs, 1);
  switch (mode) {
#define OOK_STEP(M)                                                        \
  OokStep<M>{q.aa, q.da, q.fa, q.keep, q.va, q.ratio, q.attack_frames,     \
             q.decay_frames, 0.f, 0.f, 0.f, 0, 0, 0}
    case kCompare: {
      auto s = OOK_STEP(kCompare);
      using T = OokStep<kCompare>;
      if (bins)
        return short_launch<T, unsigned char, true>(a, io, s, device, stream);
      return short_launch<T, unsigned char, false>(a, io, s, device, stream);
    }
#define OOK_CASE(M)                                                        \
  case M: {                                                                \
    auto s = OOK_STEP(M);                                                  \
    return short_launch<OokStep<M>, unsigned char, false>(a, io, s,        \
                                                          device, stream); \
  }
    OOK_CASE(kPeak)
    OOK_CASE(kAverage)
    OOK_CASE(kMinMax)
    OOK_CASE(kManual)
    OOK_CASE(kNoise)
#undef OOK_CASE
#undef OOK_STEP
    default:
      return cudaErrorInvalidValue;
  }
}

// K4's and K6's launch plan (short_plan) for n frames of fs floats and
// esz-byte outputs (K4: 4, K6: 1), into out[8]: form (1 pass, 2 ring),
// frames per stage, stages, the staged row's pitch (floats), the output
// row's pitch (bytes), the shared-memory bytes, channels per block and
// threads per block.
int recur_short_plan(int n, int fs, int esz, int* out) {
  if (fs < 1 || n < 0 || (esz != 1 && esz != 4)) return cudaErrorInvalidValue;
  const ShPlan p = short_plan(n, fs, esz);
  const int v[8] = {p.form,      p.L,    p.stages, p.pitch,
                    p.out_pitch, p.smem, kShLanes, kShThreads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
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
// U, leak the weights' leak.  form: 0 the launcher's pick for U
// (recur_anf_form), 1 the chain form (U <= 32), 2 the wide form.  One
// block per row.  Returns the first CUDA error.
int recur_anf_scan_form(int device, int form, const float* x, int R, int N,
                        int U, int taps, int H, float alpha, float leak,
                        const float* w, const float* hist, float* y,
                        float* w_out, float* hist_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (R <= 0 || N < 0 || U <= 0 || N % U || taps <= 0 ||
      taps > kAnfMaxTaps || H < taps - 1 || H > kAnfMaxHist || form < 0 ||
      form > 2 || (form == 1 && U > kAnfChainMaxU))
    return cudaErrorInvalidValue;
  if (form == 0) form = anf_form(U);
  AnfArgs a{x, w, hist, y, w_out, hist_out, N, U, taps, H, alpha, leak};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 2) {
    recur_anf_wide<<<R, anf_threads(2, U), 0, s>>>(a);
    return cudaGetLastError();
  }
  const int b = kAnfChainThreads;
  if (U == 1) recur_anf_chain<1, false><<<R, b, 0, s>>>(a);
  else if (U <= 2) recur_anf_chain<2, false><<<R, b, 0, s>>>(a);
  else if (U <= 4) recur_anf_chain<4, false><<<R, b, 0, s>>>(a);
  else if (U <= 8) recur_anf_chain<8, false><<<R, b, 0, s>>>(a);
  else if (U < 16) recur_anf_chain<16, false><<<R, b, 0, s>>>(a);
  else if (U == 16) recur_anf_chain<16, true><<<R, b, 0, s>>>(a);
  else recur_anf_chain<32, false><<<R, b, 0, s>>>(a);
  return cudaGetLastError();
}

int recur_anf_scan(int device, const float* x, int R, int N, int U,
                   int taps, int H, float alpha, float leak, const float* w,
                   const float* hist, float* y, float* w_out,
                   float* hist_out, void* stream) {
  return recur_anf_scan_form(device, 0, x, R, N, U, taps, H, alpha, leak, w,
                             hist, y, w_out, hist_out, stream);
}

// K8's limits (the wrapper reads them): taps and history length at most;
// the form the launcher picks for U and a form's threads per block.
int recur_anf_max_taps() { return kAnfMaxTaps; }
int recur_anf_max_hist() { return kAnfMaxHist; }
int recur_anf_form(int U) { return anf_form(U); }
int recur_anf_threads(int form, int U) { return anf_threads(form, U); }

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
      return probe(ChunkStep<false>{0.1f, 0.01f, -0.5f, 0.5f, 0.f, 0.f, 1.f},
                   steps, out, device, stream);
    case 5:
      return probe(ChunkStep<true>{0.1f, 0.01f, -0.5f, 0.5f, 0.f, 0.f, 1.f},
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

// The chain probe fed from memory of the forms whose register-only probe
// may fold steps on its constant inputs: 0-3 (pll_scan with detector 0-3)
// and 4-5 (pll_chunk_scan, its pilot form): probe_loop_fed_kernel, the loop
// kernel's chain alone, data n [re, im, amp', q] frames; 6 and 7 (agc_scan
// with and without the hang: data n float32 log envelopes) and 9-14
// (ook_scan in the threshold mode 0-5: data n [main, low, high] frames, read
// as K6 reads goertzel_power's trio): probe_fed_kernel,
// recur_short_kernel's chain loop; with recur_probe's constants; n a power
// of two (4 to 2048 frames; 1024 for 0-5), steps a multiple of 4.  Time it
// over many steps, as recur_probe.
int recur_probe_fed(int device, int form, int steps, const void* data, int n,
                    float* out, void* stream) {
  const float a = 0.0139f, b = 9.6e-5f, lo = -0.098f, hi = 0.098f;
  switch (form) {
#define PLL_FED(D)                                                         \
  case D:                                                                  \
    return probe_loop_fed(PllStep<D>{a, b, 0.03f, lo, hi, 0.f, 0.f, 1.f},  \
                          data, n, steps, out, device, stream);
    PLL_FED(kAtan2)
    PLL_FED(kCross)
    PLL_FED(kCostas)
    PLL_FED(kPilot)
#undef PLL_FED
    case 4:
      return probe_loop_fed(
          ChunkStep<false>{0.1f, 0.01f, -0.5f, 0.5f, 0.f, 0.f, 1.f}, data, n,
          steps, out, device, stream);
    case 5:
      return probe_loop_fed(
          ChunkStep<true>{0.1f, 0.01f, -0.5f, 0.5f, 0.f, 0.f, 1.f}, data, n,
          steps, out, device, stream);
    case 6:
      return probe_fed<AgcStep<true>, float, false>(
          AgcStep<true>{0.03f, 0.012f, 0.002f, 0.04f, 100, -8.f, -8.f, 0},
          data, n, 1, steps, out, device, stream);
    case 7:
      return probe_fed<AgcStep<false>, float, false>(
          AgcStep<false>{0.03f, 0.012f, 0.002f, 0.002f, 0, -8.f, -8.f, 0},
          data, n, 1, steps, out, device, stream);
#define OOK_FED(M)                                                         \
  case 9 + M:                                                              \
    return probe_fed<OokStep<M>, unsigned char, M == kCompare>(            \
        OokStep<M>{0.4f, 0.02f, 0.002f, 0.99f, 0.01f, 4.f, 2, 2, 1e-6f,    \
                   1e-6f, 1e-6f, 0, 0, 0},                                 \
        data, n, 3, steps, out, device, stream);
    OOK_FED(kCompare)
    OOK_FED(kPeak)
    OOK_FED(kAverage)
    OOK_FED(kMinMax)
    OOK_FED(kManual)
    OOK_FED(kNoise)
#undef OOK_FED
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
