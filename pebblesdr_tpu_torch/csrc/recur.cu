// Per-sample recurrences for Hopper (sm_90a): the second-order carrier loop
// (K3 pll_scan, four phase detectors), the same loop at the chunk rate (K3c
// pll_chunk_scan), the scan AGC's attack / decay / hang smoother (K4
// agc_scan) and the adaptive IQ balance's LMS loop (K5 iq_lms_scan).
//
// Replaces no Pallas kernel: in the JAX package each is a jax.lax.scan,
// pll.pll_run (pebblesdr_tpu/ops/pll.py:116), the loop of
// pll.pll_run_blockwise (:182), the scan of agc.agc_apply
// (pebblesdr_tpu/ops/agc.py:298) and scanops.auto_iq_balance
// (pebblesdr_tpu/ops/scanops.py:164).  The plain PyTorch versions are
// pll_scan_plain and pll_chunk_scan_plain in ops/pll.py, agc_scan_plain in
// ops/agc.py and iq_lms_scan_plain in ops/scanops.py: a Python loop over
// time of the same arithmetic on [C] tensors.
//
// What bounds K3, K3c and K4: the latency of one step's dependent chain,
// times the steps.  Each channel's state (three or four scalars) feeds the
// next sample, so a channel is one thread that carries its state in
// registers; the bytes (x read once, two float32 outputs written once)
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
  const void* x;        // [C, N] input (float2 or float rows)
  float* out[2];        // [C, N] output rows
  const void* st_in[3];
  void* st_out[3];
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

// Samples per K5 group and per tile (the wrapper and the tests read them).
int recur_iq_group() { return kIqGroup; }
int recur_iq_tile() { return kIqTile; }

// The serial floor's probe (probe_kernel) of one form: 0-3 pll_scan with
// detector 0-3, 4 pll_chunk_scan, 5 its pilot form, 6 agc_scan with the
// hang, 7 without, 8 iq_lms_scan; out [1] float32.  Time it over many steps: the time per
// step is the latency of the form's dependent chain.
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
