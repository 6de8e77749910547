// Fused WFM stereo tail for Hopper (sm_90a): stereo demux + decimating audio
// low-pass, from the time-major composite [T, C] to the packed audio plane
// [T/F, 2C] = [mono | L-R] and the carried history, in one launch.
//
// Replaces the TPU kernel _wfm_tail_kernel / wfm_tail_packed
// (pebblesdr_tpu/ops/pallas_kernels.py:869, :917).  The plain PyTorch version
// is wfm_tail_reference in ops/wfm_tail.py.
//
// What bounds it: operations.  The low-pass costs D+1 FMAs per output lane
// (235 taps, 32768 x 128 outputs at the WFM headline: ~1 GFMA, ~29 us at
// the float32 peak), the demux one sine per composite sample; the composite
// is read once and the audio written once (32 MiB in, 16 MiB out: ~15 us
// at 3.35 TB/s).  The TPU kernel walks sub-blocks in order and carries the
// filter history in VMEM; here the work is a time march:
//   * a work item is one channel group (16 channels: a warp's 32 lanes are
//     its [mono | L-R] lanes) x one time segment of outputs; a persistent
//     grid (one block of 16 warps per SM) walks the items, tail_plan
//     sizing the segments so that every SM gets about equal rows, at least
//     two items each;
//   * each composite row is staged once: one thread of a warp that does
//     not filter (kProducer) keeps `stages` units of 2D tensor-map boxes
//     (16 lanes x 128 rows, TMA, bulk_ring.cuh load_2d) in flight on an
//     mbarrier ring, across the item boundaries of the block's stream; an
//     item's first unit is its prologue, the `hist` rows before its
//     segment, then it marches in steps of 128 outputs (128 F rows).  A
//     box must start on 16 bytes, so a composite whose rows are not a
//     multiple of 16 bytes (C % 4 != 0) stages element by element
//     instead, chosen by shape;
//   * each row is demuxed once, into a ring of [mono | L-R] rows that keeps
//     the hist rows the next step's FIR (and hist') needs: every thread of
//     the 16 warps walks one channel's rows 32 apart, its in-chunk index
//     and the pilot's (p0, wf) of its chunk carried from row to row (the
//     next chunk's pair loaded a chunk ahead); rows before t = 0 come from
//     the carried history, already demuxed.  The phase uses round-to-
//     nearest intrinsics (no FMA contraction) and sinf (not __sinf), so
//     its argument is the plain version's float32 value bit for bit.
//     sinf is a chain of dependent operations behind a branch (its slow
//     path), so a warp demuxes one row after another at the chain's
//     latency; 16 warps, 4 to a scheduler, hide part of it;
//   * the FIR runs over the ring in polyphase form (polyphase.cuh): each
//     of the first 8 warps makes 16 outputs of the step for its 32 lanes
//     (60 taps and 16 sums in registers fit 128 of them), walking the F
//     branches (cut into S slices of at most 64 taps) with each slice's
//     taps in registers while its column of ring rows streams past once,
//     so every output's sum stays in one accumulator and no partial sums
//     meet in shared memory; a ring row is one warp's 128-byte load;
//   * the ring is rewound by copying its last hist rows to its front when
//     the next step would overrun it (every second step where two fit),
//     so the FIR's fully unrolled loop reads fixed offsets;
//   * the item that holds a channel group's last segment writes hist', the
//     last d_rows rows of [raw | lmr], from its ring.
// Every dot is IEEE float32 FMAs (no tensor cores).

#include <cuda.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bulk_ring.cuh"
#include "polyphase.cuh"
#include "launch.cuh"

namespace {

constexpr int kCg = 16;                    // channels per work item
constexpr int kLanes = 2 * kCg;            // [mono | L-R] lanes: one warp
constexpr int kWarps = 16;                 // warps of a block: all demux
constexpr int kFirWarps = 8;               // the first kFirWarps filter
constexpr int kThreads = 32 * kWarps;
// the thread that issues the stages' copies: in a warp that does not
// filter, where there is one
constexpr int kProducer = kFirWarps < kWarps ? 32 * kFirWarps : 0;
constexpr int kPartM = 16;                 // outputs of one FIR warp per step
constexpr int kStepOut = kFirWarps * kPartM;  // outputs of one step
constexpr int kRowPass = kThreads / kCg;   // rows one demux pass covers
constexpr int kBoxRows = 128;              // rows of a tensor-map box
constexpr int kMaxSliceTaps = 64;          // taps of one FIR slice at most
constexpr int kStageBudget = 65536;        // bytes of the raw stages
constexpr int kRingSteps = 2;              // steps the ring keeps, if they fit
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;
static_assert(kBoxRows % kRowPass == 0,
              "a thread's demux rows must run on from unit to unit");

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The low-pass's polyphase cut: S slices of dps taps per branch (dps one
// of the instantiations, ops/wfm_tail.py SLICE_TAPS); dps 0 when none
// covers ntaps taps at decimation F.
struct Slices {
  int S, dps;
};

inline Slices tail_slices(int ntaps, int F) {
  if (F < 1 || ntaps < 1) return Slices{0, 0};
  const int need = (ntaps + F - 1) / F;
  const int S = (need + kMaxSliceTaps - 1) / kMaxSliceTaps;
  const int per = (need + S - 1) / S;
  for (int inst : {8, 16, 32, 60, 64})
    if (per <= inst) return Slices{S, inst};
  return Slices{S, 0};
}

// The march's geometry and shared-memory layout (bytes; ops/wfm_tail.py
// mirrors it in tail_march_layout).  A step makes kStepOut outputs from
// step_rows = kStepOut F new rows; the ring keeps hist rows before them:
// the FIR's F S dps - 1 rows of history, or d_rows for hist' when that is
// more, rounded up to whole boxes (the prologue unit), then kRingSteps
// steps where they fit (a rewind every kRingSteps steps), else the fewest
// that keep the rewind's copy off its own source.  Layout: the
// stages' barriers, `stages` raw stages of stage_rows x 16 float32 (a
// unit: the prologue or a step), the ring [ring_rows][32] ([mono | L-R]),
// the taps [F][S][dps].
struct TailGeom {
  int F, dps, S, step_rows, fir_hist, hist, ring_rows, stage_rows;
  int stage_bytes, stages, stage_off, ring, taps, smem;
  __host__ __device__ TailGeom(int F_, int dps_, int S_, int d_rows) {
    F = F_;
    dps = dps_;
    S = S_;
    step_rows = kStepOut * F;
    fir_hist = F * S * dps - 1;
    hist = round_up(fir_hist > d_rows ? fir_hist : d_rows, kBoxRows);
    stage_rows = step_rows > hist ? step_rows : hist;
    stage_bytes = stage_rows * kCg * 4;
    stages = kStageBudget / stage_bytes;
    stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
    stage_off = 128;                        // the stage barriers below
    ring = stage_off + stages * stage_bytes;
    int x_min = (hist + step_rows - 1) / step_rows;
    x_min = x_min < 1 ? 1 : x_min;
    for (int x = x_min > kRingSteps ? x_min : kRingSteps; x >= x_min; --x) {
      ring_rows = hist + x * step_rows;
      taps = ring + ring_rows * kLanes * 4;
      smem = round_up(taps + F * S * dps * 4, 128);
      if (smem <= kMaxSmem) break;
    }
  }
  __host__ __device__ bool ok() const {
    return dps > 0 && smem <= kMaxSmem && step_rows % kBoxRows == 0
           && stage_bytes <= (int)bulk::kMaxTxBytes;
  }
};

inline TailGeom tail_geom(int ntaps, int F, int d_rows) {
  const Slices s = tail_slices(ntaps, F);
  return TailGeom(F, s.dps, s.S, d_rows);
}

// The work items: a channel group (16 channels) x a time segment of ms
// outputs (the last one shorter; a segment's last step stores only its
// own outputs), item i = segment i / groups, channel group i % groups.
// ms is chosen for the fewest rows on the busiest of `slots` resident
// blocks, among the choices with at least two items per slot where the
// shape has them (ops/wfm_tail.py mirrors this in tail_march_plan).
struct TailPlanC {
  int ms, nseg, items, grid;
};

inline TailPlanC tail_plan(int T, int C, const TailGeom& g, int slots) {
  const int M = T / g.F, groups = (C + kCg - 1) / kCg;
  const int max_seg = (M + kStepOut - 1) / kStepOut;
  const int n_lo = min(max((2 * slots + groups - 1) / groups, 1), max_seg);
  TailPlanC best{M, 1, groups, 0};
  long long best_cost = -1;
  for (int n = n_lo; n <= min(4 * n_lo, max_seg); ++n) {
    const int ms = (M + n - 1) / n;
    const int nseg = (M + ms - 1) / ms;
    const int items = groups * nseg;
    if (nseg < n_lo) continue;
    const long long waves = (items + slots - 1) / slots;
    const long long cost =
        waves * ((long long)(ms + kStepOut - 1) / kStepOut * g.step_rows
                 + g.hist);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = TailPlanC{ms, nseg, items, 0};
    }
  }
  best.grid = min(best.items, slots);
  return best;
}

// Everything the kernel takes besides the composite's tensor map.
struct Tail {
  const float *raw, *p0, *wf, *hist, *h;
  int T, C, ell, d_rows, ntaps, F, S, ms, items;
  bool tma;                       // stage by tensor-map boxes (else element
                                  // by element)
  float *y, *hist_out;
};

// 2 sin(2 (p0 + wf r)) in the plain version's float32 rounding.
__device__ __forceinline__ float demux_gain(float p0, float wf, int r) {
  const float ph = __fmul_rn(2.0f, __fadd_rn(p0, __fmul_rn(wf, (float)r)));
  return 2.0f * sinf(ph);
}

// Stage rows [t0, t0 + rows) of channels [c0, c0 + 16) element by element
// into dst [rows][16] (zeros outside the composite) by asynchronous 4-byte
// copies, for composites a tensor map cannot box.  The caller commits,
// waits and synchronizes.
__device__ void stage_elements(float* dst, const float* __restrict__ raw,
                               int T, int C, int c0, int t0, int rows) {
  for (int e = threadIdx.x; e < rows * kCg; e += kThreads) {
    const int i = e / kCg, c = c0 + e % kCg, t = t0 + i;
    if (c < C && t >= 0 && t < T)
      __pipeline_memcpy_async(dst + e, raw + (size_t)t * C + c, sizeof(float));
    else
      dst[e] = 0.0f;
  }
}

// grid plan.grid, block kThreads, g.smem bytes of dynamic shared memory.
// y[o] = sum_{j=0..D} h[j] a[F o - j], a = [raw | lmr], a[t < 0] =
// hist[d_rows + t]; DPS taps per slice, S slices per branch (h zero-padded
// to F S DPS taps); FT the decimation when it is fixed at compile time
// (0: a.F).  Block b walks items b, b + gridDim.x, ...; an item's units
// are its prologue (rows [F o_s - hist, F o_s) into ring rows [0, hist))
// and its steps (step j: rows F (o_s + 128 j) + [0, step_rows) after the
// ring's history).  Each unit waits for its stage (kProducer keeps
// `stages` units in flight; with a.tma false the block stages it element
// by element first), is demuxed into the ring, and frees its stage for
// the unit `stages` later; each step then runs the FIR: warp w <
// kFirWarps makes outputs 16 w .. 16 w + 15 of the step, output o reading
// ring rows F o - F (s DPS + i) - p for branch p, slice s, tap i.
template <int DPS, int FT>
__global__ void __launch_bounds__(kThreads, 1)
wfm_tail_march(const __grid_constant__ CUtensorMap map, Tail a) {
  extern __shared__ __align__(128) unsigned char tail_smem[];
  const int F = FT ? FT : a.F;
  const TailGeom g(F, DPS, a.S, a.d_rows);
  const int tid = threadIdx.x, C = a.C, T = a.T;
  const size_t c2 = 2 * (size_t)C;
  const int groups = (C + kCg - 1) / kCg, M = T / F, nchunk = T / a.ell;
  uint64_t* full = reinterpret_cast<uint64_t*>(tail_smem);
  unsigned char* stages = tail_smem + g.stage_off;
  float* ring = reinterpret_cast<float*>(tail_smem + g.ring);
  float* h_s = reinterpret_cast<float*>(tail_smem + g.taps);
  auto stage = [&](int u) {
    return reinterpret_cast<float*>(stages
                                    + (size_t)(u % g.stages) * g.stage_bytes);
  };

  auto seg_start = [&](int item) { return (item / groups) * a.ms; };
  auto item_steps = [&](int item) {
    const int o_s = seg_start(item);
    return (min(o_s + a.ms, M) - o_s + kStepOut - 1) / kStepOut;
  };
  // unit `unit` of item: its first row and its rows
  auto unit_rows = [&](int item, int unit, int* t0) {
    const int o_s = seg_start(item);
    *t0 = unit ? F * o_s + (unit - 1) * g.step_rows : F * o_s - g.hist;
    return unit ? g.step_rows : g.hist;
  };
  // the block's stream of units, and (kProducer) the next one to issue
  int total = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x)
    total += 1 + item_steps(i);
  int p_item = blockIdx.x, p_unit = 0;
  auto issue = [&](int u) {                      // stream entry u
    uint64_t* bar = full + u % g.stages;
    unsigned char* dst = reinterpret_cast<unsigned char*>(stage(u));
    int t0;
    const int rows = unit_rows(p_item, p_unit, &t0);
    const int c0 = (p_item % groups) * kCg;
    // boxes wholly before t = 0 or past T are not fetched: their rows
    // come from the carried history or feed no stored output
    uint32_t bytes = 0;
    for (int r = 0; r < rows; r += kBoxRows)
      if (t0 + r + kBoxRows > 0 && t0 + r < T) bytes += kBoxRows * kCg * 4;
    bulk::mbar_arrive_expect_tx(bar, bytes);
    for (int r = 0; r < rows; r += kBoxRows)
      if (t0 + r + kBoxRows > 0 && t0 + r < T)
        bulk::load_2d(dst + (size_t)r * kCg * 4, &map, c0, t0 + r, bar);
    if (++p_unit == 1 + item_steps(p_item)) {
      p_item += gridDim.x;
      p_unit = 0;
    }
  };
  if (a.tma && tid == kProducer) {
    for (int s = 0; s < g.stages; ++s) bulk::mbar_init(full + s, 1);
    bulk::fence_mbar_init();
    for (int u = 0; u < g.stages && u < total; ++u) issue(u);
  }
  // the taps, h_s[(p S + s) DPS + i] = h[F (s DPS + i) + p] (read after
  // the prologue's barriers)
  for (int i = tid; i < F * a.S * DPS; i += kThreads) {
    const int ps = i / DPS, k = i - ps * DPS;
    const int p = ps / a.S, s = ps - p * a.S;
    const int j = F * (s * DPS + k) + p;
    h_s[i] = j < a.ntaps ? a.h[j] : 0.0f;
  }

  // the demux's channel and row of this thread; the FIR's warp and lane
  const int dc = tid % kCg, dr = tid / kCg;
  const int warp = tid / 32, lane = tid % 32;
  int u = 0;                                     // the block's stream entry
  // wait for unit u's rows in its stage (rows from t0)
  auto land = [&](int item, int unit) {
    if (a.tma) {
      bulk::mbar_wait(full + u % g.stages, (uint32_t)(u / g.stages) & 1u);
    } else {
      int t0;
      const int rows = unit_rows(item, unit, &t0);
      stage_elements(stage(u), a.raw, T, C, (item % groups) * kCg, t0, rows);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
  };
  // the stage of unit u is free: refill it with unit u + stages
  auto refill = [&]() {
    if (a.tma && tid == kProducer && u + g.stages < total) {
      bulk::fence_async_smem();
      issue(u + g.stages);
    }
  };
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int c0 = (item % groups) * kCg;
    const int o_s = seg_start(item), o_e = min(o_s + a.ms, M);
    const int nsteps = item_steps(item);
    const int c = c0 + dc;
    const bool in = c < C;
    // this thread's next row, its pilot chunk k and its index r_in in the
    // chunk, and the pilot parameters of chunks k and k + 1
    int t = F * o_s - g.hist + dr;
    int k = floor_div(t, a.ell), r_in = t - k * a.ell;
    auto param = [&](const float* v, int kk) {
      return in && kk >= 0 && kk < nchunk ? v[(size_t)kk * C + c] : 0.0f;
    };
    float p0c = param(a.p0, k), wfc = param(a.wf, k);
    float p0n = param(a.p0, k + 1), wfn = param(a.wf, k + 1);
    // unit rows from stage st -> ring rows [dst, dst + n): [raw | lmr],
    // the carried history before t = 0, zeros past T and for channels >= C.
    // A warp's two half-warps hold neighbouring rows and write their
    // [mono | L-R] halves in opposite order, so no store shares a bank.
    auto demux = [&](const float* st, int n, int dst) {
#pragma unroll 4
      for (int i = dr; i < n; i += kRowPass) {
        float mono = 0.0f, lmr = 0.0f;
        if (in && t >= 0) {
          if (t < T) {
            mono = st[i * kCg + dc];
            lmr = __fmul_rn(mono, demux_gain(p0c, wfc, r_in));
          }
        } else if (in && t >= -a.d_rows) {
          const size_t hr = (size_t)(a.d_rows + t) * c2;
          mono = a.hist[hr + c];
          lmr = a.hist[hr + C + c];
        }
        float* row = ring + (size_t)(dst + i) * kLanes;
        const bool odd = i & 1;
        row[odd ? kCg + dc : dc] = odd ? lmr : mono;
        row[odd ? dc : kCg + dc] = odd ? mono : lmr;
        t += kRowPass;
        r_in += kRowPass;
        while (r_in >= a.ell) {
          r_in -= a.ell;
          ++k;
          p0c = p0n;
          wfc = wfn;
          p0n = param(a.p0, k + 1);
          wfn = param(a.wf, k + 1);
        }
      }
    };

    __syncthreads();             // the last item is done with the ring
    land(item, 0);               // the prologue
    demux(stage(u), g.hist, 0);
    __syncthreads();
    refill();
    ++u;
    int pos = g.hist;                            // ring row of row F o0
    for (int j = 0; j < nsteps; ++j, ++u) {
      if (pos + g.step_rows > g.ring_rows) {     // rewind: history down
        __syncthreads();
        const int n4 = g.hist * kLanes / 4, src = (pos - g.hist) * kLanes / 4;
        float4* r4 = reinterpret_cast<float4*>(ring);
        for (int e = tid; e < n4; e += kThreads) r4[e] = r4[src + e];
        pos = g.hist;
        __syncthreads();
      }
      land(item, 1 + j);
      demux(stage(u), g.step_rows, pos);
      __syncthreads();
      refill();

      // the FIR (warps below kFirWarps): this warp's outputs o0 + 16 warp
      // + ol, over branches p and slices s
      const int o0 = o_s + j * kStepOut;
      if (warp < kFirWarps) {
        float acc[kPartM];
#pragma unroll
        for (int ol = 0; ol < kPartM; ++ol) acc[ol] = 0.0f;
        const float* win =
            ring + (size_t)(pos + F * (warp * kPartM - (DPS - 1))) * kLanes
            + lane;
        for (int p = 0; p < F; ++p) {
          for (int s = 0; s < a.S; ++s) {
            float hr[DPS];
            const float4* h4 =
                reinterpret_cast<const float4*>(h_s + (p * a.S + s) * DPS);
#pragma unroll
            for (int i = 0; i < DPS / 4; ++i) {
              const float4 v = h4[i];
              hr[4 * i] = v.x;
              hr[4 * i + 1] = v.y;
              hr[4 * i + 2] = v.z;
              hr[4 * i + 3] = v.w;
            }
            poly::fir_column<kPartM, DPS>(
                win - (ptrdiff_t)(F * s * DPS + p) * kLanes, F * kLanes, hr,
                acc);
          }
        }
        const int ch = c0 + (lane & (kCg - 1));
        if (ch < C) {
          float* yl = a.y + (lane < kCg ? 0 : (size_t)C) + ch;
#pragma unroll
          for (int ol = 0; ol < kPartM; ++ol) {
            const int o = o0 + warp * kPartM + ol;
            if (o < o_e) yl[(size_t)o * c2] = acc[ol];
          }
        }
      }
      if (j + 1 == nsteps && o_e == M) {
        // hist': rows T - d_rows .. T - 1 lie at ring rows from r0
        const int r0 = pos + T - a.d_rows - F * o0;
        for (int e = tid; e < a.d_rows * kLanes; e += kThreads) {
          const int i = e / kLanes, l = e - i * kLanes;
          const int cc = c0 + (l & (kCg - 1));
          if (cc < C)
            a.hist_out[(size_t)i * c2 + (l < kCg ? 0 : (size_t)C) + cc] =
                ring[(size_t)(r0 + i) * kLanes + l];
        }
      }
      pos += g.step_rows;
    }
  }
}

template <int DPS, int FT>
cudaError_t launch_tail(const Tail& args, const TailGeom& g, int device,
                        cudaStream_t st) {
  auto kernel = wfm_tail_march<DPS, FT>;
  int slots = 0;
  cudaError_t err =
      launch::resident_blocks(kernel, device, kThreads, g.smem, 1, &slots);
  if (err != cudaSuccess) return err;
  const TailPlanC p = tail_plan(args.T, args.C, g, slots);
  Tail a = args;
  a.ms = p.ms;
  a.items = p.items;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma && (err = launch::plane_map(a.raw, a.C, a.T, 4, kCg, kBoxRows,
                                      &map)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)p.grid, kThreads, g.smem, st>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the march needs for a low-pass of ntaps taps decimating by
// F (the carried history d_rows = ntaps - 1 rounded up to 8; ell >= 1 the
// pilot chunk); 0 when no instantiation covers it or it does not fit a
// block.
size_t wfm_tail_smem_bytes(int ntaps, int F, int ell) {
  if (ell < 1) return 0;
  const TailGeom g = tail_geom(ntaps, F, round_up(ntaps - 1, 8));
  return g.ok() ? (size_t)g.smem : 0;
}

// The march's work items on `slots` resident blocks for a [T, C]
// composite: out = {segment outputs, segments, items, grid, step rows,
// history rows, ring rows, stages, stage rows, slices, taps per slice};
// returns 0, or -1 when no instantiation covers the plan.
int wfm_tail_plan(int T, int C, int ntaps, int F, int ell, int slots,
                  int* out) {
  const TailGeom g = tail_geom(ntaps, F, round_up(ntaps - 1, 8));
  if (!g.ok() || T <= 0 || C <= 0 || slots <= 0 || ell < 1) return -1;
  const TailPlanC p = tail_plan(T, C, g, slots);
  const int v[11] = {p.ms, p.nseg, p.items, p.grid, g.step_rows, g.hist,
                     g.ring_rows, g.stages, g.stage_rows, g.S, g.dps};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

const char* wfm_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One tail dispatch of T composite rows (T * 2C < 2^31; T a multiple of F
// and of ell; d_rows >= ntaps - 1): audio y [T/F, 2C] and hist_out
// [d_rows, 2C], in one launch.  tma != 0 stages by tensor-map boxes (C %
// 4 == 0, raw 16-byte aligned), else element by element.  Returns the
// first CUDA error.
int wfm_tail_forward(int device, const float* raw, int T, int C,
                     const float* p0, const float* wf, int ell,
                     const float* hist, int d_rows, const float* h, int ntaps,
                     int F, float* y, float* hist_out, int tma, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (T <= 0 || C <= 0 || F < 1 || ell < 1 || T % F || T % ell
      || d_rows < ntaps - 1 || (long long)T * 2 * C >= (1LL << 31)
      || (tma && (C % 4 || reinterpret_cast<uintptr_t>(raw) % 16)))
    return cudaErrorInvalidValue;
  const Slices s = tail_slices(ntaps, F);
  const TailGeom g(F, s.dps, s.S, d_rows);
  if (!g.ok()) return cudaErrorInvalidValue;
  Tail a;
  a.raw = raw; a.p0 = p0; a.wf = wf; a.hist = hist; a.h = h;
  a.T = T; a.C = C; a.ell = ell; a.d_rows = d_rows; a.ntaps = ntaps;
  a.F = F; a.S = s.S; a.ms = a.items = 0;
  a.tma = tma != 0;
  a.y = y; a.hist_out = hist_out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (s.dps == 60 && F == 4) return launch_tail<60, 4>(a, g, device, st);
  switch (s.dps) {
    case 8: return launch_tail<8, 0>(a, g, device, st);
    case 16: return launch_tail<16, 0>(a, g, device, st);
    case 32: return launch_tail<32, 0>(a, g, device, st);
    case 60: return launch_tail<60, 0>(a, g, device, st);
    case 64: return launch_tail<64, 0>(a, g, device, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
