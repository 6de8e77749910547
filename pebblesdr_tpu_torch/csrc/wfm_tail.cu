// Fused WFM stereo tail for Hopper (sm_90a): stereo demux + decimating audio
// low-pass, from the time-major composite [T, C] to the packed audio plane
// [T/F, 2C] = [mono | L-R].
//
// Replaces the TPU kernel _wfm_tail_kernel / wfm_tail_packed
// (pebblesdr_tpu/ops/pallas_kernels.py:869, :917).  The plain PyTorch version
// is wfm_tail_reference in ops/wfm_tail.py.
//
// What bounds it: the composite is read once and the audio written once (at
// the WFM headline, 32 MiB in and 16 MiB out per dispatch: ~15 us at
// 3.35 TB/s), and the low-pass costs D+1 FMAs per output lane (235 taps,
// 32768 x 128 outputs: ~1 GFMA, ~30 us at the float32 peak).  The TPU kernel
// walks sub-blocks in order and carries the filter history in VMEM; here
// every block is independent:
//   1. wfm_tail_fir: tiles of kM decimated outputs x 8 channels.  A block
//      stages its halo of input rows in shared memory with asynchronous
//      copies (rows before t = 0 come from the carried packed history, whose
//      L-R lanes are already demuxed), together with the pilot's per-chunk
//      phase parameters of the rows it covers; it then forms
//      lmr = raw * 2 sin(2 (p0[f] + wf[f] r)) for row fL + r in place and
//      runs the FIR in polyphase form.  The decimation is small (F = 4), so
//      each branch's taps are split over kGroups/F thread groups: every one
//      of the 16 groups holds a slice of one branch's taps in registers
//      while its column of staged samples streams past once, fully
//      unrolled; the groups' partial sums meet in shared memory.
//   2. wfm_tail_hist: the last d_rows rows of [raw | lmr], the history
//      carried to the next dispatch.
// The demux phase uses round-to-nearest intrinsics (no FMA contraction) and
// sinf (not __sinf), so its argument is the plain version's float32 value
// bit for bit.  Every dot is IEEE float32.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kCg = 8;          // channels per block
constexpr int kLanes = 2 * kCg; // mono + L-R lanes per block
constexpr int kGroups = 16;     // tap groups per block
constexpr int kThreads = kLanes * kGroups;
constexpr int kM = 32;          // decimated outputs per block
constexpr int kMaxSmem = 232448;

// Shared-memory layout (floats), 32-aligned.  The u area stages the span
// input rows and afterwards the groups' partial sums [kGroups][kM][kLanes].
struct TailSmem {
  int h, p0, wf, u, total;
  __host__ __device__ TailSmem(int F, int dp, int ell) {
    const int span = F * (kM + dp - 1);
    const int nk = span / ell + 2;
    h = 0;
    p0 = align32(F * dp);
    wf = p0 + align32(nk * kCg);
    u = wf + align32(nk * kCg);
    total = u + (span > kGroups * kM ? span : kGroups * kM) * kLanes;
  }
  __host__ __device__ static int align32(int v) { return (v + 31) & ~31; }
};

// 2 sin(2 (p0 + wf r)) in the plain version's float32 rounding.
__device__ __forceinline__ float demux_gain(float p0, float wf, int r) {
  const float ph = __fmul_rn(2.0f, __fadd_rn(p0, __fmul_rn(wf, (float)r)));
  return 2.0f * sinf(ph);
}

// grid (ceil(C/kCg), ceil((T/F)/kM)), block (kLanes, kGroups).
// y[o] = sum_{j=0..D} h[j] a[F o - j], a = [raw | lmr], a[t < 0] =
// hist[d_rows + t].  Each branch p has DP = S*DPS taps (zero-padded), split
// into S slices of DPS taps; item it = g, g + kGroups, ... < F*S takes
// branch it % F, slice it / F.
template <int DPS>
__global__ void __launch_bounds__(kThreads)
wfm_tail_fir(const float* __restrict__ raw, int T, int C,
             const float* __restrict__ p0, const float* __restrict__ wf,
             int ell, const float* __restrict__ hist, int d_rows,
             const float* __restrict__ h, int ntaps, int F, int S,
             float* __restrict__ y) {
  extern __shared__ float smem[];
  const int DP = S * DPS;
  const TailSmem lay(F, DP, ell);
  float* h_s = smem + lay.h;                      // [F][DP]: h[F i + p]
  float* u_s = smem + lay.u;                      // [span][kLanes]
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const size_t c2 = 2 * (size_t)C;
  const int c0 = blockIdx.x * kCg;
  const int o0 = blockIdx.y * kM;
  const int span = F * (kM + DP - 1);
  const int t_base = F * o0 - F * DP + 1;         // row of u_s[0]
  const int t_lo = max(t_base, 0);
  const int t_hi = min(t_base + span, T);         // rows [t_lo, t_hi) are input
  const int k_base = t_lo / ell;

  // 1. Input rows [t_base, t_base + span) -> u_s by asynchronous copies:
  // the raw composite into the mono lanes (the L-R lanes are formed from it
  // below), the carried history into both lanes for rows before t = 0,
  // zeros elsewhere ...
  for (int e = tid; e < span * kLanes; e += kThreads) {
    const int row = e / kLanes, l = e - row * kLanes;
    const bool mono = l < kCg;
    const int c = c0 + (mono ? l : l - kCg);
    const int t = t_base + row;
    float* dst = u_s + e;
    if (c < C && t >= 0 && t < T) {
      if (mono)
        __pipeline_memcpy_async(dst, raw + (size_t)t * C + c, sizeof(float));
    } else if (c < C && t < 0 && t >= -d_rows) {
      __pipeline_memcpy_async(
          dst, hist + (size_t)(d_rows + t) * c2 + (mono ? 0 : C) + c,
          sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
  __pipeline_commit();

  // ... while they land: the taps and the pilot parameters of the covered
  // chunks.
  for (int i = tid; i < F * DP; i += kThreads) {
    const int p = i / DP, k = i - p * DP, j = F * k + p;
    h_s[i] = j < ntaps ? h[j] : 0.0f;
  }
  if (t_lo < t_hi) {
    const int nk = (t_hi - 1) / ell - k_base + 1;
    for (int i = tid; i < nk * kCg; i += kThreads) {
      const int k = i / kCg, c = c0 + i % kCg;
      const size_t src = (size_t)(k_base + k) * C + c;
      smem[lay.p0 + i] = c < C ? p0[src] : 0.0f;
      smem[lay.wf + i] = c < C ? wf[src] : 0.0f;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. Stereo demux of the input rows, in place: lmr = raw * 2 sin(2 phase).
  for (int e = tid; e < (t_hi - t_lo) * kCg; e += kThreads) {
    const int t = t_lo + e / kCg, cc = e % kCg;
    if (c0 + cc >= C) continue;
    const int k = t / ell - k_base;
    float* row = u_s + (t - t_base) * kLanes;
    row[kCg + cc] = __fmul_rn(row[cc],
                              demux_gain(smem[lay.p0 + k * kCg + cc],
                                         smem[lay.wf + k * kCg + cc],
                                         t % ell));
  }
  __syncthreads();

  // 3. Polyphase FIR (polyphase.cuh).  Slice s of branch p holds taps
  // i = s*DPS + i' of h[F i + p]; tap i of local output ol reads shared row
  // F (ol - i + DP) - 1 - p, i.e. row slice_row(p, s) + F (m-1) with
  // m = ol - i' + DPS in [1, kM + DPS - 1].
  const int lx = threadIdx.x, g = threadIdx.y;
  float acc[kM];
#pragma unroll
  for (int ol = 0; ol < kM; ++ol) acc[ol] = 0.0f;
  for (int it = g; it < F * S; it += kGroups) {
    const int p = it % F, s = it / F;
    float hr[DPS];
#pragma unroll
    for (int i = 0; i < DPS; ++i) hr[i] = h_s[p * DP + s * DPS + i];
    poly::fir_column<kM, DPS>(
        u_s + poly::slice_row(F, S, DPS, p, s) * kLanes + lx, F * kLanes, hr,
        acc);
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
      float sum = 0.0f;
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) sum += red[(gg * kM + ol) * kLanes + l];
      y[(size_t)o * c2 + (l < kCg ? (size_t)cch : (size_t)C + cch)] = sum;
    }
  }
}

// grid ceil(d_rows*C/256), block 256: the last d_rows rows of [raw | lmr].
__global__ void wfm_tail_hist(const float* __restrict__ raw, int T, int C,
                              const float* __restrict__ p0,
                              const float* __restrict__ wf, int ell,
                              const float* __restrict__ hist, int d_rows,
                              float* __restrict__ hist_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d_rows * C) return;
  const int i = idx / C, c = idx % C;
  const size_t c2 = 2 * (size_t)C;
  const int t = T - d_rows + i;
  float mono, lmr;
  if (t >= 0) {
    const size_t k = (size_t)(t / ell) * C + c;
    mono = raw[(size_t)t * C + c];
    lmr = __fmul_rn(mono, demux_gain(p0[k], wf[k], t % ell));
  } else {
    mono = hist[(size_t)(d_rows + t) * c2 + c];
    lmr = hist[(size_t)(d_rows + t) * c2 + C + c];
  }
  hist_out[i * c2 + c] = mono;
  hist_out[i * c2 + C + c] = lmr;
}

// Taps per slice the FIR kernel is instantiated for (ops/wfm_tail.py
// mirrors this list in SLICE_TAPS).
int slice_taps(int ntaps, int F, int S) {
  const int dp = (ntaps + F - 1) / F;
  const int dps = (dp + S - 1) / S;
  for (int inst : {8, 16, 24, 32})
    if (dps <= inst) return inst;
  return 0;
}

int slices(int F) { return F < kGroups ? kGroups / F : 1; }

}  // namespace

extern "C" {

// Shared memory the FIR kernel needs; 0 when no instantiation covers it.
size_t wfm_tail_smem_bytes(int ntaps, int F, int ell) {
  const int S = slices(F);
  const int dps = slice_taps(ntaps, F, S);
  if (!dps) return 0;
  return (size_t)TailSmem(F, S * dps, ell).total * sizeof(float);
}

const char* wfm_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One tail dispatch of T composite rows (T * 2C < 2^31; T a multiple of F
// and of ell; T / F / kM < 65536).  Returns the first CUDA error.
int wfm_tail_forward(int device, const float* raw, int T, int C,
                     const float* p0, const float* wf, int ell,
                     const float* hist, int d_rows, const float* h, int ntaps,
                     int F, float* y, float* hist_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int S = slices(F);
  const size_t smem = wfm_tail_smem_bytes(ntaps, F, ell);
  if (smem == 0 || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kCg - 1) / kCg),
                  (unsigned)((T / F + kM - 1) / kM));
  const dim3 block(kLanes, kGroups);
  switch (slice_taps(ntaps, F, S)) {
#define WFM_TAIL_CASE(DPS)                                                   \
  case DPS:                                                                  \
    err = cudaFuncSetAttribute(wfm_tail_fir<DPS>,                            \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                   \
    if (err != cudaSuccess) return err;                                      \
    wfm_tail_fir<DPS><<<grid, block, smem, st>>>(raw, T, C, p0, wf, ell,     \
                                                 hist, d_rows, h, ntaps, F,  \
                                                 S, y);                      \
    break;
    WFM_TAIL_CASE(8)
    WFM_TAIL_CASE(16)
    WFM_TAIL_CASE(24)
    WFM_TAIL_CASE(32)
#undef WFM_TAIL_CASE
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int nt = d_rows * C;
  wfm_tail_hist<<<(unsigned)((nt + 255) / 256), 256, 0, st>>>(
      raw, T, C, p0, wf, ell, hist, d_rows, hist_out);
  return cudaGetLastError();
}

}  // extern "C"
