// Fused wideband front end for Hopper (sm_90a): DC blocker + NCO mix +
// composed-FIR decimation, on one lane-packed [T, 2C] float32 plane (re in
// lanes [0, C), im in lanes [C, 2C)).
//
// Replaces the TPU kernel _front_kernel / fused_front_packed
// (pebblesdr_tpu/ops/pallas_kernels.py:119, :516) with float32 input, no IQ
// balance, no noise blanker, no in-kernel composite decimation, fold 1; with
// or without the FM discriminator (disc_gain, pallas_kernels.py:352-374) and
// the trailing-window y output (y_tail_rows, :344-351).  The plain PyTorch
// version is fused_front_reference in ops/front.py.
//
// What bounds it: the input plane is read once (512 MiB per headline
// dispatch of 32 x 32768 rows x 128 lanes), and the FIR costs (D+1) FMAs per
// output lane: D = 710 for the factor-32 AM plan, about 3 GFMA a dispatch;
// D = 282 for the factor-8 WFM plan, about 4.75 GFMA.
// The TPU kernel walks 2048-row sub-blocks in order and carries the DC
// estimate and the FIR history from one grid step to the next; a Hopper grid
// runs in no order, so the carried state becomes closed forms:
//   1. front_means: per-chunk (512-row) means of every lane, in parallel over
//      chunks; it also copies each block's trailing raw rows (display tails).
//   2. front_dc_scan: the chunk EWMA m_k = a m_{k-1} + (1-a) mu_k as a
//      two-level scan (32 segments per lane, then the 32 segment seeds).
//   3. front_fir: tiles of 24 decimated outputs x 8 channels, two blocks per
//      SM, consecutive blocks on the channel groups of one time tile (so each
//      512-byte input row is fetched once from DRAM).  Each block re-reads a
//      halo of D input rows (mostly from L2) into shared memory with
//      asynchronous copies, all in flight at once; while they land it builds
//      the DC estimates of the covered chunks and the oscillator's phasor
//      tables; then it DC-removes and mixes the tile in place (rows before
//      t = 0 come from the carried post-mix tail) and runs the FIR in
//      polyphase form: each of 16 thread groups holds one branch's taps in
//      registers while that branch's column of staged samples streams past
//      once, fully unrolled (one shared load per up to 24 FMAs); the groups'
//      partial sums meet in shared memory.
//   4. front_tail: the post-mix history carried to the next dispatch.
//   5. front_disc (WFM only): the FM discriminator of every decimated row,
//      atan2(y[o] conj(y[o-1])) * gain with y[-1] the carried disc_last, the
//      next disc_last, and each block's trailing y_tail_rows rows of y.  The
//      TPU kernel carries y[o-1] across its sequential grid steps; here the
//      FIR writes all of y to scratch and this pass reads it back (64 MiB
//      per WFM headline dispatch), so no tile needs its neighbour's output.
//      The conj product uses round-to-nearest intrinsics so no contraction
//      changes a zero's sign: the first row after a zero seed lands on
//      atan2(+-0, -0) = +-pi exactly as the plain version does.
// The oscillator is factored as in the TPU kernel: a coarse phasor per
// 128 rows times a fine phasor per row within them, with the phases in the
// split form (t = 2048 s + 128 q + r, f_hi on the 2^-12 grid).  The phase
// arithmetic uses round-to-nearest intrinsics, so no FMA contraction changes
// its rounding: the plain PyTorch version computes the same float32 phases
// bit for bit.  Every dot is IEEE float32.

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

// grid (nchunk, ceil(2C/32)), block (32, 8)
__global__ void front_means(const float* __restrict__ x, int c2, int n,
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
      const float v = x[(size_t)t * c2 + lane];
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

// Shared-memory layout of the FIR block (floats), all offsets 32-aligned.
// The u area first stages the span input rows, then holds the groups'
// partial sums [kGroups][kM][kLanes], so it is sized for the larger.
// ops/front.py mirrors this layout (fir_smem_layout).
struct FirSmem {
  int h, fine_c, fine_s, coarse_c, coarse_s, dc, u, total;
  __host__ __device__ FirSmem(int F, int dp) {
    const int span = F * (kM + dp - 1);
    h = 0;
    fine_c = align32(h + F * dp);
    fine_s = fine_c + kQ * kCg;
    coarse_c = fine_s + kQ * kCg;
    coarse_s = coarse_c + align32(max_q(span) * kCg);
    dc = coarse_s + align32(max_q(span) * kCg);
    u = dc + align32(max_chunks(span) * kLanes);
    total = u + (span > kGroups * kM ? span : kGroups * kM) * kLanes;
  }
  __host__ __device__ static int align32(int v) { return (v + 31) & ~31; }
  __host__ __device__ static int max_q(int span) { return span / kQ + 2; }
  __host__ __device__ static int max_chunks(int span) {
    return span / kDcChunk + 2;
  }
};

// grid (ceil(C/kCg), ceil((T/F)/kM)), block (kLanes, kGroups).
// y[o] = sum_{j=0..D} h[j] u[F o - j], u[t < 0] = tail[d_rows + t].
// DP taps per polyphase branch (h zero-padded to F*DP taps).
template <int DP>
__global__ void __launch_bounds__(kThreads)
front_fir(const float* __restrict__ x, int T, int C,
          const float* __restrict__ mseq, const float* __restrict__ tail_in,
          int d_rows, const float* __restrict__ phase0,
          const float* __restrict__ fhi, const float* __restrict__ flo,
          const float* __restrict__ h, int ntaps, int F,
          float* __restrict__ y) {
  extern __shared__ float smem[];
  const FirSmem lay(F, DP);
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
  const int q_base = t_lo / kQ;
  const int k_base = t_lo / kDcChunk;

  // 1. Raw input rows [t_base, t_base + span) -> u_s by asynchronous copies,
  // all in flight at once (rows before t = 0 come from the carried post-mix
  // tail, rows outside both are zero) ...
  for (int e = tid; e < span * kLanes; e += kThreads) {
    const int row = e / kLanes, l = e - row * kLanes;
    const int c = c0 + (l < kCg ? l : l - kCg);
    const size_t col = (l < kCg ? 0 : (size_t)C) + c;
    const int t = t_base + row;
    float* dst = u_s + e;
    if (c < C && t >= 0 && t < T) {
      __pipeline_memcpy_async(dst, x + (size_t)t * c2 + col, sizeof(float));
    } else if (c < C && t < 0 && t >= -d_rows) {
      __pipeline_memcpy_async(dst, tail_in + (size_t)(d_rows + t) * c2 + col,
                              sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
  __pipeline_commit();

  // ... while they land: the taps, the DC estimates of the covered chunks,
  // and the oscillator's fine (row within 128) and coarse (per 128 rows)
  // phasors of this block's channels.
  for (int i = tid; i < F * DP; i += kThreads) {
    const int p = i / DP, k = i - p * DP, j = F * k + p;
    h_s[i] = j < ntaps ? h[j] : 0.0f;
  }
  if (t_lo < t_hi) {
    const int nk = (t_hi - 1) / kDcChunk - k_base + 1;
    for (int i = tid; i < nk * kLanes; i += kThreads) {
      const int k = i / kLanes, l = i - k * kLanes;
      const int c = c0 + (l < kCg ? l : l - kCg);
      smem[lay.dc + i] = c < C ? mseq[(size_t)(k_base + k) * c2
                                      + (l < kCg ? 0 : C) + c] : 0.0f;
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

  // 2. DC removal and mix of the input rows, in place, from shared memory.
  for (int e = tid; e < (t_hi - t_lo) * kCg; e += kThreads) {
    const int t = t_lo + e / kCg, cc = e % kCg;
    if (c0 + cc >= C) continue;
    const int q = t / kQ - q_base, r = t % kQ, k = t / kDcChunk - k_base;
    float* ur = u_s + (t - t_base) * kLanes + cc;
    float* ui = ur + kCg;
    const float* m = smem + lay.dc + k * kLanes + cc;
    mix(*ur - m[0], *ui - m[kCg],
        smem[lay.coarse_c + q * kCg + cc], smem[lay.coarse_s + q * kCg + cc],
        smem[lay.fine_c + r * kCg + cc], smem[lay.fine_s + r * kCg + cc],
        ur, ui);
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

// grid ceil(d_rows*C/256), block 256: the last d_rows post-mix rows.
__global__ void front_tail(const float* __restrict__ x, int T, int C,
                           const float* __restrict__ mseq,
                           const float* __restrict__ tail_in, int d_rows,
                           const float* __restrict__ phase0,
                           const float* __restrict__ fhi,
                           const float* __restrict__ flo,
                           float* __restrict__ tail_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d_rows * C) return;
  const int i = idx / C, c = idx % C;
  const size_t c2 = 2 * (size_t)C;
  const int t = T - d_rows + i;
  float ur, ui;
  if (t >= 0) {
    const size_t xr = (size_t)t * c2;
    const size_t mr = (size_t)(t / kDcChunk) * c2;
    float cr, ci, fr, fi;
    sincospif(2.0f * coarse_phase(t, phase0[c], fhi[c], flo[c]), &ci, &cr);
    sincospif(2.0f * fine_phase(t % kQ, fhi[c], flo[c]), &fi, &fr);
    mix(x[xr + c] - mseq[mr + c], x[xr + C + c] - mseq[mr + C + c],
        cr, ci, fr, fi, &ur, &ui);
  } else {
    const size_t tr = (size_t)(d_rows + t) * c2;
    ur = tail_in[tr + c];
    ui = tail_in[tr + C + c];
  }
  tail_out[i * c2 + c] = ur;
  tail_out[i * c2 + C + c] = ui;
}

// grid ceil(M*C/256), block 256, M = T/F decimated rows.  FM discriminator
// of the decimated composite, the carried sample, and the y-tail windows.
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
  const float pr = prev[c], pi = prev[C + c];
  const float im = __fsub_rn(__fmul_rn(yi, pr), __fmul_rn(yr, pi));
  const float re = __fadd_rn(__fmul_rn(yr, pr), __fmul_rn(yi, pi));
  disc[(size_t)o * C + c] = __fmul_rn(atan2f(im, re), gain);
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

// Taps per polyphase branch that the FIR kernel is instantiated for
// (ops/front.py mirrors this list in FIR_BRANCH_TAPS).
int fir_branch_taps(int ntaps, int F) {
  const int dp = (ntaps + F - 1) / F;
  for (int inst : {8, 16, 24, 32, 40})
    if (dp <= inst) return inst;
  return 0;
}

}  // namespace

extern "C" {

// Shared memory the FIR kernel needs for a composed response of ntaps taps
// decimating by F; 0 when no instantiation covers it.
size_t front_fir_smem_bytes(int ntaps, int F) {
  const int dp = fir_branch_taps(ntaps, F);
  if (!dp) return 0;
  return (size_t)FirSmem(F, dp).total * sizeof(float);
}

const char* front_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One fused front-end dispatch of T rows (T * 2C < 2^31; T a multiple of
// 512, of F and of n; T / F / kM < 65536; r_rows <= n).  Scratch mseq:
// [T/512, 2C].  With disc_gain != 0 also the discriminator: disc [T/F, C],
// dlast [1, 2C] from disc_last [1, 2C], and, when y_tail_rows > 0, ytail
// [T/n, y_tail_rows, 2C] (y is then the full-rate scratch the FIR writes).
// Returns the first CUDA error.
int front_forward(int device, const float* x, int T, int C, int n,
                  int r_rows, const float* dc_in, const float* tail_in,
                  int d_rows, const float* phase0, const float* fhi,
                  const float* flo, const float* h, int ntaps, int F, float a,
                  float b, float* mseq, float* y, float* dc_out,
                  float* tail_out, float* raw, float disc_gain,
                  const float* disc_last, int y_tail_rows, float* disc,
                  float* dlast, float* ytail, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int c2 = 2 * C;
  const int nchunk = T / kDcChunk;
  const unsigned lane_groups = (unsigned)((c2 + 31) / 32);

  front_means<<<dim3((unsigned)nchunk, lane_groups), dim3(32, 8), 0, st>>>(
      x, c2, n, r_rows, mseq, raw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  front_dc_scan<<<dim3(lane_groups), dim3(32, 32), 0, st>>>(
      mseq, nchunk, c2, dc_in, dc_out, a, b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = front_fir_smem_bytes(ntaps, F);
  if (smem == 0 || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C + kCg - 1) / kCg),
                  (unsigned)((T / F + kM - 1) / kM));
  const dim3 block(kLanes, kGroups);
  switch (fir_branch_taps(ntaps, F)) {
#define FRONT_FIR_CASE(DP)                                                   \
  case DP:                                                                   \
    err = cudaFuncSetAttribute(front_fir<DP>,                                \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                   \
    if (err != cudaSuccess) return err;                                      \
    front_fir<DP><<<grid, block, smem, st>>>(x, T, C, mseq, tail_in, d_rows, \
                                             phase0, fhi, flo, h, ntaps, F,  \
                                             y);                             \
    break;
    FRONT_FIR_CASE(8)
    FRONT_FIR_CASE(16)
    FRONT_FIR_CASE(24)
    FRONT_FIR_CASE(32)
    FRONT_FIR_CASE(40)
#undef FRONT_FIR_CASE
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int nt = d_rows * C;
  front_tail<<<(unsigned)((nt + 255) / 256), 256, 0, st>>>(
      x, T, C, mseq, tail_in, d_rows, phase0, fhi, flo, tail_out);
  if ((err = cudaGetLastError()) != cudaSuccess || disc_gain == 0.0f)
    return err;

  const int M = T / F;
  front_disc<<<(unsigned)(((size_t)M * C + 255) / 256), 256, 0, st>>>(
      y, M, C, disc_last, disc_gain, n / F, y_tail_rows, disc, dlast,
      y_tail_rows > 0 ? ytail : nullptr);
  return cudaGetLastError();
}

}  // extern "C"
