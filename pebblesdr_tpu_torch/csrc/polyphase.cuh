// The polyphase FIR's inner loop, shared by K1's front_fir (front.cu) and
// K2's wfm_tail_fir (wfm_tail.cu).
//
// A decimating FIR y[o] = sum_j h[j] u[F o - j] is F branches p (taps
// h[F i + p]).  A thread group holds a run of one branch's taps in
// registers while that branch's column of staged samples streams past
// once, fully unrolled (one shared load per up to M FMAs), accumulating M
// consecutive outputs.  So that all of a block's groups have work when F
// is small, K2 (wfm_tail_fir) cuts each branch of DP taps into S slices of
// DPS taps (item it = g, g + groups, ... < F S takes branch it % F and
// slice it / F), and K1's front_fir splits the outputs into parts instead
// (front.cu).  Sums are IEEE float32 FMAs in a fixed order (no TF32).

#pragma once

namespace poly {

// Row of the first sample that slice s of branch p reads, counted from the
// first row of the staged window (the window of M outputs at decimation F
// starts F (DP - 1) rows before the first output's newest row, plus F - 1);
// its later samples lie F rows apart.
__host__ __device__ __forceinline__ int slice_row(int F, int S, int DPS,
                                                  int p, int s) {
  return (F - 1 - p) + F * (S - 1 - s) * DPS;
}

// acc[ol] += sum_{i < DPS} hr[i] col[(ol + DPS - 1 - i) stride], ol < M.
template <int M, int DPS>
__device__ __forceinline__ void fir_column(const float* col, int stride,
                                           const float (&hr)[DPS],
                                           float (&acc)[M]) {
#pragma unroll
  for (int m = 1; m < M + DPS; ++m) {
    const float v = col[(m - 1) * stride];
#pragma unroll
    for (int ol = 0; ol < M; ++ol) {
      const int i = ol + DPS - m;
      if (i >= 0 && i < DPS) acc[ol] = fmaf(hr[i], v, acc[ol]);
    }
  }
}

}  // namespace poly
