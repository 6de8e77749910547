// The polyphase FIR's inner loop, shared by K1's front_fir (front.cu) and
// K2's wfm_tail_march (wfm_tail.cu).
//
// A decimating FIR y[o] = sum_j h[j] u[F o - j] is F branches p (taps
// h[F i + p]).  A thread group holds a run of one branch's taps in
// registers while that branch's column of staged samples streams past
// once, fully unrolled (one shared load per up to M FMAs), accumulating M
// consecutive outputs.  K1's front_fir (front.cu) gives each group one
// branch of a part of the outputs and sums the groups' partials; K2's
// wfm_tail_march (wfm_tail.cu) gives each warp a part of the outputs and
// walks every branch (cut into slices of at most 64 taps) into the same
// accumulators.  Sums are IEEE float32 FMAs in a fixed order (no TF32).

#pragma once

namespace poly {

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
