"""The adaptive noise filter (ANF), a block-LMS adaptive notch (port of the
ANF of pebblesdr_tpu/ops/scanops.py).

NoiseFilter capability (application/noisefilter.cpp:5-106, the dttsp LMS):
a 45-tap filter predicts x from a copy delayed by 64 samples and outputs the
prediction, the periodic (tonal) part.  Block LMS: the weights are frozen
for each sub-block of `update_every` samples, the gradient is accumulated
over it and applied once (leak 1 - 1e-5, rate 0.01).  The sub-blocks are a
Python loop, each a few batched matmuls (the JAX package's lax.scan); the
receiver updates once per demod block, so a K-block dispatch runs K steps.
Complex input runs as two real ANFs stacked on the channel axis.

Not ported: the noise blanker's scan forms and the adaptive IQ balance
(auto_iq_balance, a per-sample LMS scan).
"""

from __future__ import annotations

import dataclasses

import torch

ANF_TAPS = 45          # noisefilter.cpp:5-16
ANF_DELAY = 64
ANF_RATE = 0.01
ANF_LEAK = 1.0 - 1e-5


@dataclasses.dataclass(frozen=True)
class ANFState:
    weights: torch.Tensor  # [C, taps] adaptive filter
    delay: torch.Tensor    # [C, delay + taps - 1] recent input history


def anf_init(channels: int, device, taps: int = ANF_TAPS,
             delay: int = ANF_DELAY, dtype=torch.float32) -> ANFState:
    return ANFState(
        weights=torch.zeros(channels, taps, dtype=dtype, device=device),
        delay=torch.zeros(channels, delay + taps - 1, dtype=dtype,
                          device=device))


def anf(state: ANFState, x: torch.Tensor, rate: float = ANF_RATE,
        leak: float = ANF_LEAK, update_every: int = 16,
        taps: int = ANF_TAPS, delay: int = ANF_DELAY):
    """x [C, N] float32 or complex64 (N a multiple of update_every) ->
    (state', the prediction y [C, N] of x's periodic part)."""
    if x.is_complex():
        c = x.shape[0]

        def stack(t):
            return (torch.cat([t.real, t.imag]) if t.is_complex()
                    else t.repeat(2, 1))

        st, ys = anf(ANFState(weights=stack(state.weights),
                              delay=stack(state.delay)),
                     torch.cat([x.real, x.imag]), rate, leak, update_every,
                     taps, delay)
        return (ANFState(weights=torch.complex(st.weights[:c], st.weights[c:]),
                         delay=torch.complex(st.delay[:c], st.delay[c:])),
                torch.complex(ys[:c], ys[c:]))

    c, n = x.shape
    u = update_every
    h = state.delay.shape[-1]                       # delay + taps - 1
    full = torch.cat([state.delay, x], dim=-1)      # [C, H + N]
    # frames[:, m, k] = full[:, m + k]: the reference window of output m,
    # x delayed by `delay`..`delay + taps - 1` samples (a view)
    frames = full[:, :n + taps - 1].unfold(-1, taps, 1)       # [C, N, taps]
    w = state.weights
    preds = []
    for i in range(n // u):
        # one copy of the block's frames serves both products (a batched
        # matmul would copy the overlapping view for each)
        fr = frames[:, i * u:(i + 1) * u].contiguous()        # [C, U, taps]
        pred = torch.matmul(fr, w[:, :, None])[..., 0]        # [C, U]
        err = x[:, i * u:(i + 1) * u] - pred
        # w <- leak w + 2 rate grad, grad = err . frames / U
        w = torch.add(leak * w, torch.matmul(err[:, None, :], fr)[:, 0],
                      alpha=2.0 * rate / u)
        preds.append(pred)
    return (ANFState(weights=w, delay=full[:, full.shape[-1] - h:]),
            torch.cat(preds, dim=-1))
