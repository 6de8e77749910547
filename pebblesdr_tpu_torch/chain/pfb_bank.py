"""Dense-bank front end: one polyphase filterbank feeds many channel tails.

Port of pebblesdr_tpu/chain/pfb_bank.py (without its sharded form).  The
critically sampled (or 2x oversampled) filterbank (ops/pfb.py) turns one
wideband capture into M uniform channels in one pass; each wanted station
takes its nearest channel, and a standard Receiver built at the channel
rate runs its tail there: its NCO takes out the station's residual offset
from the channel centre, its decimation plan is typically empty (fs/M
lands at the demod rate) and its DC blocker is off (a station on its
channel centre is the channel's DC term).

Dispatch: the filterbank runs once over the dispatch's concatenated
capture, the stations' channels are gathered, and the tail Receiver's
staged front (its residual mix, and DC removal, the IQ balance, the
blanker or a decimation plan where configured) and batched tail run once
on the [C, K*N/hop] channel stream.  Where that front is trivial (no
decimation, DC blocker, IQ balance, blanker or ANF) the JAX package runs
its batched tail, whose RDS symbol timing updates once per call; the bank
asks the Receiver for that cadence (step_many's rds_per_call).

Limits (critical sampling): a station's band plus its residual must fit
its channel's passband; edge stations lose sideband energy unless
oversample=2.
"""

from __future__ import annotations

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import (Receiver, ReceiverConfig,
                                                _first_block)
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import pfb
from pebblesdr_tpu_torch.utils.precision import ieee_float32


def pick_bank_size(sample_rate: float, lo: float = 16000.0,
                   hi: float = 64000.0) -> int:
    """Largest power-of-two M with fs/M in [lo, hi] (channel rate ~ demod
    rate, so the tail needs no further decimation)."""
    m = 1
    while sample_rate / (2 * m) >= lo:
        m *= 2
    if not lo <= sample_rate / m <= hi:
        raise ValueError(f"no power-of-two bank puts {sample_rate} Hz into "
                         f"[{lo}, {hi}] Hz channels")
    return m


class PfbBankReceiver:
    """One wideband capture -> C demodulated stations through a shared PFB.

    tunes: [C] Hz offsets from the capture centre (each maps to its nearest
    bank channel plus a residual the tail Receiver's NCO removes); n_bank:
    the filterbank size M (default pick_bank_size); rx_kwargs go to the
    tail's ReceiverConfig (enable_dc_removal defaults to False).  The bank
    runs on `device` (the card unless the caller passes "cpu").

    step(state, iq): one wideband block, [N] or [1, N] complex64 or an
    [N, 2] float32 (re, im) plane; returns (state', the tail Receiver's
    outputs, [C, ...] rows in tune order).  step_many(state, iq): K blocks
    in one dispatch ([K*N], [1, K*N] or [K*N, 2]); outputs gain a leading K
    axis."""

    def __init__(self, sample_rate: int, frames_per_buffer: int, tunes,
                 mode: DemodMode = DemodMode.AM, n_bank: int | None = None,
                 taps_per_branch: int = 12, spectrum_bins: int | None = None,
                 oversample: int = 1, device: str | torch.device = "cuda",
                 **rx_kwargs):
        fs = float(sample_rate)
        m = int(n_bank) if n_bank else pick_bank_size(fs)
        if frames_per_buffer % m:
            raise ValueError(f"frames_per_buffer={frames_per_buffer} not "
                             f"divisible by bank size {m}")
        self.pfb_plan = pfb.plan(fs, m, taps_per_branch=taps_per_branch,
                                 os=oversample)
        ch_rate = fs / self.pfb_plan.hop
        if ch_rate != int(ch_rate):
            raise ValueError(f"channel rate {ch_rate} not integral")
        self.n_bank = m
        self.ch_rate = int(ch_rate)
        n_ch_block = frames_per_buffer // self.pfb_plan.hop
        self._assign(tunes)
        rx_kwargs.setdefault("enable_dc_removal", False)
        self.rx = Receiver(ReceiverConfig(
            sample_rate=self.ch_rate, frames_per_buffer=n_ch_block,
            channels=len(self.chan_idx), mode=mode,
            spectrum_bins=min(spectrum_bins or 2048, n_ch_block),
            **rx_kwargs), device)
        self.device = self.rx.device
        self.params = self.rx.default_params(self.residuals)
        self.frames_per_buffer = frames_per_buffer
        cfg = self.rx.cfg
        self.rds_per_call = (len(self.rx.plan.stages) == 0
                             and not cfg.enable_dc_removal
                             and not cfg.enable_iq_balance
                             and not cfg.enable_noise_blanker
                             and not cfg.enable_anf)

    def _assign(self, tunes) -> None:
        """Each tune's nearest channel (with the Nyquist wrap) and its
        residual offset from the channel centre."""
        fs = float(self.pfb_plan.fs_in)
        tunes = np.atleast_1d(np.asarray(tunes, np.float64))
        centers = pfb.channel_freqs(self.pfb_plan)
        diff = (tunes[:, None] - centers[None, :] + fs / 2) % fs - fs / 2
        self.chan_idx = np.argmin(np.abs(diff), axis=1)
        self.residuals = diff[np.arange(len(tunes)), self.chan_idx]
        if np.any(np.abs(self.residuals) > fs / (2 * self.n_bank) + 1e-6):
            raise AssertionError("residual exceeds half a channel")

    # ------------------------------------------------------------------ state
    def init_state(self):
        """(the filterbank's carry [1, T M - hop] complex64, the tail
        Receiver's state)."""
        return (pfb.init_state(self.pfb_plan, 1, self.device),
                self.rx.init_state())

    def retune(self, tunes) -> None:
        """New stations (as many as before): new channel assignments and
        residuals on the same bank and tail Receiver."""
        n = len(self.chan_idx)
        self._assign(tunes)
        if len(self.chan_idx) != n:
            raise ValueError(f"retune keeps {n} stations, got "
                             f"{len(self.chan_idx)}")
        self.params = self.rx.retune(self.params, self.residuals)

    # ------------------------------------------------------------------- step
    def _to_complex(self, iq: torch.Tensor) -> torch.Tensor:
        """The capture as one [1, T] complex64 row."""
        if iq.device != self.device:
            raise ValueError(f"input is on {iq.device} but this bank runs "
                             f"on {self.device}")
        if not iq.is_complex():                         # [T, 2] plane
            iq = iq.reshape(-1, iq.shape[-1])
            return torch.complex(iq[:, 0].float(), iq[:, 1].float())[None]
        return iq.reshape(1, -1).to(torch.complex64)

    @ieee_float32()
    def step_many(self, state, iq: torch.Tensor, params=None,
                  spectra: bool = True):
        """K concatenated blocks in one dispatch, its products in IEEE
        float32 (utils/precision.py); params defaults to the bank's
        residual tuning."""
        params = self.params if params is None else params
        pfb_state, rx_state = state
        x = self._to_complex(iq)
        n = self.frames_per_buffer
        if x.shape[1] % n:
            raise ValueError(f"{x.shape[1]} samples are not a whole number "
                             f"of {n}-frame blocks")
        pfb_state, y = pfb.apply(self.pfb_plan, pfb_state, x)
        idx = torch.as_tensor(self.chan_idx, device=self.device)
        ch = y[0].index_select(0, idx)                       # [C, K*nb]
        rx_state, out = self.rx.step_many(rx_state, params, ch,
                                          spectra=spectra,
                                          rds_per_call=self.rds_per_call)
        return (pfb_state, rx_state), out

    def step(self, state, iq: torch.Tensor, params=None,
             spectra: bool = True):
        """One block: step_many's outputs without the leading K axis."""
        state, out = self.step_many(state, iq, params, spectra)
        return state, _first_block(out)
