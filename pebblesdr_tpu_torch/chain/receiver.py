"""The receive chain, AM, as one batched graph per K-block dispatch.

Port of pebblesdr_tpu/chain/receiver.py for the batched ``step_many`` path
(``_step_many_impl`` -> ``_step_many_batched`` -> ``_tail_many``, AM branch):

  fused front (DC blocker + NCO mix + composed-FIR decimation, ops/front.py)
  -> full-rate display spectrum per block (closed-form EWMA over blocks)
  -> zoomed demod-rate power per block -> S-meter -> squelch with 3 dB
     hysteresis
  -> FastFIR bandpass -> parallel AGC -> AM demod -> fractional resampler
  -> squelch / gain / mute gate.

State is explicit (ReceiverState), with the fields and shapes of the JAX
pytree in its fused-front layout: ``dc`` [1, 2C], ``decim`` [d_rows, 2C].
The Receiver is built for one device and runs its whole graph there; on a
CUDA device the front end is the hand-written CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from pebblesdr_tpu.demod.modes import MODE_INFO, DemodMode
from pebblesdr_tpu_torch.core import db as dbu
from pebblesdr_tpu_torch.demod import am as am_mod
from pebblesdr_tpu_torch.ops import (agc, decimator, fastfir, front, mixer,
                                     resampler, signalstrength, spectrum)


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    sample_rate: int                      # device sample rate (sps)
    frames_per_buffer: int = 32768        # input block length
    channels: int = 1
    mode: DemodMode = DemodMode.AM
    audio_rate: int = 48000
    spectrum_bins: int = 2048
    zoom_bins: int = 2048                 # demod-rate spectrum size, capped
    #                                       at the demod block length
    agc_mode: str | None = None           # None -> mode default
    agc_stride: int = 1
    db_offset: float = 0.0                # display calibration offset


@dataclasses.dataclass(frozen=True)
class RxParams:
    """Runtime-tunable knobs: inputs to every step, never rebuilt."""
    tune_hi: torch.Tensor     # [C] split-precision normalized tune freq (hi)
    tune_lo: torch.Tensor     # [C] (lo)
    bp_mask: torch.Tensor     # [2, 2*blk] float32 FastFIR mask (re, im)
    sm_band: torch.Tensor     # [zoom_bins] float32 signal-strength band mask
    sm_noise: torch.Tensor    # [zoom_bins] float32 noise side-window mask
    squelch_db: torch.Tensor  # scalar; -999 = always open
    gain: torch.Tensor        # scalar audio gain
    mute: torch.Tensor        # scalar bool
    iq_gain: torch.Tensor     # scalar IQ balance gain (not used by the AM path)
    iq_phase: torch.Tensor    # scalar IQ balance phase (not used by the AM path)


@dataclasses.dataclass(frozen=True)
class ReceiverState:
    mixer: Any
    decim: Any
    fastfir: Any
    dc: Any
    nb: Any
    anf: Any
    agc: Any
    demod: Any
    resamp: Any
    spec_full: Any
    spec_zoom: Any
    rds: Any = None
    squelch: Any = None  # [C] bool: previous squelch decision (hysteresis)
    iqbal: Any = None
    ctcss: Any = None


class Receiver:
    """Build once per configuration and device; ``step_many`` is the hot loop."""

    def __init__(self, cfg: ReceiverConfig, device: str | torch.device):
        if cfg.mode != DemodMode.AM:
            raise ValueError(f"mode {cfg.mode.name} is not ported yet; the "
                             f"PyTorch receiver runs AM")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.info = info = MODE_INFO[cfg.mode]
        fs = float(cfg.sample_rate)

        self.plan = decimator.build_plan(fs, info.max_output_bw)
        if cfg.frames_per_buffer % self.plan.factor:
            raise ValueError(
                f"frames_per_buffer={cfg.frames_per_buffer} not divisible by "
                f"decimation factor {self.plan.factor}")
        if cfg.frames_per_buffer % front.SUB_BLOCK:
            raise ValueError(f"frames_per_buffer={cfg.frames_per_buffer} must "
                             f"be a multiple of {front.SUB_BLOCK}")
        if cfg.spectrum_bins > front.SUB_BLOCK:
            raise ValueError(f"spectrum_bins={cfg.spectrum_bins} exceeds the "
                             f"front end's raw tail of {front.SUB_BLOCK} rows")
        self.demod_rate = int(self.plan.rate_out)
        self.blk = cfg.frames_per_buffer // self.plan.factor

        self.am_cfg = am_mod.AMConfig.make(self.demod_rate, info.default_filter)
        self.rs_plan = resampler.plan(self.demod_rate, cfg.audio_rate, self.blk)
        self.audio_blk = self.rs_plan.n_out

        agc_mode = cfg.agc_mode if cfg.agc_mode is not None else info.agc_mode
        agc_stride = max(1, cfg.agc_stride)
        while self.blk % agc_stride:  # stride must divide the demod block
            agc_stride //= 2
        self.agc_cfg = agc.AGCConfig.make(self.demod_rate, agc_mode,
                                          stride=agc_stride)

        w_full, self.cg_full = spectrum.make_window(cfg.spectrum_bins)
        self.w_full = torch.from_numpy(w_full).to(self.device)
        self.zoom_bins = min(self.blk, int(cfg.zoom_bins))
        w_zoom, self.cg_zoom = spectrum.make_window(self.zoom_bins)
        self.w_zoom = torch.from_numpy(w_zoom).to(self.device)

        self.front = front.FrontPlan.make(decimator.compose_response(self.plan),
                                          self.plan.factor, self.device)

    # ------------------------------------------------------------------ state

    def init_state(self) -> ReceiverState:
        c = self.cfg.channels
        dev = self.device
        return ReceiverState(
            mixer=mixer.mixer_init(c, dev),
            decim=torch.zeros(self.front.d_rows, 2 * c, dtype=torch.float32,
                              device=dev),
            fastfir=fastfir.state_init(c, self.blk, dev),
            dc=torch.zeros(1, 2 * c, dtype=torch.float32, device=dev),
            nb=None,
            anf=None,
            agc=agc.agc_init(self.agc_cfg, c, dev),
            demod=am_mod.am_init(self.am_cfg, c, dev),
            resamp=resampler.state_init(self.rs_plan, c, dev),
            spec_full=spectrum.state_init(c, self.cfg.spectrum_bins, dev),
            spec_zoom=spectrum.state_init(c, self.zoom_bins, dev),
            squelch=torch.zeros(c, dtype=torch.bool, device=dev),
        )

    # ----------------------------------------------------------------- params

    def make_bandpass(self, lo_hz: float, hi_hz: float,
                      offset_hz: float | None = None):
        """(bp_mask [2, 2*blk] f32, sm_band [zoom_bins], sm_noise [zoom_bins])
        on the Receiver's device."""
        mask_c = fastfir.design_mask(lo_hz, hi_hz, self.demod_rate, self.blk,
                                     offset_hz or 0.0)
        mask = np.stack([mask_c.real, mask_c.imag]).astype(np.float32)
        band, noise = signalstrength.band_masks(lo_hz, hi_hz, self.demod_rate,
                                                self.zoom_bins)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (mask, band, noise))

    def set_bandpass(self, params: RxParams, lo_hz: float, hi_hz: float,
                     offset_hz: float | None = None) -> RxParams:
        mask, band, noise = self.make_bandpass(lo_hz, hi_hz, offset_hz)
        return dataclasses.replace(params, bp_mask=mask, sm_band=band,
                                   sm_noise=noise)

    def _tune(self, tune_hz) -> dict[str, torch.Tensor]:
        tunes = np.broadcast_to(np.asarray(tune_hz, np.float64),
                                (self.cfg.channels,))
        splits = [mixer.split_freq(t, self.cfg.sample_rate) for t in tunes]
        return {key: torch.from_numpy(np.stack([s[i] for s in splits])
                                      ).to(self.device)
                for i, key in enumerate(("tune_hi", "tune_lo"))}

    def default_params(self, tune_hz: float | np.ndarray = 0.0) -> RxParams:
        mask, band, noise = self.make_bandpass(self.info.lo_cut,
                                               self.info.hi_cut)

        def scalar(v, dtype=torch.float32):
            return torch.tensor(v, dtype=dtype, device=self.device)

        return RxParams(bp_mask=mask, sm_band=band, sm_noise=noise,
                        squelch_db=scalar(-999.0), gain=scalar(1.0),
                        mute=scalar(False, torch.bool), iq_gain=scalar(1.0),
                        iq_phase=scalar(0.0), **self._tune(tune_hz))

    def retune(self, params: RxParams, tune_hz) -> RxParams:
        return dataclasses.replace(params, **self._tune(tune_hz))

    # ------------------------------------------------------------------- step

    def step(self, state: ReceiverState, params: RxParams, iq: torch.Tensor,
             spectra: bool = True):
        """One block: iq [N, 2C] float32 lane-packed plane, [2, N, C] plane
        pair, or [C, N] complex64.  Returns (state', outputs) with the
        outputs of step_many for its single block (no leading K axis)."""
        c = self.cfg.channels
        have = (iq.shape[-1] if iq.dim() == 3
                else iq.shape[0] if iq.is_complex()
                else iq.shape[-1] // 2)
        if have != c:
            raise ValueError(f"input block has {have} channels but this "
                             f"Receiver was built with channels={c}")
        if iq.dim() == 3:
            iq = torch.cat([iq[0], iq[1]], dim=-1)
        elif iq.is_complex():
            iq = iq[None]                                  # [1, C, N]
        state, out = self.step_many(state, params, iq, spectra=spectra)
        return state, _first_block(out)

    def step_many(self, state: ReceiverState, params: RxParams, iq,
                  spectra: bool = True):
        """K blocks in one dispatch: iq [K*N, 2C] float32 lane-packed plane
        (preferred), [K, N, 2C], an (re, im) pair of [K*N, C] planes,
        [K, 2, N, C] / [2, K, N, C] stacks or [K, C, N] complex64.

        Returns (state', out) with out['audio'] [K, C, audio_blk],
        'spectrum' [K, C, spectrum_bins] dB and 'overload' [K, C] (spectra
        only), 'zoomed' [K, C, zoom_bins] dB (spectra only), 'smeter' (dict
        of [K, C] dB) and 'squelch_open' [K, C] bool."""
        x_pk = self._pack(iq)
        n = self.cfg.frames_per_buffer
        if x_pk.shape[0] % n:
            raise ValueError(f"{x_pk.shape[0]} input rows are not a whole "
                             f"number of {n}-frame blocks")
        return self._step_many_batched(state, params, x_pk, spectra)

    def _pack(self, iq) -> torch.Tensor:
        """Normalize every accepted layout to the [K*N, 2C] packed plane,
        with the channel-count guards of the JAX Receiver."""
        c = self.cfg.channels
        c2 = 2 * c
        if (not isinstance(iq, (tuple, list)) and iq.is_complex()
                and iq.shape[-2] != c):
            raise ValueError(
                f"complex input has {iq.shape[-2]} channels but this "
                f"Receiver was built with channels={c}")
        if isinstance(iq, (tuple, list)) and len(iq) == 2:
            x_pk = torch.cat([iq[0], iq[1]], dim=-1)
        elif iq.dim() == 4 and iq.shape[1] == 2:          # [K, 2, N, C]
            x_pk = torch.cat([iq[:, 0], iq[:, 1]], dim=-1)
        elif iq.dim() == 4 and iq.shape[0] == 2:          # [2, K, N, C]
            x_pk = torch.cat([iq[0], iq[1]], dim=-1)
        elif not iq.is_complex():                         # packed already
            x_pk = iq
        else:                                             # [K, C, N] complex
            x_pk = torch.cat([iq.real.transpose(1, 2),
                              iq.imag.transpose(1, 2)], dim=-1)
        if x_pk.dim() == 3:
            if x_pk.shape[-1] != c2:
                raise ValueError(
                    f"packed plane has {x_pk.shape[-1] // 2} channels but "
                    f"this Receiver was built with channels={c}")
            x_pk = x_pk.reshape(-1, c2)
        if x_pk.dim() != 2:
            raise ValueError(f"unsupported input shape {tuple(x_pk.shape)}")
        if x_pk.shape[-1] != c2:
            if x_pk.shape[-1] % c2:
                raise ValueError(f"lane width {x_pk.shape[-1]} is neither "
                                 f"2C={c2} nor a folded multiple of it")
            raise ValueError(
                f"lane width {x_pk.shape[-1]} is a plane time-folded by "
                f"{x_pk.shape[-1] // c2}; this Receiver takes unfolded "
                f"[K*N, 2C={c2}] planes")
        if x_pk.dtype != torch.float32:
            raise ValueError(f"input planes must be float32, got {x_pk.dtype}")
        if x_pk.device != self.device:
            raise ValueError(f"input is on {x_pk.device} but this Receiver "
                             f"runs on {self.device}")
        return x_pk.contiguous()

    def _step_many_batched(self, state: ReceiverState, params: RxParams,
                           x_pk: torch.Tensor, spectra: bool):
        cfg = self.cfg
        c = cfg.channels
        k = x_pk.shape[0] // cfg.frames_per_buffer
        y_pk, dc, decim, phase, raw = front.fused_front(
            self.front, x_pk, state.dc, state.mixer.phase, params.tune_hi,
            params.tune_lo, state.decim, n_block=cfg.frames_per_buffer,
            raw_rows=cfg.spectrum_bins if spectra else 0)
        x_cat = torch.complex(y_pk[:, :c].T, y_pk[:, c:].T)      # [C, K*blk]
        raw_c = (torch.complex(raw[:, :, :c].transpose(1, 2),
                               raw[:, :, c:].transpose(1, 2))     # [K, C, bins]
                 if spectra else None)
        tail_st, out = self._tail_many(state, params, k, raw_c, x_cat, spectra)
        new_state = ReceiverState(
            mixer=mixer.MixerState(phase=phase), decim=decim, dc=dc,
            nb=state.nb, iqbal=state.iqbal, **tail_st)
        return new_state, out

    def _ewma_blocks(self, prev: torch.Tensor, p: torch.Tensor, a: float):
        """avg_k = a avg_{k-1} + (1-a) p_k over the leading K axis, seeded by
        prev, as one matmul.  Returns (avg [K, ...], avg_last)."""
        k = p.shape[0]
        lmat, seed = _ewma_tables(k, a, p.device)
        avg = (torch.matmul(lmat, p.reshape(k, -1)).reshape(p.shape)
               + seed.reshape((k,) + (1,) * (p.dim() - 1)) * prev[None])
        return avg, avg[-1]

    def _tail_many(self, state: ReceiverState, params: RxParams, k: int,
                   raw_c, x_cat: torch.Tensor, spectra: bool):
        """The batched demod-rate tail for K concatenated blocks (AM).
        raw_c: [K, C, spectrum_bins] complex display tails (None without
        spectra); x_cat: [C, K*blk] demod-rate stream."""
        cfg = self.cfg
        c = cfg.channels
        blk = self.blk
        out: dict[str, Any] = {}

        # ---- full-rate spectrum per block
        if spectra:
            bins = raw_c.shape[-1]
            out["overload"] = (torch.amax(torch.abs(raw_c.real), dim=-1)
                               > spectrum.OVERLOAD_LEVEL)
            xw = raw_c * self.w_full[None, None, :]
            norm = 1.0 / (bins * self.cg_full)
            p_full = (spectrum.shifted_power(xw.reshape(k * c, bins))
                      .reshape(k, c, bins) * (norm * norm))
            avg, avg_last = self._ewma_blocks(state.spec_full.avg_power,
                                              p_full, 0.5)
            out["spectrum"] = dbu.power_to_db(avg) + cfg.db_offset
            spec_full_state = spectrum.SpectrumState(avg_power=avg_last)
        else:
            spec_full_state = state.spec_full

        # ---- zoom power + S-meter per block, in the stream's [C, K] order
        n_z = self.zoom_bins
        xz = x_cat.reshape(c, k, blk)[:, :, blk - n_z:]            # [C, K, n_z]
        xzw = xz * self.w_zoom[None, None, :]
        normz = 1.0 / (n_z * self.cg_zoom)
        power_lin = (spectrum.shifted_power(xzw.reshape(c * k, n_z))
                     .reshape(c, k, n_z) * (normz * normz))
        power_lin = power_lin * 10.0 ** (cfg.db_offset / 10.0)
        if spectra:
            zavg, zavg_last = self._ewma_blocks(state.spec_zoom.avg_power,
                                                power_lin.transpose(0, 1), 0.5)
            out["zoomed"] = dbu.power_to_db(zavg)
            spec_zoom_state = spectrum.SpectrumState(avg_power=zavg_last)
        else:
            spec_zoom_state = state.spec_zoom
        sm = signalstrength.fd_estimate_masked(
            power_lin.reshape(c * k, n_z), params.sm_band, params.sm_noise)
        sm = {key: v.reshape(c, k).T for key, v in sm.items()}
        out["smeter"] = sm

        # ---- squelch with hysteresis: open_k = b_k | (a_k & open_{k-1})
        snr = sm["snr_db"]
        squelch_open = _squelch_hysteresis(snr > params.squelch_db,
                                           snr > params.squelch_db - 3.0,
                                           state.squelch)
        out["squelch_open"] = squelch_open

        # ---- demod-rate tail once on the concatenated stream
        mask = torch.complex(params.bp_mask[0], params.bp_mask[1])
        ff_state, xt = fastfir.apply_many(state.fastfir, x_cat, mask, blk)
        agc_state, xt = agc.agc_apply(self.agc_cfg, state.agc, xt)
        demod_state, audio = am_mod.am_demod(self.am_cfg, state.demod, xt)
        resamp_state, audio = resampler.apply_many(self.rs_plan, state.resamp,
                                                   audio)
        audio = audio.reshape(c, k, audio.shape[-1] // k).transpose(0, 1)

        gate = (squelch_open.float() * params.gain
                * (1.0 - params.mute.float()))
        out["audio"] = audio * gate[:, :, None]

        tail_st = dict(
            fastfir=ff_state, agc=agc_state, demod=demod_state,
            resamp=resamp_state, spec_full=spec_full_state,
            spec_zoom=spec_zoom_state, rds=state.rds,
            squelch=squelch_open[-1], ctcss=state.ctcss, anf=state.anf)
        return tail_st, out


@functools.lru_cache(maxsize=16)
def _ewma_tables(k: int, a: float, device: torch.device):
    kk = np.arange(k)
    lmat = np.where(kk[:, None] >= kk[None, :],
                    (1.0 - a) * a ** (kk[:, None] - kk[None, :]), 0.0)
    return (torch.from_numpy(lmat.astype(np.float32)).to(device),
            torch.from_numpy((a ** (kk + 1)).astype(np.float32)).to(device))


def _squelch_hysteresis(b: torch.Tensor, a: torch.Tensor,
                        prev: torch.Tensor) -> torch.Tensor:
    """Closed form of open_k = b_k | (a_k & open_{k-1}) over the leading K
    axis: open iff some j <= k has b_j and a holds on (j, k], or a holds on
    [0, k] and prev was open."""
    k = b.shape[0]
    idx = torch.arange(k, device=b.device).reshape((k,) + (1,) * (b.dim() - 1))
    none = torch.full_like(idx, -1).expand(b.shape)
    last_b = torch.cummax(torch.where(b, idx.expand(b.shape), none), dim=0).values
    last_not_a = torch.cummax(torch.where(a, none, idx.expand(b.shape)),
                              dim=0).values
    opens = (last_b >= 0) & (last_b >= last_not_a)
    return opens | ((last_not_a < 0) & prev[None])


def _first_block(out: dict) -> dict:
    """Drop the leading K=1 axis of step_many's outputs."""
    return {key: (_first_block(v) if isinstance(v, dict) else v[0])
            for key, v in out.items()}
