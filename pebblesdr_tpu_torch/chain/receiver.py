"""The receive chain, the narrowband modes, NFM and WFM (stereo and mono),
as one batched graph per K-block dispatch.

Port of pebblesdr_tpu/chain/receiver.py for the batched ``step_many`` path
(``_step_many_impl`` -> ``_step_many_batched`` -> ``_tail_many``) and the
staged front of its per-block path (``_step_impl``), its narrowband (AM,
SAM, FMN, USB, LSB, CWU, CWL, DIGU, DIGL, DSB, NONE) and FM (FMS stereo,
FMM and FMS with stereo=False mono) branches:

  fused front (DC blocker, optional static IQ balance and NB1/NB2 noise
  blanker, NCO mix, composed-FIR decimation, ops/front.py; for WFM also the
  FM discriminator and each block's trailing zoom window), or the staged
  front where the JAX package drops its fused kernel (adaptive IQ balance
  enable_iq_balance="auto", enable_dc_removal=False, an empty decimation
  plan): DC blocker (ops/iir.py dc_removal_chunked, per sample on blocks
  that are not a multiple of 512) -> static IQ balance or the adaptive LMS
  loop (ops/scanops.py auto_iq_balance: the recurrence kernel K5 on a CUDA
  device) -> NB1/NB2 (scanops.noise_blanker_chunked) -> NCO mix per block
  -> the halfband cascade (ops/decimator.py apply), each op once over the
  dispatch's concatenated [C, K*N] stream (each is streaming-exact; forms
  are chosen from the block length, as JAX runs them per block)
  -> full-rate display spectrum per block (closed-form EWMA over blocks)
  -> zoomed demod-rate power per block -> S-meter -> squelch with 3 dB
     hysteresis
  -> narrowband: FastFIR bandpass -> optional ANF (block LMS, one update
     per demod block, ops/scanops.py) -> parallel AGC (the hang mode 'long'
     too) -> the mode's demod (AM envelope; SAM's aimed carrier loop and
     sideband split, demod/sam.py, or on demod blocks that are not a
     multiple of 128 samples its per-sample loop; FMN's conj or derivative
     discriminator, demod/nfm.py; USB/CWU/DIGU I+Q, LSB/CWL/DIGL I-Q, DSB
     2I, demod/ssb.py; NONE the real part) -> resampler
     WFM stereo behind the fused front where the block admits a tail
     sub-block (tail_sub > 0): open pilot -> fused stereo tail
     (ops/wfm_tail.py) -> lock gate -> L/R -> de-emphasis (demod/wfm.py
     wfm_demod_tm) -> stereo resampler
     WFM stereo otherwise (tail_sub == 0, e.g. 2.88 and 1.536 Msps, and on
     the staged front), as the JAX package's XLA tail: discriminator ->
     (hq: composite decimation by 2) -> open pilot -> demux -> stacked
     low-pass -> lock gate -> L/R -> de-emphasis (demod/wfm.py wfm_demod)
     -> stereo resampler
     WFM mono: pre-discriminator biquad -> discriminator -> (hq: composite
     decimation by 2) -> mono low-pass -> de-emphasis (demod/wfm.py) ->
     resampler; with the RDS tap (any) also the RDS subchain
     (demod/rds.py: the squaring loop, or the per-sample Costas loop of
     rds_alg="scan") -> soft symbols
  -> FMN's CTCSS tone squelch (ops/goertzel.py) on the resampled audio
  -> squelch / gain / mute gate.

The WFM hq geometry (wfm_hq) protects the full +-200 kHz: the front
decimates by 4 to 512 kHz; stereo discriminates there and decimates the
composite by 2 back to the 256 kHz tail rate inside the front end
(comp_taps), mono runs the front in its base form and does both in
demod/wfm.py (its pre-discriminator biquad comes first).

The per-sample carrier loops (the "scan" RDS carrier, SAM on short
blocks) run on a CUDA device as one launch of the recurrence kernel
csrc/recur.cu pll_scan per dispatch (ops/pll.py).  Behind the staged front
the tail takes the per-block path's cadences: the RDS symbol timing and
the ANF update per block and per 16 samples (step_many's rds_per_call
keeps the RDS timing at one update per call, as the JAX package's bank
runs a trivial front).

TestBench's taps (taps=True, chain/testbench.py) take the staged front, as
the JAX package's front_ok does, and return out["taps"] with the JAX keys:
raw_iq (after DC removal, IQ balance and the blanker), post_mixer (after
the decimation), post_bp (the FastFIR output, before the ANF) and
post_demod (the demod's output before the resampler; WFM's left channel),
and rds_baseband with the WFM RDS tap.  step_many gives each as [K, C, n],
a view of the dispatch's [C, K*n] stream (no extra device pass).
Each entry point runs its products in IEEE float32 whatever the process
has set, and restores the caller's settings (utils/precision.py).

Entry planes are float32 or int16 (the ADC's native container, read as
x * 2^-15), unfolded [K*N, 2C] or time-folded [K*N/G, 2GC] (the TPU feeders'
layout, pallas_kernels.fold_plane_np; unfolded on entry with one copy).

State is explicit (ReceiverState), with the fields and shapes of the JAX
pytree in its fused-front layout: ``dc`` [1, 2C], ``decim`` [d_rows, 2C],
``nb`` (avg [1, 2C], spike tail [16, 2C]) with the noise blanker on; or in
its staged layout: ``dc`` [C] complex64, ``decim`` one [C, T-1] complex64
tail per stage, ``nb`` a NoiseBlankerChunkedState, ``iqbal`` the
AutoIQBalanceState (w [C] complex64) with "auto";
``anf`` the complex64 ANFState with the ANF on; ``demod`` is AMState,
SAMState, NFMState, or None for the stateless modes (SSB, CW, DIG, DSB,
NONE); for WFM the demod state is WFMState (stereo with tail_sub > 0: the
fused-tail layout)
and the FastFIR, ANF and AGC states ride along untouched, as in the JAX
package; ``ctcss`` the CtcssState with a CTCSS tone.  The Receiver is built
for one device and runs its whole graph there; on a CUDA device the front
end, the stereo tail and the carrier loops are hand-written CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from pebblesdr_tpu_torch.core import db as dbu
from pebblesdr_tpu_torch.demod import am as am_mod
from pebblesdr_tpu_torch.demod import nfm as nfm_mod
from pebblesdr_tpu_torch.demod import rds as rds_mod
from pebblesdr_tpu_torch.demod import sam as sam_mod
from pebblesdr_tpu_torch.demod import ssb as ssb_mod
from pebblesdr_tpu_torch.demod import wfm as wfm_mod
from pebblesdr_tpu_torch.demod.modes import MODE_INFO, DemodMode, is_wfm
from pebblesdr_tpu_torch.ops import (agc, decimator, fastfir, front, goertzel,
                                     iir, mixer, resampler, scanops,
                                     signalstrength, spectrum)
from pebblesdr_tpu_torch.utils.precision import ieee_float32


# the modes the port's Receiver runs: every mode of the table
PORTED_MODES = tuple(DemodMode)
NB_CHUNK = 512   # the staged noise blanker's EWMA chunk (the JAX default)


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
    stereo: bool = True                   # FMS only (False: mono, as FMM)
    rds: bool = False                     # WFM RDS tap
    rds_alg: str = "open"                 # RDS carrier: "open" = the scan-
    #                                       free squaring loop; "scan" = the
    #                                       per-sample Costas loop
    wfm_hq: bool = False                  # WFM hq geometry: discriminate at
    #                                       ~512 kHz (the reference's), then
    #                                       decimate the composite by 2
    sam_sideband: str = "analytic"        # SAM sideband split: "analytic"
    #                                       (complex Hilbert bandpass) or
    #                                       "rails" (the reference's per-rail
    #                                       phasing)
    db_offset: float = 0.0                # display calibration offset
    enable_noise_blanker: bool | str = False  # True: NB1 (blank);
    #                                       "average": NB2 (RMS substitution)
    enable_iq_balance: bool | str = False  # True: static params.iq_gain/
    #                                       iq_phase; "auto": the adaptive
    #                                       image-reject loop, its weight
    #                                       carried in ReceiverState.iqbal
    enable_dc_removal: bool = True        # the front's DC blocker; off for
    #                                       baseband input whose DC is signal
    #                                       (the PFB bank's channel streams)
    enable_anf: bool = False              # adaptive noise filter (narrowband
    #                                       modes; one LMS update per block)
    ctcss_tone: float | None = None       # FMN only: CTCSS tone squelch
    #                                       (a CTCSS table tone, Hz)
    taps: bool = False                    # TestBench's intermediate taps
    #                                       (out["taps"]; the staged front)


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
    iq_gain: torch.Tensor     # scalar IQ balance gain (enable_iq_balance)
    iq_phase: torch.Tensor    # scalar IQ balance phase (enable_iq_balance)


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
        if cfg.enable_iq_balance not in (False, True, "auto"):
            raise ValueError(f"enable_iq_balance={cfg.enable_iq_balance!r}: "
                             f"False, True or 'auto'")
        # noise blanker: (threshold, blank_width, alpha, mode)
        self.nb_params = None
        if cfg.enable_noise_blanker:
            self.nb_params = (3.3, 7, 0.001,
                              "average" if cfg.enable_noise_blanker
                              == "average" else "blank")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.info = info = MODE_INFO[cfg.mode]
        fs = float(cfg.sample_rate)

        wfm = is_wfm(cfg.mode)
        # the hq geometry protects the full +-200 kHz (~512 kHz composite)
        self.plan = decimator.build_plan(
            fs, (2.0 if wfm and cfg.wfm_hq else 1.0) * info.max_output_bw)
        if cfg.frames_per_buffer % self.plan.factor:
            raise ValueError(
                f"frames_per_buffer={cfg.frames_per_buffer} not divisible by "
                f"decimation factor {self.plan.factor}")
        # the fused front (K1) where the JAX package's front_ok holds; the
        # staged front otherwise
        self.staged = not (cfg.enable_iq_balance != "auto"
                           and cfg.enable_dc_removal and not cfg.taps
                           and len(self.plan.stages) > 0)
        self._check_front()
        self.demod_rate = int(self.plan.rate_out)
        self.blk = cfg.frames_per_buffer // self.plan.factor

        self.am_cfg = self.sam_cfg = self.nfm_cfg = None
        self.wfm_cfg = self.rds_cfg = self.wfm_tail = None
        if wfm:
            # hq: the composite (< 61 kHz wide) decimates by 2 right after
            # the discriminator, so the stereo tail runs at ~256 kHz
            self.wfm_comp_decim = (
                2 if (cfg.wfm_hq and self.demod_rate >= 400_000) else 1)
            tail_rate = self.demod_rate // self.wfm_comp_decim
            self.wfm_tail_blk = self.blk // self.wfm_comp_decim
            # the audio low-pass decimates inside the demod so the resampler
            # runs near 64 kHz instead of the composite rate
            wcfg = wfm_mod.WFMConfig.make(
                tail_rate, stereo=cfg.mode == DemodMode.FMS and cfg.stereo,
                rds_tap=cfg.rds, audio_decim=max(1, tail_rate // 64000),
                comp_decim=self.wfm_comp_decim)
            # the fused tail (K2) behind the fused front where the block
            # admits a sub-block; the stereo tail without K2 otherwise
            self.wfm_cfg = dataclasses.replace(
                wcfg, tail_sub=0 if self.staged else
                wfm_mod.tail_kernel_sub(wcfg, self.wfm_tail_blk))
            if self.wfm_cfg.tail_sub:
                self.wfm_tail = wfm_mod.tail_plan(
                    self.wfm_cfg, self.wfm_tail_blk, self.device)
                # stereo discriminates in the front end, at its rate (mono
                # after its pre-discriminator biquad, in demod/wfm.py)
                self.disc_gain = self.demod_rate / (
                    2.0 * np.pi * self.wfm_cfg.max_deviation)
            audio_src_rate = int(self.wfm_cfg.audio_rate)
            audio_blk = self.wfm_tail_blk // self.wfm_cfg.audio_decim
            if cfg.rds:
                self.rds_cfg = rds_mod.RdsConfig.make(
                    tail_rate, self.wfm_tail_blk, alg=cfg.rds_alg)
                rds_mod.check_ported(self.rds_cfg)
        else:
            if cfg.mode == DemodMode.AM:
                self.am_cfg = am_mod.AMConfig.make(self.demod_rate,
                                                   info.default_filter)
            elif cfg.mode == DemodMode.SAM:
                self.sam_cfg = sam_mod.SAMConfig.make(
                    self.demod_rate, info.default_filter,
                    sideband=cfg.sam_sideband)
            elif cfg.mode == DemodMode.FMN:
                self.nfm_cfg = nfm_mod.NFMConfig.make(self.demod_rate)
            audio_src_rate, audio_blk = self.demod_rate, self.blk
        self.rs_plan = resampler.plan(audio_src_rate, cfg.audio_rate, audio_blk)
        self.audio_blk = self.rs_plan.n_out

        self.ctcss_cfg = None
        if cfg.ctcss_tone is not None:
            if cfg.mode != DemodMode.FMN:
                raise ValueError("ctcss_tone requires mode=FMN")
            self.ctcss_cfg = goertzel.CtcssConfig.make(
                cfg.ctcss_tone, float(cfg.audio_rate), self.audio_blk)

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

        self.front = (None if self.staged else front.FrontPlan.make(
            decimator.compose_response(self.plan), self.plan.factor,
            self.device))

    def _check_front(self) -> None:
        """The block geometry each front takes: K1's sub-blocks and raw tail
        (fused); whole spectra, adaptive-IQ groups and blanker chunks per
        block (staged)."""
        cfg, n = self.cfg, self.cfg.frames_per_buffer
        if not self.staged:
            if n % front.SUB_BLOCK:
                raise ValueError(f"frames_per_buffer={n} must be a multiple "
                                 f"of {front.SUB_BLOCK}")
            if cfg.spectrum_bins > front.SUB_BLOCK:
                raise ValueError(f"spectrum_bins={cfg.spectrum_bins} exceeds "
                                 f"the front end's raw tail of "
                                 f"{front.SUB_BLOCK} rows")
            return
        if cfg.spectrum_bins > n:
            raise ValueError(f"spectrum_bins={cfg.spectrum_bins} exceeds the "
                             f"{n}-frame block")
        if cfg.enable_iq_balance == "auto" and n % scanops.IQ_GROUP:
            raise ValueError(f"enable_iq_balance='auto' updates every "
                             f"{scanops.IQ_GROUP} samples: frames_per_buffer="
                             f"{n} is not a multiple")
        if cfg.enable_noise_blanker and n % NB_CHUNK:
            raise ValueError(f"the staged noise blanker takes whole "
                             f"{NB_CHUNK}-sample chunks: frames_per_buffer="
                             f"{n} is not a multiple")

    # ------------------------------------------------------------------ state

    def init_state(self) -> ReceiverState:
        c = self.cfg.channels
        dev = self.device
        demod = None                     # SSB/CW/DIG/DSB/NONE: stateless
        if self.wfm_cfg is not None:
            demod = wfm_mod.wfm_init(self.wfm_cfg, c, dev)
        elif self.am_cfg is not None:
            demod = am_mod.am_init(self.am_cfg, c, dev)
        elif self.sam_cfg is not None:
            demod = sam_mod.sam_init(self.sam_cfg, c, dev)
        elif self.nfm_cfg is not None:
            demod = nfm_mod.nfm_init(self.nfm_cfg, c, dev)
        # stereo: L and R resample as 2C channels
        stereo = self.wfm_cfg is not None and self.wfm_cfg.stereo
        resamp = resampler.state_init(self.rs_plan, 2 * c if stereo else c,
                                      dev)
        if self.staged:
            decim = decimator.state_init(self.plan, c, dev)
            dc = torch.zeros(c, dtype=torch.complex64, device=dev)
        else:
            decim = torch.zeros(self.front.d_rows, 2 * c, dtype=torch.float32,
                                device=dev)
            dc = torch.zeros(1, 2 * c, dtype=torch.float32, device=dev)
        return ReceiverState(
            mixer=mixer.mixer_init(c, dev),
            decim=decim,
            fastfir=fastfir.state_init(c, self.blk, dev),
            dc=dc,
            nb=self._nb_init(),
            anf=(scanops.anf_init(c, dev, dtype=torch.complex64)
                 if self.cfg.enable_anf else None),
            agc=agc.agc_init(self.agc_cfg, c, dev),
            demod=demod,
            resamp=resamp,
            spec_full=spectrum.state_init(c, self.cfg.spectrum_bins, dev),
            spec_zoom=spectrum.state_init(c, self.zoom_bins, dev),
            rds=(rds_mod.rds_init(self.rds_cfg, c, dev)
                 if self.rds_cfg is not None else None),
            squelch=torch.zeros(c, dtype=torch.bool, device=dev),
            iqbal=(scanops.auto_iq_balance_init(c, dev)
                   if self.cfg.enable_iq_balance == "auto" else None),
            ctcss=(goertzel.ctcss_init(c, dev) if self.ctcss_cfg is not None
                   else None),
        )

    def _nb_init(self):
        """The noise blanker's carry: in the fused-front layout (avg [1, 2C],
        spike tail [16, 2C]), staged a NoiseBlankerChunkedState; None with
        the blanker off."""
        if self.nb_params is None:
            return None
        if self.staged:
            return scanops.noise_blanker_chunked_init(
                self.cfg.channels, self.device, self.nb_params[1])
        c2 = 2 * self.cfg.channels
        return tuple(torch.zeros(rows, c2, dtype=torch.float32,
                                 device=self.device)
                     for rows in (1, front.NB_TAIL_ROWS))

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

    @ieee_float32()
    def step(self, state: ReceiverState, params: RxParams, iq: torch.Tensor,
             spectra: bool = True):
        """One block: iq [N, 2C] float32 or int16 lane-packed plane, [2, N, C]
        plane pair, or [C, N] complex64.  Returns (state', outputs) with the
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

    @ieee_float32()
    def step_many(self, state: ReceiverState, params: RxParams, iq,
                  spectra: bool = True, rds_per_call: bool = False):
        """K blocks in one dispatch: iq [K*N, 2C] float32 or int16
        lane-packed plane (preferred), a time-folded [K*N/G, 2GC] plane,
        [K, N, 2C], an (re, im) pair of [K*N, C] planes, [K, 2, N, C] /
        [2, K, N, C] stacks or [K, C, N] complex64.

        Returns (state', out) with out['audio'] [K, C, audio_blk] (every
        mode but stereo FM) or [K, C, 2, audio_blk] (FMS stereo: left,
        right), 'spectrum' [K, C, spectrum_bins] dB and 'overload' [K, C]
        (spectra only), 'zoomed' [K, C, zoom_bins] dB (spectra only),
        'smeter' (dict of [K, C] dB), 'squelch_open' [K, C] bool (with a
        CTCSS tone AND-ed with 'ctcss_open' [K, C]) and, for WFM,
        'pilot_locked' [K, C] bool (all False in mono); with the RDS tap
        'rds_soft' [K, C, n_sym] soft symbols and 'rds_timing' [K, C]
        int32 (the dispatch's symbol phase; with the staged front the
        symbol phase of each block, unless rds_per_call: the dispatch's, as
        the JAX package's bank runs a trivial front); with taps=True
        'taps', a dict of [K, C, n] views (raw_iq, post_mixer, post_bp,
        post_demod, rds_baseband).  The staged front also takes a [C, K*N]
        complex64 stream."""
        n = self.cfg.frames_per_buffer
        if self.staged:
            x_cn = self._complex_input(iq)
            if x_cn.shape[1] % n:
                raise ValueError(f"{x_cn.shape[1]} input samples are not a "
                                 f"whole number of {n}-frame blocks")
            raw = None
            if spectra:
                bins = self.cfg.spectrum_bins
                raw = x_cn.reshape(x_cn.shape[0], -1, n)[:, :, n - bins:
                                                         ].transpose(0, 1)
            return self._step_many_staged(state, params, x_cn, raw, spectra,
                                          rds_per_block=not rds_per_call)
        x_pk = self._pack(iq)
        if x_pk.shape[0] % n:
            raise ValueError(f"{x_pk.shape[0]} input rows are not a whole "
                             f"number of {n}-frame blocks")
        return self._step_many_batched(state, params, x_pk, spectra)

    def _complex_input(self, iq) -> torch.Tensor:
        """The staged front's entry: [K, C, N] or [C, K*N] complex64 as is,
        every packed form through _pack (int16 read as x * 2^-15), as the
        [C, K*N] complex64 stream on the Receiver's device."""
        c = self.cfg.channels
        if not isinstance(iq, (tuple, list)) and iq.is_complex():
            if iq.shape[-2] != c:
                raise ValueError(
                    f"complex input has {iq.shape[-2]} channels but this "
                    f"Receiver was built with channels={c}")
            if iq.device != self.device:
                raise ValueError(f"input is on {iq.device} but this "
                                 f"Receiver runs on {self.device}")
            if iq.dim() == 3:
                iq = iq.transpose(0, 1).reshape(c, -1)
            return iq.to(torch.complex64).contiguous()
        x_pk = self._pack(iq)
        if x_pk.dtype == torch.int16:
            x_pk = x_pk.to(torch.float32) * front.I16_SCALE
        return torch.complex(x_pk[:, :c].T, x_pk[:, c:].T).contiguous()

    def _pack(self, iq) -> torch.Tensor:
        """Normalize every accepted layout to the [K*N, 2C] packed plane,
        with the channel-count guards of the JAX Receiver.  A flat plane
        whose lane width is a multiple G of 2C is time-folded by G and is
        unfolded here (one device copy).  A CUDA plane that is not 16-byte
        aligned (a caller's view into a larger one) is copied once."""
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
        if x_pk.dtype not in (torch.float32, torch.int16):
            raise ValueError(f"input planes must be float32 or int16, got "
                             f"{x_pk.dtype}")
        if x_pk.device != self.device:
            raise ValueError(f"input is on {x_pk.device} but this Receiver "
                             f"runs on {self.device}")
        if x_pk.shape[-1] != c2:
            if x_pk.shape[-1] % c2:
                raise ValueError(f"lane width {x_pk.shape[-1]} is neither "
                                 f"2C={c2} nor a folded multiple of it")
            fold = x_pk.shape[-1] // c2
            if self.staged:
                raise ValueError("time-folded input planes need the fused "
                                 "front (as in the JAX package); the staged "
                                 "front takes unfolded planes")
            if self.nb_params is not None:
                raise ValueError("time-folded input planes are incompatible "
                                 "with the noise blanker (as in the JAX "
                                 "package); ship unfolded planes when NB is "
                                 "on")
            if x_pk.shape[0] % self.cfg.frames_per_buffer:
                raise ValueError(
                    f"a plane time-folded by {fold} must hold whole "
                    f"{self.cfg.frames_per_buffer}-frame blocks per lane "
                    f"group, got {x_pk.shape[0]} rows")
            return front.unfold_plane(x_pk, fold)
        x_pk = x_pk.contiguous()
        if x_pk.is_cuda and x_pk.data_ptr() % front.PLANE_ALIGN:
            x_pk = x_pk.clone()      # the kernels take 16-byte aligned planes
        return x_pk

    def _step_many_batched(self, state: ReceiverState, params: RxParams,
                           x_pk: torch.Tensor, spectra: bool):
        cfg = self.cfg
        c = cfg.channels
        k = x_pk.shape[0] // cfg.frames_per_buffer
        front_kw = {}
        if self.cfg.enable_iq_balance:
            front_kw.update(iq_gain=params.iq_gain, iq_phase=params.iq_phase)
        if self.nb_params is not None:
            front_kw.update(nb=self.nb_params, nb_avg=state.nb[0],
                            nb_tail=state.nb[1])
        if self.wfm_tail is not None:
            # stereo: the discriminator runs in the front end; the
            # composite is then needed only as each block's trailing zoom
            # window
            last = state.demod.last
            front_kw.update(disc_gain=self.disc_gain,
                            disc_last=torch.cat([last.real, last.imag])[None],
                            y_tail_rows=self.zoom_bins)
            if self.wfm_comp_decim > 1:
                # hq: the front decimates the composite by 2 (K1e); its
                # carried history is comp_tail on the [hr, C] rows
                taps = self.wfm_cfg.comp_taps
                hr = front.comp_hist_rows(len(taps))
                hist = torch.zeros(hr, c, dtype=torch.float32,
                                   device=self.device)
                hist[hr - (len(taps) - 1):] = state.demod.comp_tail.T
                front_kw.update(comp_taps=taps, comp_hist=hist)
        fr = front.fused_front(
            self.front, x_pk, state.dc, state.mixer.phase, params.tune_hi,
            params.tune_lo, state.decim, n_block=cfg.frames_per_buffer,
            raw_rows=cfg.spectrum_bins if spectra else 0, **front_kw)
        y_pk, dc, decim, phase, raw = fr[:5]
        nb_state = state.nb
        if self.nb_params is not None:
            nb_state, fr = fr[5:7], fr[:5] + fr[7:]
        raw_c = (torch.complex(raw[:, :, :c].transpose(1, 2),
                               raw[:, :, c:].transpose(1, 2))     # [K, C, bins]
                 if spectra else None)
        if self.wfm_tail is not None:
            xz = torch.complex(y_pk[:, :, :c], y_pk[:, :, c:]).permute(2, 0, 1)
            comp_tail = None
            if self.wfm_comp_decim > 1:
                tc = len(self.wfm_cfg.comp_taps)
                comp_tail = fr[7][fr[7].shape[0] - (tc - 1):].T.contiguous()
            demod = functools.partial(self._demod_wfm, disc_t=fr[5],
                                      dlast=fr[6], comp_tail=comp_tail)
        else:
            x_cat = torch.complex(y_pk[:, :c].T, y_pk[:, c:].T)  # [C, K*blk]
            xz = x_cat.reshape(c, k, self.blk)[:, :, self.blk - self.zoom_bins:]
            demod = (functools.partial(self._demod_cm, x_cat=x_cat,
                                       rds_per_block=False)
                     if self.wfm_cfg is not None else
                     functools.partial(self._demod_narrow, x_cat=x_cat))
        tail_st, out = self._tail_many(state, params, k, raw_c, xz, spectra,
                                       demod)
        new_state = ReceiverState(
            mixer=mixer.MixerState(phase=phase), decim=decim, dc=dc,
            nb=nb_state, iqbal=state.iqbal, **tail_st)
        return new_state, out

    def _step_many_staged(self, state: ReceiverState, params: RxParams,
                          x_cn: torch.Tensor, raw, spectra: bool,
                          rds_per_block: bool):
        """The staged front over the dispatch's [C, K*N] stream, then the
        batched tail.  raw: [K, C, spectrum_bins] raw display tails (None
        without spectra); rds_per_block: the RDS timing's cadence (_rds)."""
        cfg = self.cfg
        c, n = cfg.channels, cfg.frames_per_buffer
        k = x_cn.shape[1] // n
        x, dc = x_cn, state.dc
        if cfg.enable_dc_removal:
            # JAX runs dc_removal_chunked per block: chunked where N is a
            # multiple of its 512-sample chunk, per sample otherwise
            if n % front.DC_CHUNK:
                dc, x = iir.dc_removal_apply(state.dc, x, alpha=0.9999)
            else:
                dc, x = iir.dc_removal_chunked(state.dc, x, alpha=0.9999,
                                               chunk=front.DC_CHUNK)
        iqbal = state.iqbal
        if cfg.enable_iq_balance == "auto":
            x = x.contiguous()
            if x.is_cuda and x.data_ptr() % 16:
                x = x.clone()         # K5 takes 16-byte aligned rows
            iqbal, x = scanops.auto_iq_balance(state.iqbal, x)
        elif cfg.enable_iq_balance:
            x = scanops.iq_balance(x, params.iq_gain, params.iq_phase)
        nb_state = state.nb
        if self.nb_params is not None:
            thr, width, alpha, nb_mode = self.nb_params
            nb_state, x = scanops.noise_blanker_chunked(
                state.nb, x, threshold=thr, blank_width=width, alpha=alpha,
                chunk=NB_CHUNK, mode=nb_mode)
        raw_iq = x
        mix_state, x = mixer.mix_blocks(state.mixer, x, params.tune_hi,
                                        params.tune_lo, n)
        decim, x = decimator.apply(self.plan, state.decim, x)   # [C, K*blk]
        xz = x.reshape(c, k, self.blk)[:, :, self.blk - self.zoom_bins:]
        demod = (functools.partial(self._demod_cm, x_cat=x,
                                   rds_per_block=rds_per_block)
                 if self.wfm_cfg is not None else
                 functools.partial(self._demod_narrow, x_cat=x))
        tail_st, out = self._tail_many(state, params, k, raw, xz, spectra,
                                       demod)
        if cfg.taps:
            out["taps"] = {"raw_iq": _blocks(raw_iq, k),
                           "post_mixer": _blocks(x, k), **out["taps"]}
        new_state = ReceiverState(mixer=mix_state, decim=decim, dc=dc,
                                  nb=nb_state, iqbal=iqbal, **tail_st)
        return new_state, out

    def _ewma_blocks(self, prev: torch.Tensor, p: torch.Tensor, a: float):
        """avg_k = a avg_{k-1} + (1-a) p_k over the leading K axis, seeded by
        prev, as one matmul.  Returns (avg [K, ...], avg_last)."""
        k = p.shape[0]
        lmat, seed = iir.ewma_tables(k, a, p.device)
        avg = (torch.matmul(lmat, p.reshape(k, -1)).reshape(p.shape)
               + seed.reshape((k,) + (1,) * (p.dim() - 1)) * prev[None])
        return avg, avg[-1]

    def _tail_many(self, state: ReceiverState, params: RxParams, k: int,
                   raw_c, xz: torch.Tensor, spectra: bool, demod):
        """The batched demod-rate tail for K concatenated blocks.  raw_c:
        [K, C, spectrum_bins] complex display tails (None without spectra);
        xz: [C, K, zoom_bins] each block's trailing demod-rate window; demod:
        the mode's demod-rate chain, (state, params, k) -> (state fields,
        audio [K, C, ...], extra outputs)."""
        cfg = self.cfg
        c = cfg.channels
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

        # ---- zoom power + S-meter per block, in the window's [C, K] order
        n_z = self.zoom_bins
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
        demod_st, audio, extra = demod(state, params, k)
        out.update(extra)

        # ---- CTCSS tone squelch (FMN): one K-block update on the audio;
        # the carried hysteresis state is the AND-ed decision
        ctcss_state = state.ctcss
        if self.ctcss_cfg is not None:
            ctcss_state, tone_open = goertzel.ctcss_update_many(
                self.ctcss_cfg, state.ctcss, audio)
            squelch_open = squelch_open & tone_open
            out["squelch_open"] = squelch_open
            out["ctcss_open"] = tone_open

        gate = (squelch_open.float() * params.gain
                * (1.0 - params.mute.float()))
        out["audio"] = audio * gate.reshape(gate.shape
                                            + (1,) * (audio.dim() - 2))

        tail_st = dict(
            fastfir=state.fastfir, agc=state.agc, anf=state.anf,
            spec_full=spec_full_state, spec_zoom=spec_zoom_state,
            rds=state.rds, squelch=squelch_open[-1], ctcss=ctcss_state)
        return {**tail_st, **demod_st}, out

    def _demod_narrow(self, state: ReceiverState, params: RxParams, k: int,
                      x_cat: torch.Tensor):
        """FastFIR -> ANF -> AGC -> the mode's demod -> resampler on x_cat
        [C, K*blk]."""
        c = self.cfg.channels
        mode = self.cfg.mode
        mask = torch.complex(params.bp_mask[0], params.bp_mask[1])
        ff_state, xt = fastfir.apply_many(state.fastfir, x_cat, mask, self.blk)
        taps = {"post_bp": xt}
        anf_state = state.anf
        if self.cfg.enable_anf:
            # block LMS with one weight update per demod block: K steps
            # (staged: every 16 samples, as the per-block path updates)
            anf_state, xt = scanops.anf(
                state.anf, xt, update_every=16 if self.staged else self.blk)
        agc_state, xt = agc.agc_apply(self.agc_cfg, state.agc, xt)
        demod_state = state.demod
        if mode == DemodMode.AM:
            demod_state, audio = am_mod.am_demod(self.am_cfg, state.demod, xt)
        elif mode == DemodMode.SAM:
            demod_state, audio = sam_mod.sam_demod(self.sam_cfg, state.demod,
                                                   xt, n_block=self.blk)
        elif mode == DemodMode.FMN:
            demod_state, audio = nfm_mod.nfm_demod(self.nfm_cfg, state.demod,
                                                   xt)
        elif mode in (DemodMode.USB, DemodMode.CWU, DemodMode.DIGU):
            audio = ssb_mod.usb_demod(xt)
        elif mode in (DemodMode.LSB, DemodMode.CWL, DemodMode.DIGL):
            audio = ssb_mod.lsb_demod(xt)
        elif mode == DemodMode.DSB:
            audio = ssb_mod.dsb_demod(xt)
        else:                                              # NONE
            audio = xt.real
        taps["post_demod"] = audio
        resamp_state, audio = resampler.apply_many(self.rs_plan, state.resamp,
                                                   audio)
        audio = audio.reshape(c, k, audio.shape[-1] // k).transpose(0, 1)
        return (dict(fastfir=ff_state, anf=anf_state, agc=agc_state,
                     demod=demod_state, resamp=resamp_state), audio,
                self._taps(taps, k))

    def _demod_cm(self, state: ReceiverState, params: RxParams, k: int,
                  x_cat: torch.Tensor, rds_per_block: bool):
        """WFM on the channel-major demod-rate stream x_cat [C, K*blk]
        (demod/wfm.py wfm_demod: mono, or stereo without K2) -> resampler
        (stereo: L and R as 2C channels), and the RDS subchain on the
        tail-rate composite with the tap; FastFIR, ANF and AGC are skipped,
        as in the JAX package."""
        c = self.cfg.channels
        demod_state, wout = wfm_mod.wfm_demod(self.wfm_cfg, state.demod,
                                              x_cat, n_block=self.blk)
        extra = {"pilot_locked": wout["pilot_locked"].T,
                 **self._taps({"post_demod": wout["left"],
                               "rds_baseband": wout["rds_baseband"]}, k)}
        rds_state = state.rds
        if self.rds_cfg is not None:
            rds_state, extra["rds_soft"], extra["rds_timing"] = self._rds(
                state.rds, wout["rds_baseband"], k, rds_per_block)
        if self.wfm_cfg.stereo:
            resamp_state, audio = self._resample_lr(state, wout, k)
        else:
            resamp_state, mono = resampler.apply_many(
                self.rs_plan, state.resamp, wout["left"])
            audio = mono.reshape(c, k, mono.shape[-1] // k).transpose(0, 1)
        return (dict(demod=demod_state, resamp=resamp_state, rds=rds_state),
                audio, extra)

    def _taps(self, taps: dict, k: int) -> dict:
        """{"taps": each [C, K*n] stream as its [K, C, n] blocks} with
        taps=True (None streams left out), else {}."""
        if not self.cfg.taps:
            return {}
        return {"taps": {key: _blocks(v, k) for key, v in taps.items()
                         if v is not None}}

    def _resample_lr(self, state: ReceiverState, wout: dict, k: int):
        """L and R through the resampler as 2C channels: (state', audio [K,
        C, 2, audio_blk])."""
        c = self.cfg.channels
        resamp_state, lr = resampler.apply_many(
            self.rs_plan, state.resamp,
            torch.cat([wout["left"], wout["right"]]))
        return (resamp_state,
                lr.reshape(2, c, k, lr.shape[-1] // k).permute(2, 1, 0, 3))

    def _rds(self, rds_state, composite: torch.Tensor, k: int,
             per_block: bool):
        """The RDS subchain on the tail-rate composite [C, K*tail_blk]:
        streaming-exact on the concatenated stream, so once per dispatch.
        The symbol-timing EWMA updates once per block with the "scan"
        carrier or where per_block (JAX runs those configurations as K
        per-block steps), once per call otherwise (the JAX package's
        batched tails).  Returns (state', soft [K, C, n_sym], timing [K,
        C])."""
        c = self.cfg.channels
        per_block = per_block or self.rds_cfg.alg == "scan"
        rds_state, soft, timing = rds_mod.rds_process(
            self.rds_cfg, rds_state, composite, blocks=k if per_block else 0)
        return (rds_state, soft.reshape(c, k, -1).transpose(0, 1),
                timing.T if per_block else timing[None].expand(k, c))

    def _demod_wfm(self, state: ReceiverState, params: RxParams, k: int,
                   disc_t: torch.Tensor, dlast: torch.Tensor,
                   comp_tail: torch.Tensor | None):
        """Pilot -> stereo tail -> de-emphasis -> stereo resampler on the
        front's discriminator output disc_t [K*blk / comp_decim, C] (hq:
        comp_tail is the composite decimator's new history), and the RDS
        subchain with the tap; FastFIR and AGC are skipped, as in the JAX
        package."""
        c = self.cfg.channels
        demod_state, wout = wfm_mod.wfm_demod_tm(
            self.wfm_cfg, self.wfm_tail, state.demod, disc_t,
            torch.complex(dlast[0, :c], dlast[0, c:]), self.wfm_tail_blk,
            comp_tail_new=comp_tail)
        extra = {"pilot_locked": wout["pilot_locked"].T}
        rds_state = state.rds
        if self.rds_cfg is not None:
            rds_state, extra["rds_soft"], extra["rds_timing"] = self._rds(
                state.rds, wout["rds_baseband"], k, False)
        resamp_state, audio = self._resample_lr(state, wout, k)
        return (dict(demod=demod_state, resamp=resamp_state, rds=rds_state),
                audio, extra)


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


def _blocks(x: torch.Tensor, k: int) -> torch.Tensor:
    """A [C, K*n] stream as the [K, C, n] view of its K blocks."""
    return x.reshape(x.shape[0], k, -1).transpose(0, 1)


def _first_block(out: dict) -> dict:
    """Drop the leading K=1 axis of step_many's outputs."""
    return {key: (_first_block(v) if isinstance(v, dict) else v[0])
            for key, v in out.items()}
