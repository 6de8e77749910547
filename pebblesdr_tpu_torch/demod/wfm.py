"""Wideband broadcast FM: stereo and mono.

Port of pebblesdr_tpu/demod/wfm.py.  Two stereo routes, as in the JAX
package:

  * the fused tail (wfm_demod_tm; the ``wfm``, ``wfm_hq`` and ``wfm_rds``
    bench geometries, where the block admits a tail sub-block, tail_sub >
    0): the front end's discriminator hands over the time-major composite
    (at the hq geometry already decimated by 2 to the tail rate, K1e), then
    open pilot (ops/pll.py) -> fused stereo tail (demux + decimating
    low-pass, K2, ops/wfm_tail.py) -> lock gate -> L/R -> pilot notch where
    the low-pass leaves 19 kHz (notch_needed) -> de-emphasis;
  * the stereo tail without K2 (wfm_demod on channel-major IQ: tail_sub ==
    0, e.g. 2.88 and 1.536 Msps, the staged front, and the "pll" pilot):
    discriminator, at the hq geometry the composite FIR decimating by 2,
    the pilot ("open": pll.pilot_open_run; "pll": the Q=500 bandpass
    biquad, then the chunked loop pll.pll_run_blockwise, K3c, or with
    pilot_chunk 0 the per-sample loop pll.pll_run, K3), the per-block lock
    level, the 2 sin(2 phase) demux, one stacked [2C, N] decimating
    low-pass for mono and L-R, the lock gate, the notch, de-emphasis.

Mono (wfm_demod): the reference's 75 kHz pre-discriminator biquad over the
re/im rails, the discriminator, at the hq geometry the composite FIR, the
mono low-pass decimating by audio_decim, de-emphasis.  Where audio_decim
does not divide the tail block (2.88 Msps: 4096 / 5), each block keeps its
own decimation grid, as the JAX package's per-block path does.  With the
RDS tap the tail-rate composite is also handed out channel-major for
demod/rds.py.  The configuration and state keep the JAX package's fields,
shapes and leaf order: stereo with tail_sub > 0 carries the fused tail's
packed [d_rows, 2C] history, every other layout the [C, T-1] FIR tails;
the pilot state is PilotOpenState ("open") or PLLState ("pll").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal
import torch

from pebblesdr_tpu_torch.ops import fir, front, iir, pll
from pebblesdr_tpu_torch.ops import wfm_tail as wfm_tail_mod

PILOT_HZ = 19000.0


@dataclasses.dataclass(frozen=True, eq=False)
class WFMConfig:
    sample_rate: float                  # composite rate (~256 kHz)
    stereo: bool = True
    deemphasis_us: float = 75.0
    audio_decim: int = 4
    max_deviation: float = 75000.0
    pilot_chunk: int = 256              # "pll" pilot: the chunked loop's
    #                                     chunk; 0 = the per-sample loop
    audio_taps: np.ndarray | None = None
    pilot_bp: iir.BiquadCoef | None = None      # "pll": 19 kHz, Q = 500
    pilot_notch: iir.BiquadCoef | None = None
    pilot_pll: pll.PLLConfig | None = None      # "pll": BW 10 Hz
    rds_tap: bool = False
    pilot_alg: str = "open"
    pilot_open: pll.PilotOpenConfig | None = None
    tail_sub: int = 0                   # fused-tail sub-block; 0 = none
    notch_needed: bool = True
    # the hq geometry discriminates at sample_rate * comp_decim and brings
    # the (< 61 kHz wide) composite down to sample_rate, the tail rate,
    # with comp_taps
    comp_decim: int = 1
    comp_taps: np.ndarray | None = None
    # mono only: the reference's 75 kHz Q=1 low-pass biquad on the re/im
    # rails before the discriminator (at input rates >= 150 kHz)
    mono_pre_lp: iir.BiquadCoef | None = None

    @property
    def audio_rate(self) -> float:
        return self.sample_rate / self.audio_decim

    @property
    def input_rate(self) -> float:
        return self.sample_rate * self.comp_decim

    @staticmethod
    def make(sample_rate: float, stereo: bool = True,
             deemphasis_us: float = 75.0, audio_decim: int = 4,
             rds_tap: bool = False, pilot_alg: str = "open",
             comp_decim: int = 1) -> "WFMConfig":
        # stereo puts the low-pass stopband at the 19 kHz pilot, so the
        # separate pilot notch is redundant (notch_needed False)
        transition = (PILOT_HZ - 15000.0 if stereo
                      else sample_rate / (2.0 * audio_decim) - 15000.0)
        audio_taps = fir.design_lowpass_kaiser(
            15000.0, sample_rate, atten_db=60.0,
            transition_hz=transition, max_taps=255)
        h19 = np.abs(np.sum(audio_taps * np.exp(
            -2j * np.pi * PILOT_HZ / sample_rate * np.arange(len(audio_taps)))))
        fs_in = sample_rate * comp_decim
        mono_pre_lp = (iir.design_biquad("lowpass", 75000.0, fs_in, q=1.0)
                       if (not stereo and fs_in >= 150000.0) else None)
        comp_taps = None
        if comp_decim > 1:
            # pass 0-61 kHz flat (the RDS band's upper edge), stop what
            # would alias into it; 31 taps, unit DC gain
            comp_taps = scipy.signal.remez(
                31, [0.0, 61000.0, sample_rate - 61000.0, 0.5 * fs_in],
                [1.0, 0.0], weight=[1.0, 30.0], fs=fs_in)
            comp_taps = comp_taps / comp_taps.sum()
        return WFMConfig(
            sample_rate=sample_rate, stereo=stereo, deemphasis_us=deemphasis_us,
            audio_decim=audio_decim, audio_taps=audio_taps,
            pilot_bp=iir.design_biquad("bandpass", PILOT_HZ, sample_rate,
                                       q=500.0),
            # the notch runs on the decimated audio: designed at audio rate
            pilot_notch=iir.design_biquad("notch", PILOT_HZ,
                                          sample_rate / audio_decim, q=5.0),
            pilot_pll=pll.make_pll_config(sample_rate, bw_hz=10.0, zeta=0.707,
                                          center_hz=PILOT_HZ, range_hz=100.0,
                                          detector="pilot"),
            rds_tap=rds_tap, pilot_alg=pilot_alg,
            pilot_open=pll.make_pilot_open_config(sample_rate),
            notch_needed=bool(h19 > 10.0 ** (-55.0 / 20.0)),
            comp_decim=comp_decim, comp_taps=comp_taps,
            mono_pre_lp=mono_pre_lp)


@dataclasses.dataclass(frozen=True)
class WFMState:
    last: torch.Tensor          # [C] complex64 previous composite sample
    pilot_bq: torch.Tensor      # [C, 2] pilot bandpass biquad ("pll" only)
    pilot_pll: pll.PilotOpenState | pll.PLLState   # "open" | "pll"
    pilot_level: torch.Tensor   # [C] smoothed pilot amplitude (lock detect)
    deemph_l: torch.Tensor      # [C]
    deemph_r: torch.Tensor      # [C]
    lp_tail_mono: torch.Tensor  # fused tail (tail_sub > 0): [d_rows, 2C]
    #                             packed [mono | lmr] history; else [C, T-1]
    lp_tail_lmr: torch.Tensor   # fused tail: [C, 0]; else [C, T-1] (L-R;
    #                             unused in mono)
    notch_l: torch.Tensor       # [C, 2]
    notch_r: torch.Tensor       # [C, 2]
    comp_tail: torch.Tensor     # [C, Tc-1] composite-decimator history
    #                             (comp_decim > 1; else [C, 0])
    mono_lp_bq: torch.Tensor    # [2C, 2] mono pre-discriminator biquad
    #                             (re rails, then im rails; else [0, 2])


def tail_d_rows(cfg: WFMConfig) -> int:
    return ((len(cfg.audio_taps) - 1 + 7) // 8) * 8


def pilot_chunk_for(cfg: WFMConfig, n_block: int) -> int:
    """The open-pilot chunk at block length n_block (halved until it
    divides the block)."""
    ell = cfg.pilot_open.chunk
    while n_block % ell:
        ell //= 2
    return ell


def tail_kernel_sub(cfg: WFMConfig, blk: int) -> int:
    """Largest power-of-two sub-block <= 2048 that divides blk and is a
    multiple of the pilot chunk and of audio_decim; 0 if none."""
    if not cfg.stereo or cfg.audio_decim <= 1:
        return 0
    ell = pilot_chunk_for(cfg, blk)
    sub = min(2048, blk)
    while sub and (blk % sub or sub % ell or sub % cfg.audio_decim):
        sub //= 2
    return sub


def tail_plan(cfg: WFMConfig, blk: int, device) -> wfm_tail_mod.TailPlan:
    """The stereo tail's geometry for demod blocks of blk samples."""
    return wfm_tail_mod.TailPlan.make(cfg.audio_taps, cfg.audio_decim,
                                      pilot_chunk_for(cfg, blk), cfg.tail_sub,
                                      device)


def wfm_init(cfg: WFMConfig, channels: int, device) -> WFMState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    t = len(cfg.audio_taps)
    if cfg.stereo and cfg.tail_sub:   # the fused tail's packed history
        tail_m = zeros(tail_d_rows(cfg), 2 * channels)
        tail_s = zeros(channels, 0)
    else:
        tail_m, tail_s = zeros(channels, t - 1), zeros(channels, t - 1)
    return WFMState(
        last=zeros(channels, dtype=torch.complex64),
        pilot_bq=iir.biquad_state_init(channels, device),
        pilot_pll=(pll.pilot_open_init(channels, device)
                   if cfg.pilot_alg == "open"
                   else pll.pll_init(cfg.pilot_pll, channels, device)),
        pilot_level=zeros(channels),
        deemph_l=zeros(channels), deemph_r=zeros(channels),
        lp_tail_mono=tail_m, lp_tail_lmr=tail_s,
        notch_l=iir.biquad_state_init(channels, device),
        notch_r=iir.biquad_state_init(channels, device),
        comp_tail=zeros(channels, len(cfg.comp_taps) - 1
                        if cfg.comp_decim > 1 else 0),
        mono_lp_bq=iir.biquad_state_init(
            2 * channels if cfg.mono_pre_lp is not None else 0, device))


def discriminator(last: torch.Tensor, x: torch.Tensor, gain: float):
    """Conj-product FM discriminator of x [C, N] complex64 with the carried
    previous sample last [C]: (new_last [C], fm [C, N] float32).  The
    channel-major face of ops.front.discriminate (packed [N, 2C])."""
    c = x.shape[0]
    y = torch.cat([x.real.T, x.imag.T], dim=1)
    disc, y_last = front.discriminate(
        y, torch.cat([last.real, last.imag])[None], gain)
    return torch.complex(y_last[0, :c], y_last[0, c:]), disc.T.contiguous()


def _polish(cfg: WFMConfig, state: WFMState, mono_a: torch.Tensor,
            lmr_a: torch.Tensor, locked: torch.Tensor):
    """Lock gate (per block: locked [C, K]) -> L/R -> the pilot notch where
    the low-pass leaves 19 kHz (notch_needed) -> de-emphasis, each on the
    stacked [2C, M] L/R.  Returns (notch state [2C, 2], de-emphasis state
    [2C], left [C, M], right [C, M])."""
    c, m_all = lmr_a.shape
    k = locked.shape[1]
    lmr_a = torch.where(locked[:, :, None],
                        lmr_a.reshape(c, k, m_all // k), 0.0).reshape(c, m_all)
    lr = torch.cat([mono_a + lmr_a, mono_a - lmr_a])
    notch_lr = torch.cat([state.notch_l, state.notch_r])
    if cfg.notch_needed:
        notch_lr, lr = iir.biquad_apply(notch_lr, lr, cfg.pilot_notch)
    alpha = iir.deemphasis_alpha(cfg.deemphasis_us, cfg.audio_rate)
    d_lr, lr = iir.first_order_apply(
        torch.cat([state.deemph_l, state.deemph_r]), lr, alpha, 1.0 - alpha)
    return notch_lr, d_lr, lr[:c], lr[c:]


def wfm_demod_tm(cfg: WFMConfig, plan: wfm_tail_mod.TailPlan, state: WFMState,
                 raw_t: torch.Tensor, new_last: torch.Tensor, n_block: int,
                 comp_tail_new: torch.Tensor | None = None):
    """The stereo chain on the time-major tail-rate composite raw_t [N, C]
    (the front end's discriminator output; N a whole number of
    n_block-sample blocks) through the fused tail (open pilot, tail_sub >
    0).  new_last [C] complex64 is the carried composite sample the front
    returned.  With comp_decim > 1 the front has already decimated the
    composite (K1e), and comp_tail_new [C, Tc-1] is the history it carried.
    Returns (state', dict(left [C, M], right [C, M], pilot_locked [C, K]
    bool, rds_baseband [C, N] float32 composite with the RDS tap, else
    None)), M = N / audio_decim."""
    why = ("a mono configuration" if not cfg.stereo else
           f"the {cfg.pilot_alg!r} pilot" if cfg.pilot_alg != "open" else
           None if cfg.tail_sub else
           "a geometry without a tail sub-block (tail_sub == 0)")
    if why:
        raise ValueError(f"wfm_demod_tm runs the fused stereo tail (K2): "
                         f"{why} runs wfm_demod")
    if (cfg.comp_decim > 1) != (comp_tail_new is not None):
        raise ValueError("comp_tail_new (the front's composite-decimator "
                         "history) is needed exactly when comp_decim > 1")
    n, c = raw_t.shape
    k_blocks = n // n_block
    ell = plan.ell
    pll_state, (p0, wf, _), level_f = pll.pilot_open_core_tm(
        cfg.pilot_open, state.pilot_pll, raw_t, chunk=ell)
    lv = level_f.reshape(c, k_blocks, n_block // ell)[:, :, -1]  # [C, K]
    locked = lv > 0.002

    audio_pk, tail_pk = wfm_tail_mod.wfm_tail(
        plan, raw_t, p0.T.contiguous(), wf.T.contiguous(), state.lp_tail_mono)
    notch_lr, d_lr, left, right = _polish(cfg, state, audio_pk[:, :c].T,
                                          audio_pk[:, c:].T, locked)
    new_state = dataclasses.replace(
        state, last=new_last, pilot_pll=pll_state, pilot_level=lv[:, -1],
        deemph_l=d_lr[:c], deemph_r=d_lr[c:], lp_tail_mono=tail_pk,
        notch_l=notch_lr[:c], notch_r=notch_lr[c:],
        comp_tail=state.comp_tail if comp_tail_new is None else comp_tail_new)
    # RDS premixes its -57 kHz shift into its decimation taps: it takes the
    # real composite, channel-major
    rds_bb = raw_t.T.contiguous() if cfg.rds_tap else None
    return new_state, {"left": left, "right": right, "pilot_locked": locked,
                       "rds_baseband": rds_bb}


def _pilot(cfg: WFMConfig, state: WFMState, raw: torch.Tensor, n_block: int):
    """The pilot on the channel-major tail-rate composite raw [C, N]:
    (pilot_bq', pilot_pll', level [C], phases [C, N], locked [C, K])."""
    c, n = raw.shape
    k = n // n_block
    if cfg.pilot_alg == "open":
        # the Hann chunk window is the pilot bandpass; the lock level is the
        # chunk level at each block's last chunk
        ell = pilot_chunk_for(cfg, n_block)
        pll_state, phases, level_f = pll.pilot_open_run(
            cfg.pilot_open, state.pilot_pll, raw, chunk=ell)
        lv = level_f.reshape(c, k, n_block // ell)[:, :, -1]
        return state.pilot_bq, pll_state, lv[:, -1], phases, lv > 0.002
    if cfg.pilot_alg != "pll":
        raise ValueError(f"pilot_alg={cfg.pilot_alg!r}: 'open' or 'pll'")
    bq_state, pilot = iir.biquad_apply(state.pilot_bq, raw, cfg.pilot_bp)
    if cfg.pilot_chunk:
        pll_state, phases, _ = pll.pll_run_blockwise(
            cfg.pilot_pll, state.pilot_pll, pilot, chunk=cfg.pilot_chunk)
    else:
        pll_state, phases, _ = pll.pll_run(cfg.pilot_pll, state.pilot_pll,
                                           pilot)
    # lock: the coherent pilot amplitude pilot sin(phase) (~A/2 locked),
    # its per-block mean smoothed by the per-call EWMA in closed form
    coh = torch.abs(torch.mean((pilot * torch.sin(phases)
                                ).reshape(c, k, n_block), dim=-1))
    level_k = pll._ewma_closed(state.pilot_level, coh, 0.9)   # [C, K]
    return bq_state, pll_state, level_k[:, -1], phases, level_k > 0.002


def wfm_demod(cfg: WFMConfig, state: WFMState, x: torch.Tensor,
              n_block: int):
    """The chain on the channel-major input-rate IQ x [C, N] complex64 (N a
    whole number of n_block-sample blocks): mono (pre-discriminator biquad
    over the stacked re/im rails, discriminator, at comp_decim > 1 the
    composite FIR decimating to the tail rate, the mono low-pass decimating
    by audio_decim, de-emphasis) or stereo without K2 (discriminator, the
    composite FIR, the pilot, the 2 sin(2 phase) demux, one stacked [2C, N]
    low-pass for mono and L-R, then _polish).  Returns (state', dict(left
    [C, M], right [C, M] (= left in mono), pilot_locked [C, K] (all False in
    mono), rds_baseband [C, N / comp_decim] float32 composite with the RDS
    tap, else None)), M = K * (n_block / comp_decim // audio_decim)."""
    if cfg.stereo and cfg.tail_sub:
        raise ValueError("a stereo geometry with a tail sub-block runs the "
                         "fused tail, wfm_demod_tm")
    c, n = x.shape
    mono_bq = state.mono_lp_bq
    if cfg.mono_pre_lp is not None:
        mono_bq, ri = iir.biquad_apply(state.mono_lp_bq,
                                       torch.cat([x.real, x.imag]),
                                       cfg.mono_pre_lp)
        x = torch.complex(ri[:c], ri[c:])
    new_last, raw = discriminator(
        state.last, x, cfg.input_rate / (2.0 * np.pi * cfg.max_deviation))
    comp_tail = state.comp_tail
    blk = n_block // cfg.comp_decim
    if cfg.comp_decim > 1:
        raw, comp_tail = fir.fir_apply_real_signal(
            raw, state.comp_tail, cfg.comp_taps, decim=cfg.comp_decim)
    new_state = dataclasses.replace(state, last=new_last, comp_tail=comp_tail,
                                    mono_lp_bq=mono_bq)
    rds_bb = raw if cfg.rds_tap else None
    if not cfg.stereo:
        mono_a, tail_m = fir.fir_apply_real_signal(
            raw, state.lp_tail_mono, cfg.audio_taps, decim=cfg.audio_decim,
            block=blk)
        alpha = iir.deemphasis_alpha(cfg.deemphasis_us, cfg.audio_rate)
        dl, left = iir.first_order_apply(state.deemph_l, mono_a, alpha,
                                         1.0 - alpha)
        locked = torch.zeros(c, n // n_block, dtype=torch.bool,
                             device=x.device)
        return (dataclasses.replace(new_state, deemph_l=dl,
                                    lp_tail_mono=tail_m),
                {"left": left, "right": left, "pilot_locked": locked,
                 "rds_baseband": rds_bb})
    bq_state, pll_state, level, phases, locked = _pilot(cfg, state, raw, blk)
    lmr = raw * 2.0 * torch.sin(2.0 * phases)              # L-R at baseband
    # mono and L-R share the low-pass: one stacked [2C, N] FIR
    both, tails = fir.fir_apply_real_signal(
        torch.cat([raw, lmr]),
        torch.cat([state.lp_tail_mono, state.lp_tail_lmr]), cfg.audio_taps,
        decim=cfg.audio_decim, block=blk)
    notch_lr, d_lr, left, right = _polish(cfg, state, both[:c], both[c:],
                                          locked)
    new_state = dataclasses.replace(
        new_state, pilot_bq=bq_state, pilot_pll=pll_state, pilot_level=level,
        deemph_l=d_lr[:c], deemph_r=d_lr[c:], lp_tail_mono=tails[:c],
        lp_tail_lmr=tails[c:], notch_l=notch_lr[:c], notch_r=notch_lr[c:])
    return new_state, {"left": left, "right": right, "pilot_locked": locked,
                       "rds_baseband": rds_bb}
