#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  0. torch / CUDA versions and the card's name and power limit (nvidia-smi);
     matmuls in IEEE float32, and fir_apply's conv1d too with cuDNN's TF32
     allowed (within 1e-5 of a float64 convolution, the setting restored);
  1. build the CUDA kernels from pebblesdr_tpu_torch/csrc with nvcc;
  2. the fused front-end kernel (K1) against its plain PyTorch version at the
     headline shape (64 channels, 32768-frame blocks, 32 blocks), over two
     streaming calls;
  3. the AM receiver on the card against the same receiver on the CPU
     (4 channels, 8192-frame blocks, dispatches of 3 then 9 blocks);
  4. the headline AM receiver (64 channels at 2.048 Msps, 32 blocks of 32768
     frames per dispatch, AGC stride 16, display spectra every 6th dispatch),
     timed with CUDA events, with its K1 launch count and a tone-SNR check of
     the demodulated audio;
  5. K1 against its plain version, timed with CUDA events;
  6. K1 in its WFM form (factor-8 plan, FM discriminator, y-tail windows)
     against its plain version at the WFM headline shape (64 channels, 32
     blocks of 32768 frames), over two streaming calls;
  7. the stereo tail kernel (K2) against its plain version at the WFM
     headline shape (composite [131072 x 64]), over two streaming calls;
  8. the WFM-stereo receiver on the card against the same receiver on the
     CPU (4 channels, 8192-frame blocks, dispatches of 3 then 9 blocks);
  9. the headline WFM-stereo receiver (bench.py's wfm row: 64 channels, 32
     blocks of 32768 frames per dispatch, spectra every 6th dispatch), timed
     like phase 4, with its K1 and K2 launch counts, pilot lock and the
     L-channel tone SNR;
 10. stereo separation of an L-only 700 Hz program (bench.py:318-341) on
     the card;
 11. K1 (WFM form) and K2 against their plain versions, timed with CUDA
     events, and K2's device time per launch (torch.profiler), which
     must be one CUDA launch per call;
 12. K1 with its front options (float32 + IQ balance + NB1, float32 + IQ
     balance + NB2, int16 + IQ balance + NB1) against its plain version at
     the am_nb_64ch shape (64 channels, 32 blocks of 32768 frames), two
     streaming calls each, on an impulsive input whose threshold margin is
     asserted first, counting the blanked positions that differ; and NB1 in
     the WFM form;
 13. the AM receiver on the card against the CPU with NB1 + IQ balance on,
     with int16 planes, and with planes time-folded by 3 (C=2);
 14. the timed cells am_nb_64ch (bench.py's am_nb row, NB1), am_256ch and
     am_i16_256ch (256 channels, 16 blocks, float32 and int16 planes, their
     windows interleaved) and am_16ch (16 channels, 64 blocks, entered as a
     plane folded by 4, with the unfold copy timed on its own);
 15. K1 at each timed cell's shape and form (the base form at am_64ch,
     NB1 + IQ at am_nb_64ch, float32 at am_256ch, int16 at am_i16_256ch,
     float32 at am_16ch) against its plain version on the same inputs, then
     both timed, with each form's per-launch device times (front_fir's
     over 10 calls), and at am_64ch front_fir's plain version (DC removal,
     mix and FIR) timed;
 16. K1 in its hq form (factor-4 plan, discriminator, y-tails and the
     composite decimation by 2, K1e) against its plain version at the
     wfm_hq_64ch shape (64 channels, 32 blocks of 32768 frames), over two
     streaming calls, then both timed, with the per-launch device times
     (front_comp is the only pass over y: no front_disc, 4 CUDA launches
     per call) and front_comp's own plain version and bound;
 17. the WFM receiver at the hq geometry on the card against the CPU (4
     channels, 8192-frame blocks, dispatches of 3 then 9 blocks);
 18. the WFM+RDS receiver, at the default and at the hq geometry, on the
     card against the CPU (4 channels, 32768-frame blocks, dispatches of 3),
     with the soft symbols, the symbol timing and the RDS state;
 19. RDS decode on the card: the PS name "PEBBLES " at C=1 through 5
     dispatches of 8 blocks, at the default and at the hq geometry (there
     with no block error);
 20. stereo separation at the hq geometry on the card;
 21. the timed cells wfm_hq_64ch and wfm_rds_64ch (bench.py's wfm_hq and
     wfm_rds rows, windows interleaved) and wfm_16ch (16 channels, 64
     blocks, entered as a plane folded by 4), each with K1 and K2 held to
     their plain versions at the cell's own plans and shapes first, and a
     profile of its dispatches (event-timed ms, host enqueue, device busy,
     idle share);
 22. the K1 probes of tools/kbench2.py (ops/kprobe.py) at the probe bench's
     default shape (64 channels, 8 blocks of 32768 rows, the AM plan): the
     copy floors against their plain version exactly, each front form (v1,
     v2, v3, v4, v5 at kt 2 and 4; sub 2048 and 4096; the product on the
     tensor cores as 3xTF32) over two streaming calls against its plain
     version (y, dc' and tail' within 3e-5) and against K1's base form;
     then the probe bench's full table (pebblesdr_tpu_torch/tools/
     kbench2.py, the main path of this slice) with its launch counts; then
     each form timed against its plain version with its CUDA kernels per
     call (front_means and front_dc_scan per plane, one probe_toeplitz) and
     the TFLOP/s of its product, the packed floor at am_64ch's shape beside
     the torch call that moves the same bytes; and the product's yardstick,
     one batched torch.matmul of W [64, K] with the mixed input [128
     sub-blocks, K, 128] at "highest" precision and with TF32 allowed
     inside the call only;
 23. front_means, K1's first pass, alone (ops/front.py chunk_means: the
     chunk means and the raw display tails) at the shapes and dtypes of the
     cells am_64ch, am_256ch, am_i16_256ch and am_16ch: int16 means and
     every raw tail equal to its plain version, float32 means within 1e-6
     max |x|; then timed in turns with the PyTorch call that computes the
     means and with its plain version, with GB/s, the share of its bound
     and its per-launch device time;
 24. front_dc_scan, K1's chunk EWMA, alone (ops/front.py dc_scan) at the
     shapes of am_64ch, am_16ch, am_256ch and am_nb_64ch's second scan:
     m and dc' equal to dc_scan_emulate bit for bit and within 3e-5 of
     max |m| of the plain version, then timed in turns with it, with its
     per-launch device time and bound;
 25. K1 at front_fir's 4-channel geometry, the factor-64 / 2007-tap
     response of USB, LSB, CW and DIG (float32, int16, and NB1 + IQ balance
     on an impulsive input whose threshold margin is asserted, no flag
     mismatch) and the factor-32 / 1159-tap response of NONE (float32),
     against its plain version at the headline width (64 channels, 32
     blocks of 32768 rows), over two streaming calls; then each form timed
     against its plain version with its per-launch device times, and
     front_fir's plain version and bound;
 26. the narrowband receivers on the card against the same receivers on
     the CPU (4 channels, 8192-frame blocks, dispatches of 3 then 9
     blocks): USB (float32, int16 and NB1 + IQ entry), LSB, CWU, DIGL,
     DSB, NONE, SAM with the analytic and with the rails sideband split
     (SAM's audio within 2e-3 of its scale, its phases modulo 2 pi);
 27. the timed cells sam_64ch (bench.py:585: SAM, 64 channels, 32 blocks of
     32768 frames, the bench signal) and usb_64ch (USB at the same shape,
     AGC off, a 0.4 tone at carrier + 1.5 kHz: the audio's amplitude held to
     0.4 sqrt(2) within 10 %), windows interleaved, each with a profile of
     its dispatches;
 28. the receivers of the batched graph's last modes and options on the
     card against the same receivers on the CPU (4 channels, 8192-frame
     blocks, dispatches of 3 then 9 blocks; RDS 32768-frame blocks, 3):
     FMN with the CTCSS tone squelch (float32 and int16 entry; channels 0-1
     carry the 123.0 Hz tone, 2-3 the 127.3 Hz neighbour, after a CPU
     warm-up that lets the EWMA settle, every compared block's power ratio
     asserted far from the decision's 4, squelch_open and ctcss_open equal),
     FMM at the default and the hq geometry, FMS with stereo=False and the
     RDS tap, AM with the ANF and AGC "long", USB with AGC "long"; K1
     launched once per dispatch (its base form), K2 never;
 29. the timed cells nfm_ctcss_64ch (FMN with a 123.0 Hz CTCSS tone, 64
     channels, 32 blocks of 32768 frames: NFM voice at 3 kHz deviation and
     the sub-tone at 500 Hz, in noise; tone SNR over 300 Hz-3 kHz, the
     CTCSS squelch open on every channel), fmm_64ch (FMM on the WFM bench
     signal) and am_anf_long_64ch (AM with the ANF and AGC "long": the
     ANF's weights adapted; its SNR printed), windows interleaved, each
     with a profile of its dispatches; first K1's base form at fmm_64ch's
     plan (factor 8, 283 taps) against its plain version, both timed;
 30. the recurrence kernels of csrc/recur.cu at the module shapes, each
     driven once through its entry point (launches counted), then held to
     its plain version on the inputs that call gave it (max |kernel -
     plain| <= 1e-5, phases on the circle) and timed against it, with its
     per-launch device time and its bound (the bytes, or the serial floor
     from the register-only chain probe): pll_scan atan2 (NFM "pll",
     [64, 32768] at 64 ksps, the tone SNR held), cross and pilot (the
     composite's [64, 131072], held and timed on its first 8192 steps; the
     loop locked), pll_chunk_scan (SAM smooth "loop", [64, 4096] chunk
     phasors, the tone SNR held) and agc_scan ([64, 2048] at stride 16,
     "long" and "med");
 31. the receivers that run the per-sample loop on the card against the
     CPU (4 channels: FMS with the scan RDS carrier, a dispatch of 3
     32768-frame blocks; SAM on 64-sample blocks, 2048 frames, dispatches
     of 3 then 9), pll_scan once per dispatch; "PEBBLES " decoded with the
     scan carrier; the timed cells wfm_rds_scan_64ch (wfm_rds_64ch with
     rds_alg="scan") and sam_short_64ch (SAM, 64 channels, 128 blocks of
     2048 frames), windows interleaved, with their launch counts, tone
     SNR and dispatch profiles; then pll_scan at each cell's own inputs
     held to its plain version and timed;
 32. K5 (csrc/recur.cu iq_lms_scan, the adaptive IQ balance's LMS loop)
     through its entry point scanops.auto_iq_balance at am_iqauto_64ch's
     stream ([64, 1048576] complex64: the AM plane with the IQ imbalance
     of tests/test_chain.py:204-236), one launch, y and w' within 1e-5 of
     their scale of its plain version (timed once), the kernel timed with
     its per-launch device time, the chain probe's step latency and the
     bound; then the image rejection of that imbalance through 12 blocks
     at module level (deepens by >= 20 dB, ends above 60 dB);
 33. the receivers on the staged front on the card against the CPU, on
     imbalanced planes (4 channels, 8192-frame blocks, dispatches of 3
     then 9; RDS 32768-frame blocks, 3): AM with enable_iq_balance="auto",
     USB "auto" + NB1 (impulses, the staged blanker's threshold margin
     asserted), AM with enable_dc_removal=False, FMM "auto" + RDS; K1
     never launched, K5 once per dispatch with "auto"; then the
     PfbBankReceiver at M = 16 (1.024 Msps, 3 stations, dispatches of 3
     blocks of 16384), trivial front and "auto";
 34. the timed cells am_iqauto_64ch (am_64ch with enable_iq_balance=
     "auto" on the imbalanced plane: the staged front, K5) and
     pfb_127st_bank128 (bench.py:228-290: 127 AM stations through a
     128-channel filterbank, 16 kHz channel tails, spectra every
     dispatch), each timed alone, with launch counts, its peak memory and
     a profile; then the halfband cascade of am_iqauto_64ch
     (decimator.apply), timed, and its share of device busy.
Each phase's seconds and the running total are printed after it.
Each receiver phase sets every kernel's launch count to 0 just before it
drives the receiver and reads the counts just after (front_means and
front_dc_scan count their launches inside K1 as well; front_comp counts
the hq form's).  Each kernel's bound
is the larger of the bytes it must move over 3.35 TB/s and the operations
it does over 67 TFLOP/s (the H100 SXM's float32 peak outside the tensor
cores).  The line before the last is the per-kernel JSON summary; the last
line is {"ok": true, "device": {...}}.  No JAX is imported.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np

FS = 2_048_000
HEADLINE = dict(channels=64, frames=32768, blocks=32, agc_stride=16)
SPECTRA_EVERY = 6
WARMUP = 3
WINDOWS = 3
WINDOW_DISPATCHES = 10
FRONT_RTOL = 3e-5        # K1 vs plain: relative max error (TPU kernel's bound)
SLICE = dict(channels=4, frames=8192, dispatches=(3, 9))
TONE_SNR_DB = 40.0       # 1 kHz tone (AM m = 0.8; WFM L), band above 100 Hz
DISC_ATOL = 1e-4         # K1's discriminator vs plain (tests/test_pallas.py:286)
SEPARATION_DB = 30.0     # WFM stereo separation (the JAX package: 34.6 dB)
HQ_SEPARATION_DB = 40.0  # at the hq geometry (tests/test_chain.py:415; JAX
#                          package: 47.4 dB)
SOFT_RTOL = 1e-3         # RDS soft symbols, card vs CPU, of their scale
RDS_SLICE = dict(channels=4, frames=32768, blocks=3)
CTCSS_TONE, CTCSS_NEIGHBOUR = 123.0, 127.3   # Hz, neighbours in the table
CTCSS_WARM = (33,) * 5   # CPU warm-up dispatches before a CTCSS slice
#                          (~0.66 s at 8192 frames: the 0.25 s EWMA settles)
KERNELS = ("front", "wfm_tail", "recur")
MEANS_ATOL = 1e-6        # front_means' float32 means vs plain, of max |x|
NB1 = (3.3, 7, 0.001, "blank")     # the Receiver's NB1 (threshold, width,
NB2 = (3.3, 7, 0.001, "average")   # alpha, mode) and NB2
IQ = (1.05, 0.02)                  # static IQ balance (gain, phase)
SPIKES = (100, 511, 2046, 2049, 16385, 32765)   # impulse rows in each block
# the option cells: (name, channels, blocks, entry, receiver options)
OPTION_CELLS = {
    "am_nb_64ch": (64, 32, "f32", dict(enable_noise_blanker=True)),
    "am_256ch": (256, 16, "f32", {}),
    "am_i16_256ch": (256, 16, "i16", {}),
    "am_16ch": (16, 64, "fold4", {}),
}
# the WFM cells of this slice: (name, channels, blocks, entry, options)
WFM_CELLS = {
    "wfm_hq_64ch": (64, 32, "f32", dict(wfm_hq=True)),
    "wfm_rds_64ch": (64, 32, "f32", dict(rds=True)),
    "wfm_16ch": (16, 64, "fold4", {}),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Clock:
    """Logs the seconds each phase took and the run's total so far."""

    def __init__(self, t0: float):
        self.t0 = self.t = t0

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        log(f"{what} took {now - self.t:.1f} s ({now - self.t0:.1f} s since "
            f"the build started)")
        self.t = now


def rel_err(got, ref) -> float:
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))


def rds_biphase(t: np.ndarray) -> np.ndarray:
    """The PS groups of "PEBBLES " (PI 0x54A8, group 0A) as differential
    biphase symbols at 1187.5 baud, sampled at times t
    (tests/test_chain_batched.py:299-345)."""
    from pebblesdr_tpu_torch.demod import rds
    bits = []
    for _ in range(24):
        for seg in range(4):
            d = (ord("PEBBLES "[2 * seg]) << 8) | ord("PEBBLES "[2 * seg + 1])
            bits += rds.encode_group(0x54A8, (5 << 5) | seg, 0xE0E0, d)
    sym = np.cumsum(bits) % 2 * 2.0 - 1.0             # differential encoding
    idx = np.minimum((t * rds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    return sym[idx] * np.where(t * rds.RDS_BAUD - idx < 0.5, 1.0, -1.0)


def wfm_plane(channels: int, n_rows: int, rng, noise: float = 0.0,
              program: str = "mono", t0: float = 0.0):
    """[n_rows, 2C] float32 packed plane: broadcast FM at 250 kHz on every
    channel.  "mono": bench.py's wfm signal (1 kHz on L and R, pilot);
    "left": the L-only 700 Hz program of bench.py's quality row; "rds":
    1 kHz mono, pilot and the RDS PS groups on 57 kHz.  t0: start time."""
    t = t0 + np.arange(n_rows) / FS
    th = 2 * np.pi * 19000.0 * t
    if program == "mono":
        comp = 0.45 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
    elif program == "rds":
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
                + 0.06 * rds_biphase(t) * np.cos(3 * th))
    else:
        lt = np.sin(2 * np.pi * 700.0 * t)
        comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    plane = np.concatenate([np.repeat(iq.real[:, None], channels, 1),
                            np.repeat(iq.imag[:, None], channels, 1)], axis=1)
    if noise:
        plane = plane + noise * rng.standard_normal(plane.shape)
    return plane.astype(np.float32)


def reset_launches(front, wfm_tail) -> None:
    from pebblesdr_tpu_torch.ops import agc, pll, scanops
    front.fused_front.launches = 0
    front.fused_front.comp_launches = 0
    front.chunk_means.launches = 0
    front.dc_scan.launches = 0
    wfm_tail.wfm_tail.launches = 0
    pll.pll_scan.launches = 0
    pll.pll_scan.detector_launches.update(dict.fromkeys(pll.DETECTORS, 0))
    pll.pll_chunk_scan.launches = 0
    agc.agc_scan.launches = 0
    scanops.auto_iq_balance.launches = 0


def am_plane(channels: int, n_rows: int, rng, noise: float = 0.0):
    """[n_rows, 2C] float32 packed plane: an AM carrier at 250 kHz (1 kHz
    tone, m = 0.8) on every channel, with optional complex white noise."""
    t = np.arange(n_rows) / FS
    env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
    iq = 0.5 * env * np.exp(2j * np.pi * 250_000.0 * t)
    plane = np.concatenate([np.repeat(iq.real[:, None], channels, 1),
                            np.repeat(iq.imag[:, None], channels, 1)], axis=1)
    if noise:
        plane = plane + noise * rng.standard_normal(plane.shape)
    return plane.astype(np.float32)


def impulsive(plane: np.ndarray, n: int) -> np.ndarray:
    """Add 8+8j impulses (20x and more above the floor) at chunk, sub-block
    and block seams of every n-row block of a packed plane, in place."""
    rows = (np.arange(plane.shape[0] // n)[:, None] * n
            + np.array(SPIKES)[None, :] % n).ravel()
    plane[rows] += 8.0
    return plane


def to_i16(plane: np.ndarray, scale: float = 32768.0) -> np.ndarray:
    return np.clip(np.round(plane * scale), -32768, 32767).astype(np.int16)


def tone_snr_db(audio: np.ndarray, rate: float, f0: float = 1000.0,
                band: tuple = (100.0, None)) -> float:
    """Least-squares fit of a tone (cos, sin) at f0; SNR of the fit against
    the residual in band (lo, hi) Hz (default: above 100 Hz)."""
    t = np.arange(len(audio)) / rate
    basis = np.stack([np.cos(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * t),
                      np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, audio, rcond=None)
    fit = basis[:, :2] @ coef[:2]
    res = audio - basis @ coef
    spec = np.fft.rfft(res)
    freqs = np.fft.rfftfreq(len(res), 1 / rate)
    spec[freqs <= band[0]] = 0.0
    if band[1] is not None:
        spec[freqs > band[1]] = 0.0
    res_hp = np.fft.irfft(spec, n=len(res))
    return float(10 * np.log10(np.mean(fit ** 2) / max(np.mean(res_hp ** 2),
                                                        1e-30)))


def tone_amplitude(audio: np.ndarray, rate: float, f0: float) -> float:
    """The amplitude of a least-squares fit of a tone at f0."""
    t = np.arange(len(audio)) / rate
    basis = np.stack([np.cos(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * t),
                      np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, audio, rcond=None)
    return float(np.hypot(coef[0], coef[1]))


def tone_plane(channels: int, n_rows: int, offset_hz: float, amp: float):
    """[n_rows, 2C] float32 packed plane: a tone of amplitude amp at 250 kHz
    + offset_hz on every channel (tests/test_chain.py:118's USB tone)."""
    t = np.arange(n_rows) / FS
    iq = amp * np.exp(2j * np.pi * (250_000.0 + offset_hz) * t)
    return np.concatenate([np.repeat(iq.real[:, None], channels, 1),
                           np.repeat(iq.imag[:, None], channels, 1)],
                          axis=1).astype(np.float32)


def time_cuda(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_front(torch, front, decimator) -> dict:
    """Phase 2: K1 vs fused_front_reference on the card, headline shape."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    plan_d = decimator.build_plan(FS, 30_000.0)
    plan = front.FrontPlan.make(decimator.compose_response(plan_d),
                                plan_d.factor, "cuda")
    rng = np.random.default_rng(1)
    tunes = 250_000.0 + 1500.0 * np.arange(c)
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    splits = [split_freq(f, FS) for f in tunes]
    f_hi = torch.tensor(np.array([s[0] for s in splits]), device="cuda")
    f_lo = torch.tensor(np.array([s[1] for s in splits]), device="cuda")
    zeros = dict(dtype=torch.float32, device="cuda")
    st_k = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            torch.zeros(plan.d_rows, 2 * c, **zeros))
    st_r = st_k
    max_abs = 0.0
    worst = 0.0
    for call in range(2):
        x = torch.from_numpy(
            am_plane(c, k * n, rng, noise=0.1) + 0.05 * (call + 1)).cuda()
        out_k = front.fused_front(plan, x, st_k[0], st_k[1], f_hi, f_lo,
                                  st_k[2], n_block=n, raw_rows=2048)
        out_r = front.fused_front_reference(plan, x, st_r[0], st_r[1], f_hi,
                                            f_lo, st_r[2], n_block=n,
                                            raw_rows=2048)
        torch.cuda.synchronize()
        errs = {name: rel_err(a, b) for name, a, b in
                zip(("y", "dc", "tail", "phase", "raw"), out_k, out_r)}
        errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
        max_abs = max(max_abs, float((out_k[0] - out_r[0]).abs().max()))
        worst = max(worst, max(errs.values()))
        log(f"phase2 front call {call}: relative max errors "
            + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items()))
        st_k = (out_k[1], out_k[3], out_k[2])
        st_r = (out_r[1], out_r[3], out_r[2])
    if not worst <= FRONT_RTOL:
        raise RuntimeError(f"K1 disagrees with its plain version: {worst:.3g} "
                           f"> {FRONT_RTOL}")
    log(f"phase2 ok: K1 == plain within {FRONT_RTOL} (worst {worst:.3g}, "
        f"max abs y error {max_abs:.3g})")
    return {"plan": plan, "f_hi": f_hi, "f_lo": f_lo, "max_abs_err": max_abs}


def nfm_plane(channels: int, n_rows: int, rng, noise: float = 0.0,
              tones=(CTCSS_TONE,), t0: float = 0.0):
    """[n_rows, 2C] float32 packed plane: narrowband FM at 250 kHz on every
    channel, a 1 kHz voice tone at 3 kHz deviation plus a CTCSS sub-tone at
    500 Hz deviation (channel i carries tones[i % len(tones)]), amplitude
    0.5, with optional real white noise on every lane.  t0: start time."""
    t = t0 + np.arange(n_rows) / FS
    cols = {}
    for tone in dict.fromkeys(tones):
        dev = (3000.0 * np.sin(2 * np.pi * 1000.0 * t)
               + 500.0 * np.sin(2 * np.pi * tone * t))
        cols[tone] = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t
                                        + 2 * np.pi * np.cumsum(dev) / FS))
    iq = np.stack([cols[tones[i % len(tones)]] for i in range(channels)], 1)
    plane = np.concatenate([iq.real, iq.imag], axis=1)
    if noise:
        plane = plane + noise * rng.standard_normal(plane.shape)
    return plane.astype(np.float32)


def ctcss_ratios(torch, goertzel, cfg, state, audio) -> np.ndarray:
    """[K, C] the CTCSS tone's power over the larger neighbour's after each
    block of pre-gate audio [K, C, M], from state (the decision compares it
    with the config's nb_ratio, 4)."""
    ratios = []
    for block in audio:
        state, _ = goertzel.ctcss_update(cfg, state, block)
        p = (state.iq.double() ** 2).sum(-1)
        ratios.append((p[:, 0] / torch.maximum(p[:, 1], p[:, 2])).numpy())
    return np.stack(ratios)


def runs_loop(rx) -> bool:
    """Whether a receiver runs the per-sample carrier loop (pll_scan, once
    per dispatch): the scan RDS carrier, or SAM's per-sample form."""
    return ((rx.rds_cfg is not None and rx.rds_cfg.alg == "scan")
            or (rx.sam_cfg is not None
                and (rx.blk % 128 != 0 or rx.sam_cfg.algorithm == "scan")))


def phase_slice(torch, receiver, convert, front, wfm_tail, mode,
                entry: str | None = None, rx_opts: dict | None = None,
                tag: str | None = None, frames: int | None = None,
                warm: int = 1, imbalance: bool = False) -> int:
    """Phases 3 (AM), 8 (FMS), 13 (AM with an entry option: "nb1_iq",
    "i16" or "folded"), 17 (FMS at the hq geometry), 18 (FMS with RDS), 26
    (the narrowband modes), 28 (FMN with CTCSS, mono WFM, the ANF and AGC
    "long") and 31 (the scan RDS carrier, SAM on 64-sample blocks): the
    receiver on the card vs on the CPU; returns K1's
    launches over the compared dispatches.
    SAM's audio is held to 2e-3 of its scale (the PLL-mode bound of
    tests/test_chain_batched.py:114-118) and its carried phases modulo
    2 pi.  With a CTCSS tone the CPU warm-up is CTCSS_WARM dispatches
    (the 0.25 s EWMA settles), and every compared block's tone-to-
    neighbour power ratio is asserted far from the decision's 4 first,
    from the pre-gate audio of a twin CPU receiver without the tone
    squelch.  frames: the block length (default SLICE's); warm: the CPU
    warm-up dispatch's blocks.  The per-sample carrier loop (31: the scan
    RDS carrier, SAM on 64-sample blocks) launches pll_scan once per
    dispatch, and its carried phases are compared modulo 2 pi.  Phase 33:
    the receivers on the staged front (K1 and front_means never launched,
    K5 once per dispatch with enable_iq_balance="auto"), on planes with
    the IQ imbalance of tests/test_chain.py:204-236 (imbalance=True); the
    entry "staged_nb1" adds the impulses and asserts the staged blanker's
    threshold margin."""
    from pebblesdr_tpu_torch.ops import goertzel, scanops
    rx_opts = rx_opts or {}
    fm = mode.name in ("FMS", "FMM")
    stereo = mode.name == "FMS" and rx_opts.get("stereo", True)
    sam = mode.name == "SAM"
    tag = tag or (f"phase13 slice {entry}" if entry else
                  "phase8 WFM slice" if fm else "phase3 slice")
    use_rds = bool(rx_opts.get("rds"))
    c, n = SLICE["channels"], SLICE["frames"]
    dispatches = SLICE["dispatches"]
    if use_rds:            # RDS needs whole symbols per block: N = 32768
        c, n = RDS_SLICE["channels"], RDS_SLICE["frames"]
        dispatches = (RDS_SLICE["blocks"],)
    n = frames or n
    if entry == "folded":
        c = 2
    opts = (dict(enable_noise_blanker=True, enable_iq_balance=True)
            if entry == "nb1_iq" else {})
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=c, mode=mode, agc_stride=16,
                                  **opts, **rx_opts)
    rx_cpu = receiver.Receiver(cfg, "cpu")
    rx_gpu = receiver.Receiver(cfg, "cuda")
    ctcss = rx_cpu.ctcss_cfg
    loop = runs_loop(rx_cpu)
    rng = np.random.default_rng(5 if fm else 2)
    params_c = rx_cpu.default_params(250_000.0)
    params_g = rx_gpu.default_params(250_000.0)
    if entry == "nb1_iq":
        for name, v in zip(("iq_gain", "iq_phase"), IQ):
            params_c = dataclasses.replace(params_c, **{name: torch.tensor(v)})
            params_g = dataclasses.replace(
                params_g, **{name: torch.tensor(v, device="cuda")})

    t0 = [0.0]

    def plane(rows):
        if fm:
            x = wfm_plane(c, rows, rng, 1e-2, t0=t0[0], program=(
                "rds" if use_rds else "left" if stereo else "mono"))
        elif mode.name == "FMN":
            x = nfm_plane(c, rows, rng, 1e-2, t0=t0[0],
                          tones=(CTCSS_TONE, CTCSS_TONE, CTCSS_NEIGHBOUR,
                                 CTCSS_NEIGHBOUR))
        else:
            x = am_plane(c, rows, rng, 1e-2)
        t0[0] += rows / FS
        if imbalance:
            x = imbalanced(x)
        return impulsive(x, n) if entry in ("nb1_iq", "staged_nb1") else x

    def entry_plane(x):
        if entry == "i16":
            return to_i16(x, 16384.0)
        if entry == "folded":
            return front.fold_plane_np(x, 3)
        return x

    # a warm-up on the CPU (one block; CTCSS_WARM dispatches with a CTCSS
    # tone), carried to both, so no compared dispatch starts from the zero
    # state's filter leading edge
    st_c = rx_cpu.init_state()
    for k in (CTCSS_WARM if ctcss else (warm,)):
        st_c, _ = rx_cpu.step_many(st_c, params_c,
                                   torch.from_numpy(plane(k * n)))
    st_g = convert.state_from_numpy(rx_gpu, convert.state_to_numpy(st_c))
    if ctcss:
        twin = receiver.Receiver(dataclasses.replace(cfg, ctcss_tone=None),
                                 "cpu")
        # the twin's state: all but the CTCSS leaves (the last field)
        st_t = convert.state_from_numpy(twin,
                                        convert.state_to_numpy(st_c)[:-2])
    k1_launches = 0
    for k in dispatches:
        x = torch.from_numpy(entry_plane(plane(k * n)))
        if entry == "nb1_iq":
            _, z = front.dc_iq_reference(rx_cpu.front, x, st_c.dc,
                                         params_c.iq_gain, params_c.iq_phase)
            assert_margin(front.nb_flags(z, rx_cpu.nb_params, *st_c.nb),
                          rx_cpu.nb_params, tag)
        if entry == "staged_nb1":
            assert_margin(staged_nb_levels(torch, rx_cpu, st_c, x),
                          rx_cpu.nb_params, tag)
        if ctcss:
            st_t, out_t = twin.step_many(st_t, params_c, x)
            r = ctcss_ratios(torch, goertzel, ctcss, st_c.ctcss,
                             out_t["audio"])
            near = int(((r > 0.5) & (r < 8.0)).sum())
            log(f"{tag} K={k}: CTCSS power ratio per block and channel "
                f"{r.min():.3g}..{r.max():.3g}, {near} within (0.5, 8) of "
                f"the decision's {ctcss.nb_ratio:g}")
            if near:
                raise RuntimeError(f"{tag}: CTCSS ratio too near the "
                                   f"threshold")
        st_c, out_c = rx_cpu.step_many(st_c, params_c, x)
        reset_launches(front, wfm_tail)
        st_g, out_g = rx_gpu.step_many(st_g, params_g, x.cuda())
        torch.cuda.synchronize()
        from pebblesdr_tpu_torch.ops import pll
        launches = (front.fused_front.launches, wfm_tail.wfm_tail.launches,
                    front.chunk_means.launches, pll.pll_scan.launches,
                    scanops.auto_iq_balance.launches)
        k1_launches += launches[0]
        fused = 0 if rx_gpu.staged else 1
        if launches != (fused, 1 if stereo else 0, fused, 1 if loop else 0,
                        int(cfg.enable_iq_balance == "auto")):
            raise RuntimeError(f"{tag}: launches (K1, K2, front_means, "
                               f"pll_scan, iq_lms_scan) = {launches}")
        d_audio = float((out_g["audio"].cpu() - out_c["audio"]).abs().max())
        d_db = {key: float((out_g[key].cpu() - out_c[key]).abs().max())
                for key in ("spectrum", "zoomed")}
        d_db["snr"] = float((out_g["smeter"]["snr_db"].cpu()
                             - out_c["smeter"]["snr_db"]).abs().max())
        same = {key: bool((out_g[key].cpu() == out_c[key]).all())
                for key in ("squelch_open", "pilot_locked", "rds_timing",
                            "ctcss_open")
                if key in out_c}
        if use_rds:
            scale = float(out_c["rds_soft"].abs().max())
            d_soft = float((out_g["rds_soft"].cpu()
                            - out_c["rds_soft"]).abs().max()) / scale
            same["rds_soft"] = d_soft <= SOFT_RTOL and scale > 0.0
            log(f"{tag} K={k}: rds_soft {tuple(out_g['rds_soft'].shape)} "
                f"relative {d_soft:.3g} (<= {SOFT_RTOL}) of scale "
                f"{scale:.4g}, rds_timing equal {same['rds_timing']}")
        if ctcss:
            opened = out_c["ctcss_open"]
            same["ctcss_tone_channels"] = bool(
                opened[:, :c // 2].all() and not opened[:, c // 2:].any())
        if rx_opts.get("enable_anf"):
            w = float(st_g.anf.weights.abs().max())
            same["anf_adapted"] = w > 1e-3
            log(f"{tag} K={k}: ANF max |w| {w:.4g} (> 1e-3)")
        d_state = 0.0
        for a, b in zip(convert.state_to_numpy(st_g),
                        convert.state_to_numpy(st_c)):
            if a.size:
                d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
                if sam or loop:             # phases compared modulo 2 pi
                    d = np.minimum(d, np.abs(d - 2 * np.pi))
                d_state = max(d_state, float(d.max()))
        audio_tol = (2e-3 * max(float(out_c["audio"].abs().max()), 1e-6)
                     if sam else 2e-4)
        log(f"{tag} K={k}: audio {d_audio:.3g} (<= {audio_tol:.3g}) of "
            f"scale {float(out_c['audio'].abs().max()):.3g}, dB "
            + " ".join(f"{kk}={v:.3g}" for kk, v in d_db.items())
            + f" (<= 0.1), equal {same}, state {d_state:.3g} (<= 1e-4)")
        if not (d_audio <= audio_tol and max(d_db.values()) <= 0.1
                and all(same.values()) and d_state <= 1e-4):
            raise RuntimeError(f"{tag}: card disagrees with the CPU at K={k}")
    log(f"{tag.split()[0]} ok: card slice == CPU slice"
        + (f" ({entry})" if entry else ""))
    return k1_launches


def imbalanced(plane: np.ndarray) -> np.ndarray:
    """A packed plane through a mismatched IQ path (tests/test_chain.py:
    204-236): I gain 1.06, 0.08 of I leaked into Q."""
    c = plane.shape[1] // 2
    i = plane[:, :c].copy()
    plane[:, :c] = 1.06 * i
    plane[:, c:] += 0.08 * i
    return plane


def staged_nb_levels(torch, rx, st, x):
    """The staged blanker's |x|^2 and the average each sample is tested
    against (ops/scanops.py noise_blanker_chunked), from the CPU receiver's
    state st and its packed input x, after the DC blocker and the IQ
    balance it runs first."""
    import types
    from pebblesdr_tpu_torch.ops import front, iir, scanops
    z = rx._complex_input(x)
    if rx.cfg.enable_dc_removal:
        _, z = (iir.dc_removal_apply(st.dc, z)
                if rx.cfg.frames_per_buffer % front.DC_CHUNK
                else iir.dc_removal_chunked(st.dc, z, alpha=0.9999))
    if rx.cfg.enable_iq_balance == "auto":
        _, z = scanops.auto_iq_balance(st.iqbal, z)
    mag2 = z.real * z.real + z.imag * z.imag
    c, chunk = mag2.shape[0], 512
    means = mag2.reshape(c, -1, chunk).mean(dim=-1)
    lmat, seed = iir.ewma_tables(means.shape[1], (1.0 - rx.nb_params[2])
                                 ** chunk, means.device)
    avgs = means @ lmat.T + seed[None] * st.nb.mag_avg[:, None]
    avg_in = torch.cat([st.nb.mag_avg[:, None], avgs[:, :-1]], dim=1)
    return types.SimpleNamespace(
        mag2=mag2, avg=torch.repeat_interleave(avg_in, chunk, dim=1))


def assert_margin(fl, nb, tag: str) -> None:
    """The blanker's spike test is a comparison: fail unless no sample's
    ratio mag2 / (thr^2 max(avg, 1e-18)) lies in [0.999, 1.001]."""
    ratio = fl.mag2 / (float(np.float32(nb[0] ** 2)) * fl.avg.clamp(min=1e-18))
    near = int(((ratio >= 0.999) & (ratio <= 1.001)).sum())
    if near:
        raise RuntimeError(f"{tag}: {near} samples within 0.1 % of the "
                           f"blanker's threshold")


def make_cell(torch, receiver, front, mode, name: str, channels: int,
              blocks: int, entry: str = "f32", opts: dict | None = None,
              tone: tuple | None = None, plane=None,
              checks: dict | None = None, frames: int | None = None):
    """One timed cell: a receiver on the card and its dispatch plane (one
    bench signal block repeated, as float32, int16 or folded by 4).  tone =
    (offset Hz, amplitude, audio Hz, audio amplitude): the block is that
    tone above the 250 kHz carrier instead, and the cell's audio is held to
    that frequency and amplitude (within 10 %).  plane: a function
    (channels, rows) giving the whole dispatch's plane instead (a signal
    whose period is not a block).  checks: "snr_band" (lo, hi) Hz of the
    tone SNR's residual, "snr" False to print the SNR unchecked, "ctcss"
    True to require ctcss_open on every channel, "anf" True to require
    the ANF's max |w| > 1e-3.  frames: the block length (default the
    headline's)."""
    n = frames or HEADLINE["frames"]
    opts = opts or {}
    wfm = mode.name == "FMS" and opts.get("stereo", True)   # stereo
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=channels, mode=mode,
                                  agc_stride=HEADLINE["agc_stride"], **opts)
    rx = receiver.Receiver(cfg, "cuda")
    fm = mode.name in ("FMS", "FMM")
    if plane is not None:
        iq = torch.from_numpy(plane(channels, blocks * n)).cuda()
    else:
        block = (tone_plane(channels, n, *tone[:2]) if tone else
                 (wfm_plane if fm else am_plane)(channels, n, None))
        if entry == "i16":
            block = to_i16(block)
        if entry == "fold4":       # bench.py:130-146: G blocks side by side
            iq = torch.from_numpy(front.fold_plane_np(np.tile(block, (4, 1)),
                                                      4))
            iq = iq.cuda().repeat(blocks // 4, 1).contiguous()
        else:
            iq = torch.from_numpy(block).cuda().repeat(blocks, 1).contiguous()
    return {"name": name, "rx": rx, "cfg": cfg, "wfm": wfm, "tone": tone,
            "params": rx.default_params(250_000.0), "iq": iq,
            "blocks": blocks, "channels": channels, "state": rx.init_state(),
            "out": None, "i": 0, "launches": [0, 0, 0, 0, 0, 0, 0],
            "windows": [], "checks": checks or {}, "frames": n}


def time_cells(torch, front, wfm_tail, cells: list, tag: str) -> None:
    """Warm each cell up, then time WINDOWS windows of each, interleaved
    (cell A, cell B, cell A, ...), counting each cell's kernel launches and
    checking its last dispatch's audio.  Spectra every cell["spectra_every"]-
    th dispatch (SPECTRA_EVERY unless the cell says)."""
    def dispatch(cell):
        i = cell["i"]
        every = cell.get("spectra_every", SPECTRA_EVERY)
        cell["state"], cell["out"] = cell["rx"].step_many(
            cell["state"], cell["params"], cell["iq"],
            spectra=(i % every == 0))
        cell["i"] = i + 1

    from pebblesdr_tpu_torch.ops import pll, scanops

    def counted(cell, fn):
        reset_launches(front, wfm_tail)
        fn()
        torch.cuda.synchronize()
        cell["launches"][0] += front.fused_front.launches
        cell["launches"][1] += wfm_tail.wfm_tail.launches
        cell["launches"][2] += front.chunk_means.launches
        cell["launches"][3] += front.dc_scan.launches
        cell["launches"][4] += front.fused_front.comp_launches
        cell["launches"][5] += pll.pll_scan.launches
        cell["launches"][6] += scanops.auto_iq_balance.launches

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cell in cells:
        counted(cell, lambda: [dispatch(cell) for _ in range(WARMUP)])
    for _ in range(WINDOWS):
        for cell in cells:
            counted(cell, lambda: cell["windows"].append(
                time_cuda(torch, lambda: dispatch(cell), WINDOW_DISPATCHES)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for cell in cells:
        c, k, wfm = cell["channels"], cell["blocks"], cell["wfm"]
        n = cell["frames"]
        n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
        launches = tuple(cell["launches"])
        scans = 2 if cell["cfg"].enable_noise_blanker else 1
        loop = runs_loop(cell["rx"])
        fused = 0 if cell["rx"].staged else n_dispatch
        auto = cell["cfg"].enable_iq_balance == "auto"
        if launches != (fused, n_dispatch if wfm else 0, fused,
                        scans * fused,
                        n_dispatch if wfm and cell["cfg"].wfm_hq else 0,
                        n_dispatch if loop else 0,
                        n_dispatch if auto else 0):
            raise RuntimeError(f"{tag} {cell['name']}: launches (K1, K2, "
                               f"front_means, front_dc_scan, front_comp, "
                               f"pll_scan, iq_lms_scan) {launches} for "
                               f"{n_dispatch} dispatches")
        windows = cell["windows"]
        best = min(windows)                               # ms per dispatch
        cell.update(block_ms=best / k, msps=c * n * k / (best / 1e3) / 1e6,
                    realtime=n * k / (best / 1e3) / FS, peak_gib=peak)
        log(f"{tag} {cell['name']} {c}ch x {n} x {k}: dispatch ms per "
            f"window " + " ".join(f"{w:.4f}" for w in windows)
            + f"; block {cell['block_ms']:.5f} ms, {cell['msps']:.1f} Msps "
            f"per GPU, {cell['realtime']:.1f}x realtime per channel, window "
            f"spread {max(windows) / best:.3f}; K1 launches {launches[0]}, "
            f"K2 launches {launches[1]}, front_means launches {launches[2]}, "
            f"front_dc_scan launches {launches[3]}, front_comp launches "
            f"{launches[4]}, pll_scan launches {launches[5]}, iq_lms_scan "
            f"launches {launches[6]} for {n_dispatch} dispatches "
            f"({launches[0] / n_dispatch:g} K1 per dispatch); peak device "
            f"memory {peak:.3f} GiB" + (" (cells timed together)"
                                        if len(cells) > 1 else ""))
        out = cell["out"]
        audio = out["audio"]
        # WFM: left and right, 64 kHz blocks of n/32 resampled to 48 kHz
        shape = (k, c, 2, n * 3 // 128) if wfm else (k, c, cell["rx"].audio_blk)
        if not bool(torch.isfinite(audio).all()):
            raise RuntimeError(f"{tag} {cell['name']}: audio is not finite")
        if tuple(audio.shape) != shape:
            raise RuntimeError(f"{tag} {cell['name']}: audio shape "
                               f"{tuple(audio.shape)}")
        if not bool(out["squelch_open"].all()):
            raise RuntimeError(f"{tag} {cell['name']}: squelch closed")
        if wfm and not bool(out["pilot_locked"].all()):
            raise RuntimeError(f"{tag} {cell['name']}: pilot not locked")
        if "rds_soft" in out:
            soft, n_sym = out["rds_soft"], cell["rx"].rds_cfg.n_sym
            if (tuple(soft.shape) != (k, c, n_sym)
                    or not bool(torch.isfinite(soft).all())
                    or tuple(out["rds_timing"].shape) != (k, c)):
                raise RuntimeError(f"{tag} {cell['name']}: RDS outputs "
                                   f"{tuple(soft.shape)}")
            log(f"{tag} {cell['name']} rds_soft {tuple(soft.shape)} finite, "
                f"{n_sym} symbols per block per channel")
        checks = cell["checks"]
        if checks.get("ctcss"):
            opened = out["ctcss_open"]
            log(f"{tag} {cell['name']} ctcss_open on {int(opened.sum())} of "
                f"{opened.numel()} blocks x channels of the last dispatch")
            if not bool(opened.all()):
                raise RuntimeError(f"{tag} {cell['name']}: the CTCSS "
                                   f"squelch is closed")
        if checks.get("anf"):
            w = float(cell["state"].anf.weights.abs().max())
            log(f"{tag} {cell['name']} ANF max |w| {w:.4g} (> 1e-3)")
            if not w > 1e-3:
                raise RuntimeError(f"{tag} {cell['name']}: the ANF did not "
                                   f"adapt")
        tone = audio[:, 0, 0, :] if wfm else audio[:, 0, :]  # WFM: L channel
        tone = tone.reshape(-1).double().cpu().numpy()
        f0, want = (cell["tone"][2:] if cell["tone"] else (1000.0, None))
        band = checks.get("snr_band", (100.0, None))
        snr = tone_snr_db(tone, cell["cfg"].audio_rate, f0, band)
        amp = tone_amplitude(tone, cell["cfg"].audio_rate, f0)
        check_snr = checks.get("snr", True)
        log(f"{tag} {cell['name']} {f0:g} Hz tone SNR {snr:.2f} dB "
            + (f"(>= {TONE_SNR_DB}) " if check_snr else "(not checked) ")
            + f"over {band[0]:g}-{band[1] or cell['cfg'].audio_rate / 2:g} "
            f"Hz, amplitude {amp:.5f}"
            + (f" (want {want:.5f} within 10 %)" if want else "")
            + f", S-meter SNR {float(out['smeter']['snr_db'][-1, 0]):.2f} dB")
        cell["snr_db"] = snr
        if check_snr and not snr >= TONE_SNR_DB:
            raise RuntimeError(f"{tag} {cell['name']}: tone SNR below its "
                               f"bound")
        if want and not abs(amp - want) <= 0.1 * want:
            raise RuntimeError(f"{tag} {cell['name']}: tone amplitude "
                               f"{amp:.5f}, want {want:.5f}")


def phase_headline(torch, receiver, front, wfm_tail, mode) -> dict:
    """Phases 4 (AM) and 9 (FMS): the headline run, timed, with its launch
    counts and a check of the audio."""
    wfm = mode.name == "FMS"
    cell = make_cell(torch, receiver, front, mode,
                     "wfm_64ch" if wfm else "am_64ch", HEADLINE["channels"],
                     HEADLINE["blocks"])
    time_cells(torch, front, wfm_tail, [cell], "phase9" if wfm else "phase4")
    return {"launches": tuple(cell["launches"]), "block_ms": cell["block_ms"],
            "msps": cell["msps"]}


def time_turns(torch, fns: dict, reps: int = 10) -> tuple[dict, dict]:
    """(mean ms per call of each of fns, the runs), timed in turns: the
    names in order, then in reverse (plain, kernel, library, library,
    kernel, plain)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(time_cuda(torch, fns[name], reps))
    return {name: float(np.mean(v)) for name, v in runs.items()}, runs


def time_pair(torch, kernel, plain, reps: int = 10):
    """(kernel ms, plain ms, runs) in the order plain, kernel, kernel, plain."""
    t, runs = time_turns(torch, {"plain": plain, "kernel": kernel}, reps)
    return t["kernel"], t["plain"], runs


def phase_front_time(torch, front, fr) -> dict:
    """Phase 5: K1 vs its plain version at the headline shape."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    plan = fr["plan"]
    x = torch.from_numpy(am_plane(c, n, None)).cuda().repeat(k, 1).contiguous()
    zeros = dict(dtype=torch.float32, device="cuda")
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            fr["f_hi"], fr["f_lo"], torch.zeros(plan.d_rows, 2 * c, **zeros))
    ms, plain_ms, t = time_pair(
        torch, lambda: front.fused_front(plan, *args, n_block=n, raw_rows=2048),
        lambda: front.fused_front_reference(plan, *args, n_block=n,
                                            raw_rows=2048))
    log(f"phase5 K1 {ms:.4f} ms vs plain {plain_ms:.4f} ms per headline "
        f"dispatch (runs kernel {t['kernel']}, plain {t['plain']})")
    return {"ms": ms, "plain_ms": plain_ms}


def phase_front_wfm(torch, front, decimator) -> dict:
    """Phase 6: K1 in its WFM form vs plain, WFM headline shape."""
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    plan_d = decimator.build_plan(FS, 200_000.0)
    plan = front.FrontPlan.make(decimator.compose_response(plan_d),
                                plan_d.factor, "cuda")
    f_hi, f_lo = (torch.full((c,), float(v), device="cuda")
                  for v in split_freq(250_000.0, FS))
    gain = float(plan_d.rate_out) / (2 * np.pi * 75_000.0)
    zt = min(n // plan.factor, 2048)             # the receiver's zoom_bins
    rng = np.random.default_rng(3)
    zeros = dict(dtype=torch.float32, device="cuda")
    st_k = st_r = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                   torch.zeros(plan.d_rows, 2 * c, **zeros),
                   torch.zeros(1, 2 * c, **zeros))
    kw = dict(n_block=n, raw_rows=2048, disc_gain=gain, y_tail_rows=zt)
    worst, disc_err, max_abs = 0.0, 0.0, 0.0
    for call in range(2):
        x = torch.from_numpy(wfm_plane(c, k * n, rng, noise=0.02)
                             + 0.05 * (call + 1)).cuda()
        out_k = front.fused_front(plan, x, st_k[0], st_k[1], f_hi, f_lo,
                                  st_k[2], disc_last=st_k[3], **kw)
        out_r = front.fused_front_reference(plan, x, st_r[0], st_r[1], f_hi,
                                            f_lo, st_r[2], disc_last=st_r[3],
                                            **kw)
        torch.cuda.synchronize()
        if tuple(out_k[0].shape) != (k, zt, 2 * c):
            raise RuntimeError(f"K1 y-tail shape {tuple(out_k[0].shape)}")
        names = ("y_tail", "dc", "tail", "phase", "raw", "disc", "dlast")
        errs = {nm: rel_err(a, b) for nm, a, b in zip(names, out_k, out_r)
                if nm != "disc"}
        errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
        d_err = float((out_k[5] - out_r[5]).abs().max())
        first_equal = bool(torch.equal(out_k[5][0], out_r[5][0]))
        worst = max(worst, max(errs.values()))
        disc_err = max(disc_err, d_err)
        max_abs = max([max_abs] + [float((a - b).abs().max())
                                   for a, b in zip(out_k, out_r)])
        log(f"phase6 K1 WFM call {call}: relative max errors "
            + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
            + f"; disc abs {d_err:.3g}"
            + (f"; first disc row (zero seed) equal {first_equal}"
               if call == 0 else ""))
        if call == 0 and not first_equal:
            raise RuntimeError("K1's first discriminator row (zero seed) "
                               "differs from the plain version")
        st_k = (out_k[1], out_k[3], out_k[2], out_k[6])
        st_r = (out_r[1], out_r[3], out_r[2], out_r[6])
    if not (worst <= FRONT_RTOL and disc_err <= DISC_ATOL):
        raise RuntimeError(f"K1 (WFM) disagrees with its plain version: "
                           f"{worst:.3g} > {FRONT_RTOL} or disc {disc_err:.3g} "
                           f"> {DISC_ATOL}")
    log(f"phase6 ok: K1 WFM == plain within {FRONT_RTOL} relative (worst "
        f"{worst:.3g}), disc within {DISC_ATOL} (worst {disc_err:.3g})")
    return {"plan": plan, "f_hi": f_hi, "f_lo": f_lo, "gain": gain, "zt": zt,
            "max_abs_err": max_abs}


def tail_inputs(torch, c: int, n: int, ell: int, rng):
    """A composite-like raw plane and pilot parameters on the card."""
    raw = rng.standard_normal((n, c)).astype(np.float32) * 0.5
    p0 = rng.uniform(0.0, 10.0, (n // ell, c)).astype(np.float32)
    wf = (2 * np.pi * 19000.0 / 256000.0
          + 1e-4 * rng.standard_normal((n // ell, c))).astype(np.float32)
    return [torch.from_numpy(v).cuda() for v in (raw, p0, wf)]


def phase_tail(torch, wfm_mod, wfm_tail) -> dict:
    """Phase 7: K2 vs plain at the WFM headline shape."""
    c = HEADLINE["channels"]
    n = HEADLINE["blocks"] * HEADLINE["frames"] // 8      # composite rows
    cfg = wfm_mod.WFMConfig.make(256_000.0)
    plan = wfm_tail.TailPlan.make(cfg.audio_taps, cfg.audio_decim, 256, 2048,
                                  "cuda")
    rng = np.random.default_rng(4)
    hist_k = hist_r = torch.zeros(plan.d_rows, 2 * c, device="cuda")
    worst, max_abs = 0.0, 0.0
    for call in range(2):
        args = tail_inputs(torch, c, n, plan.ell, rng)
        out_k = wfm_tail.wfm_tail(plan, *args, hist_k)
        out_r = wfm_tail.wfm_tail_reference(plan, *args, hist_r)
        torch.cuda.synchronize()
        errs = {nm: rel_err(a, b) for nm, a, b in
                zip(("audio", "hist"), out_k, out_r)}
        worst = max(worst, max(errs.values()))
        max_abs = max(max_abs, float((out_k[0] - out_r[0]).abs().max()))
        log(f"phase7 K2 call {call}: relative max errors "
            + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items()))
        hist_k, hist_r = out_k[1], out_r[1]
    if not worst <= FRONT_RTOL:
        raise RuntimeError(f"K2 disagrees with its plain version: {worst:.3g} "
                           f"> {FRONT_RTOL}")
    log(f"phase7 ok: K2 == plain within {FRONT_RTOL} (worst {worst:.3g}, max "
        f"abs audio error {max_abs:.3g})")
    return {"plan": plan, "max_abs_err": max_abs}


def phase_separation(torch, receiver, DemodMode, hq: bool = False) -> float:
    """Phases 10 and 20 (hq): stereo separation (bench.py:318-341) on the
    card, C=1, 20 blocks of 32768 in two dispatches, measured on the second
    half."""
    n, kb = HEADLINE["frames"], 20
    tag, floor = ("phase20", HQ_SEPARATION_DB) if hq else ("phase10",
                                                           SEPARATION_DB)
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=1, mode=DemodMode.FMS, wfm_hq=hq)
    rx = receiver.Receiver(cfg, "cuda")
    params = rx.default_params(250_000.0)
    x = torch.from_numpy(wfm_plane(1, kb * n, None, program="left")).cuda()
    st, outs = rx.init_state(), []
    for i in range(2):
        st, out = rx.step_many(st, params, x[i * 10 * n:(i + 1) * 10 * n],
                               spectra=False)
        outs.append(out["audio"][:, 0])                   # [K, 2, M]
    aud = torch.cat(outs).permute(1, 0, 2).reshape(2, -1).double().cpu().numpy()
    half = aud.shape[-1] // 2
    t = np.arange(aud.shape[-1] - half) / cfg.audio_rate
    basis = np.stack([np.sin(2 * np.pi * 700.0 * t),
                      np.cos(2 * np.pi * 700.0 * t), np.ones_like(t)], 1)
    amp = [float(np.hypot(*np.linalg.lstsq(basis, a[half:], rcond=None)[0][:2]))
           for a in aud]
    sep = 20 * np.log10(amp[0] / max(amp[1], 1e-12))
    log(f"{tag} stereo separation{' (hq)' if hq else ''} {sep:.2f} dB "
        f"(>= {floor}; L {amp[0]:.5f}, R {amp[1]:.3g})")
    if not sep >= floor:
        raise RuntimeError(f"{tag}: stereo separation below its bound")
    return sep


def phase_wfm_time(torch, front, wfm_tail, fw, tl) -> dict:
    """Phase 11: K1 (WFM form) and K2 vs their plain versions, headline
    shapes."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    plan = fw["plan"]
    x = torch.from_numpy(wfm_plane(c, n, None)).cuda().repeat(k, 1).contiguous()
    zeros = dict(dtype=torch.float32, device="cuda")
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            fw["f_hi"], fw["f_lo"], torch.zeros(plan.d_rows, 2 * c, **zeros))
    kw = dict(n_block=n, raw_rows=2048, disc_gain=fw["gain"],
              disc_last=torch.zeros(1, 2 * c, **zeros), y_tail_rows=fw["zt"])
    k1 = time_pair(torch, lambda: front.fused_front(plan, *args, **kw),
                   lambda: front.fused_front_reference(plan, *args, **kw))
    tplan = tl["plan"]
    targs = tail_inputs(torch, c, k * n // plan.factor, tplan.ell,
                        np.random.default_rng(8))
    hist = torch.zeros(tplan.d_rows, 2 * c, **zeros)
    k2 = time_pair(torch, lambda: wfm_tail.wfm_tail(tplan, *targs, hist),
                   lambda: wfm_tail.wfm_tail_reference(tplan, *targs, hist))
    reps = 10
    k2_launch = kernel_times(torch, lambda: wfm_tail.wfm_tail(tplan, *targs,
                                                              hist), reps)
    if [n for _, n in k2_launch.values()] != [reps]:
        raise RuntimeError(f"phase11: K2 must be one CUDA launch per call, "
                           f"recorded {breakdown_text(k2_launch)} over "
                           f"{reps} calls")
    log(f"phase11 K1 WFM {k1[0]:.4f} ms vs plain {k1[1]:.4f} ms (runs "
        f"{k1[2]}); K2 {k2[0]:.4f} ms vs plain {k2[1]:.4f} ms (runs {k2[2]}) "
        f"per headline dispatch; K2 per launch "
        f"{breakdown_text(k2_launch)}, one launch per call")
    return {"k1": k1[:2], "k2": k2[:2]}


def phase_front_options(torch, front, fr, fw) -> dict:
    """Phase 12: K1 with its front options vs plain at the am_nb_64ch shape,
    then NB1 in the WFM form; impulsive inputs, margin asserted first."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    iq = tuple(torch.tensor(v, device="cuda") for v in IQ)
    rng = np.random.default_rng(12)
    zeros = dict(dtype=torch.float32, device="cuda")
    res = {"mismatches": 0, "worst": 0.0}
    forms = (("f32+IQ+NB1", NB1, False, False), ("f32+IQ+NB2", NB2, False, False),
             ("int16+IQ+NB1", NB1, True, False), ("WFM+NB1", NB1, False, True))
    for form, nb, i16, wfm in forms:
        f = fw if wfm else fr
        plan = f["plan"]
        kw = dict(n_block=n, raw_rows=2048, nb=nb)
        if wfm:
            kw.update(disc_gain=f["gain"], y_tail_rows=f["zt"])
        else:
            kw.update(iq_gain=iq[0], iq_phase=iq[1])
        st_k = st_r = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                       torch.zeros(plan.d_rows, 2 * c, **zeros),
                       torch.zeros(1, 2 * c, **zeros),
                       torch.zeros(16, 2 * c, **zeros),
                       torch.zeros(1, 2 * c, **zeros))
        for call in range(2):
            x = (wfm_plane(c, k * n, rng, noise=0.02) if wfm
                 else am_plane(c, k * n, rng, noise=0.01) + 0.05 * (call + 1))
            x = impulsive(x, n)
            x = torch.from_numpy(to_i16(x, 2048.0) if i16 else x).cuda()
            _, z = front.dc_iq_reference(plan, front.dequantize(x), st_r[0],
                                         kw.get("iq_gain"), kw.get("iq_phase"))
            assert_margin(front.nb_flags(z, nb, st_r[3], st_r[4]), nb,
                          f"phase12 {form}")
            del z
            outs, masks = [], []
            for st, fn in ((st_k, front.fused_front),
                           (st_r, front.fused_front_reference)):
                masks.append(torch.zeros(k * n, 2 * c, dtype=torch.uint8,
                                         device="cuda"))
                outs.append(fn(plan, x, st[0], st[1], f["f_hi"], f["f_lo"],
                               st[2], nb_avg=st[3], nb_tail=st[4],
                               nb_mask=masks[-1],
                               disc_last=st[5] if wfm else None, **kw))
            torch.cuda.synchronize()
            out_k, out_r = outs
            names = ("y", "dc", "tail", "phase", "raw", "nb_avg", "nb_tail",
                     "disc", "dlast")
            errs = {nm: rel_err(a, b) for nm, a, b in zip(names, out_k, out_r)
                    if nm not in ("phase", "disc")}
            errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
            disc_err = (float((out_k[7] - out_r[7]).abs().max()) if wfm
                        else 0.0)
            mism = int((masks[0] != masks[1]).sum())
            tail_mism = int((out_k[6] != out_r[6]).sum())
            blanked = int(masks[1].sum())
            res["worst"] = max(res["worst"], max(errs.values()))
            res["mismatches"] += mism + tail_mism
            log(f"phase12 K1 {form} call {call}: relative max errors "
                + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
                + (f"; disc abs {disc_err:.3g}" if wfm else "")
                + f"; blanked lanes {blanked}, flag mismatches {mism} "
                f"(dilated), {tail_mism} (nb_tail')")
            if not (max(errs.values()) <= FRONT_RTOL and mism == 0
                    and tail_mism == 0 and blanked > 0
                    and disc_err <= DISC_ATOL):
                raise RuntimeError(f"phase12: K1 {form} disagrees with its "
                                   f"plain version")
            nxt = []
            for o, st in ((out_k, st_k), (out_r, st_r)):
                nxt.append((o[1], o[3], o[2], o[5], o[6],
                            o[8] if wfm else st[5]))
            st_k, st_r = nxt
            del outs, masks, out_k, out_r, x
    log(f"phase12 ok: K1's option forms == plain within {FRONT_RTOL} (worst "
        f"{res['worst']:.3g}), flag mismatches {res['mismatches']}")
    return res


def phase_cells(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phase 14: the option cells, am_256ch and am_i16_256ch interleaved;
    and the folded entry's unfold copy on its own."""
    from pebblesdr_tpu_torch.utils import roofline
    done = {}
    for group in (("am_nb_64ch",), ("am_256ch", "am_i16_256ch"),
                  ("am_16ch",)):
        cells = [make_cell(torch, receiver, front, DemodMode.AM, name,
                           *OPTION_CELLS[name]) for name in group]
        time_cells(torch, front, wfm_tail, cells, "phase14")
        for cell in cells:
            done[cell["name"]] = {key: cell[key] for key in (
                "launches", "block_ms", "msps", "realtime", "peak_gib")}
        if group == ("am_16ch",):
            iq = cells[0]["iq"]
            front.unfold_plane(iq, 4)
            ms = time_cuda(torch, lambda: front.unfold_plane(iq, 4), 20)
            nbytes = 2 * iq.numel() * iq.element_size()
            log(f"phase14 am_16ch unfold copy of the {tuple(iq.shape)} "
                f"entry plane: {ms:.4f} ms ({nbytes / 2 ** 30:.3f} GiB read "
                f"and written, {nbytes / (ms / 1e3) / 1e9:.1f} GB/s; bound "
                f"{roofline.bound(nbytes, 0)['bound_ms']:.4f} ms)")
            done["unfold_ms"] = ms
        del cells
        torch.cuda.empty_cache()
    return done


def kernel_times(torch, fn, reps: int = 3) -> dict:
    """{kernel: (device ms per launch, launches recorded)} of each CUDA
    kernel fn launches, over reps calls (torch.profiler, CUDA activity
    only; a count below reps means records were lost)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        m = re.search(r"(front_\w+|wfm_tail_\w+|probe_\w+|recur_\w+)"
                      r"(<[^>]*>)?", ev.key)
        if us and m:
            tot, n = rows.get(m.group(0), (0.0, 0))
            rows[m.group(0)] = (tot + us / 1e3, n + ev.count)
    return {k: (tot / n, n) for k, (tot, n) in rows.items()}


def breakdown_text(times: dict) -> str:
    return ", ".join(f"{k} {ms:.4f} (x{n})" for k, (ms, n) in
                     sorted(times.items(), key=lambda kv: -kv[1][0] * kv[1][1])
                     ) or "none"


def kernel_breakdown(torch, fn, reps: int = 3) -> str:
    """Device time per launch of each CUDA kernel fn launches, with the
    launches the profiler recorded over reps calls (kernel_times)."""
    return breakdown_text(kernel_times(torch, fn, reps))


def fir_launch_ms(times: dict) -> float:
    """front_fir's device ms per launch in kernel_times' result."""
    return next(ms for k, (ms, _) in times.items()
                if k.startswith("front_fir"))


def check_options_form(torch, front, plan, args, kw, tag: str,
                       keep: bool = False) -> dict:
    """One K1 call and one plain call on the same inputs: every output
    within FRONT_RTOL relative (the phase in absolute), and with the
    blanker on, its margin asserted first and no blanked position or
    nb_tail' flag that differs.  keep: also return K1's outputs ("out")."""
    masks = [{}, {}]
    if kw.get("nb"):
        x, dc = args[0], args[1]
        _, z = front.dc_iq_reference(plan, front.dequantize(x), dc,
                                     kw["iq_gain"], kw["iq_phase"])
        assert_margin(front.nb_flags(z, kw["nb"], kw["nb_avg"], kw["nb_tail"]),
                      kw["nb"], tag)
        del z
        masks = [{"nb_mask": torch.zeros(x.shape, dtype=torch.uint8,
                                         device=x.device)} for _ in range(2)]
    out_k = front.fused_front(plan, *args, **kw, **masks[0])
    out_r = front.fused_front_reference(plan, *args, **kw, **masks[1])
    torch.cuda.synchronize()
    names = ("y", "dc", "tail", "phase", "raw", "nb_avg", "nb_tail")
    errs = {nm: rel_err(a, b) for nm, a, b in zip(names, out_k, out_r)
            if nm != "phase"}
    errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
    mism = 0
    if kw.get("nb"):
        mism = (int((masks[0]["nb_mask"] != masks[1]["nb_mask"]).sum())
                + int((out_k[6] != out_r[6]).sum()))
    worst = max(errs.values())
    max_abs = float((out_k[0] - out_r[0]).abs().max())
    log(f"{tag}: relative max errors "
        + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
        + f" (worst {worst:.3g}); max abs y error {max_abs:.3g}"
        + (f"; flag mismatches {mism}" if kw.get("nb") else ""))
    if not (worst <= FRONT_RTOL and mism == 0):
        raise RuntimeError(f"{tag}: K1 disagrees with its plain version")
    return {"worst": worst, "max_abs_err": max_abs,
            **({"out": out_k} if keep else {})}


def phase_options_time(torch, front, fr) -> dict:
    """Phase 15: K1 with the options vs plain at each cell's shape: the base
    form at am_64ch, NB1 + IQ at am_nb_64ch, float32 at am_256ch, int16 at
    am_i16_256ch, float32 at am_16ch (after the unfold); each checked
    against plain once, then timed (runs plain, kernel, kernel, plain),
    with its per-launch device times."""
    from pebblesdr_tpu_torch.utils import roofline
    n = HEADLINE["frames"]
    plan = fr["plan"]
    zeros = dict(dtype=torch.float32, device="cuda")
    iq = tuple(torch.tensor(v, device="cuda") for v in IQ)
    res = {}
    for name, c, k, form in (("am_64ch", 64, 32, "f32"),
                             ("am_nb_64ch", 64, 32, "nb1_iq"),
                             ("am_256ch", 256, 16, "f32"),
                             ("am_i16_256ch", 256, 16, "i16"),
                             ("am_16ch", 16, 64, "f32")):
        i16, nb = form == "i16", form == "nb1_iq"
        block = am_plane(c, n, None)
        x = torch.from_numpy(to_i16(block) if i16 else block).cuda()
        x = x.repeat(k, 1).contiguous()
        f_hi, f_lo = (v[:1].repeat(c).contiguous() for v in (fr["f_hi"],
                                                            fr["f_lo"]))
        args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                f_hi, f_lo, torch.zeros(plan.d_rows, 2 * c, **zeros))
        kw = dict(n_block=n, raw_rows=2048)
        if nb:
            kw.update(iq_gain=iq[0], iq_phase=iq[1], nb=NB1,
                      nb_avg=torch.zeros(1, 2 * c, **zeros),
                      nb_tail=torch.zeros(16, 2 * c, **zeros))
        check = check_options_form(torch, front, plan, args, kw,
                                   f"phase15 K1 {form} at {name}")
        ms, plain_ms, t = time_pair(
            torch, lambda: front.fused_front(plan, *args, **kw),
            lambda: front.fused_front_reference(plan, *args, **kw))
        b = roofline.k1_bound(plan, k * n, c, 2 if i16 else 4, n, 2048,
                              nb=nb, iq=nb)
        lt = kernel_times(torch, lambda: front.fused_front(plan, *args, **kw),
                          reps=10)
        res[name] = {"ms": ms, "plain_ms": plain_ms, **check, **b,
                     "fir_ms": fir_launch_ms(lt)}
        log(f"phase15 K1 {form} at {name}: {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms per dispatch (runs kernel {t['kernel']}, "
            f"plain {t['plain']}); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}); per launch (ms): " + breakdown_text(lt))
        if name == "am_64ch":
            res[name].update(phase_fir_plain(torch, front, plan, args, n))
        del args, x
        torch.cuda.empty_cache()
    return res


def phase_fir_plain(torch, front, plan, args, n: int, kw: dict | None = None,
                    tag: str = "phase15") -> dict:
    """front_fir's plain version on the inputs of a phase 15 (or 25) cell:
    the DC removal from the chunk means, the IQ balance and the blanking
    (with those options in kw), the mix and the composed FIR (ops/front.py
    dc_iq_reference, nb_flags, mix_reference, fir_reference; the chunk
    means and the blanker's averages are front_means' and front_nb_means'
    work and precomputed), timed with CUDA events; and front_fir's bound
    on those inputs."""
    from pebblesdr_tpu_torch.utils import roofline
    x, dc, phase0, f_hi, f_lo, tail = args
    kw = kw or {}
    c = x.shape[1] // 2
    xf = front.dequantize(x)
    means = front.chunk_means_reference(xf)[0]
    iq = (kw.get("iq_gain"), kw.get("iq_phase"))
    flags = None
    if kw.get("nb"):
        _, z = front.dc_iq_reference(plan, xf, dc, *iq, means=means)
        flags = front.nb_flags(z, kw["nb"], kw["nb_avg"], kw["nb_tail"])
        del z

    def plain():
        _, z = front.dc_iq_reference(plan, xf, dc, *iq, means=means)
        u = front.mix_reference(z, phase0, f_hi, f_lo)
        if flags is not None:
            u = torch.where(flags.widened, 0.0, u)
        return front.fir_reference(plan, u, tail)[0]

    t, runs = time_turns(torch, {"plain": plain})
    b = roofline.fir_bound(plan, x.shape[0], c, x.element_size())
    log(f"{tag} front_fir's plain version: {t['plain']:.4f} ms (runs "
        f"{runs['plain']}); front_fir bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    return {"fir_plain_ms": t["plain"], "fir_bound": b}


def phase_front_hq(torch, front, decimator, wfm_mod) -> dict:
    """Phase 16: K1 in its hq form (factor-4 plan, discriminator, y-tails,
    composite decimation by 2) vs plain at the wfm_hq_64ch shape, two
    streaming calls from a random comp_hist; then both timed, with the
    per-launch device times: front_comp must be the only pass that reads y
    (the profiler records no front_disc, 4 CUDA launches per call).  Then
    front_comp's plain version (the discriminator, the decimation by 2,
    comp_hist', dlast and the y-tails from the full-rate y) timed against
    its per-launch time, with its bound."""
    from pebblesdr_tpu_torch.ops import fir
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    from pebblesdr_tpu_torch.utils import roofline
    c, k, _, _ = WFM_CELLS["wfm_hq_64ch"]
    n = HEADLINE["frames"]
    plan_d = decimator.build_plan(FS, 400_000.0)
    plan = front.FrontPlan.make(decimator.compose_response(plan_d),
                                plan_d.factor, "cuda")
    taps = wfm_mod.WFMConfig.make(plan_d.rate_out / 2, comp_decim=2).comp_taps
    hr = front.comp_hist_rows(len(taps))
    f_hi, f_lo = (torch.full((c,), float(v), device="cuda")
                  for v in split_freq(250_000.0, FS))
    gain = float(plan_d.rate_out) / (2 * np.pi * 75_000.0)
    zt = min(n // plan.factor, 2048)
    rng = np.random.default_rng(16)
    zeros = dict(dtype=torch.float32, device="cuda")
    st_k = st_r = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
                   torch.zeros(plan.d_rows, 2 * c, **zeros),
                   torch.zeros(1, 2 * c, **zeros),
                   0.1 * torch.randn(hr, c, **zeros))
    kw = dict(n_block=n, raw_rows=2048, disc_gain=gain, y_tail_rows=zt,
              comp_taps=taps)
    worst, disc_err, hist_err, max_abs = 0.0, 0.0, 0.0, 0.0
    for call in range(2):
        x = torch.from_numpy(wfm_plane(c, k * n, rng, noise=0.02)
                             + 0.05 * (call + 1)).cuda()
        out_k = front.fused_front(plan, x, st_k[0], st_k[1], f_hi, f_lo,
                                  st_k[2], disc_last=st_k[3],
                                  comp_hist=st_k[4], **kw)
        out_r = front.fused_front_reference(plan, x, st_r[0], st_r[1], f_hi,
                                            f_lo, st_r[2], disc_last=st_r[3],
                                            comp_hist=st_r[4], **kw)
        torch.cuda.synchronize()
        shapes = tuple(tuple(o.shape) for o in (out_k[0], out_k[5], out_k[7]))
        if shapes != ((k, zt, 2 * c), (k * n // (2 * plan.factor), c),
                      (hr, c)):
            raise RuntimeError(f"K1e output shapes {shapes}")
        names = ("y_tail", "dc", "tail", "phase", "raw", "disc", "dlast",
                 "comp_hist")
        errs = {nm: rel_err(a, b) for nm, a, b in zip(names, out_k, out_r)
                if nm not in ("phase", "disc", "comp_hist")}
        errs["phase"] = float((out_k[3] - out_r[3]).abs().max())
        d_err = float((out_k[5] - out_r[5]).abs().max())
        h_err = float((out_k[7] - out_r[7]).abs().max())
        worst = max(worst, max(errs.values()))
        disc_err, hist_err = max(disc_err, d_err), max(hist_err, h_err)
        max_abs = max([max_abs] + [float((a - b).abs().max())
                                   for a, b in zip(out_k, out_r)])
        log(f"phase16 K1e call {call}: relative max errors "
            + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
            + f"; half-rate disc abs {d_err:.3g}, comp_hist' abs {h_err:.3g}")
        st_k = (out_k[1], out_k[3], out_k[2], out_k[6], out_k[7])
        st_r = (out_r[1], out_r[3], out_r[2], out_r[6], out_r[7])
        del out_k, out_r, x
    if not (worst <= FRONT_RTOL and disc_err <= DISC_ATOL
            and hist_err <= DISC_ATOL):
        raise RuntimeError(f"K1e disagrees with its plain version: {worst:.3g}"
                           f" > {FRONT_RTOL} or disc {disc_err:.3g} / "
                           f"comp_hist' {hist_err:.3g} > {DISC_ATOL}")
    log(f"phase16 ok: K1e == plain within {FRONT_RTOL} relative (worst "
        f"{worst:.3g}), disc and comp_hist' within {DISC_ATOL} (worst "
        f"{disc_err:.3g}, {hist_err:.3g})")
    x = torch.from_numpy(wfm_plane(c, n, None)).cuda().repeat(k, 1).contiguous()
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            f_hi, f_lo, torch.zeros(plan.d_rows, 2 * c, **zeros))
    kw.update(disc_last=torch.zeros(1, 2 * c, **zeros),
              comp_hist=torch.zeros(hr, c, **zeros))
    ms, plain_ms, t = time_pair(
        torch, lambda: front.fused_front(plan, *args, **kw),
        lambda: front.fused_front_reference(plan, *args, **kw))
    b = roofline.k1_bound(plan, k * n, c, 4, n, 2048, disc=True,
                          y_tail_rows=zt, comp_taps=len(taps))
    reps = 10
    lt = kernel_times(torch, lambda: front.fused_front(plan, *args, **kw),
                      reps=reps)
    log(f"phase16 K1e at wfm_hq_64ch: {ms:.4f} ms vs plain {plain_ms:.4f} ms "
        f"per dispatch (runs kernel {t['kernel']}, plain {t['plain']}); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); per launch (ms): "
        + breakdown_text(lt))
    # four kernels (front_fir writes the carried history), each at most
    # once a call (the profiler may lose a record, never add one),
    # front_comp among them and no front_disc
    if len(lt) != 4 or "front_comp" not in lt or any(
            kk.startswith("front_disc") or cnt > reps
            for kk, (_, cnt) in lt.items()):
        raise RuntimeError(f"phase16: the hq form must launch front_comp and "
                           f"no front_disc, 4 kernels once per call: {lt}")
    # front_comp's plain version, from the full-rate y of the same inputs
    y = front.fused_front_reference(plan, *args, n_block=n, raw_rows=2048)[0]
    dl, ch, mb = kw["disc_last"], kw["comp_hist"], n // plan.factor

    def comp_plain():
        d, dlast = front.discriminate(y, dl, gain)
        tails = y.reshape(k, mb, 2 * c)[:, mb - zt:].contiguous()
        hist = torch.cat([ch, d])[-hr:].contiguous()
        disc = fir.tm_fir_decimate(d, taps, ch[hr - (len(taps) - 1):],
                                   front.COMP_DECIM)[0]
        return disc, dlast, tails, hist

    tp, runs = time_turns(torch, {"plain": comp_plain})
    cb = roofline.comp_bound(y.shape[0], c, len(taps), hr, k, zt)
    comp_ms = lt["front_comp"][0]
    log(f"phase16 front_comp at wfm_hq_64ch: {comp_ms:.4f} ms per launch, "
        f"plain version {tp['plain']:.4f} ms (runs {runs['plain']}); bound "
        f"{cb['bound_ms']:.4f} ms ({cb['bound_by']}), "
        f"{cb['bound_ms'] / comp_ms:.1%} of it; the only pass over y "
        f"(no front_disc, 4 CUDA kernels per K1 call)")
    del args, x, y
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs, **b,
            "comp": {"ms": comp_ms, "plain_ms": tp["plain"],
                     "max_abs_err": max(disc_err, hist_err), **cb}}


def phase_rds_decode(torch, receiver, DemodMode, rds_alg: str = "open",
                     geometries=(False, True), tag: str = "phase19") -> dict:
    """Phase 19: the PS name through the card receiver at C=1, 5 dispatches
    of 8 blocks of 32768 (tests/test_chain_batched.py:299-345), at the
    default and at the hq geometry; the hq run must see no block error
    (tests/test_rds.py:331).  Phase 31 runs it with the scan carrier
    (rds_alg="scan") at the default geometry."""
    from pebblesdr_tpu_torch.demod import rds
    n, n_disp, kb = HEADLINE["frames"], 5, 8
    x = torch.from_numpy(wfm_plane(1, n_disp * kb * n, None,
                                   program="rds")).cuda()
    res = {}
    for hq in geometries:
        cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                      channels=1, mode=DemodMode.FMS,
                                      rds=True, wfm_hq=hq, rds_alg=rds_alg)
        rx = receiver.Receiver(cfg, "cuda")
        st, params = rx.init_state(), rx.default_params(250_000.0)
        dec = rds.RdsBlockDecoder()
        for d in range(n_disp):
            st, out = rx.step_many(st, params, x[d * kb * n:(d + 1) * kb * n],
                                   spectra=False)
            dec.feed_symbols(out["rds_soft"][:, 0].reshape(-1).cpu().numpy())
        grp = rds.RdsGroupDecoder()
        for g in dec.groups:
            grp.decode(g)
        name = "hq" if hq else "default"
        log(f"{tag} RDS decode ({name} geometry, {rds_alg} carrier): synced "
            f"{dec.synced}, "
            f"{len(dec.groups)} groups, {dec.blocks_ok} blocks ok, "
            f"{dec.block_errors} block errors, {dec.bits_corrected} bits "
            f"corrected; PS {grp.ps_name!r}, PI {grp.pi:#06x} "
            f"({grp.callsign})")
        if not (dec.synced and grp.ps_name == "PEBBLES "
                and (dec.block_errors == 0 or not hq)):
            raise RuntimeError(f"{tag}: RDS decode failed ({name}, "
                               f"{rds_alg} carrier)")
        res[name] = {"groups": len(dec.groups),
                     "block_errors": dec.block_errors}
    return res


def dispatch_profile(torch, cell, tag: str, reps: int = 5) -> dict:
    """One cell's dispatches with spectra off (on where the cell computes
    them every dispatch): timed by CUDA events without the profiler, their
    host enqueue time (no sync inside), then under torch.profiler (CUDA
    activity) for the device busy time per dispatch (the union of its
    kernels' intervals).  Idle share = 1 - busy / event-timed ms; with the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    st = [cell["state"]]
    spectra = cell.get("spectra_every", SPECTRA_EVERY) == 1

    def step():
        st[0], _ = cell["rx"].step_many(st[0], cell["params"], cell["iq"],
                                        spectra=spectra)

    step()
    ms = time_cuda(torch, step, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    host = (time.perf_counter() - t0) * 1e3 / reps    # enqueue, no sync
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        spans.append((a, b))
        key = re.sub(r"^void\s+|\(anonymous namespace\)::|at::native::", "",
                     ev.name)
        key = re.sub(r"\(.*", "", key)[:48]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e3 / reps
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy = busy / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = max(0.0, 1.0 - busy / ms)
    log(f"{tag} {cell['name']} profile (spectra {'on' if spectra else 'off'}"
        f"): {ms:.4f} ms per dispatch by "
        f"events, host enqueue {host:.4f} ms, device busy {busy:.4f} ms "
        f"(idle share {idle:.3f}; "
        f"{len(spans) // reps} kernels per dispatch); top (ms): "
        + ", ".join(f"{nm} {t:.4f}" for nm, t in top))
    return {"ms": ms, "host_ms": host, "busy_ms": busy, "idle": idle}


def check_cell_kernels(torch, front, wfm_tail, cell, tag: str) -> None:
    """K1 (its WFM form; at hq with comp_taps from a random comp_hist) and
    K2 against their plain versions once, at a WFM cell's own plans and
    shapes: the receiver's front and tail plans and its dispatch plane
    (unfolded; plus a DC offset, which keeps dc' away from 0), K2 on the
    plain discriminator output with random pilot phases."""
    rx, c, n = cell["rx"], cell["channels"], HEADLINE["frames"]
    x = cell["iq"]
    if x.shape[1] != 2 * c:
        x = front.unfold_plane(x, x.shape[1] // (2 * c))
    x = x + 0.05
    zeros = dict(dtype=torch.float32, device="cuda")
    f_hi, f_lo = cell["params"].tune_hi, cell["params"].tune_lo
    kw = dict(n_block=n, raw_rows=rx.cfg.spectrum_bins,
              disc_gain=rx.disc_gain, disc_last=torch.zeros(1, 2 * c, **zeros),
              y_tail_rows=rx.zoom_bins)
    names = ["y_tail", "dc", "tail", "phase", "raw", "disc", "dlast"]
    if rx.wfm_comp_decim > 1:
        taps = rx.wfm_cfg.comp_taps
        kw.update(comp_taps=taps, comp_hist=0.1 * torch.randn(
            front.comp_hist_rows(len(taps)), c, **zeros))
        names.append("comp_hist")
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros), f_hi,
            f_lo, torch.zeros(rx.front.d_rows, 2 * c, **zeros))
    out_k = front.fused_front(rx.front, *args, **kw)
    out_r = front.fused_front_reference(rx.front, *args, **kw)
    torch.cuda.synchronize()
    absolute = ("phase", "disc", "comp_hist")
    errs = {nm: (float((a - b).abs().max()) if nm in absolute
                 else rel_err(a, b)) for nm, a, b in zip(names, out_k, out_r)}
    plan = rx.wfm_tail
    rows = out_r[5].shape[0]
    _, p0, wf = tail_inputs(torch, c, rows, plan.ell,
                            np.random.default_rng(21))
    hist = torch.zeros(plan.d_rows, 2 * c, **zeros)
    tk = wfm_tail.wfm_tail(plan, out_r[5], p0, wf, hist)
    tr = wfm_tail.wfm_tail_reference(plan, out_r[5], p0, wf, hist)
    torch.cuda.synchronize()
    errs.update(k2_audio=rel_err(tk[0], tr[0]), k2_hist=rel_err(tk[1], tr[1]))
    log(f"{tag} {cell['name']} kernels vs plain at the cell's shapes (K1 "
        f"{tuple(x.shape)}, K2 {tuple(out_r[5].shape)}): "
        + " ".join(f"{kk}={v:.3g}" for kk, v in errs.items())
        + " (phase, disc, comp_hist absolute)")
    bad = [nm for nm, v in errs.items()
           if v > (DISC_ATOL if nm in ("disc", "comp_hist") else FRONT_RTOL)]
    if bad:
        raise RuntimeError(f"{tag} {cell['name']}: {bad} disagree with the "
                           f"plain versions")
    del out_k, out_r, tk, tr, x, args


def phase_wfm_cells(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phase 21: the WFM cells wfm_hq_64ch and wfm_rds_64ch (windows
    interleaved) and wfm_16ch, each with K1 and K2 first held to their
    plain versions at the cell's shapes, and a profile of its dispatches."""
    done = {}
    for group in (("wfm_hq_64ch", "wfm_rds_64ch"), ("wfm_16ch",)):
        cells = [make_cell(torch, receiver, front, DemodMode.FMS, name,
                           *WFM_CELLS[name]) for name in group]
        for cell in cells:
            check_cell_kernels(torch, front, wfm_tail, cell, "phase21")
        torch.cuda.empty_cache()
        time_cells(torch, front, wfm_tail, cells, "phase21")
        for cell in cells:
            prof = dispatch_profile(torch, cell, "phase21")
            done[cell["name"]] = {key: cell[key] for key in (
                "launches", "block_ms", "msps", "realtime", "peak_gib")}
            done[cell["name"]].update(prof)
        del cells
        torch.cuda.empty_cache()
    return done


def phase_probes(torch, front, kprobe, kbench2, receiver, DemodMode) -> dict:
    """Phase 22: the K1 probes of tools/kbench2.py.  At the probe bench's
    default shape (64 channels, 8 blocks of 32768 rows, the AM plan): the
    floors against their plain version exactly (two planes and packed, sub
    2048/4096/8192); each front form (v1, v2, v3, v4, v5 at kt 2 and 4;
    sub 2048 and 4096) over two streaming calls from a random state on a
    plane with a DC offset, y/dc'/tail' within FRONT_RTOL relative, phase'
    equal, and y of the first call within FRONT_RTOL of K1 (fused_front,
    base form) on the same input and state.  Then the bench's full table
    (the main path of this slice, launch counts reset just before it and
    read just after), and each form timed against its plain version with
    its CUDA kernels per call checked (one probe_toeplitz, which also
    writes tail'), the packed floor checked exactly and timed at am_64ch's
    [1,048,576 x 128] shape, and the matmul yardstick of the product."""
    c, n, k = 64, 32768, 8
    t = n * k
    rx = receiver.Receiver(receiver.ReceiverConfig(
        sample_rate=FS, frames_per_buffer=n, channels=c, mode=DemodMode.AM,
        agc_stride=16), "cuda")
    plan, factor = rx.front, rx.front.factor
    f_hi, f_lo = np.full(c, kbench2.F_HI), np.zeros(c)
    hi_t, lo_t = (torch.tensor(v, dtype=torch.float32, device="cuda")
                  for v in (f_hi, f_lo))
    gen = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + offset

    def check_floor(form, planes, subs):
        """The copy floor against its plain version, exactly: the largest
        absolute difference (0.0)."""
        err = 0.0
        for sub in subs:
            got = kprobe.probe_floor(planes, sub, factor)
            ref = kprobe.probe_floor_reference(planes, sub, factor)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"phase22 {form} sub={sub}: the copy floor "
                                   f"differs from its plain version")
            err = max([err] + [float((a - b).abs().max())
                               for a, b in zip(got, ref)])
        log(f"phase22 {form}: probe_floor_copy == plain exactly at sub "
            f"{', '.join(map(str, subs))} ({len(planes)} x "
            f"{tuple(planes[0].shape)})")
        return err

    res = {}
    for form, planes in (("floor", (randn(t, c), randn(t, c))),
                         ("floor128", (randn(t, 2 * c),))):
        res[form] = {"max_abs_err": check_floor(form, planes,
                                                (2048, 4096, 8192))}
        del planes

    xs = [randn(t, 2 * c, scale=0.5, offset=0.2 * (i + 1)) for i in range(2)]
    st0 = (randn(1, 2 * c, scale=0.05), randn(plan.d_rows, 2 * c, scale=0.3),
           torch.rand(c, generator=gen, device="cuda"))
    k1_y = front.fused_front(plan, xs[0], st0[0], st0[2], hi_t, lo_t,
                             st0[1])[0]
    worst, k1_worst = 0.0, 0.0
    for variant, kt in kprobe.FORMS:
        for sub in (2048, 4096):
            _, dc, tail, ph = kprobe.to_layout(variant, xs[0], *st0)
            st_k = st_r = (dc, tail, ph)
            errs, max_abs = {}, 0.0
            for call, x in enumerate(xs):
                xv = kprobe.to_layout(variant, x, *st0)[0]
                got = kprobe.probe_front(variant, plan, xv, st_k[0], st_k[2],
                                         f_hi, f_lo, st_k[1], sub, kt)
                ref = kprobe.probe_front_reference(variant, plan, xv,
                                                   st_r[0], st_r[2], f_hi,
                                                   f_lo, st_r[1], sub, kt)
                torch.cuda.synchronize()
                for nm, a, b in zip(("y", "dc", "tail"), got, ref):
                    errs[nm] = max(errs.get(nm, 0.0), rel_err(a, b))
                if not torch.equal(got[3], ref[3]):
                    raise RuntimeError(f"phase22 {variant} kt={kt} sub={sub}: "
                                       f"phase' differs from plain")
                max_abs = max(max_abs, float((got[0] - ref[0]).abs().max()))
                if call == 0:
                    y = kprobe.from_layout(variant, *got)[0]
                    errs["y_vs_K1"] = rel_err(k1_y, y)
                st_k, st_r = got[1:], ref[1:]
                del got, ref, xv
            log(f"phase22 {variant} kt={kt} sub={sub}: relative max errors "
                + " ".join(f"{nm}={v:.3g}" for nm, v in errs.items())
                + f"; phase' equal; max abs y error {max_abs:.3g}")
            k1_worst = max(k1_worst, errs.pop("y_vs_K1"))
            worst = max(worst, max(errs.values()))
            if sub == 2048:
                res[(variant, kt)] = {"max_abs_err": max_abs}
    if not (worst <= FRONT_RTOL and k1_worst <= FRONT_RTOL):
        raise RuntimeError(f"phase22: a front probe disagrees with its plain "
                           f"version ({worst:.3g}) or with K1 ({k1_worst:.3g})"
                           f" beyond {FRONT_RTOL}")
    log(f"phase22 ok: every front probe's y, dc' and tail' == plain within "
        f"{FRONT_RTOL} (worst "
        f"{worst:.3g}) and == K1's base form (worst {k1_worst:.3g})")
    del xs, k1_y
    torch.cuda.empty_cache()

    # the main path of this slice: the probe bench's full table
    kprobe.probe_floor.launches = kprobe.probe_front.launches = 0
    front.fused_front.launches = 0
    lines = kbench2.main(list(kbench2.NAMES), device="cuda")
    torch.cuda.synchronize()
    totals = (kprobe.probe_floor.launches, kprobe.probe_front.launches,
              front.fused_front.launches)
    summed = tuple(sum(ln["launches"][key] for ln in lines) for key in (
        "probe_floor", "probe_front", "fused_front"))
    if totals != summed or min(totals) == 0:
        raise RuntimeError(f"phase22: launches {totals} (per line {summed})")
    for key in res:
        variant, kt = key if isinstance(key, tuple) else (key, 1)
        res[key]["launches"] = sum(
            ln["launches"]["probe_floor" if variant.startswith("floor")
                           else "probe_front"]
            for ln in lines if ln["variant"] == variant and ln["kt"] == kt)
        if not res[key]["launches"]:
            raise RuntimeError(f"phase22: {key} was not launched by the bench")
    log(f"phase22 bench: {len(lines)} lines; launches probe_floor "
        f"{totals[0]}, probe_front {totals[1]}, fused_front {totals[2]}")

    # each form timed against its plain version at the bench's shape (sub
    # 2048); the packed floor at am_64ch's shape, beside the torch call that
    # moves the same bytes
    zeros = dict(dtype=torch.float32, device="cuda")
    x = randn(t, 2 * c)
    for key in res:
        variant, kt = key if isinstance(key, tuple) else (key, 1)
        if variant == "floor":
            planes = (x[:, :c].contiguous(), x[:, c:].contiguous())
            fns = (lambda: kprobe.probe_floor(planes, 2048, factor),
                   lambda: kprobe.probe_floor_reference(planes, 2048, factor))
            lib = lambda: x.view(-1, factor, 2 * c).sum(1)  # noqa: E731
            lib()
            lib_ms = time_cuda(torch, lib, 10)   # the same bytes, one plane
            b = kprobe.probe_bound("floor", 2048, 1, c, t, factor)
        elif variant == "floor128":
            xa = randn(1_048_576, 2 * c)
            res[key]["max_abs_err"] = max(res[key]["max_abs_err"], check_floor(
                "floor128 at am_64ch's shape", (xa,), (2048,)))
            fns = (lambda: kprobe.probe_floor((xa,), 2048, factor),
                   lambda: kprobe.probe_floor_reference((xa,), 2048, factor))
            lib = lambda: xa.view(-1, factor, 2 * c).sum(1)  # noqa: E731
            lib()
            lib_ms = time_cuda(torch, lib, 10)
            b = kprobe.probe_bound("floor128", 2048, 1, c, xa.shape[0], factor)
        else:
            args = kprobe.to_layout(variant, x,
                                    torch.zeros(1, 2 * c, **zeros),
                                    torch.zeros(plan.d_rows, 2 * c, **zeros),
                                    torch.zeros(c, **zeros))
            fns = tuple(functools.partial(
                fn, variant, plan, args[0], args[1], args[3], f_hi, f_lo,
                args[2], 2048, kt) for fn in (kprobe.probe_front,
                                              kprobe.probe_front_reference))
            b = kprobe.probe_bound(variant, 2048, kt, c, t, factor,
                                   plan.d_rows, plan.h.numel())
            lib_ms = None
            # one probe_toeplitz per call after front_means + front_dc_scan
            # per plane, and no probe_tail (tail' is written by the
            # product); each kernel at most as often as that (the profiler
            # may lose a record, never add one) and none missing
            planes = 2 if variant in kprobe.TWO_PLANE else 1
            reps = 5
            kt_times = kernel_times(torch, fns[0], reps=reps)
            want = {"front_means": planes, "front_dc_scan": planes,
                    "probe_toeplitz": 1}
            got = {kk: sum(n for name, (_, n) in kt_times.items()
                           if name.startswith(kk)) for kk in want}
            if any(not 0 < got[kk] <= want[kk] * reps for kk in want) or any(
                    not name.startswith(tuple(want)) for name in kt_times):
                raise RuntimeError(f"phase22 {variant} kt={kt}: CUDA kernels "
                                   f"per call {breakdown_text(kt_times)}, "
                                   f"expected {want}")
            res[key]["kernels_per_call"] = sum(want.values())
        ms, plain_ms, runs = time_pair(torch, *fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fns[0]()
        host = (time.perf_counter() - t0) * 1e2          # ms per call
        torch.cuda.synchronize()
        res[key].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        shape = ("am_64ch [1048576 x 128]" if variant == "floor128"
                 else f"{k} x {n} rows x {c} ch")
        log(f"phase22 {variant}{f' kt={kt}' if kt > 1 else ''} sub=2048 at "
            f"{shape}: {ms:.4f} ms vs plain {plain_ms:.4f} ms (host enqueue "
            f"{host:.4f} ms; runs kernel "
            f"{runs['kernel']}, plain {runs['plain']})"
            + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
            + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{b['bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s, "
            f"{b['flops'] / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the function, "
            f"{b['product_flops'] / (ms * 1e-3) / 1e12:.2f} of the product"
            + (f", {3 * b['product_flops'] / (ms * 1e-3) / 1e12:.2f} of its "
               f"three TF32 passes" if b["product_flops"] else "")
            + (f", {res[key]['kernels_per_call']} CUDA kernels per call"
               if "kernels_per_call" in res[key] else "")
            + "); per launch (ms): " + kernel_breakdown(torch, fns[0]))
        fns = args = planes = None
    res["yardstick"] = probe_yardstick(torch, kprobe, plan, x, c, t, factor)
    return res


def probe_yardstick(torch, kprobe, plan, x, c: int, t: int,
                    factor: int) -> dict:
    """The Toeplitz product alone at the probe bench's shape, as one batched
    torch.matmul of W^T [64, K] with the mixed input already laid out [t /
    2048 sub-blocks, K, 2c] (a yardstick for probe_toeplitz's product, not
    the same function: no DC, no mix, no tail): at "highest" precision
    (IEEE float32) and with TF32 allowed for this call only."""
    sub, d = 2048, plan.d_rows
    w = kprobe.composed_wt(plan, sub)                    # [64, K]
    ext = torch.cat([torch.zeros(d, 2 * c, device="cuda"), x])
    e = ext.unfold(0, d + sub, sub).transpose(1, 2).contiguous()
    b = kprobe.probe_bound("v3", sub, 1, c, t, factor, d, plan.h.numel())

    def mm():
        return torch.matmul(w, e)                        # [nsub, 64, 2c]

    out = {}
    for mode in ("highest", "tf32"):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
        try:
            if mode == "tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.set_float32_matmul_precision("high")
            mm()
            out[mode] = time_cuda(torch, mm, 20)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.set_float32_matmul_precision(prev[1])
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("phase22: the yardstick left TF32 on")
    log(f"phase22 yardstick: torch.matmul W [64, {d + sub}] x E "
        f"{tuple(e.shape)}: {out['highest']:.4f} ms at highest precision "
        f"({b['product_flops'] / (out['highest'] * 1e-3) / 1e12:.2f} "
        f"TFLOP/s), {out['tf32']:.4f} ms with TF32 "
        f"({b['product_flops'] / (out['tf32'] * 1e-3) / 1e12:.2f} TFLOP/s)")
    del e, ext
    return out


def phase_means(torch, front) -> dict:
    """Phase 23: front_means alone (front.chunk_means: chunk means and raw
    tails of 2048 rows per 32768-row block) at the AM cells' shapes and
    dtypes, on the cell's plane with noise and a DC offset.  int16 means
    and every raw tail equal to the plain version, float32 means within
    MEANS_ATOL max |x| (the sums run in another order); then timed in turns
    with the PyTorch call that computes the means (float32: the reshape
    mean; int16: the reshape sum in float32) and with the plain version,
    with GB/s, the share of its bound and its per-launch device time."""
    from pebblesdr_tpu_torch.utils import roofline
    n, raw_rows = HEADLINE["frames"], 2048
    gen = torch.Generator(device="cuda").manual_seed(23)
    res = {}
    for name, c, k, entry in (("am_64ch", 64, 32, "f32"),
                              ("am_256ch", 256, 16, "f32"),
                              ("am_i16_256ch", 256, 16, "i16"),
                              ("am_16ch", 16, 64, "f32")):
        i16 = entry == "i16"
        block = am_plane(c, n, None)
        x = torch.from_numpy(to_i16(block) if i16 else block).cuda()
        x = x.repeat(k, 1)
        noise = torch.randn(x.shape, generator=gen, device="cuda")
        if i16:
            x = (x.float() + 300.0 * noise + 1500.0).round().clamp(
                -32768, 32767).to(torch.int16)
        else:
            x = x + 0.01 * noise + 0.05
        del noise
        x = x.contiguous()
        got = front.chunk_means(x, n, raw_rows)
        ref = front.chunk_means_reference(x, n, raw_rows)
        torch.cuda.synchronize()
        scale = float(front.dequantize(x).abs().max())
        err = float((got[0] - ref[0]).abs().max())
        raw_equal = torch.equal(got[1], ref[1])
        means_ok = (torch.equal(got[0], ref[0]) if i16
                    else err <= MEANS_ATOL * scale)
        log(f"phase23 front_means at {name} {tuple(x.shape)} {x.dtype}: "
            f"means max abs error {err:.3g} "
            + ("(equal)" if i16 else f"(<= {MEANS_ATOL} x {scale:.4g})")
            + f", raw tails {tuple(got[1].shape)} equal {raw_equal}")
        if not (means_ok and raw_equal):
            raise RuntimeError(f"phase23: front_means disagrees with its "
                               f"plain version at {name}")
        del got, ref
        view = x.view(-1, front.DC_CHUNK, 2 * c)
        fns = {"plain": lambda: front.chunk_means_reference(x, n, raw_rows),
               "kernel": lambda: front.chunk_means(x, n, raw_rows),
               "library": ((lambda: torch.sum(view, 1, dtype=torch.float32))
                           if i16 else (lambda: view.mean(1)))}
        t, runs = time_turns(torch, fns)
        b = roofline.means_bound(x.shape[0], 2 * c, x.element_size(), k,
                                 raw_rows)
        ms = t["kernel"]
        log(f"phase23 front_means at {name}: {ms:.4f} ms vs library "
            f"{t['library']:.4f} ms vs plain {t['plain']:.4f} ms (runs "
            f"{runs}); {b['bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{b['bound_ms'] / ms:.1%} of it; per launch (ms): "
            + kernel_breakdown(torch, fns["kernel"]))
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": t["plain"],
                     "library_ms": t["library"], "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"]}
        del fns, view, x
        torch.cuda.empty_cache()
    return res


def phase_dc_scan(torch, front) -> dict:
    """Phase 24: front_dc_scan alone (front.dc_scan: the chunk EWMA over a
    copy of the chunk means) at the shapes K1 gives it: the chunk means of
    am_64ch's, am_16ch's and am_256ch's planes (with noise and a DC offset)
    and the DC blocker's a = 0.9999^512, and am_nb_64ch's second scan (its
    shape, the blanker's a = 0.999^512, on am_64ch's means).  m and dc'
    must equal front.dc_scan_emulate bit for bit, and the plain version
    (float64 closed form) within FRONT_RTOL of max |m|; then the call is
    timed in turns with the plain version, with the kernel's per-launch
    device time and its bound."""
    from pebblesdr_tpu_torch.utils import roofline
    n = HEADLINE["frames"]
    gen = torch.Generator(device="cuda").manual_seed(24)
    res, means = {}, {}
    for name, c, k, alpha in (("am_64ch", 64, 32, 0.9999),
                              ("am_16ch", 16, 64, 0.9999),
                              ("am_256ch", 256, 16, 0.9999),
                              ("am_nb_64ch", 64, 32, None)):
        a = (alpha if alpha else 1.0 - NB1[2]) ** front.DC_CHUNK
        if name == "am_nb_64ch":
            mu = means["am_64ch"]
        else:
            x = torch.from_numpy(am_plane(c, n, None)).cuda().repeat(k, 1)
            x = (x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda")
                 + 0.05).contiguous()
            mu = means[name] = front.chunk_means(x)[0]
            del x
        dc = torch.full((1, 2 * c), 0.02, device="cuda")
        got = front.dc_scan(mu, dc, a)
        ref = front.dc_scan_reference(mu, dc, a)
        torch.cuda.synchronize()
        a32, b32 = front.chunk_ewma(a)
        emu = front.dc_scan_emulate(mu.cpu().numpy(), dc.cpu().numpy(), a32,
                                    b32)
        exact = all(np.array_equal(g.cpu().numpy().view(np.uint32),
                                   e.view(np.uint32))
                    for g, e in zip(got, emu))
        err = float((got[0] - ref[0]).abs().max())
        scale = float(ref[0].abs().max())
        log(f"phase24 front_dc_scan at {name} {tuple(mu.shape)} (a = "
            f"{a32:.6f}): m and dc' equal dc_scan_emulate {exact}; max abs "
            f"error vs plain {err:.3g} (<= {FRONT_RTOL} x {scale:.4g})")
        if not (exact and err <= FRONT_RTOL * scale):
            raise RuntimeError(f"phase24: front_dc_scan disagrees at {name}")
        del got, ref
        fns = {"plain": lambda: front.dc_scan_reference(mu, dc, a),
               "kernel": lambda: front.dc_scan(mu, dc, a)}
        t, runs = time_turns(torch, fns)
        lt = kernel_times(torch, fns["kernel"], reps=10)
        ms = next(v for kk, (v, _) in lt.items()
                  if kk.startswith("front_dc_scan"))
        b = roofline.scan_bound(mu.shape[0], 2 * c)
        log(f"phase24 front_dc_scan at {name}: {ms:.4f} ms per launch "
            f"({t['kernel']:.4f} ms per call with the copy of the means) vs "
            f"plain {t['plain']:.4f} ms (runs {runs}); bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{b['bound_ms'] / ms:.1%} of it; per launch (ms): "
            + breakdown_text(lt))
        res[name] = {"max_abs_err": err, "ms": ms, "call_ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"]}
        torch.cuda.empty_cache()
    return res


# phase 25's forms of K1 on front_fir's 4-channel items: (name, protected
# bandwidth of the plan, int16 entry, blanker + IQ balance)
NARROW_FORMS = (("USB plan float32", 20_000.0, False, False),
                ("USB plan int16", 20_000.0, True, False),
                ("USB plan NB1 + IQ", 20_000.0, False, True),
                ("NONE plan float32", 48_000.0, False, False))
# phase 26's narrowband receivers: (mode name, receiver options, entry);
# the USB int16 and NB1 + IQ slices run phase 25's other USB-plan forms
NARROW_SLICES = (("USB", {}, None), ("USB", {}, "i16"),
                 ("USB", {}, "nb1_iq"), ("LSB", {}, None), ("CWU", {}, None),
                 ("DIGL", {}, None), ("DSB", {}, None), ("NONE", {}, None),
                 ("SAM", dict(sam_sideband="analytic"), None),
                 ("SAM", dict(sam_sideband="rails"), None))
# phase 27's cells: (name, mode, options, tone): sam_64ch is bench.py:585
# (SAM, the bench signal); usb_64ch is the port's own: tests/test_chain.py
# :111-125's USB tone (0.4 at carrier + 1.5 kHz, AGC off; the audio's
# amplitude is 0.4 sqrt(2)) at the headline shape
NARROW_CELLS = (("sam_64ch", "SAM", {}, None),
                ("usb_64ch", "USB", dict(agc_mode="off"),
                 (1500.0, 0.4, 1500.0, 0.4 * np.sqrt(2.0))))


def phase_front_narrow(torch, front, decimator) -> dict:
    """Phase 25: K1 at front_fir's 4-channel geometry (the factor-64 /
    2007-tap and factor-32 / 1159-tap responses) against its plain version
    at the headline width (64 channels, 32 blocks of 32768 rows), two
    streaming calls each; with the blanker on an impulsive input whose
    threshold margin is asserted first, no blanked position or nb_tail'
    flag differing.  Then each form timed against its plain version, with
    its per-launch device times, front_fir's plain version and bound."""
    from pebblesdr_tpu_torch.ops.mixer import split_freq
    from pebblesdr_tpu_torch.utils import roofline
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    zeros = dict(dtype=torch.float32, device="cuda")
    iq = tuple(torch.tensor(v, device="cuda") for v in IQ)
    splits = [split_freq(250_000.0 + 1500.0 * i, FS) for i in range(c)]
    f_hi, f_lo = (torch.tensor(np.array([s[j] for s in splits]),
                               device="cuda") for j in (0, 1))
    rng = np.random.default_rng(25)
    res = {}
    for form, protect, i16, opts in NARROW_FORMS:
        p = decimator.build_plan(FS, protect)
        plan = front.FrontPlan.make(decimator.compose_response(p), p.factor,
                                    "cuda")
        lay = front.fir_march_layout(plan.h.numel(), plan.factor, opts,
                                     2 if i16 else 4)
        log(f"phase25 {form}: factor {plan.factor}, {plan.h.numel()} taps, "
            f"front_fir items of {lay['cg']} channels, {lay['dp']} taps per "
            f"branch, steps of {lay['step_rows']} rows, {lay['smem']} bytes "
            f"of shared memory")
        kw = dict(n_block=n, raw_rows=2048)
        if opts:
            kw.update(iq_gain=iq[0], iq_phase=iq[1], nb=NB1)
        # the carried state (dc, phase, tail, nb_avg, nb_tail): the
        # kernel's after each call, into both versions of the next
        st = (torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
              torch.zeros(plan.d_rows, 2 * c, **zeros),
              torch.zeros(1, 2 * c, **zeros), torch.zeros(16, 2 * c, **zeros))
        worst = max_abs = 0.0
        for call in range(2):
            x = am_plane(c, k * n, rng, noise=0.01) + 0.05 * (call + 1)
            if opts:
                x = impulsive(x, n)
            x = torch.from_numpy(to_i16(x, 16384.0) if i16 else x).cuda()
            args = (x, st[0], st[1], f_hi, f_lo, st[2])
            tkw = dict(kw, nb_avg=st[3], nb_tail=st[4]) if opts else kw
            check = check_options_form(torch, front, plan, args, tkw,
                                       f"phase25 K1 {form} call {call}",
                                       keep=True)
            worst, max_abs = (max(worst, check["worst"]),
                              max(max_abs, check["max_abs_err"]))
            o = check.pop("out")
            st = (o[1], o[3], o[2]) + ((o[5], o[6]) if opts else st[3:])
            del o
        torch.cuda.synchronize()

        def kernel():
            return front.fused_front(plan, *args, **tkw)

        ms, plain_ms, t = time_pair(
            torch, kernel,
            lambda: front.fused_front_reference(plan, *args, **tkw))
        lt = kernel_times(torch, kernel, reps=10)
        b = roofline.k1_bound(plan, k * n, c, 2 if i16 else 4, n, 2048,
                              nb=opts, iq=opts)
        log(f"phase25 K1 {form}: {ms:.4f} ms vs plain {plain_ms:.4f} ms per "
            f"dispatch (runs kernel {t['kernel']}, plain {t['plain']}); "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); per launch "
            f"(ms): " + breakdown_text(lt))
        res[form] = {"ms": ms, "plain_ms": plain_ms, **b, "worst": worst,
                     "max_abs_err": max_abs, "fir_ms": fir_launch_ms(lt),
                     "plan": plan}
        res[form].update(phase_fir_plain(torch, front, plan, args, n, tkw,
                                         f"phase25 {form}"))
        f = res[form]
        log(f"phase25 front_fir {form}: {f['fir_ms']:.4f} ms per launch vs "
            f"its plain version {f['fir_plain_ms']:.4f} ms, bound "
            f"{f['fir_bound']['bound_ms']:.4f} ms "
            f"({f['fir_bound']['bound_by']}; "
            f"{f['fir_bound']['bound_ms'] / f['fir_ms']:.1%} of it)")
        del args, x, st
        torch.cuda.empty_cache()
    log(f"phase25 ok: K1 at the 4-channel geometry == plain within "
        f"{FRONT_RTOL} (worst {max(v['worst'] for v in res.values()):.3g}), "
        f"no flag mismatch")
    return res


def phase_narrow_cells(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phase 27: the narrowband cells sam_64ch and usb_64ch, windows
    interleaved, each with a profile of its dispatches and a tone check of
    its audio."""
    cells = [make_cell(torch, receiver, front, DemodMode[mode], name,
                       HEADLINE["channels"], HEADLINE["blocks"], opts=opts,
                       tone=tone)
             for name, mode, opts, tone in NARROW_CELLS]
    time_cells(torch, front, wfm_tail, cells, "phase27")
    done = {}
    for cell in cells:
        prof = dispatch_profile(torch, cell, "phase27")
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib")}
        done[cell["name"]].update(prof)
    del cells
    torch.cuda.empty_cache()
    return done



# phase 28's receivers: (tag, mode name, receiver options, entry)
NEW_SLICES = (("FMN ctcss", "FMN", dict(ctcss_tone=CTCSS_TONE), None),
              ("FMN ctcss i16", "FMN", dict(ctcss_tone=CTCSS_TONE), "i16"),
              ("FMM", "FMM", {}, None),
              ("FMM hq", "FMM", dict(wfm_hq=True), None),
              ("FMS mono rds", "FMS", dict(stereo=False, rds=True), None),
              ("AM anf long", "AM", dict(enable_anf=True, agc_mode="long"),
               None),
              ("USB long", "USB", dict(agc_mode="long"), None))
# phase 29's cells: (name, mode name, options, dispatch plane or None for
# the bench block repeated, checks).  nfm_ctcss_64ch's plane is one
# continuous dispatch (the 123 Hz sub-tone has no whole period in a block):
# the CTCSS tone squelch's cell, NFM voice (tests/test_dtmf_ctcss.py:
# 128-140's signal at 3 kHz deviation), its SNR over the voice band (the
# sub-tone lies below it); fmm_64ch is bench.py:575's WFM signal
# demodulated mono; am_anf_long_64ch is am_64ch with the ANF and AGC
# "long" (the ANF outputs its prediction, so its SNR is printed, not held)
NEW_CELLS = (
    ("nfm_ctcss_64ch", "FMN", dict(ctcss_tone=CTCSS_TONE),
     lambda c, rows: nfm_plane(c, rows, np.random.default_rng(29), 0.01),
     dict(snr_band=(300.0, 3000.0), ctcss=True)),
    ("fmm_64ch", "FMM", {}, None, {}),
    ("am_anf_long_64ch", "AM", dict(enable_anf=True, agc_mode="long"), None,
     dict(snr=False, anf=True)))


def check_base_form(torch, front, cell, tag: str) -> dict:
    """K1's base form at a cell's plan and plane (plus a DC offset, which
    keeps dc' away from 0) against its plain version once, then both
    timed, with the per-launch device times and the bound."""
    from pebblesdr_tpu_torch.utils import roofline
    rx, c, n = cell["rx"], cell["channels"], HEADLINE["frames"]
    x = cell["iq"] + 0.05
    zeros = dict(dtype=torch.float32, device="cuda")
    p = cell["params"]
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            p.tune_hi, p.tune_lo, torch.zeros(rx.front.d_rows, 2 * c, **zeros))
    kw = dict(n_block=n, raw_rows=2048)
    check = check_options_form(torch, front, rx.front, args, kw,
                               f"{tag} {cell['name']} K1 base form at factor "
                               f"{rx.plan.factor}, {rx.front.h.numel()} taps")

    def kernel():
        return front.fused_front(rx.front, *args, **kw)

    ms, plain_ms, t = time_pair(
        torch, kernel, lambda: front.fused_front_reference(rx.front, *args,
                                                           **kw))
    lt = kernel_times(torch, kernel, reps=10)
    b = roofline.k1_bound(rx.front, x.shape[0], c, 4, n, 2048)
    log(f"{tag} {cell['name']} K1 base form: {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms per dispatch (runs kernel {t['kernel']}, plain "
        f"{t['plain']}); bound {b['bound_ms']:.4f} ms ({b['bound_by']}); per "
        f"launch (ms): " + breakdown_text(lt))
    del x, args
    return {"ms": ms, "plain_ms": plain_ms, **b, **check,
            "fir_ms": fir_launch_ms(lt)}


def phase_new_cells(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phase 29: the cells nfm_ctcss_64ch, fmm_64ch and am_anf_long_64ch,
    windows interleaved, each with its checks and a profile of its
    dispatches; first K1's base form at fmm_64ch's plan (factor 8, no
    timed cell ran it before) against its plain version, timed."""
    cells = [make_cell(torch, receiver, front, DemodMode[mode], name,
                       HEADLINE["channels"], HEADLINE["blocks"], opts=opts,
                       plane=plane, checks=checks)
             for name, mode, opts, plane, checks in NEW_CELLS]
    k1 = check_base_form(torch, front, cells[1], "phase29")
    torch.cuda.empty_cache()
    time_cells(torch, front, wfm_tail, cells, "phase29")
    done = {}
    for cell in cells:
        prof = dispatch_profile(torch, cell, "phase29")
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib",
            "snr_db")}
        done[cell["name"]].update(prof)
    done["fmm_64ch"]["k1"] = k1
    del cells
    torch.cuda.empty_cache()
    return done


# ---- phases 30-31: the per-sample loops (csrc/recur.cu) ----------------

LOOP_ATOL = 1e-5      # recurrence kernel vs plain: phases (rad, on the
#                       circle), freqs (rad/sample) and AGC levels (log10):
#                       the kernel repeats the plain version's float32
#                       operations one by one (no FMA contraction, the same
#                       sincosf / atan2f / hypotf), bit-equal where measured
LOOP_PREFIX = 8192    # steps of the composite-rate forms held to (and timed
#                       against) the plain version: its Python loop costs
#                       ~0.3 ms a step on the card
LOOP_FS = 64_000.0    # the narrowband demod rate (AM's plan at 2.048 Msps)
PROBE_STEPS = 32768   # steps of the chain probe (serial floor)
# phase 31's cells: (name, mode, options, frames, blocks)
LOOP_CELLS = (("wfm_rds_scan_64ch", "FMS", dict(rds=True, rds_alg="scan"),
               32768, 32),
              ("sam_short_64ch", "SAM", {}, 2048, 128))


@contextlib.contextmanager
def captured(module, name: str):
    """Record the arguments of every call of module.name (a kernel wrapper,
    which still launches and counts) while the block runs."""
    fn, seen = getattr(module, name), []

    def spy(*args, **kw):
        seen.append((args, kw))
        return fn(*args, **kw)

    spy.__dict__ = fn.__dict__     # the wrapper counts through its own name
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def hold_loop(torch, name: str, kernel, plain, args, angles, tag: str,
              steps: int | None = None) -> dict:
    """A recurrence kernel against its plain version on the same inputs
    (args; with steps, the first `steps` columns of args[0] only): the
    plain version once, timed by events (a Python loop of ~20 launches a
    step), the kernel timed over 10 calls, its per-launch device time
    (torch.profiler), and every output compared (the indices in `angles`
    on the circle).  Raises past LOOP_ATOL."""
    if steps is not None:
        args = (args[0][:, :steps].contiguous(),) + tuple(args[1:])
    out_k = kernel(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_p = plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    ms = time_cuda(torch, lambda: kernel(*args), 10)
    # one launch per call, so ms is its launch's time; the profiler's
    # per-launch record where it keeps one (after the earlier phases'
    # profiles of whole dispatches it may record none)
    lt = kernel_times(torch, lambda: kernel(*args), reps=3)
    err = 0.0
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        if not a.numel():
            continue
        d = a.double() - b.double()
        if i in angles:
            d = torch.angle(torch.exp(1j * d))
        err = max(err, float(d.abs().max()))
    shape = tuple(args[0].shape)
    log(f"{tag} {name} {shape}: kernel {ms:.4f} ms per call (per launch "
        f"{breakdown_text(lt)}) vs plain {plain_ms:.1f} ms; max |kernel - "
        f"plain| {err:.3g} (<= {LOOP_ATOL})")
    if not err <= LOOP_ATOL:
        raise RuntimeError(f"{tag} {name}: the kernel disagrees with its "
                           f"plain version ({err:.3g})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "shape": shape, "launch_ms": lt}


def probe_ns(torch, pll, form: str) -> float:
    """The serial floor's step latency of one form (ns): the register-only
    chain probe over PROBE_STEPS steps, timed by events."""
    pll.chain_probe(form, 256, "cuda")
    ms = time_cuda(torch, lambda: pll.chain_probe(form, PROBE_STEPS, "cuda"),
                   3)
    return ms * 1e6 / PROBE_STEPS


def loop_bound(roofline, kind: str, shape, step_ns: float) -> dict:
    c, n = shape
    fn = {"pll_scan": roofline.pll_scan_bound,
          "pll_chunk_scan": roofline.pll_chunk_bound,
          "agc_scan": roofline.agc_scan_bound}[kind]
    return fn(c, n, step_ns)


def phase_loops(torch, front, wfm_tail) -> dict:
    """Phase 30: the recurrence kernels at the module shapes, each driven
    once through its entry point with the launch counts set to 0 just
    before and read just after, then held to its plain version on the
    inputs that call gave it and timed against it:
      * pll_scan atan2: NFM algorithm "pll" at [64, 32768] (64 ksps, NFM
        voice at 3 kHz deviation): the whole call held, and the audio's
        1 kHz tone SNR (300 Hz - 3 kHz) >= TONE_SNR_DB;
      * pll_scan cross and pilot at the WFM composite's shape [64, 131072]
        (256 kHz, 10 Hz loops: a complex 19 kHz carrier 5 Hz off at unit
        amplitude, the cross detector's gain; the real composite with its
        pilot): held and timed on the first LOOP_PREFIX steps of
        the same input and state (the plain loop would take ~40 s for the
        whole call), the whole call's kernel time logged, and the loop
        locked (its mean frequency over the last 8192 samples within 1 Hz
        of the carrier);
      * pll_chunk_scan: SAM smooth "loop" at sam_64ch's demod stream
        ([64, 32768] at 64 ksps in 1024-sample blocks: [64, 4096] chunk
        phasors; an AM carrier 230 Hz off, noise at 1e-4 since nothing
        band-limits it here), held whole, the audio's tone SNR >=
        TONE_SNR_DB;
      * agc_scan: the scan AGC at am_64ch's demod stream ([64, 32768],
        stride 16: 2048 steps) in the modes "long" (the hang) and "med",
        held whole;
    and each form's serial floor (the chain probe).  Returns the kernel
    entries of the JSON line keyed by form."""
    from pebblesdr_tpu_torch.demod import nfm, sam
    from pebblesdr_tpu_torch.ops import agc, pll
    from pebblesdr_tpu_torch.utils import roofline
    c, n, fs = HEADLINE["channels"], HEADLINE["frames"], LOOP_FS
    rng = np.random.default_rng(30)
    steps_ns = {form: probe_ns(torch, pll, form) for form in pll.PROBE_FORMS}
    log("phase30 chain probe (ns per step, one thread, registers only): "
        + ", ".join(f"{k} {v:.1f}" for k, v in steps_ns.items()))
    res = {}

    def drive(tag, kind, fn, module, name, det=None):
        """Run the entry point fn once with the counts at 0; returns the
        kernel's launches and the arguments of its call."""
        reset_launches(front, wfm_tail)
        with captured(module, name) as seen:
            out = fn()
        torch.cuda.synchronize()
        launches = (pll.pll_scan.detector_launches[det] if det
                    else getattr(pll if kind != "agc_scan" else agc,
                                 kind).launches)
        if launches != 1 or len(seen) != 1:
            raise RuntimeError(f"phase30 {tag}: {launches} {kind} launches "
                               f"for one call")
        return out, seen[0][0]

    # NFM "pll": pll_scan atan2
    t = np.arange(n) / fs
    ph = (2 * np.pi * 150.0 * t + 3.0 * np.sin(2 * np.pi * 1000.0 * t))
    x = (0.5 * np.exp(1j * (ph + np.arange(c)[:, None]))
         + 1e-3 * (rng.standard_normal((c, n))
                   + 1j * rng.standard_normal((c, n))))
    x = torch.from_numpy(x.astype(np.complex64)).cuda()
    ncfg = nfm.NFMConfig.make(fs, algorithm="pll")
    (_, audio), args = drive("nfm pll", "pll_scan", lambda: nfm.nfm_demod(
        ncfg, nfm.nfm_init(ncfg, c, "cuda"), x), pll, "pll_scan", "atan2")
    snr = tone_snr_db(audio[0, n // 4:].double().cpu().numpy(), fs, 1000.0,
                      (300.0, 3000.0))
    log(f"phase30 NFM 'pll' [{c}, {n}]: 1 kHz tone SNR {snr:.2f} dB "
        f"(>= {TONE_SNR_DB})")
    if not snr >= TONE_SNR_DB:
        raise RuntimeError("phase30: NFM 'pll' tone SNR below its bound")
    h = hold_loop(torch, "pll_scan atan2 (NFM pll)", pll.pll_scan,
                  pll.pll_scan_plain, args, (0, 3), "phase30")
    res["atan2 nfm"] = dict(h, launches=1, **loop_bound(
        roofline, "pll_scan", h["shape"], steps_ns["atan2"]))

    # cross and pilot at the composite shape
    rate, nc = 256_000.0, n * HEADLINE["blocks"] // 8
    tc = np.arange(nc) / rate
    for det in ("cross", "pilot"):
        pcfg = pll.make_pll_config(rate, 10.0, center_hz=19000.0,
                                   range_hz=100.0, detector=det)
        phc = 2 * np.pi * 19005.0 * tc + 0.3 * np.arange(c)[:, None]
        if det == "pilot":
            xc = (0.1 * np.sin(phc) + 0.3 * np.sin(2 * np.pi * 1000.0 * tc)
                  + 0.01 * rng.standard_normal((c, nc)))
        else:                # cross: unnormalised, so at unit amplitude
            xc = np.exp(1j * phc) + 0.01 * rng.standard_normal((c, nc))
        xc = torch.from_numpy(xc.astype(np.complex64)).cuda()
        (_, _, fr), args = drive(det, "pll_scan", lambda: pll.pll_run(
            pcfg, pll.pll_init(pcfg, c, "cuda"), xc), pll, "pll_scan", det)
        f_hat = fr[:, -8192:].mean(dim=1).double().cpu().numpy() \
            * rate / (2 * np.pi)
        full_ms = time_cuda(torch, lambda: pll.pll_scan(*args), 5)
        log(f"phase30 pll_scan {det} [{c}, {nc}]: {full_ms:.4f} ms per call; "
            f"locked at {f_hat.min():.3f}..{f_hat.max():.3f} Hz (19005 "
            f"within 1)")
        if not np.all(np.abs(f_hat - 19005.0) < 1.0):
            raise RuntimeError(f"phase30: the {det} loop did not lock")
        h = hold_loop(torch, f"pll_scan {det}", pll.pll_scan,
                      pll.pll_scan_plain, args, (0, 3), "phase30",
                      steps=LOOP_PREFIX)
        res[det] = dict(h, launches=1, full_ms=full_ms, full_shape=(c, nc),
                        **loop_bound(roofline, "pll_scan", h["shape"],
                                     steps_ns[det]))

    # SAM smooth "loop": pll_chunk_scan
    env = 1 + 0.5 * np.cos(2 * np.pi * 1000.0 * t)
    xs = (0.3 * env * np.exp(1j * (2 * np.pi * 230.0 * t
                                   + 0.7 * np.arange(c)[:, None]))
          + 1e-4 * (rng.standard_normal((c, n))
                    + 1j * rng.standard_normal((c, n))))
    xs = torch.from_numpy(xs.astype(np.complex64)).cuda()
    scfg = sam.SAMConfig.make(fs, smooth="loop")
    (_, audio), args = drive("sam loop", "pll_chunk_scan", lambda: (
        sam.sam_demod(scfg, sam.sam_init(scfg, c, "cuda"), xs,
                      n_block=1024)), pll, "pll_chunk_scan")
    snr = tone_snr_db(audio[0, n // 4:].double().cpu().numpy(), fs, 1000.0)
    log(f"phase30 SAM smooth='loop' [{c}, {n}]: 1 kHz tone SNR {snr:.2f} dB "
        f"(>= {TONE_SNR_DB})")
    if not snr >= TONE_SNR_DB:
        raise RuntimeError("phase30: SAM loop tone SNR below its bound")
    h = hold_loop(torch, "pll_chunk_scan (SAM loop)", pll.pll_chunk_scan,
                  pll.pll_chunk_scan_plain, args, (0, 3), "phase30")
    res["chunk"] = dict(h, launches=1, **loop_bound(
        roofline, "pll_chunk_scan", h["shape"], steps_ns["chunk"]))

    # the scan AGC at am_64ch's demod stream
    xa = torch.from_numpy((0.5 * np.where((t % 0.3) < 0.15, 1.0, 0.02)
                           * env * np.exp(2j * np.pi * 300.0 * t)
                           + 1e-3 * rng.standard_normal((c, n)))
                          .astype(np.complex64)).cuda()
    for mode in ("long", "med"):
        acfg = agc.AGCConfig.make(fs, mode, stride=HEADLINE["agc_stride"],
                                  algorithm="scan")
        _, args = drive(f"agc {mode}", "agc_scan", lambda: agc.agc_apply(
            acfg, agc.agc_init(acfg, c, "cuda"), xa), agc, "agc_scan")
        h = hold_loop(torch, f"agc_scan ({mode})", agc.agc_scan,
                      agc.agc_scan_plain, args, (), "phase30")
        res[f"agc {mode}"] = dict(h, launches=1, **loop_bound(
            roofline, "agc_scan", h["shape"],
            steps_ns["agc hang" if mode == "long" else "agc"]))
    for key, r in res.items():
        log(f"phase30 {key}: bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"serial floor {r['serial_ms']:.4f} ms) vs kernel "
            f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of it)")
    res["steps_ns"] = steps_ns
    return res


def phase_loop_cells(torch, receiver, convert, front, wfm_tail,
                     DemodMode, steps_ns: dict) -> dict:
    """Phase 31: the receivers that run the per-sample loop.  First the
    card against the CPU (C=4): FMS with the scan RDS carrier (32768-frame
    blocks, a dispatch of 3) and SAM on 64-sample blocks (2048 frames,
    dispatches of 3 then 9 after a 33-block warm-up: the AGC delay line
    and the loop's lock), pll_scan once per dispatch; then the RDS decode
    of "PEBBLES " with the scan carrier; then the timed cells
    wfm_rds_scan_64ch (wfm_rds_64ch with rds_alg="scan": K1's WFM form, K2
    and pll_scan costas over 9728 steps per dispatch) and sam_short_64ch
    (SAM, 64 channels, 128 blocks of 2048 frames: K1's base form and
    pll_scan atan2 over 8192 steps per dispatch), windows interleaved, each
    with its launch counts, tone SNR and a profile of its dispatches; then
    pll_scan at each cell's own inputs (captured from a dispatch) held to
    its plain version and timed."""
    from pebblesdr_tpu_torch.ops import pll
    from pebblesdr_tpu_torch.utils import roofline
    phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.FMS,
                rx_opts=dict(rds=True, rds_alg="scan"),
                tag="phase31 RDS scan slice")
    phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.SAM,
                frames=2048, warm=33, tag="phase31 SAM short slice")
    phase_rds_decode(torch, receiver, DemodMode, rds_alg="scan",
                     geometries=(False,), tag="phase31")
    cells = [make_cell(torch, receiver, front, DemodMode[mode], name,
                       HEADLINE["channels"], blocks, opts=opts,
                       frames=frames)
             for name, mode, opts, frames, blocks in LOOP_CELLS]
    time_cells(torch, front, wfm_tail, cells, "phase31")
    done = {}
    for cell in cells:
        prof = dispatch_profile(torch, cell, "phase31")
        det = "costas" if cell["rx"].rds_cfg is not None else "atan2"
        with captured(pll, "pll_scan") as seen:
            cell["rx"].step_many(cell["state"], cell["params"], cell["iq"],
                                 spectra=False)
        torch.cuda.synchronize()
        h = hold_loop(torch, f"pll_scan {det} ({cell['name']})",
                      pll.pll_scan, pll.pll_scan_plain, seen[0][0], (0, 3),
                      "phase31")
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib",
            "snr_db")}
        done[cell["name"]].update(prof)
        done[cell["name"]]["k3"] = dict(h, **loop_bound(
            roofline, "pll_scan", h["shape"], steps_ns[det]))
        n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
        log(f"phase31 {cell['name']}: pll_scan {det} launches "
            f"{cell['launches'][5]} ({cell['launches'][5] / n_dispatch:g} "
            f"per dispatch); {h['ms']:.4f} ms of the dispatch's "
            f"{cell['block_ms'] * cell['blocks']:.4f} ms")
    del cells
    torch.cuda.empty_cache()
    return done


# ---- phases 32-34: the staged front, K5 and the dense filterbank bank ----

IQ_RTOL = 1e-5        # K5 vs plain: y and w' within 1e-5 of their scale (the
#                       chain repeats the plain version's float32 operations
#                       one by one; the group sums are added in another order)
IQ_REJECTION = (20.0, 60.0)   # dB: adaptive balance deepens image rejection
#                               by >= 20 over 12 blocks and ends above 60
#                               (tests/test_chain.py:204-236)
# phase 33's receivers: (tag, mode name, receiver options, entry)
STAGED_SLICES = (("AM auto", "AM", dict(enable_iq_balance="auto"), None),
                 ("USB auto nb1", "USB", dict(enable_iq_balance="auto",
                                              enable_noise_blanker=True),
                  "staged_nb1"),
                 ("AM dc off", "AM", dict(enable_dc_removal=False), None),
                 ("FMM auto rds", "FMM", dict(enable_iq_balance="auto",
                                              rds=True), None))
BANK_SLICE = dict(fs=1_024_000, frames=16384, bank=16, dispatches=(3, 3))
PFB_CELL = dict(bank=128, stations=127)   # bench.py:228-290


class BankCell:
    """A PfbBankReceiver behind the Receiver's step_many(state, params, iq,
    spectra) signature (time_cells, dispatch_profile); every other
    attribute is its tail Receiver's."""

    def __init__(self, bank):
        self.bank = bank

    def __getattr__(self, name):
        return getattr(self.bank.rx, name)

    def step_many(self, state, params, iq, spectra=True):
        return self.bank.step_many(state, iq, params, spectra)


def make_iqauto_cell(torch, receiver, front):
    """am_iqauto_64ch: am_64ch's shape and signal (AM, 64 channels, 32
    blocks of 32768 frames, AGC stride 16) with enable_iq_balance="auto",
    the plane through tests/test_chain.py:204-236's IQ imbalance."""
    cell = make_cell(torch, receiver, front, receiver.DemodMode.AM,
                     "am_iqauto_64ch", HEADLINE["channels"],
                     HEADLINE["blocks"], opts=dict(enable_iq_balance="auto"))
    c = HEADLINE["channels"]
    i = cell["iq"][:, :c].clone()
    cell["iq"][:, :c] = 1.06 * i
    cell["iq"][:, c:] += 0.08 * i
    return cell


def make_bank_cell(torch, receiver=None, front=None):
    """pfb_127st_bank128 (bench.py:228-290): one 2.048 Msps capture (the
    bench's AM block, an [N, 2] plane repeated over 32 blocks of 32768)
    through a 128-channel filterbank, 127 AM stations on bank channels
    1-127 (16 kHz channels, 256-sample channel blocks), AGC stride 16,
    spectra every dispatch, as the bench computes them.  The bench's
    carrier sits between two channel centres, so the tone SNR is printed,
    not held."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.ops import pfb
    m, n, k = PFB_CELL["bank"], HEADLINE["frames"], HEADLINE["blocks"]
    centers = pfb.channel_freqs(pfb.plan(FS, m))
    tunes = centers[(1 + np.arange(PFB_CELL["stations"])) % m]
    bank = PfbBankReceiver(FS, n, tunes, n_bank=m,
                           agc_stride=HEADLINE["agc_stride"], device="cuda")
    t = np.arange(n) / FS
    iq = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 250_000.0 * t)
    block = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    return {"name": "pfb_127st_bank128", "rx": BankCell(bank),
            "cfg": bank.rx.cfg, "wfm": False, "tone": None,
            "params": bank.params,
            "iq": torch.from_numpy(block).cuda().repeat(k, 1).contiguous(),
            "blocks": k, "channels": len(tunes), "state": bank.init_state(),
            "out": None, "i": 0, "launches": [0] * 7, "windows": [],
            "checks": dict(snr=False), "frames": n, "spectra_every": 1}


# the two cells of this slice, by name (tools/cell_profile.py reads it)
STAGED_CELLS = {"am_iqauto_64ch": make_iqauto_cell,
                "pfb_127st_bank128": make_bank_cell}


def image_rejection_db(y: np.ndarray, f0: float) -> float:
    spec = np.abs(np.fft.fft(y))
    freqs = np.fft.fftfreq(len(y), 1.0 / FS)
    return float(20 * np.log10(spec[np.argmin(np.abs(freqs - f0))] / max(
        spec[np.argmin(np.abs(freqs + f0))], 1e-12)))


def phase_iq_lms(torch, front, wfm_tail) -> dict:
    """Phase 32: K5 (csrc/recur.cu iq_lms_scan) against its plain version
    at am_iqauto_64ch's shape ([64, 1048576] complex64: 16384 groups of 64
    per channel; the AM plane's channels with the IQ imbalance, through
    its entry point scanops.auto_iq_balance with the counts at 0: one
    launch), y and w' within IQ_RTOL of their scale, the plain version
    timed once by events, the kernel over 10 calls with its per-launch
    device time, the chain probe's step latency and the bound; then the
    image rejection at module level: tests/test_chain.py:204-236's tone
    (0.5 at 300 kHz, I gain 1.06, 0.08 of I in Q) through 12 blocks of
    32768 samples on the card must deepen by >= 20 dB and end above 60."""
    from pebblesdr_tpu_torch.ops import pll, scanops
    from pebblesdr_tpu_torch.utils import roofline
    c = HEADLINE["channels"]
    n = HEADLINE["frames"] * HEADLINE["blocks"]
    plane = imbalanced(am_plane(c, n, np.random.default_rng(32), 0.01))
    x = torch.complex(*(torch.from_numpy(plane[:, j * c:(j + 1) * c].T
                                         .copy()).cuda() for j in (0, 1)))
    del plane
    st0 = scanops.auto_iq_balance_init(c, "cuda")
    reset_launches(front, wfm_tail)
    st1, y = scanops.auto_iq_balance(st0, x)
    torch.cuda.synchronize()
    if scanops.auto_iq_balance.launches != 1:
        raise RuntimeError(f"phase32: {scanops.auto_iq_balance.launches} K5 "
                           f"launches for one call")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y_p, w_p = scanops.iq_lms_scan_plain(x, st0.w)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err_y = float((y - y_p).abs().max())
    err_w = float((st1.w - w_p).abs().max())
    rel_y = err_y / float(y_p.abs().max())
    rel_w = err_w / float(w_p.abs().max())
    ms = time_cuda(torch, lambda: scanops.auto_iq_balance(st0, x), 10)
    lt = kernel_times(torch, lambda: scanops.auto_iq_balance(st0, x), reps=3)
    step_ns = probe_ns(torch, pll, "iq lms")
    b = roofline.iq_lms_bound(c, n, step_ns)
    log(f"phase32 iq_lms_scan [{c}, {n}]: kernel {ms:.4f} ms per call (per "
        f"launch {breakdown_text(lt)}) vs plain {plain_ms:.1f} ms; max |y - "
        f"plain| {err_y:.3g} ({rel_y:.3g} of scale), max |w' - plain| "
        f"{err_w:.3g} ({rel_w:.3g} of scale) (<= {IQ_RTOL}); |w'| "
        f"{float(st1.w.abs().min()):.4g}..{float(st1.w.abs().max()):.4g}; "
        f"chain probe {step_ns:.2f} ns per group; bound {b['bound_ms']:.4f} "
        f"ms ({b['bound_by']}; bytes {b['bytes'] / 3.35e9:.4f} ms, serial "
        f"floor {b['serial_ms']:.4f} ms): {b['bound_ms'] / ms:.1%} of it")
    if not (rel_y <= IQ_RTOL and rel_w <= IQ_RTOL):
        raise RuntimeError("phase32: K5 disagrees with its plain version")
    del y, y_p, x
    blk, f0 = 32768, 300_000.0
    st = scanops.auto_iq_balance_init(1, "cuda")
    rej = []
    for b_i in range(12):
        tt = (b_i * blk + np.arange(blk)) / FS
        clean = 0.5 * np.exp(2j * np.pi * f0 * tt)
        xb = (clean.real * 1.06 + 1j * (clean.imag + 0.08 * clean.real))
        st, yb = scanops.auto_iq_balance(
            st, torch.from_numpy(xb.astype(np.complex64)[None]).cuda())
        rej.append(image_rejection_db(yb[0].cpu().numpy(), f0))
    log(f"phase32 image rejection per block (dB): "
        + " ".join(f"{r:.1f}" for r in rej)
        + f" (deepens by >= {IQ_REJECTION[0]}, ends > {IQ_REJECTION[1]})")
    if not (rej[-1] >= rej[0] + IQ_REJECTION[0] and rej[-1] > IQ_REJECTION[1]):
        raise RuntimeError("phase32: adaptive IQ balance did not reject the "
                           "image")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max(err_y, err_w),
            "shape": (c, n), "step_ns": step_ns, "launch_ms": lt,
            "rejection_db": rej, **b}


def phase_bank_slice(torch, convert, front, wfm_tail,
                     tag: str = "phase33 bank slice") -> None:
    """The PfbBankReceiver at M = 16 (1.024 Msps: 64 kHz channels) on the
    card against the CPU, its trivial front and with
    enable_iq_balance="auto" (K5 on the tail's staged front), three
    stations on and off the grid in noise, dispatches of 3 then 3 blocks
    of 16384: the bounds of tests/test_chain_batched.py:58-69; K5 once per
    dispatch with "auto", K1 never."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.ops import pfb, scanops
    fs, n, m = BANK_SLICE["fs"], BANK_SLICE["frames"], BANK_SLICE["bank"]
    centers = pfb.channel_freqs(pfb.plan(fs, m))
    tunes = centers[[2, 5, 11]] + np.array([0.0, 1000.0, -700.0])
    rng = np.random.default_rng(33)
    for opts in ({}, dict(enable_iq_balance="auto")):
        cpu, gpu = (PfbBankReceiver(fs, n, tunes, n_bank=m, agc_stride=16,
                                    device=dev, **opts)
                    for dev in ("cpu", "cuda"))
        sc = cpu.init_state()
        sg = convert.state_from_numpy(gpu, convert.state_to_numpy(sc))
        t0 = 0.0
        for k in BANK_SLICE["dispatches"]:
            t = t0 + np.arange(k * n) / fs
            t0 += k * n / fs
            env = (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2
            x = sum(0.4 * env * np.exp(2j * np.pi * f * t) for f in tunes)
            x = x + 1e-2 * (rng.standard_normal(len(t))
                            + 1j * rng.standard_normal(len(t)))
            x = torch.from_numpy(x.astype(np.complex64))
            sc, oc = cpu.step_many(sc, x)
            reset_launches(front, wfm_tail)
            sg, og = gpu.step_many(sg, x.cuda())
            torch.cuda.synchronize()
            launches = (front.fused_front.launches,
                        scanops.auto_iq_balance.launches)
            want = (0, int(bool(opts)))
            d_audio = float((og["audio"].cpu() - oc["audio"]).abs().max())
            d_db = max(float((og[key].cpu() - oc[key]).abs().max())
                       for key in ("spectrum", "zoomed"))
            d_snr = float((og["smeter"]["snr_db"].cpu()
                           - oc["smeter"]["snr_db"]).abs().max())
            d_state = max(float(np.abs(a.astype(np.complex128)
                                       - b.astype(np.complex128)).max())
                          for a, b in zip(convert.state_to_numpy(sg),
                                          convert.state_to_numpy(sc))
                          if a.size)
            same = bool((og["squelch_open"].cpu() == oc["squelch_open"]).all())
            log(f"{tag} {opts or 'trivial'} K={k}: "
                f"audio {d_audio:.3g} (<= 2e-4) of scale "
                f"{float(oc['audio'].abs().max()):.3g}, dB {d_db:.3g} and "
                f"S-meter {d_snr:.3g} (<= 0.1), squelch equal {same}, state "
                f"{d_state:.3g} (<= 1e-4); launches (K1, K5) {launches}")
            if not (d_audio <= 2e-4 and d_db <= 0.1 and d_snr <= 0.1 and same
                    and d_state <= 1e-4 and launches == want):
                raise RuntimeError(f"{tag}: card disagrees with the CPU")
    log(f"{tag.split()[0]} ok: the bank on the card == the CPU bank")


def cascade_time(torch, decimator, x) -> float:
    """The staged halfband cascade as the port runs it (ops/decimator.py
    apply: each stage a strided conv1d, fir.fir_apply) on x, timed by CUDA
    events (ms per dispatch)."""
    plan = decimator.build_plan(FS, 30_000.0)
    state = decimator.state_init(plan, x.shape[0], "cuda")
    decimator.apply(plan, state, x)
    ms = time_cuda(torch, lambda: decimator.apply(plan, state, x), 10)
    log(f"phase34 halfband cascade [{x.shape[0]}, {x.shape[1]}] -> factor "
        f"{plan.factor}: conv1d (decimator.apply) {ms:.4f} ms per dispatch")
    return ms


def phase_staged_cells(torch, receiver, front, wfm_tail, decimator) -> dict:
    """Phase 34: the cells am_iqauto_64ch and pfb_127st_bank128, each timed
    alone (so its peak device memory is its own, beside what earlier
    phases still hold), with their launch counts (K1 never; K5 once per
    dispatch at am_iqauto_64ch), audio shape and squelch, am_iqauto_64ch's
    tone SNR, and a profile of each cell's dispatches; after
    am_iqauto_64ch the halfband cascade on its [64, 1048576] stream,
    timed, and its share of the cell's device busy."""
    done = {}
    for make in STAGED_CELLS.values():
        cell = make(torch, receiver, front)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30
        log(f"phase34 {cell['name']}: {held:.3f} GiB allocated before its "
            f"windows (its plane and state, and what earlier phases hold)")
        time_cells(torch, front, wfm_tail, [cell], "phase34")
        prof = dispatch_profile(torch, cell, "phase34")
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib",
            "snr_db")}
        done[cell["name"]].update(prof)
        if cell["name"] == "am_iqauto_64ch":
            c = HEADLINE["channels"]
            x = torch.complex(cell["iq"][:, :c].T.contiguous(),
                              cell["iq"][:, c:].T.contiguous())
            ms = cascade_time(torch, decimator, x)
            log(f"phase34 am_iqauto_64ch: the halfband cascade {ms:.4f} ms "
                f"of the dispatch's {prof['busy_ms']:.4f} ms device busy "
                f"({ms / prof['busy_ms']:.1%})")
            done["cascade_ms"] = ms
            del x
        del cell
        torch.cuda.empty_cache()
    return done


def conv_ieee(torch) -> None:
    """Phase 0: fir_apply's conv1d with cuDNN's TF32 allowed is held to a
    float64 convolution within 1e-5 of scale (TF32's 10-bit mantissa would
    miss it), and the caller's setting holds after it."""
    from pebblesdr_tpu_torch.ops import fir
    rng = np.random.default_rng(0)
    c, n = 4, 8192
    x = (rng.standard_normal((c, n))
         + 1j * rng.standard_normal((c, n))).astype(np.complex64)
    taps = rng.standard_normal(31).astype(np.float32)
    want = np.stack([np.convolve(r.astype(np.complex128),
                                 taps.astype(np.float64))[:n] for r in x])
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y, _ = fir.fir_apply(torch.from_numpy(x).cuda(), taps,
                             torch.zeros(c, 30, dtype=torch.complex64,
                                         device="cuda"))
        kept = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    err = float(np.abs(y.cpu().numpy() - want).max() / np.abs(want).max())
    log(f"phase0 fir_apply conv1d with cuDNN TF32 allowed: {err:.3g} of "
        f"scale from float64 (<= 1e-5), caller's setting kept {kept}")
    if not (err <= 1e-5 and kept):
        raise RuntimeError("convolutions must run in IEEE float32 (no TF32)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.demod import wfm as wfm_mod
    from pebblesdr_tpu_torch.kernels import build
    from pebblesdr_tpu_torch.ops import (agc, decimator, front, kprobe,
                                         pll, scanops, wfm_tail)
    from pebblesdr_tpu_torch.tools import kbench2
    from pebblesdr_tpu_torch.utils import convert, roofline
    DemodMode = receiver.DemodMode

    # phase 0
    log(f"phase0 python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmuls must run in IEEE float32 (no TF32)")
    conv_ieee(torch)

    # phase 1: one nvcc per source, all started together
    t0 = time.perf_counter()
    clock = Clock(t0)
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    log(f"phase1 built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} "
        f"s (" + ", ".join(f"{nm} {build.build_seconds.get(nm, 0.0):.1f} s"
                           for nm in KERNELS) + ")")

    clock("phases 0-1")
    fr = phase_front(torch, front, decimator)
    clock("phase 2")
    phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.AM)
    clock("phase 3")
    head = phase_headline(torch, receiver, front, wfm_tail, DemodMode.AM)
    clock("phase 4")
    times = phase_front_time(torch, front, fr)
    clock("phase 5")
    fw = phase_front_wfm(torch, front, decimator)
    clock("phase 6")
    tl = phase_tail(torch, wfm_mod, wfm_tail)
    clock("phase 7")
    phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.FMS)
    clock("phase 8")
    whead = phase_headline(torch, receiver, front, wfm_tail, DemodMode.FMS)
    clock("phase 9")
    phase_separation(torch, receiver, DemodMode)
    clock("phase 10")
    wtimes = phase_wfm_time(torch, front, wfm_tail, fw, tl)
    clock("phase 11")
    phase_front_options(torch, front, fr, fw)
    clock("phase 12")
    for entry in ("nb1_iq", "i16", "folded"):
        phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.AM,
                    entry)
    clock("phase 13")
    cells = phase_cells(torch, receiver, front, wfm_tail, DemodMode)
    clock("phase 14")
    otimes = phase_options_time(torch, front, fr)
    clock("phase 15")
    hq_fr = phase_front_hq(torch, front, decimator, wfm_mod)
    clock("phase 16")
    phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.FMS,
                rx_opts=dict(wfm_hq=True), tag="phase17 hq slice")
    clock("phase 17")
    for opts, tag in ((dict(rds=True), "phase18 RDS slice"),
                      (dict(rds=True, wfm_hq=True), "phase18 hq+RDS slice")):
        phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.FMS,
                    rx_opts=opts, tag=tag)
    clock("phase 18")
    phase_rds_decode(torch, receiver, DemodMode)
    clock("phase 19")
    phase_separation(torch, receiver, DemodMode, hq=True)
    clock("phase 20")
    wcells = phase_wfm_cells(torch, receiver, front, wfm_tail, DemodMode)
    clock("phase 21")
    probes = phase_probes(torch, front, kprobe, kbench2, receiver, DemodMode)
    clock("phase 22")
    means = phase_means(torch, front)
    clock("phase 23")
    scans = phase_dc_scan(torch, front)
    clock("phase 24")
    narrow = phase_front_narrow(torch, front, decimator)
    clock("phase 25")
    slices = {}
    for name, opts, entry in NARROW_SLICES:
        tag = " ".join([name] + list(opts.values()) + [entry or ""]).strip()
        slices[tag] = phase_slice(torch, receiver, convert, front, wfm_tail,
                                  DemodMode[name], entry, rx_opts=opts,
                                  tag=f"phase26 {tag} slice")
    clock("phase 26")
    ncells = phase_narrow_cells(torch, receiver, front, wfm_tail, DemodMode)
    clock("phase 27")
    for tag, name, opts, entry in NEW_SLICES:
        phase_slice(torch, receiver, convert, front, wfm_tail,
                    DemodMode[name], entry, rx_opts=opts,
                    tag=f"phase28 {tag} slice")
    clock("phase 28")
    phase_new_cells(torch, receiver, front, wfm_tail, DemodMode)
    clock("phase 29")
    loops = phase_loops(torch, front, wfm_tail)
    clock("phase 30")
    lcells = phase_loop_cells(torch, receiver, convert, front, wfm_tail,
                              DemodMode, loops["steps_ns"])
    clock("phase 31")
    k5 = phase_iq_lms(torch, front, wfm_tail)
    clock("phase 32")
    for tag, name, opts, entry in STAGED_SLICES:
        phase_slice(torch, receiver, convert, front, wfm_tail,
                    DemodMode[name], entry, rx_opts=opts, imbalance=True,
                    tag=f"phase33 {tag} slice")
    phase_bank_slice(torch, convert, front, wfm_tail)
    clock("phase 33")
    scells = phase_staged_cells(torch, receiver, front, wfm_tail, decimator)
    clock("phase 34")

    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    t = n * k
    # no single PyTorch call computes DC + mix + decimating FIR, or demux +
    # decimating low-pass: library_ms is null for both kernels
    log(json.dumps({"kernels": [
        {"name": "fused_front", "route": "cuda", "source": front.SOURCE,
         "replaces": front.REPLACES, "launches": head["launches"][0],
         "max_abs_err": fr["max_abs_err"], "ms": times["ms"],
         "plain_ms": times["plain_ms"],
         **roofline.k1_bound(fr["plan"], t, c, 4, n, 2048),
         "library_ms": None},
        {"name": "fused_front (WFM form: disc_gain, y_tail_rows)",
         "route": "cuda", "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:352",
         "launches": whead["launches"][0], "max_abs_err": fw["max_abs_err"],
         "ms": wtimes["k1"][0], "plain_ms": wtimes["k1"][1],
         **roofline.k1_bound(fw["plan"], t, c, 4, n, 2048, disc=True,
                             y_tail_rows=fw["zt"]), "library_ms": None},
        {"name": "wfm_tail", "route": "cuda", "source": wfm_tail.SOURCE,
         "replaces": wfm_tail.REPLACES, "launches": whead["launches"][1],
         "max_abs_err": tl["max_abs_err"], "ms": wtimes["k2"][0],
         "plain_ms": wtimes["k2"][1],
         **roofline.k2_bound(tl["plan"], t // fw["plan"].factor, c),
         "library_ms": None},
        # K1's first pass alone: launches from the headline AM run (one per
        # K1 call), times and bound at am_64ch's shape (phase 23), the
        # error the largest of the four cells'
        # K1's FIR pass alone: launches from the headline AM run (one per
        # K1 call), its device time per launch, plain version and bound at
        # am_64ch's shape (phase 15), the error of y there
        {"name": "front_fir (K1's DC removal, mix and FIR: time march)",
         "route": "cuda", "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:315",
         "launches": head["launches"][0],
         "max_abs_err": otimes["am_64ch"]["max_abs_err"],
         "ms": otimes["am_64ch"]["fir_ms"],
         "plain_ms": otimes["am_64ch"]["fir_plain_ms"],
         **otimes["am_64ch"]["fir_bound"], "library_ms": None},
        {"name": "front_means (chunk means + raw tails)", "route": "cuda",
         "source": front.SOURCE, "replaces": front.MEANS_REPLACES,
         "launches": head["launches"][2],
         "max_abs_err": max(v["max_abs_err"] for v in means.values()),
         **{key: means["am_64ch"][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ] + [
        # one entry per option form, each from its own cell
        {"name": f"fused_front ({form})", "route": "cuda",
         "source": front.SOURCE,
         "replaces": f"pebblesdr_tpu/ops/pallas_kernels.py:{lines}",
         "launches": cells[cell]["launches"][0],
         **{key: otimes[cell][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for form, lines, cell in (
            ("IQ balance + noise blanker NB1", "212, :218", "am_nb_64ch"),
            ("int16 entry", "181", "am_i16_256ch"))
    ] + [
        # the hq form at wfm_hq_64ch: no single PyTorch call computes the
        # front end and the composite decimation either
        {"name": "fused_front (hq form: comp_taps)", "route": "cuda",
         "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:362",
         "launches": wcells["wfm_hq_64ch"]["launches"][0],
         **{key: hq_fr[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        # K1e's one pass over y alone: launches from the wfm_hq_64ch cell
        # (phase 21), its device time per launch, plain version, bound and
        # the error of disc and comp_hist' at that shape (phase 16)
        {"name": "front_comp (K1e, hq form: discriminator, decimation by 2, "
                 "comp_hist', dlast, y-tails in one pass over y)",
         "route": "cuda", "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:362",
         "launches": wcells["wfm_hq_64ch"]["launches"][4],
         **{key: hq_fr["comp"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
        # K1's chunk EWMA alone: launches from the headline AM run (one per
        # K1 call), its device time per launch, plain version, bound and
        # error at am_64ch's shape (phase 24)
        {"name": "front_dc_scan (K1's chunk EWMA)", "route": "cuda",
         "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:198",
         "launches": head["launches"][3],
         **{key: scans["am_64ch"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
    ] + [
        # front_fir's 4-channel geometry, one entry per form: launches from
        # the receiver run that takes it (the USB plan in float32: the
        # usb_64ch cell, phase 27; in int16 and with NB1 + IQ, and the
        # NONE plan: their phase 26 slices), its device time per launch,
        # its plain version and bound and the error of y at the headline
        # width (phase 25)
        {"name": f"front_fir ({form}: 4-channel items)", "route": "cuda",
         "source": front.SOURCE,
         "replaces": "pebblesdr_tpu/ops/pallas_kernels.py:315",
         "launches": launches, "max_abs_err": narrow[form]["max_abs_err"],
         "ms": narrow[form]["fir_ms"],
         "plain_ms": narrow[form]["fir_plain_ms"],
         **narrow[form]["fir_bound"], "library_ms": None}
        for form, launches in (
            ("USB plan float32", ncells["usb_64ch"]["launches"][0]),
            ("USB plan int16", slices["USB i16"]),
            ("USB plan NB1 + IQ", slices["USB nb1_iq"]),
            ("NONE plan float32", slices["NONE"]))
    ] + [
        # the K1 probes: the launches of the bench's full table (phase 22),
        # the times at its shape (the packed floor at am_64ch's)
        {"name": name, "route": "cuda", "source": kprobe.SOURCE,
         "replaces": kprobe.REPLACES[key if isinstance(key, str) else key[0]],
         **{k: probes[key][k] for k in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for key, name in (
            ("floor", "probe_floor_copy (two planes, sub 2048)"),
            ("floor128", "probe_floor_copy (packed plane, sub 2048; timed "
                         "at am_64ch's [1048576 x 128], checked there and at "
                         "the bench's shape, launches in the bench)"),
            (("v1", 1), "probe_toeplitz v1 (two planes, two products; "
                        "3xTF32 wgmma)"),
            (("v2", 1), "probe_toeplitz v2 (two planes, one product; 3xTF32 "
                        "wgmma)"),
            (("v3", 1), "probe_toeplitz v3 (packed plane; 3xTF32 wgmma)"),
            (("v4", 1), "probe_toeplitz v4 (packed A/B tables; 3xTF32 "
                        "wgmma)"),
            (("v5", 2), "probe_toeplitz v5 (K-tiled, kt 2; 3xTF32 mma.sync)"),
            (("v5", 4), "probe_toeplitz v5 (K-tiled, kt 4; 3xTF32 "
                        "mma.sync)"))
    ] + [
        # the recurrences (csrc/recur.cu; no Pallas kernel: each replaces a
        # per-sample lax.scan).  pll_scan on the receivers' paths: launches
        # from the timed cell (phase 31), times and error at the inputs a
        # dispatch gave it; the module options (phase 30): launches from
        # one call of the entry point, times at its shape (cross and pilot
        # on the first LOOP_PREFIX steps of the composite).  The bound is
        # the larger of the bytes over 3.35 TB/s and the serial floor
        # (steps x the chain probe's step latency); no PyTorch call
        # computes a recurrence: library_ms null
        {"name": name, "route": "cuda", "source": pll.SOURCE,
         "replaces": replaces, "launches": launches,
         **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
         "library_ms": None}
        for name, replaces, launches, r in (
            ("pll_scan atan2 (SAM on 64-sample blocks: sam_short_64ch, "
             f"{lcells['sam_short_64ch']['k3']['shape']})",
             pll.REPLACES["pll_scan"],
             lcells["sam_short_64ch"]["launches"][5],
             lcells["sam_short_64ch"]["k3"]),
            ("pll_scan costas (the scan RDS carrier: wfm_rds_scan_64ch, "
             f"{lcells['wfm_rds_scan_64ch']['k3']['shape']})",
             pll.REPLACES["pll_scan"],
             lcells["wfm_rds_scan_64ch"]["launches"][5],
             lcells["wfm_rds_scan_64ch"]["k3"]),
            (f"pll_scan atan2 (NFM 'pll', {loops['atan2 nfm']['shape']})",
             pll.REPLACES["pll_scan"], loops["atan2 nfm"]["launches"],
             loops["atan2 nfm"]),
            (f"pll_scan cross (timed at {loops['cross']['shape']}, the "
             f"first {LOOP_PREFIX} steps of {loops['cross']['full_shape']})",
             pll.REPLACES["pll_scan"], loops["cross"]["launches"],
             loops["cross"]),
            (f"pll_scan pilot (timed at {loops['pilot']['shape']}, the "
             f"first {LOOP_PREFIX} steps of {loops['pilot']['full_shape']})",
             pll.REPLACES["pll_scan"], loops["pilot"]["launches"],
             loops["pilot"]),
            (f"pll_chunk_scan (SAM smooth='loop', {loops['chunk']['shape']} "
             f"chunk phasors)", pll.REPLACES["pll_chunk_scan"],
             loops["chunk"]["launches"], loops["chunk"]),
            (f"agc_scan long (hang; {loops['agc long']['shape']})",
             agc.REPLACES, loops["agc long"]["launches"], loops["agc long"]),
            (f"agc_scan med ({loops['agc med']['shape']})", agc.REPLACES,
             loops["agc med"]["launches"], loops["agc med"]))
    ] + [
        # K5 (csrc/recur.cu; replaces auto_iq_balance's lax.scan): launches
        # from the am_iqauto_64ch cell (phase 34), times, error and bound
        # at its [64, 1048576] stream (phase 32); no PyTorch call computes
        # the recurrence: library_ms null
        {"name": f"iq_lms_scan (adaptive IQ balance: am_iqauto_64ch, "
                 f"{k5['shape']})", "route": "cuda",
         "source": scanops.SOURCE, "replaces": scanops.REPLACES,
         "launches": scells["am_iqauto_64ch"]["launches"][6],
         **{key: k5[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
