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
     its plain version on the inputs that call gave it (K3 and K3c bit for
     bit, K4 within 1e-5) and timed against it, with its per-launch device
     time and its bound (the bytes, or the serial floor from the chain
     probe fed from memory, printed beside the register-only probe's):
     pll_scan atan2 (NFM "pll", [64, 32768] at 64 ksps, the tone SNR
     held), cross and pilot (the composite's [64, 131072], held and timed
     on its first 8192 steps; the loop locked), pll_chunk_scan (SAM smooth
     "loop", [64, 4096] chunk phasors, the tone SNR held; and its pilot
     form on the same phasors) and agc_scan ([64, 2048] at stride 16,
     "long" and "med": per launch and per call, one launch and one kernel
     in a call's trace);
 31. the receivers that run the per-sample loop on the card against the
     CPU (4 channels: FMS with the scan RDS carrier, a dispatch of 3
     32768-frame blocks; SAM on 64-sample blocks, 2048 frames, dispatches
     of 3 then 9), pll_scan once per dispatch; "PEBBLES " decoded with the
     scan carrier; the timed cells wfm_rds_scan_64ch (wfm_rds_64ch with
     rds_alg="scan") and sam_short_64ch (SAM, 64 channels, 128 blocks of
     2048 frames), windows interleaved, with their launch counts, tone
     SNR and dispatch profiles (device busy a dispatch); then pll_scan at
     each cell's own inputs held to its plain version bit for bit and
     timed, per launch beside its bound;
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
     (decimator.apply), timed, and its share of device busy;
 35. the stereo tail without K2 on the card against the CPU (K2 never
     launched; pilot locked and separation >= 30 dB on an L-only program
     in each): FMS at 2.88 Msps (4 channels, a dispatch of 3 blocks of
     32768 frames: audio_decim 5, tail_sub == 0, K1's base form), FMS on
     the staged front (enable_iq_balance="auto", K5), and a module-level
     WFMConfig(pilot_alg="pll") with the pilot notch (the bandpass biquad,
     K3c once per call); then the timed cell wfm_2m88_64ch (FMS, 64
     channels, 2.88 Msps, 32 blocks of 32768 frames, bench.py's wfm
     program at 250 kHz made as one continuous dispatch) with its launch
     counts, tone SNR, peak memory and profile;
 36. the port's command-line receiver (serve/cli.py) on the card, in
     process, each run under torch.profiler: synthetic USB and an AM --wav
     (the written WAV's tone SNR >= 40 dB), a 2.048 Msps FMS --wav with
     --rds ("PEBBLES " decoded; wfm_tail_march in the trace), a 2.88 Msps
     FMS --wav (no wfm_tail_march; separation from the WAV >= 30 dB) and
     --stations through the bank (its staged front: no K1); front_fir in
     the traces of the first four; each run's realtime factor printed;
 37. K6 (csrc/recur.cu ook_scan, the OOK detector) at [64, 2048] frames in
     each of the six threshold modes and K7 (sweep_scan, the test
     generator's sweep) at 32768 samples in each mode with and without
     pulses (100 -> 2000 Hz at 48 kHz, where a float64 recurrence wraps on
     other samples) and at +-100 kHz / 512 kHz, each through its entry
     point (one launch per call) and held to its plain version: K6's marks
     equal and state within 1e-6 of scale on powers whose decision margins
     are asserted, K7's samples within 1e-5 and wrap samples equal; timed,
     per launch and per call, with the chain probe's ns per step and each
     bound (K6's from the probe fed from memory, beside the register-only
     probe's); one kernel in a K6 call's trace;
 38. the TestBench on the card (an AM Receiver with taps=True: the staged
     front): a -40 dB tone read at -40 +- 1 dB on the raw_iq tap, -60 dB
     noise, the four taps flowing; a pulsed sweep injected on the card and
     the CPU (K7 once per block, taps and audio within 2e-4); K7 held and
     timed at the arguments the TestBench gave it;
 39. the CLI's --decode on the card, each run under torch.profiler: cw on
     the synthetic Morse source ("cq..."; ook_scan launched and in the
     trace), dtmf on tests/test_cli.py's recording ("911"), wwv (its
     decoded_time reported);
 40. the timed cell cw_taps_64ch (CWU, 64 channels, 32 blocks of 32768
     frames, taps=True: 64 keyed CW signals 30 kHz apart, MorseModem on
     every channel's post_bp tap every dispatch, 64 host decoders): 7
     dispatches in a row decode "cq" on every channel, then windows timed
     with the launch counts (K1 and K5 never, K6 once per dispatch), peak
     memory and a profile of the dispatches' device part; K6 held and
     timed at the inputs a dispatch gave it (goertzel_power's [C, F, 3]
     columns, read where they lie), its device ms per launch read from
     the OokStep kernel's records, one kernel in a call's trace, and its
     per-call ms printed beside the dispatch's ms and host enqueue;
 41. K8 (csrc/recur.cu anf_scan, the ANF's block LMS) through its entry
     point scanops.anf on complex [64, N] (128 rows) at the staged front's
     U = 16 ([64, 32768], 2048 updates, three calls carrying the state),
     the batched graph's U = 1024 and U = 1 ([64, 2048]), the form that
     ran logged (the chain form at U = 16 and 1, the wide form at 1024):
     one launch per call, y and w' within 1e-5 of their scale of
     anf_plain, the history equal; timed with its per-launch device time,
     the plain version, the chain probe's ns per update and the bound;
 42. am_anf_long_64ch re-timed with K8 (U = 1024) and the new cell
     am_iqauto_anf_64ch (am_iqauto_64ch with enable_anf=True: the staged
     front, K5, K8 at U = 16), each alone, with launch counts, the ANF
     adapted, the tone SNR printed and a profile (kernels per dispatch,
     host enqueue, device busy); then am_iqauto_anf_64ch with anf_plain in
     K8's place, one window;
 43. checkpoint/resume on the card: am_iqauto_anf_64ch's receiver saved
     after dispatch 3 into a file (utils/checkpoint.py), restored into a
     fresh Receiver: dispatches 4-6 and the final state equal to the
     uninterrupted run's bit for bit;
 44. the port's soak (pebblesdr_tpu_torch/tools/soak.py): WFM stereo +
     RDS, 64 channels, 32 blocks a dispatch, 60 s: no bad dispatch, RDS
     synced, PS "PEBBLES ", its sustained Msps;
 45. the CLI on the card with --checkpoint and --checkpoint-every 4
     ("health" in its JSON), then --resume from the file;
 46. the host runtime built from pebblesdr_tpu_torch/csrc/ring.cpp (g++,
     no -march=native) into build/kernels/, its path printed; a NativeRing
     round trip with an overrun counted; the native decode_iq_planes and
     deint_iq_planes_i16 bit-equal to numpy, and core.iqformat.decode_iq
     on a CUDA tensor bit-equal to decode_iq_host, every format;
 47. rtl_tcp at full width: `python -m pebblesdr_tpu_torch.serve.server
     --source file` (a subprocess pacing an AM recording in real time)
     feeds the CLI in this process under torch.profiler (--source rtl_tcp,
     64 channels, 32 blocks of 32768 frames, 4 dispatches, --audio-out
     pipe:dd): front_fir in the trace, K1 once per dispatch (and once
     for the CLI's warm-up dispatch before it opens a network source),
     the piped PCM's tone SNR >= 40 dB, every dispatch after the first
     doing its work in under its 512 ms of signal, the paced sink's
     overruns 0; then an unpaced run (an in-process RtlTcpServer, 8
     dispatches), every pass after the first, read included, under 512
     ms, with its realtime factor and per-dispatch split (read and
     decode, plane build, copy, step, the whole pass);
 48. FM stereo with --rds over rtl_tcp at full width: K1's WFM form and K2
     launched once per dispatch (and the warm-up) and in the trace,
     "PEBBLES " decoded;
 49. SDR-IP at full width through the native UDP pump, paced by the
     server subprocess: datagrams received (+ counted gaps) = sent, none
     dropped, restarted or overrun (blocks that find no ring slot at the
     stop counted in the pump's 'discarded', logged), each pass's work
     under 512 ms, tone SNR >= 40 dB; HPSDR with --bandscope --display waterfall
     (bandscope_frames > 0), a ghpsdr3 loopback round trip, and
     AudioIqSource over a WavStream into the Receiver on the card (tone
     SNR >= 40 dB);
 50. the control surface on the card through the CLI (64 channels,
     --display spectrum, --keys): a retune moves the demodulated tone, 'p'
     snaps to a carrier within one display bin, 'm' rebuilds the chain as
     FM stereo on cuda (K2 in the trace), 'q' ends the run;
 51. the mode experts (parallel/expert.py) at full width: one 2.048 Msps
     capture of 64 stations 30 kHz apart (32 AM, 16 USB, 16 FMN), N 32768,
     K 32, through ModeExpertChannelizer.step_many: each expert within
     1e-5 of its mode's single-mode Receiver on the same rows, the AM and
     USB tones >= 40 dB, K1 launched experts x dispatches, event windows,
     the dispatches' profile and the kernels by name; K1 at the AM
     expert's shape against its plain version, both timed;
 52. the CLI's --assign on the card (AM, USB, FMN, AM experts on one AM
     station): the per-channel WAVs' tone SNR >= 40 dB, K1 once per expert
     per dispatch;
 53. the sharded receiver: a world of 4 ranks (this script with
     --shard-rank, channel 2 x time 2) on the one card over gloo, the
     payloads hopping through the host (counted); am_64ch's geometry with
     the fused front: K1 per time shard (each rank's wrapper counters),
     its dc seeded and its history received, one call held to its plain
     version; the audio within 2e-3 of the unsharded step_many on the
     card; host hops and bytes per block beside halo_accounting; then a
     one-rank NCCL world on the same step; K1 at a shard's shape timed;
 54. in the same world: pfb_shard (2 x 2), dist_fft (1 x 4) and the
     4-stage pipeline, each against its unsharded counterpart on the card.
     Four ranks on one card measure correctness and host hops, not
     scaling;
 55. the main path against the independent float64 golden at full width
     (pebblesdr_tpu_torch/tools/parity_harness.py, the port of
     tools/parity_harness.py): for AM, USB, LSB, FMN, SAM, FMM and FMS one
     2.048 Msps capture of two dispatches holding tests/test_parity.py's
     signal at four carriers within +-750 kHz, 64 channels tuned channel c
     to carrier c % 4, run through Receiver.step_many (K = 32, N = 32768)
     and Receiver.step; every channel of both paths at or above its mode's
     threshold (AM, USB, LSB, FMN 60 dB, SAM 55, FMS 70 on the left
     channel with the golden's own separation > 30 dB, FMM the JAX chain's
     least SNR less 3 dB) against its carrier's golden, no channel reading
     another carrier (tone phasors), K1 launched per dispatch and per
     step, K2 likewise for FMS; min, median and max SNR per mode and path,
     the goldens' host seconds; then `python -m
     pebblesdr_tpu_torch.tools.parity_harness` on its fixture at 64
     channels, K = 32, batched, which must exit 0;
 56. the port's examples 01-05 (pebblesdr_tpu_torch/examples/) on the
     card, each outcome checked: the written audio and the S-meter, the
     channels on a station, pilot lock and the PS name "TPU FM  ", the
     bank's stations, the DTMF digits "2468" and the CTCSS open;
 57. the JAX suite's impairment and robustness bounds at full width
     (pebblesdr_tpu_torch/tools/quality.py, the port of bench.py
     bench_quality; tests/test_impairments.py, tests/test_robustness.py):
     64 channels at 2.048 Msps, N = 32768, K = 32, each channel its own
     columns, every channel checked: stereo clean (>= 30 dB) and through a
     15 us / -10 dB two-ray channel (> 15 dB, L tone > 0.5), hq (>= 40 dB),
     the RDS BLER curve at 12-20 dB (zero and "PEBBLES " on every 20 dB
     channel, the pooled curve weakly non-increasing), AM beside a -20 dB
     neighbour and a -50 dB CW spur (< 1 dB loss over the JAX test's 12
     blocks; 16 and 32 printed), three FM stations in one
     capture (own tone > 0.25, ten times any other), 128 AM blocks (finite,
     phase in [0, 1), level steady to 1 %), the display offset (+10.0 +-
     0.1 dB, SNR +- 0.2) and the AGC hang (< 3 dB on 64 rows, K4's
     launches counted); channels of each capture held to the CPU port
     with the slice bounds; then the card's quality row at 64 channels
     (the tool's Receiver captures, the AGC hangs above).
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


def wfm_plane(channels: int, n_rows: int, rng, noise: float = 0.0,
              program: str = "mono", t0: float = 0.0, fs: int = FS):
    """[n_rows, 2C] float32 packed plane: broadcast FM at 250 kHz on every
    channel of an fs capture.  "mono": bench.py's wfm signal (1 kHz on L
    and R, pilot); "left": the L-only 700 Hz program of bench.py's quality
    row; "rds": 1 kHz mono, pilot and the RDS PS groups on 57 kHz.  t0:
    start time."""
    from pebblesdr_tpu_torch.tools import soak
    t = t0 + np.arange(n_rows) / fs
    th = 2 * np.pi * 19000.0 * t
    if program == "mono":
        comp = 0.45 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
    elif program == "rds":
        comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * np.sin(th)
                + 0.06 * soak.rds_biphase(t) * np.cos(3 * th))
    else:
        lt = np.sin(2 * np.pi * 700.0 * t)
        comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / fs
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    plane = np.concatenate([np.repeat(iq.real[:, None], channels, 1),
                            np.repeat(iq.imag[:, None], channels, 1)], axis=1)
    if noise:
        plane = plane + noise * rng.standard_normal(plane.shape)
    return plane.astype(np.float32)


def reset_launches(front, wfm_tail) -> None:
    from pebblesdr_tpu_torch.core import siggen
    from pebblesdr_tpu_torch.ops import agc, goertzel, pll, scanops
    goertzel.ook_detect.launches = 0
    siggen.sweep.launches = 0
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
    scanops.anf_scan.launches = 0


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
                warm: int = 1, imbalance: bool = False, fs: int = FS,
                blocks: tuple | None = None,
                separation: bool = False) -> int:
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
    threshold margin.  Phase 35 (the stereo tail without K2: K2 never
    launched): fs the capture's rate, blocks the compared dispatches'
    blocks, separation: the pilot locked on every block of the last
    dispatch and the card's stereo separation of the L-only program there
    (channel 0) >= SEPARATION_DB."""
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
    dispatches = blocks or dispatches
    if entry == "folded":
        c = 2
    opts = (dict(enable_noise_blanker=True, enable_iq_balance=True)
            if entry == "nb1_iq" else {})
    cfg = receiver.ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
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
            x = wfm_plane(c, rows, rng, 1e-2, t0=t0[0], fs=fs, program=(
                "rds" if use_rds else "left" if stereo else "mono"))
        elif mode.name == "FMN":
            x = nfm_plane(c, rows, rng, 1e-2, t0=t0[0],
                          tones=(CTCSS_TONE, CTCSS_TONE, CTCSS_NEIGHBOUR,
                                 CTCSS_NEIGHBOUR))
        else:
            x = am_plane(c, rows, rng, 1e-2)
        t0[0] += rows / fs
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
                    scanops.auto_iq_balance.launches,
                    scanops.anf_scan.launches)
        k1_launches += launches[0]
        fused = 0 if rx_gpu.staged else 1
        k2 = int(rx_gpu.wfm_tail is not None)
        if launches != (fused, k2, fused, 1 if loop else 0,
                        int(cfg.enable_iq_balance == "auto"),
                        int(cfg.enable_anf)):
            raise RuntimeError(f"{tag}: launches (K1, K2, front_means, "
                               f"pll_scan, iq_lms_scan, anf_scan) = "
                               f"{launches}")
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
    if separation:
        check_separation(out_g["audio"][:, 0], out_g["pilot_locked"][:, 0],
                         cfg.audio_rate, tag)
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
              checks: dict | None = None, frames: int | None = None,
              fs: int = FS):
    """One timed cell: a receiver on the card and its dispatch plane (one
    bench signal block repeated, as float32, int16 or folded by 4).  tone =
    (offset Hz, amplitude, audio Hz, audio amplitude): the block is that
    tone above the 250 kHz carrier instead, and the cell's audio is held to
    that frequency and amplitude (within 10 %).  plane: a function
    (channels, rows) giving the whole dispatch's plane instead (a signal
    whose period is not a block).  checks: "snr_band" (lo, hi) Hz of the
    tone SNR's residual, "snr" False to print the SNR unchecked, "ctcss"
    True to require ctcss_open on every channel, "anf" True to require
    the ANF's max |w| > 1e-3, "skip_blocks" the leading blocks of the last
    dispatch left out of the tone SNR.  frames: the block length (default the
    headline's); fs: the capture's rate."""
    n = frames or HEADLINE["frames"]
    opts = opts or {}
    wfm = mode.name == "FMS" and opts.get("stereo", True)   # stereo
    cfg = receiver.ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                  channels=channels, mode=mode,
                                  agc_stride=HEADLINE["agc_stride"], **opts)
    rx = receiver.Receiver(cfg, "cuda")
    fm = mode.name in ("FMS", "FMM")
    if plane is not None:
        iq = torch.from_numpy(plane(channels, blocks * n)).cuda()
    else:
        block = (tone_plane(channels, n, *tone[:2]) if tone else
                 wfm_plane(channels, n, None, fs=fs) if fm else
                 am_plane(channels, n, None))
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
            "out": None, "i": 0, "launches": [0] * 8,
            "windows": [], "checks": checks or {}, "frames": n, "fs": fs}


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
        cell["launches"][7] += scanops.anf_scan.launches

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
        k2 = n_dispatch if getattr(cell["rx"], "wfm_tail", None) else 0
        if launches != (fused, k2, fused, scans * fused,
                        k2 if cell["cfg"].wfm_hq else 0,
                        n_dispatch if loop else 0,
                        n_dispatch if auto else 0,
                        n_dispatch if cell["cfg"].enable_anf else 0):
            raise RuntimeError(f"{tag} {cell['name']}: launches (K1, K2, "
                               f"front_means, front_dc_scan, front_comp, "
                               f"pll_scan, iq_lms_scan, anf_scan) "
                               f"{launches} for {n_dispatch} dispatches")
        windows = cell["windows"]
        best = min(windows)                               # ms per dispatch
        cell.update(block_ms=best / k, msps=c * n * k / (best / 1e3) / 1e6,
                    realtime=n * k / (best / 1e3) / cell.get("fs", FS),
                    peak_gib=peak)
        log(f"{tag} {cell['name']} {c}ch x {n} x {k}: dispatch ms per "
            f"window " + " ".join(f"{w:.4f}" for w in windows)
            + f"; block {cell['block_ms']:.5f} ms, {cell['msps']:.1f} Msps "
            f"per GPU, {cell['realtime']:.1f}x realtime per channel, window "
            f"spread {max(windows) / best:.3f}; K1 launches {launches[0]}, "
            f"K2 launches {launches[1]}, front_means launches {launches[2]}, "
            f"front_dc_scan launches {launches[3]}, front_comp launches "
            f"{launches[4]}, pll_scan launches {launches[5]}, iq_lms_scan "
            f"launches {launches[6]}, anf_scan launches {launches[7]} for "
            f"{n_dispatch} dispatches "
            f"({launches[0] / n_dispatch:g} K1 per dispatch); peak device "
            f"memory {peak:.3f} GiB" + (" (cells timed together)"
                                        if len(cells) > 1 else ""))
        out = cell["out"]
        audio = out["audio"]
        # WFM: left and right
        shape = ((k, c, 2) if wfm else (k, c)) + (cell["rx"].audio_blk,)
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
        tone = tone[checks.get("skip_blocks", 0):]
        tone = tone.reshape(-1).double().cpu().numpy()
        f0, want = (cell["tone"][2:] if cell["tone"] else (1000.0, None))
        wcfg = cell["rx"].wfm_cfg
        if wcfg is not None:
            # each block's audio spans blk // audio_decim tail samples of
            # its blk (4095 of 4096 at 2.88 Msps: one composite sample
            # dropped a block, as the JAX package's per-block path does):
            # the tone plays that much faster
            blk = cell["rx"].wfm_tail_blk
            f0 *= blk / (wcfg.audio_decim * (blk // wcfg.audio_decim))
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
                                                              hist), reps,
                           want=("wfm_tail_march",))
    # one kernel, at most once a call (the profiler may lose a record,
    # never add one)
    if len(k2_launch) != 1 or not 0 < next(iter(k2_launch.values()))[1] \
            <= reps:
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


def kernel_times(torch, fn, reps: int = 3, want: tuple = (),
                 tries: int = 3) -> dict:
    """{kernel: (device ms per launch, launches recorded)} of each CUDA
    kernel fn launches, over reps calls: the device records of a
    torch.profiler trace (CUDA activity only), read from prof.events() as
    dispatch_profile reads them.  key_averages() is not used: it gives no
    device time to a record it marks asynchronous, and on the H100 it gave
    none at all for some traces of a few launches.  A count below reps
    means records were lost; while no kernel was recorded, or none whose
    name starts with one of the names in want, the calls are traced
    again, up to tries traces; the last trace's records are returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        rows = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if getattr(ev, "device_type", None) != DeviceType.CUDA:
                continue
            m = re.search(r"(front_\w+|wfm_tail_\w+|probe_\w+|recur_\w+)"
                          r"(<[^>]*>)?", ev.name)
            if m:
                tot, n = rows.get(m.group(0), (0.0, 0))
                rows[m.group(0)] = (tot + (ev.time_range.end
                                           - ev.time_range.start) / 1e3,
                                    n + 1)
        if rows and all(any(k.startswith(w) for k in rows) for w in want):
            break
    return {k: (tot / n, n) for k, (tot, n) in rows.items()}


def breakdown_text(times: dict) -> str:
    return ", ".join(f"{k} {ms:.4f} (x{n})" for k, (ms, n) in
                     sorted(times.items(), key=lambda kv: -kv[1][0] * kv[1][1])
                     ) or "none"


def kernel_breakdown(torch, fn, reps: int = 3) -> str:
    """Device time per launch of each CUDA kernel fn launches, with the
    launches the profiler recorded over reps calls (kernel_times)."""
    return breakdown_text(kernel_times(torch, fn, reps))


def launch_ms(times: dict, name: str) -> float:
    """The device ms per launch of the kernel whose name starts with name in
    kernel_times' result (kernel_times(..., want=(name,)) traces again
    while it has none); a RuntimeError naming the kernel if no trace
    recorded it."""
    for k, (ms, _) in times.items():
        if k.startswith(name):
            return ms
    raise RuntimeError(f"torch.profiler recorded no {name} launch in "
                       f"any of its traces")


def fir_launch_ms(times: dict) -> float:
    """front_fir's device ms per launch in kernel_times' result."""
    return launch_ms(times, "front_fir")


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
                          reps=10, want=("front_fir",))
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
                      reps=reps, want=("front_means", "front_dc_scan",
                                       "front_fir", "front_comp"))
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


def dispatch_profile(torch, cell, tag: str, reps: int = 5,
                     dispatch=None) -> dict:
    """One cell's dispatches with spectra off (on where the cell computes
    them every dispatch): timed by CUDA events without the profiler, their
    host enqueue time (no sync inside), then under torch.profiler (CUDA
    activity) for the device busy time per dispatch (the union of its
    kernels' intervals).  Idle share = 1 - busy / event-timed ms; with the
    kernels that take the most device time.  dispatch: a function running
    one dispatch of the cell (default: its Receiver's step_many)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    st = [cell["state"]]
    spectra = cell.get("spectra_every", SPECTRA_EVERY) == 1

    def step():
        st[0], _ = cell["rx"].step_many(st[0], cell["params"], cell["iq"],
                                        spectra=spectra)

    step = dispatch or step

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
            want = {"front_means": planes, "front_dc_scan": planes,
                    "probe_toeplitz": 1}
            kt_times = kernel_times(torch, fns[0], reps=reps,
                                    want=tuple(want))
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
        lt = kernel_times(torch, fns["kernel"], reps=10,
                          want=("front_dc_scan",))
        ms = launch_ms(lt, "front_dc_scan")
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
        lt = kernel_times(torch, kernel, reps=10, want=("front_fir",))
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
    lt = kernel_times(torch, kernel, reps=10, want=("front_fir",))
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
#                       sincosf / atan2f / hypotf); K3 and K3c are held bit
#                       for bit (hold_loop exact=True)
LOOP_PREFIX = 8192    # steps of the composite-rate forms held to (and timed
#                       against) the plain version: its Python loop costs
#                       ~0.3 ms a step on the card
LOOP_FS = 64_000.0    # the narrowband demod rate (AM's plan at 2.048 Msps)
PROBE_STEPS = 32768   # steps of the chain probe (serial floor)
# the forms whose fed probe phase 30 times: K3's detectors, K3c's two forms
# (their chain alone) and K4's two (its loop in one lane)
LOOP_FED = ("atan2", "cross", "costas", "pilot", "chunk", "chunk pilot",
            "agc hang", "agc")
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
              steps: int | None = None, exact: bool = False) -> dict:
    """A recurrence kernel against its plain version on the same inputs
    (args; with steps, the first `steps` columns of args[0] only): the
    plain version once, timed by events (a Python loop of ~20 launches a
    step), the kernel timed over 10 calls, its per-launch device time
    (torch.profiler), and every output compared (the indices in `angles`
    on the circle).  Raises past LOOP_ATOL, or with exact=True unless
    every output and state leaf equals the plain version's bit for bit."""
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
    lt = kernel_times(torch, lambda: kernel(*args), reps=3, want=("recur_",))
    launch = next((v[0] for k, v in lt.items() if k.startswith("recur_")),
                  float("nan"))
    err = 0.0
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        if not a.numel():
            continue
        d = a.double() - b.double()
        if i in angles:
            d = torch.angle(torch.exp(1j * d))
        err = max(err, float(d.abs().max()))
    shape = tuple(args[0].shape)
    equal = all(a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(out_k, out_p))
    log(f"{tag} {name} {shape}: kernel {ms:.4f} ms per call (per launch "
        f"{breakdown_text(lt)}) vs plain {plain_ms:.1f} ms; max |kernel - "
        f"plain| {err:.3g} (<= {LOOP_ATOL}); "
        + ("bit for bit" if equal else "not bit for bit")
        + (" (required)" if exact else ""))
    if not err <= LOOP_ATOL or (exact and not equal):
        raise RuntimeError(f"{tag} {name}: the kernel disagrees with its "
                           f"plain version ({err:.3g}, bit-equal {equal})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "shape": shape, "launch_ms": lt, "launch": launch,
            "bit_equal": equal}


def probe_ns(torch, pll, form: str, steps: int = PROBE_STEPS,
             fed: bool = False) -> float:
    """The serial floor's step latency of one form (ns): the chain probe
    over `steps` steps, timed by events; register-only, or with fed=True
    (pll.FED_FORMS: the register-only probe may fold steps on its constant
    inputs) one lane of the K4 / K6 kernel's own chain loop, or the K3 /
    K3c loop kernel's chain alone, its constants pinned and its inputs
    read from a small pattern in shared memory."""
    pll.chain_probe(form, 256, "cuda", fed=fed)
    ms = time_cuda(torch, lambda: pll.chain_probe(form, steps, "cuda",
                                                  fed=fed), 3)
    return ms * 1e6 / steps


def call_kernels(torch, fn, calls: int = 10, tries: int = 5) -> list:
    """The names of the CUDA device records (kernels, copies and fills) of
    `calls` calls of fn under torch.profiler, traced again while none was
    recorded: the profiler drops records (after the earlier phases'
    profiles it kept 1 of 10, and none in three traces of one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA]
        if names:
            break
    return names


def one_kernel(torch, fn, step: str, tag: str, calls: int = 10) -> str:
    """Asserts that a call of fn puts one device record in a trace: every
    record of `calls` calls is the short-chain kernel of `step` (AgcStep /
    OokStep), at most `calls` of them (the profiler drops records, never
    adds them); returns its name."""
    names = call_kernels(torch, fn, calls)
    if (not names or len(names) > calls
            or any(step not in nm or "recur_short_kernel" not in nm
                   for nm in names)):
        raise RuntimeError(f"{tag}: a trace of {calls} calls holds "
                           f"{sorted(set(names))} x {len(names)}, not one "
                           f"{step} kernel a call")
    return re.sub(r"\(anonymous namespace\)::|^void ", "", names[0])


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
        TONE_SNR_DB; and its pilot form (the WFM "pll" pilot's flag) on
        the same phasors;
      * agc_scan: the scan AGC at am_64ch's demod stream ([64, 32768],
        stride 16: 2048 steps) in the modes "long" (the hang) and "med",
        held whole;
    and each form's serial floor: the chain probe on registers and fed
    from memory (the bound: K3's and K3c's chain alone, K4's loop in one
    lane).  K3 and K3c are held bit for bit, K4 within LOOP_ATOL (its
    levels and state equal where measured).  Returns the kernel entries of
    the JSON line keyed by form."""
    from pebblesdr_tpu_torch.demod import nfm, sam
    from pebblesdr_tpu_torch.ops import agc, pll
    from pebblesdr_tpu_torch.utils import roofline
    c, n, fs = HEADLINE["channels"], HEADLINE["frames"], LOOP_FS
    rng = np.random.default_rng(30)
    steps_ns = {form: probe_ns(torch, pll, form) for form in pll.PROBE_FORMS
                if not form.startswith("anf")}    # K8's: phase 41
    log("phase30 chain probe (ns per step, one thread, registers only): "
        + ", ".join(f"{k} {v:.1f}" for k, v in steps_ns.items()))
    fed_ns = {form: probe_ns(torch, pll, form, fed=True)
              for form in LOOP_FED}
    log("phase30 chain probe fed from memory (ns per step; the bound of K3, "
        "K3c and K4): " + ", ".join(f"{k} {v:.2f} (registers "
                                    f"{steps_ns[k]:.2f})"
                                    for k, v in fed_ns.items()))
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
                  pll.pll_scan_plain, args, (0, 3), "phase30", exact=True)
    res["atan2 nfm"] = dict(h, launches=1, **loop_bound(
        roofline, "pll_scan", h["shape"], fed_ns["atan2"]))

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
                      steps=LOOP_PREFIX, exact=True)
        res[det] = dict(h, launches=1, full_ms=full_ms, full_shape=(c, nc),
                        **loop_bound(roofline, "pll_scan", h["shape"],
                                     fed_ns[det]))

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
                  pll.pll_chunk_scan_plain, args, (0, 3), "phase30",
                  exact=True)
    res["chunk"] = dict(h, launches=1, **loop_bound(
        roofline, "pll_chunk_scan", h["shape"], fed_ns["chunk"]))
    # its pilot form on the same phasors (timed and held; the WFM "pll"
    # pilot drives it through its entry point in phase 35)
    args = args[:4] + (True,) + args[5:]
    h = hold_loop(torch, "pll_chunk_scan pilot", pll.pll_chunk_scan,
                  pll.pll_chunk_scan_plain, args, (0, 3), "phase30",
                  exact=True)
    res["chunk pilot"] = dict(h, **loop_bound(
        roofline, "pll_chunk_scan", h["shape"], fed_ns["chunk pilot"]))

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
        form = "agc hang" if mode == "long" else "agc"
        b = loop_bound(roofline, "agc_scan", h["shape"], fed_ns[form])
        lt = kernel_times(torch, lambda: agc.agc_scan(*args), reps=10,
                          want=("recur_short",))
        launch = launch_ms(lt, "recur_short")
        name = one_kernel(torch, lambda: agc.agc_scan(*args), "AgcStep",
                          f"phase30 agc_scan ({mode})")
        log(f"phase30 agc_scan ({mode}) {h['shape']}: per launch "
            f"{launch:.4f} ms, per call {h['ms']:.4f} ms; 1 launch and one "
            f"kernel in a call's trace ({name}); {b['bound_ms'] / launch:.1%}"
            f" of the {b['bound_ms']:.4f} ms bound per launch (fed probe "
            f"{fed_ns[form]:.2f} ns a step; registers {steps_ns[form]:.2f})")
        res[f"agc {mode}"] = dict(h, launches=1, launch=launch, **b)
    for key, r in res.items():
        per = r.get("launch", r["ms"])
        log(f"phase30 {key}: bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"serial floor {r['serial_ms']:.4f} ms) vs kernel {r['ms']:.4f} "
            f"ms a call, {per:.4f} a launch ({r['bound_ms'] / per:.1%} of "
            f"the bound per launch)")
    res["steps_ns"] = steps_ns
    res["fed_ns"] = fed_ns
    return res


def phase_loop_cells(torch, receiver, convert, front, wfm_tail,
                     DemodMode, fed_ns: dict) -> dict:
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
    its plain version bit for bit and timed, its bound from the chain-only
    probe fed from memory (fed_ns, phase 30)."""
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
                      "phase31", exact=True)
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib",
            "snr_db")}
        done[cell["name"]].update(prof)
        done[cell["name"]]["k3"] = dict(h, **loop_bound(
            roofline, "pll_scan", h["shape"], fed_ns[det]))
        n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
        k3 = done[cell["name"]]["k3"]
        log(f"phase31 {cell['name']}: pll_scan {det} launches "
            f"{cell['launches'][5]} ({cell['launches'][5] / n_dispatch:g} "
            f"per dispatch); {h['ms']:.4f} ms a call, {h['launch']:.4f} a "
            f"launch ({k3['bound_ms'] / h['launch']:.1%} of its "
            f"{k3['bound_ms']:.4f} ms bound) of the dispatch's "
            f"{cell['block_ms'] * cell['blocks']:.4f} ms, device busy "
            f"{prof['busy_ms']:.4f} ms a dispatch")
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
                 ("AM auto anf", "AM", dict(enable_iq_balance="auto",
                                            enable_anf=True), None),
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


def make_iqauto_cell(torch, receiver, front, name: str = "am_iqauto_64ch",
                     opts: dict | None = None, checks: dict | None = None):
    """am_iqauto_64ch: am_64ch's shape and signal (AM, 64 channels, 32
    blocks of 32768 frames, AGC stride 16) with enable_iq_balance="auto",
    the plane through tests/test_chain.py:204-236's IQ imbalance; opts:
    more receiver options (another cell of this signal, `name`)."""
    cell = make_cell(torch, receiver, front, receiver.DemodMode.AM, name,
                     HEADLINE["channels"], HEADLINE["blocks"],
                     opts=dict(enable_iq_balance="auto", **(opts or {})),
                     checks=checks)
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
            "out": None, "i": 0, "launches": [0] * 8, "windows": [],
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


# ---- phases 35-36: the stereo tail without K2, the command-line receiver

FS_288 = 2_880_000    # a common rtl-sdr rate: audio_decim 5, tail_sub == 0
# the stereo slices held card vs CPU: (tag, phase_slice keywords); warm-up
# blocks so the pilot has locked before the compared dispatches
STEREO_SLICES = (
    ("FMS 2.88 Msps", dict(fs=FS_288, frames=32768, blocks=(3,), warm=4)),
    ("FMS staged auto", dict(rx_opts=dict(enable_iq_balance="auto"),
                             imbalance=True, warm=16)),
)
PLL_PILOT = dict(rate=256_000.0, channels=4, n_block=4096, blocks=4,
                 calls=3)
STEREO_CELL = ("wfm_2m88_64ch", 64, 32)      # (name, channels, blocks)


def check_separation(audio, locked, rate: float, tag: str) -> float:
    """audio [K, 2, M] (L, R) of an L-only 700 Hz program, locked [K]: the
    pilot locked on every block, and R's 700 Hz tone >= SEPARATION_DB below
    L's over the whole span."""
    aud = audio.permute(1, 0, 2).reshape(2, -1).double().cpu().numpy()
    amp = [tone_amplitude(a, rate, 700.0) for a in aud]
    sep = 20 * np.log10(amp[0] / max(amp[1], 1e-12))
    ok = bool(locked.all())
    log(f"{tag}: pilot locked on every block {ok}; stereo separation "
        f"{sep:.2f} dB (>= {SEPARATION_DB}; L {amp[0]:.5f}, R {amp[1]:.3g})")
    if not (ok and sep >= SEPARATION_DB):
        raise RuntimeError(f"{tag}: pilot lock or stereo separation failed")
    return sep


def left_only_iq(c: int, n: int, rate: float, t0: float, rng) -> np.ndarray:
    """[C, n] complex64: the L-only 700 Hz program (pilot, L-R on 38 kHz)
    discriminated at rate, channel i at level 0.3 + 0.4 i / C and phase
    pi/4 + i pi/2, complex noise at 1e-2."""
    t = t0 + np.arange(n) / rate
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt / 2 + 0.1 * np.sin(th) + 0.45 * lt / 2 * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / rate
    x = np.stack([(0.3 + 0.4 * i / c) * np.exp(1j * (ph + np.pi / 4
                                                     + i * np.pi / 2))
                  for i in range(c)])
    x = x + 1e-2 * (rng.standard_normal(x.shape)
                    + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def phase_pll_pilot(torch, convert, front, wfm_tail, wfm_mod, pll) -> dict:
    """Phase 35, the "pll" pilot and its notch: demod/wfm.py wfm_demod on a
    module-level WFMConfig(pilot_alg="pll", notch_needed=True) at 256 kHz,
    on the card against the CPU over PLL_PILOT["calls"] streaming calls of
    4 blocks of 4096 (the bandpass biquad, K3c pll_chunk_scan once per
    call, the demux, the stacked low-pass, the notch, de-emphasis): audio
    2e-4, lock equal, state 1e-4 (the loop phase on the circle; the
    carried L-R samples within the stereo tail's 5e-4: the demux reads the
    loop's absolute ramp), then lock and separation on the last call."""
    r = PLL_PILOT
    c, nb, k = r["channels"], r["n_block"], r["blocks"]
    cfg = dataclasses.replace(
        wfm_mod.WFMConfig.make(r["rate"], pilot_alg="pll"), notch_needed=True)
    st_c = wfm_mod.wfm_init(cfg, c, "cpu")
    st_g = wfm_mod.wfm_init(cfg, c, "cuda")
    fields = [f.name for f in dataclasses.fields(st_c)]
    lmr = sum(len(convert.leaves(getattr(st_c, nm)))
              for nm in fields[:fields.index("lp_tail_lmr")])
    rng = np.random.default_rng(35)
    worst = {"audio": 0.0, "state": 0.0, "lmr": 0.0}
    for call in range(r["calls"]):
        x = torch.from_numpy(left_only_iq(c, k * nb, r["rate"],
                                          call * k * nb / r["rate"], rng))
        st_c, out_c = wfm_mod.wfm_demod(cfg, st_c, x, nb)
        reset_launches(front, wfm_tail)
        st_g, out_g = wfm_mod.wfm_demod(cfg, st_g, x.cuda(), nb)
        torch.cuda.synchronize()
        if pll.pll_chunk_scan.launches != 1:
            raise RuntimeError(f"phase35 pll pilot: pll_chunk_scan launched "
                               f"{pll.pll_chunk_scan.launches} times")
        d_audio = max(float((out_g[key].cpu() - out_c[key]).abs().max())
                      for key in ("left", "right"))
        same = bool((out_g["pilot_locked"].cpu()
                     == out_c["pilot_locked"]).all())
        for i, (a, b) in enumerate(zip(convert.state_to_numpy(st_g),
                                       convert.state_to_numpy(st_c))):
            d = np.abs(a.astype(np.complex128) - b.astype(np.complex128))
            d = np.minimum(d, np.abs(d - 2 * np.pi)).max(initial=0.0)
            key = "lmr" if i == lmr else "state"
            worst[key] = max(worst[key], float(d))
        worst["audio"] = max(worst["audio"], d_audio)
        log(f"phase35 pll pilot call {call}: audio {d_audio:.3g} (<= 2e-4), "
            f"lock equal {same}, state {worst['state']:.3g} (<= 1e-4), L-R "
            f"history {worst['lmr']:.3g} (<= 5e-4); pll_chunk_scan launches "
            f"1")
        if not (d_audio <= 2e-4 and same and worst["state"] <= 1e-4
                and worst["lmr"] <= 5e-4):
            raise RuntimeError("phase35 pll pilot: card disagrees with the "
                               "CPU")
    lr = torch.stack([out_g["left"][0], out_g["right"][0]])      # [2, M]
    check_separation(lr[None], out_g["pilot_locked"][0], cfg.audio_rate,
                     "phase35 pll pilot")
    return worst


def phase_stereo_tail(torch, receiver, convert, front, wfm_tail, wfm_mod,
                      pll, DemodMode) -> dict:
    """Phase 35: the stereo tail without K2.  The receivers on the card
    against the CPU (STEREO_SLICES: FMS at 2.88 Msps, 4 channels, 32768
    frames, K = 3, behind K1's base form; FMS on the staged front with
    enable_iq_balance="auto"), K2 never launched, pilot locked and
    separation >= 30 dB; the "pll" pilot with its notch at module level
    (phase_pll_pilot); then the cell wfm_2m88_64ch (FMS, 64 channels, 2.88
    Msps, 32 blocks of 32768 frames, bench.py's wfm program at 250 kHz
    made as one continuous dispatch) timed alone, with its launch counts,
    tone SNR (past the dispatch seam), peak memory and a dispatch
    profile."""
    for tag, kw in STEREO_SLICES:
        phase_slice(torch, receiver, convert, front, wfm_tail, DemodMode.FMS,
                    tag=f"phase35 {tag} slice", separation=True, **kw)
    pll_err = phase_pll_pilot(torch, convert, front, wfm_tail, wfm_mod, pll)
    name, c, k = STEREO_CELL
    # bench.py's wfm program (1 kHz mono, the pilot, 250 kHz) made as one
    # continuous dispatch: at 2.88 Msps a repeated 32768-frame block would
    # jump the pilot's and the tone's phase at every block seam; the seam
    # left at each dispatch's start is kept out of the tone SNR
    cell = make_cell(torch, receiver, front, DemodMode.FMS, name, c, k,
                     fs=FS_288, checks=dict(skip_blocks=4),
                     plane=lambda ch, rows: wfm_plane(ch, rows, None,
                                                      fs=FS_288))
    rx = cell["rx"]
    log(f"phase35 {name}: demod rate {rx.demod_rate}, tail block "
        f"{rx.wfm_tail_blk}, audio_decim {rx.wfm_cfg.audio_decim}, tail_sub "
        f"{rx.wfm_cfg.tail_sub}, {rx.audio_blk} audio samples per block")
    if rx.wfm_tail is not None:
        raise RuntimeError(f"phase35 {name}: expected the tail without K2")
    time_cells(torch, front, wfm_tail, [cell], "phase35")
    prof = dispatch_profile(torch, cell, "phase35")
    done = {key: cell[key] for key in ("launches", "block_ms", "msps",
                                       "realtime", "peak_gib", "snr_db")}
    done.update(prof, pll=pll_err)
    del cell
    torch.cuda.empty_cache()
    return done


CLI_DIR = "build/chip_smoke_cli"


def kernel_names(prof) -> set:
    """The names of the CUDA kernels a torch.profiler run saw."""
    from torch.autograd import DeviceType
    return {ev.name for ev in prof.events()
            if getattr(ev, "device_type", None) == DeviceType.CUDA}


def phase_cli(torch, wav) -> dict:
    """Phase 36: the port's command-line receiver (serve/cli.py main) on
    the card, in this process, with --device cuda, each run under a
    torch.profiler trace: (1) --synthetic tone USB, the written WAV's
    1 kHz tone SNR >= 40 dB; (2) --wav of an AM recording written with the
    port's io/wav.py, --blocks-per-dispatch 8, its tone SNR too; (3) --wav
    of a 2.048 Msps FMS recording with the "PEBBLES " RDS groups, --rds:
    the PS decoded, K2 (wfm_tail_march) in the trace; (4) --wav of a 2.88
    Msps FMS recording of the L-only program (the stereo tail without K2:
    no wfm_tail_march), separation >= 30 dB from the WAV; (5) --stations
    through the dense bank (its tail runs the staged front, so no K1:
    device kernels in the trace, the rows' SNR).  front_fir must be in the
    traces of (1)-(4).  Each run's realtime factor is printed."""
    import io
    import os

    from torch.profiler import ProfilerActivity, profile

    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(CLI_DIR, exist_ok=True)
    path = functools.partial(os.path.join, CLI_DIR)
    n, kb = HEADLINE["frames"], 8

    def seconds(blocks: int, fs: int = FS) -> str:     # int() of it: blocks
        return str((blocks + 0.5) * n / fs)

    t = np.arange(n * kb * 5) / FS
    am = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 250_000.0 * t)
    wav.write_iq_wav(path("am.wav"), am.astype(np.complex64), FS,
                     demod_mode="AM")
    rds = wfm_plane(1, 5 * kb * n, None, program="rds")
    wav.write_iq_wav(path("fm_rds.wav"), (rds[:, 0] + 1j * rds[:, 1])
                     .astype(np.complex64), FS, demod_mode="FMS")
    left = wfm_plane(1, 2 * kb * n, None, program="left", fs=FS_288)
    wav.write_iq_wav(path("fm288.wav"), (left[:, 0] + 1j * left[:, 1])
                     .astype(np.complex64), FS_288, demod_mode="FMS")
    runs = (
        ("usb", ["--synthetic", "tone", "--mode", "USB", "--tune", "400000",
                 "--seconds", "0.3", "--audio-out", path("usb.wav")]),
        ("am wav", ["--wav", path("am.wav"), "--mode", "AM", "--tune",
                    "250000", "--seconds", seconds(5 * kb),
                    "--blocks-per-dispatch", "8", "--audio-out",
                    path("am_out.wav")]),
        ("fms rds", ["--wav", path("fm_rds.wav"), "--mode", "FM-Stereo",
                     "--tune", "250000", "--seconds", seconds(5 * kb),
                     "--rds", "--audio-out", path("fms_out.wav")]),
        ("fms 2.88 Msps", ["--wav", path("fm288.wav"), "--mode",
                           "FM-Stereo", "--tune", "250000", "--seconds",
                           seconds(2 * kb, FS_288), "--audio-out",
                           path("fm288_out.wav")]),
        ("stations", ["--synthetic", "am", "--tune", "250000", "--stations",
                      "250000,-300000", "--seconds", "0.3", "--audio-out",
                      path("st.wav")]),
    )
    done = {}
    for name, argv in runs:
        buf = io.StringIO()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--json", "--device", "cuda"])
            torch.cuda.synchronize()
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        names = kernel_names(prof)
        fir = any("front_fir" in nm for nm in names)
        k2 = any("wfm_tail_march" in nm for nm in names)
        log(f"phase36 cli {name}: rc {rc}, {m['blocks']} blocks, realtime "
            f"factor {m['realtime_factor']}, step ms {m['step_ms']}; "
            f"{len(names)} distinct CUDA kernels in the trace, front_fir "
            f"{fir}, wfm_tail_march {k2}")
        ok = rc == 0 and len(names) > 0
        if name == "stations":
            ok = ok and not fir and len(m["rows"]) == 2
            log(f"phase36 cli stations rows: "
                + "; ".join(f"{r['station']} channel {r['channel']} SNR "
                            f"{r['snr_db']} dB" for r in m["rows"]))
        else:
            ok = ok and fir and k2 == (name == "fms rds")
        if name in ("usb", "am wav"):
            a = read_audio_wav(argv[argv.index("--audio-out") + 1])[:, 0]
            # past the AGC's and the DC blockers' settling
            snr = tone_snr_db(a[len(a) * 3 // 5:], m["audio_rate"])
            log(f"phase36 cli {name}: written WAV's 1 kHz tone SNR {snr:.2f} "
                f"dB (>= {TONE_SNR_DB})")
            ok = ok and snr >= TONE_SNR_DB
        if name == "fms rds":
            log(f"phase36 cli fms rds: {m['rds']}")
            ok = ok and m["rds"]["ps"] == "PEBBLES "
        if name == "fms 2.88 Msps":
            a = read_audio_wav(argv[argv.index("--audio-out") + 1])
            half = a[a.shape[0] // 2:]
            amp = [tone_amplitude(half[:, i], m["audio_rate"], 700.0)
                   for i in range(2)]
            sep = 20 * np.log10(amp[0] / max(amp[1], 1e-12))
            log(f"phase36 cli fms 2.88 Msps: separation from the WAV "
                f"{sep:.2f} dB (>= {SEPARATION_DB})")
            ok = ok and sep >= SEPARATION_DB
        if not ok:
            raise RuntimeError(f"phase36 cli {name} failed")
        done[name] = m["realtime_factor"]
    return done


def read_audio_wav(path: str) -> np.ndarray:
    """An int16 audio WAV's samples scaled by 1/32767, [n, channels]."""
    import struct
    buf = open(path, "rb").read()
    ch = struct.unpack_from("<H", buf, buf.index(b"fmt ") + 10)[0]
    i = buf.index(b"data")
    size = struct.unpack_from("<I", buf, i + 4)[0]
    pcm = np.frombuffer(buf[i + 8:i + 8 + size], "<i2").astype(np.float64)
    return pcm.reshape(-1, ch) / 32767.0


# ---- phases 37-40: the decode path: K6, K7, the TestBench, --decode ----

OOK_SHAPE = (64, 2048)   # phase 37: K6 against its plain version, each mode
OOK_MARGIN = 1e-5        # least decision margin (ops/goertzel.py ook_margin)
OOK_RTOL = 1e-6          # K6's state vs plain, of each leaf's scale (the
#                          kernel repeats the plain version's float32
#                          operations one by one: bit-equal where measured)
SWEEP_N = 32768          # phase 37: K7's samples per call
SWEEP_ATOL = 1e-5        # K7's samples vs plain
# K7's checks, (start Hz, stop Hz, rate Hz/s, fs): the case whose wraps a
# float64 recurrence puts on other samples (every mode, with and without
# pulses), and a wideband one (repeat)
SWEEP_CASES = {"100-2000 Hz at 48 kHz": (100.0, 2000.0, 1e5, 48_000.0),
               "+-100 kHz at 512 kHz": (-100e3, 100e3, 1e7, 512_000.0)}
PULSE = (300, 1000)      # on samples, period
TB = dict(fs=512_000, frames=32768, steps=3)   # phase 38's TestBench
TB_ATOL = 2e-4           # card vs CPU taps (the staged slices' audio bound)
# phase 40's cell: 64 keyed CW signals 30 kHz apart (none at DC), each on
# its own channel
CW_CELL = dict(name="cw_taps_64ch", channels=64, blocks=32, dispatches=7,
               text="cq cq de pebble", wpm=20.0, amp=0.01, noise=1e-3)


def sweep_wraps(y: np.ndarray) -> np.ndarray:
    """The samples where a sweep wraps to its start: the phase step between
    neighbouring samples jumps by more than 1e-2 rad there (it moves by
    < 3e-4 rad a sample otherwise); pairs with a sample off are left out."""
    on = np.abs(y) > 0
    dp = np.angle(y[1:] * np.conj(y[:-1]))
    ok = on[1:] & on[:-1]
    return np.nonzero((np.abs(np.diff(dp)) > 1e-2) & ok[1:] & ok[:-1])[0]


def ook_powers(torch, c: int, f: int, rng):
    """(main, low, high) [C, F] float32 bin powers on the card, the three
    columns of one [C, F, 3] tensor (the layout goertzel_power writes and
    K6 reads in place), whose decisions sit far from every mode's
    threshold: marks and spaces in runs cycling through 6, 10, 8, 12 and
    7 frames (a 50 % duty, so the average mode's mean stays near half the
    mark level), marks at 0.4 with a +-10 % fade, spaces near 1e-3, the
    compare bins near 2e-3 with a little of the keying on the low one (a
    deeper fade or a duty far from half puts decisions within 1e-5 of
    their thresholds)."""
    runs = (6, 10, 8, 12, 7)
    key = np.zeros((c, f), bool)
    for i in range(c):
        t, j, on = 0, i, False
        while t < f:
            key[i, t:t + runs[j % 5]] = on
            t, j, on = t + runs[j % 5], j + 1, not on
    fade = 1 + 0.1 * np.sin(np.arange(f) / 40.0 + np.arange(c)[:, None])
    pows = (np.where(key, 0.4 * fade, 1e-3 * (1 + 0.5 * rng.random((c, f)))),
            0.03 * key + 2e-3 * (1 + 0.5 * rng.random((c, f))),
            2e-3 * (1 + 0.5 * rng.random((c, f))))
    p3 = torch.from_numpy(np.stack(pows, -1).astype(np.float32)).cuda()
    return [p3[:, :, 0], p3[:, :, 1], p3[:, :, 2]]


def hold_ook(torch, goertzel, cfg, state, pows, tag: str) -> dict:
    """K6 against ook_detect_plain on the same inputs, whose decision
    margin is asserted first: one launch for the call, the marks equal,
    the state within OOK_RTOL of each leaf's scale; the plain version once
    (events), the kernel over 10 calls (events) and per launch
    (torch.profiler over 10 calls, traced again while no recurrence
    launch was recorded: the OokStep kernel's ms in "launch", None if no
    trace recorded it)."""
    from pebblesdr_tpu_torch.utils import convert
    margin = goertzel.ook_margin(cfg, state, *pows)
    if not margin >= OOK_MARGIN:
        raise RuntimeError(f"{tag} ook_scan {cfg.mode}: a decision margin "
                           f"{margin:.3g} below {OOK_MARGIN}")
    before = goertzel.ook_detect.launches
    st_k, m_k = goertzel.ook_detect(cfg, state, *pows)
    torch.cuda.synchronize()
    launches = goertzel.ook_detect.launches - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st_p, m_p = goertzel.ook_detect_plain(cfg, state, *pows)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err, rel = 0.0, 0.0
    for a, b in zip(convert.leaves(st_k), convert.leaves(st_p)):
        if a.dtype == torch.float32 and b.numel():
            d = float((a - b).abs().max())
            err = max(err, d)
            rel = max(rel, d / max(float(b.abs().max()), 1e-30))
        elif not torch.equal(a, b):
            raise RuntimeError(f"{tag} ook_scan {cfg.mode}: the decision or "
                               f"a counter differs from the plain version")
    mismatch = int((m_k != m_p).sum())
    ms = time_cuda(torch, lambda: goertzel.ook_detect(cfg, state, *pows), 10)
    lt = kernel_times(torch, lambda: goertzel.ook_detect(cfg, state, *pows),
                      reps=10, want=("recur_short",))
    k6 = [ms for name, (ms, _) in lt.items() if "OokStep" in name]
    launch = k6[0] if k6 else None      # None: no trace recorded it
    one_kernel(torch, lambda: goertzel.ook_detect(cfg, state, *pows),
               "OokStep", f"{tag} ook_scan {cfg.mode}")
    shape = tuple(pows[0].shape)
    log(f"{tag} ook_scan {cfg.mode} {shape}: {launches} launch, kernel "
        f"{ms:.4f} ms per call (per launch {breakdown_text(lt)}) vs plain "
        f"{plain_ms:.1f} ms; marks differing {mismatch} of {m_p.numel()}, "
        f"{float(m_p.float().mean()):.3f} on; state max |kernel - plain| "
        f"{err:.3g} ({rel:.3g} of scale, <= {OOK_RTOL}); margin "
        f"{margin:.3g}; K6 per launch "
        f"{'not recorded' if launch is None else f'{launch:.4f} ms'}; one "
        f"kernel in a call's trace")
    if launches != 1 or mismatch or not rel <= OOK_RTOL:
        raise RuntimeError(f"{tag} ook_scan {cfg.mode}: the kernel "
                           f"disagrees with its plain version")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "shape": shape, "launch_ms": lt, "launch": launch,
            "launches": launches}


def hold_sweep(torch, siggen, args, kw, tag: str) -> dict:
    """K7 against sweep_plain on the same arguments: one launch for the
    call, the samples within SWEEP_ATOL, the wrap samples equal, the
    state's frequency, direction and pulse count equal and its phase
    within 1e-6; the plain version once (events), the kernel over 10
    calls (events) and per launch (torch.profiler)."""
    before = siggen.sweep.launches
    st_k, y_k = siggen.sweep(*args, **kw)
    torch.cuda.synchronize()
    launches = siggen.sweep.launches - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st_p, y_p = siggen.sweep_plain(*args, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    yk, yp = y_k.cpu().numpy(), y_p.cpu().numpy()
    err = float(np.abs(yk - yp).max()) if yk.size else 0.0
    wk, wp = sweep_wraps(yk), sweep_wraps(yp)
    ph_err = abs(float(st_k.phase) - float(st_p.phase))
    same = all(torch.equal(getattr(st_k, f), getattr(st_p, f))
               for f in ("freq", "direction", "pulse_count"))
    ms = time_cuda(torch, lambda: siggen.sweep(*args, **kw), 10)
    lt = kernel_times(torch, lambda: siggen.sweep(*args, **kw))
    log(f"{tag} sweep_scan n={len(yk)}: {launches} launch, kernel {ms:.4f} "
        f"ms per call (per launch {breakdown_text(lt)}) vs plain "
        f"{plain_ms:.1f} ms; max |kernel - plain| {err:.3g} (<= "
        f"{SWEEP_ATOL}); wraps {len(wk)} at equal samples "
        f"{np.array_equal(wk, wp)}; state phase {ph_err:.3g}, frequency, "
        f"direction and pulse count equal {same}")
    if (launches != 1 or not err <= SWEEP_ATOL or not np.array_equal(wk, wp)
            or not ph_err <= 1e-6 or not same):
        raise RuntimeError(f"{tag} sweep_scan: the kernel disagrees with its "
                           f"plain version")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "n": len(yk), "launch_ms": lt, "launches": launches,
            "wraps": len(wk)}


def phase_decode_kernels(torch) -> dict:
    """Phase 37: K6 (ook_scan) at OOK_SHAPE in each of the six threshold
    modes and K7 (sweep_scan) at SWEEP_N samples in each mode with and
    without pulses (the 100 -> 2000 Hz / 48 kHz case) and in "repeat" at
    +-100 kHz / 512 kHz, each through its entry point and held to its plain
    version on the same inputs (hold_ook, hold_sweep), with the chain
    probe's ns per step and each bound."""
    from pebblesdr_tpu_torch.core import siggen
    from pebblesdr_tpu_torch.ops import goertzel, pll
    from pebblesdr_tpu_torch.utils import roofline
    reg_ns = {form: probe_ns(torch, pll, form) for form in pll.PROBE_FORMS
              if form.startswith(("ook", "sweep"))}
    log("phase37 chain probe (ns per step, one thread, registers only): "
        + ", ".join(f"{k} {v:.1f}" for k, v in reg_ns.items()))
    fed_ns = {form: probe_ns(torch, pll, form, fed=True)
              for form in pll.FED_FORMS if form.startswith("ook")}
    log("phase37 chain probe fed from memory (ns per step; K6's bound): "
        + ", ".join(f"{k} {v:.2f} (registers {reg_ns[k]:.2f})"
                    for k, v in fed_ns.items()))
    # the bound's step: K6's fed probe, K7's register-only one
    steps_ns = {**reg_ns, **fed_ns}
    rng = np.random.default_rng(37)
    c, f = OOK_SHAPE
    res = {"steps_ns": steps_ns, "register_ns": reg_ns, "ook": {},
           "sweep": {}}
    for mode in goertzel.THRESHOLD_MODES:
        cfg = goertzel.OOKConfig.make(mode=mode, manual_threshold=0.1)
        h = hold_ook(torch, goertzel, cfg, goertzel.ook_init(c, "cuda"),
                     ook_powers(torch, c, f, rng), "phase37")
        b = roofline.ook_scan_bound(c, f, steps_ns[f"ook {mode}"],
                                    compare=mode == "compare")
        res["ook"][mode] = dict(h, **b)
        if h["launch"] is not None:
            log(f"phase37 ook_scan {mode} {h['shape']}: per launch "
                f"{h['launch']:.4f} ms, per call {h['ms']:.4f} ms; "
                f"{b['bound_ms'] / h['launch']:.1%} of the "
                f"{b['bound_ms']:.4f} ms bound per launch (fed probe "
                f"{fed_ns[f'ook {mode}']:.2f} ns a step)")
    for case, (a, b, rate, fs) in SWEEP_CASES.items():
        wide = case.startswith("+-")
        for mode in ("repeat",) if wide else siggen.SWEEP_MODES:
            for pulse in ((0, 0),) if wide else ((0, 0), PULSE):
                tag = f"{case} {mode}{' pulsed' if pulse[1] else ''}"
                h = hold_sweep(torch, siggen, (
                    siggen.sweep_init(a, "cuda"), SWEEP_N, a, b, rate, fs,
                    0.5, mode, *pulse), {}, f"phase37 {tag}:")
                res["sweep"][tag] = dict(h, **roofline.sweep_scan_bound(
                    SWEEP_N, steps_ns[f"sweep {mode}"]))
    for kind in ("ook", "sweep"):
        for key, r in res[kind].items():
            log(f"phase37 {kind} {key}: bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; serial floor {r['serial_ms']:.4f} ms) vs "
                f"kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of "
                f"it)")
    return res


def phase_testbench(torch, receiver, front, wfm_tail, DemodMode,
                    steps_ns: dict) -> dict:
    """Phase 38: the TestBench on the card (chain/testbench.py, an AM
    Receiver with taps=True: the staged front, TB's rate and block), as
    tests/test_testbench.py: a -40 dB tone read at -40 +- 1 dB on the
    raw_iq tap's spectrum, -60 dB noise at -60 +- 1 dB, the four taps
    flowing (post_mixer's peak at DC); then a pulsed sweep injected on the
    card and on the CPU with the same capture: K7 once per block on the
    card (the counts set to 0 just before), every tap and the audio within
    TB_ATOL of the CPU's; then K7 held to its plain version on the
    arguments the TestBench gave it (captured) and timed: the kernels
    line's entry."""
    from pebblesdr_tpu_torch.chain.testbench import TestBench
    from pebblesdr_tpu_torch.core import siggen
    from pebblesdr_tpu_torch.utils import roofline
    fs, n = TB["fs"], TB["frames"]

    def bench(dev, inject):
        cfg = receiver.ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                      mode=DemodMode.AM, taps=True,
                                      agc_mode="off")
        return TestBench(receiver.Receiver(cfg, dev), inject=inject)

    def run(tb, steps, tune, x=None):
        st, p = tb.rx.init_state(), tb.rx.default_params(tune)
        for i in range(steps):
            blk = (torch.zeros(1, n, dtype=torch.complex64) if x is None
                   else x[i])
            st, _ = tb.step(st, p, blk.to(tb.rx.device))
        return tb

    tb = run(bench("cuda", ("tone", {"freq_hz": 100_000.0, "db": -40.0})),
             4, 100_000.0)
    freqs, db = tb.tap_spectrum_db("raw_iq", fs)
    peak = int(np.argmax(db))
    log(f"phase38 TestBench -40 dB tone: raw_iq peak {db[peak]:.3f} dB at "
        f"{freqs[peak]:.1f} Hz (-40 +- 1 dB at 100 kHz)")
    ok = abs(db[peak] + 40.0) <= 1.0 and abs(freqs[peak] - 1e5) < fs / 4096
    tb = run(bench("cuda", ("noise", {"db": -60.0})), 4, 0.0)
    x = tb.tap("raw_iq")[0]
    level = 10 * np.log10(np.mean(np.abs(x) ** 2))
    log(f"phase38 TestBench -60 dB noise: raw_iq {level:.3f} dB (+- 1)")
    ok = ok and abs(level + 60.0) <= 1.0
    tb = run(bench("cuda", ("tone", {"freq_hz": 100_000.0, "db": -20.0})),
             3, 100_000.0)
    freqs, db = tb.tap_spectrum_db("post_mixer", tb.rx.demod_rate)
    taps = sorted(tb.history)
    log(f"phase38 TestBench taps {taps}; post_mixer peak at "
        f"{freqs[np.argmax(db)]:.2f} Hz (DC within "
        f"{tb.rx.demod_rate / 1024:.1f})")
    ok = ok and set(taps) >= {"raw_iq", "post_mixer", "post_bp",
                              "post_demod", "audio"} \
        and abs(freqs[np.argmax(db)]) < tb.rx.demod_rate / 1024
    if not ok:
        raise RuntimeError("phase38: the TestBench checks failed on the card")
    # a pulsed sweep, card against CPU on the same capture
    inject = ("sweep", {"start_hz": 90e3, "stop_hz": 110e3,
                        "rate_hz_per_sec": 4e6, "db": -20.0,
                        "pulse_on_samples": 3000,
                        "pulse_period_samples": 5000})
    rng = np.random.default_rng(38)
    x = [torch.from_numpy((1e-3 * (rng.standard_normal((1, n)) + 1j
                                   * rng.standard_normal((1, n))))
                          .astype(np.complex64)) for _ in range(TB["steps"])]
    reset_launches(front, wfm_tail)
    with captured(siggen, "sweep") as seen:
        card = run(bench("cuda", inject), TB["steps"], 100_000.0, x)
        torch.cuda.synchronize()
    launches = siggen.sweep.launches
    cpu = run(bench("cpu", inject), TB["steps"], 100_000.0, x)
    err = {name: float(np.abs(card.tap(name) - cpu.tap(name)).max())
           for name in cpu.history}
    log(f"phase38 TestBench pulsed sweep, card vs CPU: sweep_scan launches "
        f"{launches} for {TB['steps']} blocks; max |card - CPU| "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f" (<= {TB_ATOL})")
    if launches != TB["steps"] or max(err.values()) > TB_ATOL:
        raise RuntimeError("phase38: the card's TestBench disagrees with the "
                           "CPU's, or K7 did not run once a block")
    args, kw = seen[-1]
    h = hold_sweep(torch, siggen, args, kw, "phase38 TestBench's")
    return dict(h, launches=launches, **roofline.sweep_scan_bound(
        h["n"], steps_ns[f"sweep {kw.get('mode', 'repeat')}"]))


def dtmf_wav(path: str, wav) -> str:
    """tests/test_cli.py:83-110's recording: the dial "911" (80 ms tones,
    80 ms gaps) as FM at 3 kHz deviation on +30 kHz of a 256 kHz capture."""
    from pebblesdr_tpu_torch.modem import dtmf
    fs, seconds = 256_000, 2.2
    dial = dtmf.encode_dtmf("911", 48000.0, tone_ms=80, gap_ms=80)
    n = int(fs * seconds)
    afull = np.zeros(int(seconds * 48000) + 1, np.float32)
    afull[2000:2000 + len(dial)] = dial
    a_dev = np.interp(np.arange(n) / fs, np.arange(len(afull)) / 48000.0,
                      afull)
    ph = 2 * np.pi * np.cumsum(3000.0 * a_dev) / fs
    iq = 0.5 * np.exp(1j * (2 * np.pi * 30_000.0 * np.arange(n) / fs + ph))
    wav.write_iq_wav(path, iq.astype(np.complex64), fs,
                     center_freq_hz=30_000.0, demod_mode="FMN")
    return path


def phase_cli_decode(torch, front, wfm_tail, wav) -> dict:
    """Phase 39: the CLI's --decode on the card, in process, each run under
    torch.profiler with the counts set to 0 just before: --synthetic morse
    --mode CWU --decode cw (the staged front's post_bp tap, MorseModem, K6:
    the text starts "cq", ook_scan launched and its kernel, recur_kernel
    over OokStep, in the trace), --decode dtmf on tests/test_cli.py's
    recording ("911"), --decode wwv (0.2 s: no whole minute,
    decoded_time reported as null)."""
    import io
    import os

    from torch.profiler import ProfilerActivity, profile

    from pebblesdr_tpu_torch.ops import goertzel
    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(CLI_DIR, exist_ok=True)
    dtmf = dtmf_wav(os.path.join(CLI_DIR, "dtmf.wav"), wav)
    runs = (
        ("cw", ["--synthetic", "morse", "--mode", "CWU", "--tune", "100000",
                "--seconds", "3.2", "--decode", "cw"], "decoded_text"),
        ("dtmf", ["--wav", dtmf, "--mode", "FMN", "--tune", "30000",
                  "--sample-rate", "256000", "--frames", "32768",
                  "--seconds", "1.5", "--decode", "dtmf"], "decoded_digits"),
        ("wwv", ["--synthetic", "am", "--mode", "AM", "--tune", "250000",
                 "--seconds", "0.2", "--decode", "wwv"], "decoded_time"),
    )
    done = {}
    for name, argv, key in runs:
        buf = io.StringIO()
        reset_launches(front, wfm_tail)
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(buf):
            rc = cli.main(argv + ["--json", "--device", "cuda"])
            torch.cuda.synchronize()
        launches = goertzel.ook_detect.launches
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        names = kernel_names(prof)
        k6 = any("OokStep" in nm for nm in names)
        log(f"phase39 cli --decode {name}: rc {rc}, {m['blocks']} blocks, "
            f"realtime factor {m['realtime_factor']}, {key} "
            f"{m.get(key, 'missing')!r}; ook_scan launches {launches}, in "
            f"the trace {k6}; {len(names)} distinct CUDA kernels")
        ok = rc == 0 and key in m
        if name == "cw":
            ok = ok and m[key].lower().startswith("cq") and launches > 0 \
                and k6
        elif name == "dtmf":
            ok = ok and m[key] == "911"
        if not ok:
            raise RuntimeError(f"phase39 cli --decode {name} failed")
        done[name] = m["realtime_factor"]
    return done


def cw_planes(torch, freqs: np.ndarray, rows: int, dispatches: int):
    """dispatches consecutive [rows, 2C] float32 planes on the card: the sum
    of len(freqs) keyed CW signals (CW_CELL's text at its WPM and
    amplitude, signal i at freqs[i] Hz and i ms late) plus complex noise,
    the same capture on every channel's lanes."""
    from pebblesdr_tpu_torch.io import sources
    c = CW_CELL["channels"]
    total = rows * dispatches
    env = torch.from_numpy(sources.morse_envelope(
        CW_CELL["text"], CW_CELL["wpm"], FS).astype(np.float32)).cuda()
    t = torch.arange(total, dtype=torch.int64, device="cuda")
    sig = torch.zeros(total, dtype=torch.complex64, device="cuda")
    for i, f in enumerate(freqs):
        lag = i * FS // 1000
        keyed = torch.zeros(total, dtype=torch.float32, device="cuda")
        span = min(total - lag, len(env))
        keyed[lag:lag + span] = env[:span]
        ang = (2 * np.pi / FS) * torch.remainder(int(f) * t, FS).double()
        sig += (torch.polar(keyed.double() * CW_CELL["amp"], ang)
                .to(torch.complex64))
    g = torch.Generator(device="cuda")
    g.manual_seed(40)
    sig += (CW_CELL["noise"] / np.sqrt(2.0)) * torch.complex(
        torch.randn(total, generator=g, device="cuda"),
        torch.randn(total, generator=g, device="cuda"))
    planes = []
    for d in range(dispatches):
        part = sig[d * rows:(d + 1) * rows]
        planes.append(torch.cat([part.real[:, None].expand(rows, c),
                                 part.imag[:, None].expand(rows, c)],
                                dim=1).contiguous())
    return planes


def phase_cw_cell(torch, receiver, front, wfm_tail, DemodMode,
                  steps_ns: dict) -> dict:
    """Phase 40: the timed cell cw_taps_64ch (a CW skimmer decoding a band
    segment: CWU, 64 channels at 2.048 Msps, 32 blocks of 32768 frames,
    taps=True: the staged front) on 64 keyed CW signals 30 kHz apart from
    -952.5 kHz, each channel tuned 1 kHz below its own: every dispatch re-frames every
    channel's post_bp tap to whole 480-sample frames at the 32 kHz demod
    rate (~34 a dispatch), MorseModem (Goertzel, "peak": one K6 launch)
    and 64 MorseDecoders on the host.  First CW_CELL dispatches in a row,
    each channel's text starting "cq"; then WARMUP + WINDOWS x
    WINDOW_DISPATCHES dispatches over the same planes in turn, windows
    timed by events and by the host clock, with the launch counts (K1 and
    K5 never, K6 once a dispatch) and the peak memory; a profile of the
    dispatches' device part; then K6 held to its plain version on the
    inputs a dispatch gave it (the kernels line's entry)."""
    from pebblesdr_tpu_torch.modem import morse
    from pebblesdr_tpu_torch.ops import goertzel, scanops
    from pebblesdr_tpu_torch.utils import roofline
    c, k, n = CW_CELL["channels"], CW_CELL["blocks"], HEADLINE["frames"]
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=c, mode=DemodMode.CWU,
                                  agc_stride=HEADLINE["agc_stride"],
                                  taps=True)
    rx = receiver.Receiver(cfg, "cuda")
    # 30 kHz apart, none at 0 Hz (the front's DC blocker takes a carrier
    # there)
    freqs = -952_500 + 30_000 * np.arange(c)
    params = rx.default_params((freqs - 1000.0).astype(np.float64))
    planes = cw_planes(torch, freqs, k * n, CW_CELL["dispatches"])
    modem = morse.MorseModem(rx.demod_rate,
                             tone_hz=abs(rx.info.cw_offset) or 1000.0)
    decoders = [morse.MorseDecoder(frame_rate=modem.frame_rate)
                for _ in range(c)]
    cell = {"name": CW_CELL["name"], "rx": rx, "params": params,
            "state": rx.init_state(), "iq": planes[0], "i": 0,
            "modem": modem.init_state(c, "cuda"),
            "buf": torch.zeros(c, 0, dtype=torch.complex64, device="cuda")}

    def device_dispatch():
        """One dispatch on the card: the receiver, the tap re-framed, the
        modem; returns the marks (on the card)."""
        iq = planes[cell["i"] % len(planes)]
        cell["i"] += 1
        cell["state"], out = rx.step_many(cell["state"], params, iq,
                                          spectra=False)
        taps = out["taps"]["post_bp"]                       # [K, C, blk]
        buf = torch.cat([cell["buf"],
                         taps.transpose(0, 1).reshape(c, -1)], dim=-1)
        use = buf.shape[-1] // modem.frame * modem.frame
        cell["buf"] = buf[:, use:]
        cell["modem"], marks = modem.detect(cell["modem"],
                                            buf[:, :use].contiguous())
        return marks

    def dispatch():
        marks = device_dispatch().cpu().numpy()
        for dec, m in zip(decoders, marks):
            dec.feed(m)
        return marks.shape[1]

    frames = [dispatch() for _ in range(CW_CELL["dispatches"])]
    texts = [dec.text for dec in decoders]
    good = sum(t.startswith("cq") for t in texts)
    log(f"phase40 {cell['name']}: {CW_CELL['dispatches']} dispatches in a "
        f"row ({frames} frames each), decoded on {good} of {c} channels "
        f"(channel 0 {texts[0]!r}, channel {c - 1} {texts[-1]!r})")
    if good != c:
        raise RuntimeError(f"phase40 {cell['name']}: text starting 'cq' on "
                           f"{good} of {c} channels")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(front, wfm_tail)
    for _ in range(WARMUP):
        dispatch()
    windows, host = [], []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        windows.append(time_cuda(torch, dispatch, WINDOW_DISPATCHES))
        host.append((time.perf_counter() - t0) * 1e3 / WINDOW_DISPATCHES)
    torch.cuda.synchronize()
    n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
    launches = (front.fused_front.launches, goertzel.ook_detect.launches,
                scanops.auto_iq_balance.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    best = min(windows)
    log(f"phase40 {cell['name']} {c}ch x {n} x {k}: dispatch ms per window "
        + " ".join(f"{w:.4f}" for w in windows)
        + f" (host clock {' '.join(f'{h:.4f}' for h in host)}); block "
        f"{best / k:.5f} ms, {n * k / (best / 1e3) / FS:.1f}x realtime per "
        f"channel (the receiver, the modem and {c} host decoders); K1 "
        f"launches {launches[0]}, ook_scan launches {launches[1]}, "
        f"iq_lms_scan launches {launches[2]} for {n_dispatch} dispatches; "
        f"peak device memory {peak:.3f} GiB")
    if launches != (0, n_dispatch, 0):
        raise RuntimeError(f"phase40 {cell['name']}: launches (K1, K6, K5) "
                           f"{launches} for {n_dispatch} dispatches")
    prof = dispatch_profile(torch, cell, "phase40", dispatch=device_dispatch)
    with captured(goertzel, "ook_detect") as seen:
        device_dispatch()
        torch.cuda.synchronize()
    (cfg_k, state, *pows), _ = seen[0]
    h = hold_ook(torch, goertzel, cfg_k, state, pows, f"phase40 "
                 f"{cell['name']}'s")
    k6b = roofline.ook_scan_bound(*h["shape"], steps_ns[f"ook {cfg_k.mode}"],
                                  compare=cfg_k.mode == "compare")
    log(f"phase40 {cell['name']}: K6 {h['ms']:.4f} ms per call, "
        f"{'not recorded' if h['launch'] is None else f'{h['launch']:.4f}'}"
        f" per launch (bound {k6b['bound_ms']:.5f} ms, {k6b['bound_by']}), "
        f"beside the dispatch's {prof['ms']:.4f} ms by events (best window "
        f"{best:.4f}) and {prof['host_ms']:.4f} ms of host enqueue")
    planes.clear()
    del cell
    torch.cuda.empty_cache()
    return {"launches": launches, "windows": windows, "host_ms": host,
            "block_ms": best / k, "peak_gib": peak, "profile": prof,
            "k6": dict(h, **k6b)}


# ---- phases 41-45: K8 (the ANF), checkpoint/resume, the soak, the CLI ----

ANF_RTOL = 1e-5       # K8 vs anf_plain: y and w' within 1e-5 of their scale
#                       (the same sums in another order, through the LMS
#                       feedback: 2048 updates at the staged shape)
# K8's shapes: (tag, channels (2C rows), samples per call, update_every,
# calls carrying the state)
ANF_SHAPES = (("staged", 64, 32768, 16, 3), ("batched", 64, 32768, 1024, 3),
              ("sample", 64, 2048, 1, 2))
SOAK = dict(seconds=60.0, channels=64, blocks=32)
CKPT_DIR = "build/chip_smoke_ckpt"


def make_iqauto_anf_cell(torch, receiver, front):
    """am_iqauto_anf_64ch: am_iqauto_64ch with enable_anf=True (the staged
    front, K5, then K8 at U = 16: shortwave AM through a mismatched I/Q
    path with the adaptive noise filter); its tone SNR printed, the ANF's
    adaptation held."""
    return make_iqauto_cell(torch, receiver, front, "am_iqauto_anf_64ch",
                            dict(enable_anf=True),
                            dict(snr=False, anf=True))


def make_anf_long_cell(torch, receiver, front):
    """am_anf_long_64ch (phase 29's cell): AM with the ANF (K8 at U = the
    demod block, 1024: one update per block) and AGC "long"."""
    _, mode, opts, plane, checks = NEW_CELLS[2]
    return make_cell(torch, receiver, front, receiver.DemodMode[mode],
                     "am_anf_long_64ch", HEADLINE["channels"],
                     HEADLINE["blocks"], opts=opts, plane=plane,
                     checks=checks)


# the ANF cells of this slice, by name (tools/cell_profile.py reads it)
ANF_CELLS = {"am_anf_long_64ch": make_anf_long_cell,
             "am_iqauto_anf_64ch": make_iqauto_anf_cell}


def anf_signal(c: int, n: int, rng) -> np.ndarray:
    """[c, n] complex64 at the demod rate (64 kHz): an 800 Hz tone (a phase
    per channel), 2100 Hz on I, and noise at 0.1."""
    t = np.arange(n) / 64_000.0 + rng.random()
    x = (0.3 * np.exp(1j * (2 * np.pi * 800.0 * t
                            + np.arange(c)[:, None]))
         + 0.2 * np.cos(2 * np.pi * 2100.0 * t)
         + 0.1 * (rng.standard_normal((c, n))
                  + 1j * rng.standard_normal((c, n))))
    return x.astype(np.complex64)


def phase_anf(torch, front, wfm_tail) -> dict:
    """Phase 41: K8 (csrc/recur.cu anf_scan) through its entry point
    scanops.anf at the main path's shapes, complex [64, N] (128 rows):
    the staged front's U = 16 over [64, 32768] (2048 updates a call), the
    batched graph's U = 1024 (32 updates) and the sample-exact U = 1 over
    [64, 2048], the form that ran (chain at U = 16 and 1, wide at 1024)
    logged; each over several calls carrying the state, one launch
    per call (the counts at 0 first), y and w' within ANF_RTOL of their
    scale of anf_plain (on the stacked rows, from the same state); then
    K8 alone (anf_scan on the rows) timed over 10 calls with its
    per-launch device time, the plain version once, the chain probe's ns
    per update ("anf <U>", the register-only chain of one update) and the
    bound."""
    from pebblesdr_tpu_torch.ops import pll, scanops
    from pebblesdr_tpu_torch.utils import roofline
    done = {}
    for tag, c, n, u, calls in ANF_SHAPES:
        rng = np.random.default_rng(41 + u)
        xs = [torch.from_numpy(anf_signal(c, n, rng)).cuda()
              for _ in range(calls)]
        st = scanops.anf_init(c, "cuda", dtype=torch.complex64)
        w_p = torch.zeros(2 * c, scanops.ANF_TAPS, device="cuda")
        h_p = torch.zeros(2 * c, st.delay.shape[-1], device="cuda")
        reset_launches(front, wfm_tail)
        err_y = err_w = rel_y = rel_w = 0.0
        plain_ms = 0.0
        for x in xs:
            w_in, h_in = w_p, h_p
            st, y = scanops.anf(st, x, update_every=u)
            rows = torch.cat([x.real, x.imag]).contiguous()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y_p, w_p, h_p = scanops.anf_plain(rows, w_in, h_in,
                                              update_every=u)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            yk = torch.cat([y.real, y.imag])
            wk = torch.cat([st.weights.real, st.weights.imag])
            err_y = max(err_y, float((yk - y_p).abs().max()))
            err_w = max(err_w, float((wk - w_p).abs().max()))
            rel_y = max(rel_y, err_y / float(y_p.abs().max()))
            rel_w = max(rel_w, err_w / float(w_p.abs().max()))
            hk = torch.cat([st.delay.real, st.delay.imag])
            if not torch.equal(hk, h_p):
                raise RuntimeError(f"phase41 {tag}: K8's history differs "
                                   f"from the plain version's")
        torch.cuda.synchronize()
        launches = scanops.anf_scan.launches
        if launches != calls:
            raise RuntimeError(f"phase41 {tag}: {launches} K8 launches for "
                               f"{calls} calls")
        rows = torch.cat([xs[-1].real, xs[-1].imag]).contiguous()
        h_p = h_p.contiguous()          # anf_plain's history is a view

        def kernel():
            return scanops.anf_scan(rows, w_p, h_p, update_every=u)

        ms = time_cuda(torch, kernel, 10)
        lt = kernel_times(torch, kernel, reps=3)
        step_ns = probe_ns(torch, pll, f"anf {u}")
        b = roofline.anf_scan_bound(2 * c, n, u, step_ns)
        adapted = float(st.weights.abs().max())
        form = scanops.anf_form(u)
        log(f"phase41 anf_scan {tag} [{2 * c} rows, {n}] U={u} "
            f"({n // u} updates), the {form} form "
            f"({scanops.anf_threads(form, u)} threads a row): {launches} "
            f"launches for {calls} calls; "
            f"kernel {ms:.4f} ms per call (per launch {breakdown_text(lt)}) "
            f"vs plain {plain_ms:.1f} ms; max |y - plain| {err_y:.3g} "
            f"({rel_y:.3g} of scale), max |w' - plain| {err_w:.3g} "
            f"({rel_w:.3g} of scale) (<= {ANF_RTOL}); max |w| {adapted:.4g};"
            f" chain probe {step_ns:.1f} ns per update; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
            f"{b['bytes'] / 3.35e9:.4f} ms, operations "
            f"{b['ops'] / 67e9:.4f} ms, serial floor {b['serial_ms']:.4f} "
            f"ms): {b['bound_ms'] / ms:.1%} of it")
        if not (rel_y <= ANF_RTOL and rel_w <= ANF_RTOL and adapted > 1e-3):
            raise RuntimeError(f"phase41 {tag}: K8 disagrees with its plain "
                               f"version")
        done[tag] = {"ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": max(err_y, err_w), "rel_y": rel_y,
                     "rel_w": rel_w, "shape": (2 * c, n), "u": u,
                     "form": form,
                     "step_ns": step_ns, "launch_ms": lt,
                     "launches": launches, **b}
        del xs, rows
    return done


def phase_anf_cells(torch, receiver, front, wfm_tail) -> dict:
    """Phase 42: am_anf_long_64ch re-timed with K8 (U = 1024, one launch
    per dispatch) and the new cell am_iqauto_anf_64ch (the staged front,
    K5, K8 at U = 16), each timed alone with its launch counts, the ANF
    adapted, its tone SNR printed, peak memory and a profile of its
    dispatches (kernels per dispatch, host enqueue, device busy); then
    am_iqauto_anf_64ch's dispatch with anf_plain in K8's place, one window,
    timed once: the loop this kernel replaces."""
    from pebblesdr_tpu_torch.ops import scanops
    done = {}
    for make in ANF_CELLS.values():
        cell = make(torch, receiver, front)
        time_cells(torch, front, wfm_tail, [cell], "phase42")
        prof = dispatch_profile(torch, cell, "phase42")
        done[cell["name"]] = {key: cell[key] for key in (
            "launches", "block_ms", "msps", "realtime", "peak_gib",
            "snr_db", "windows")}
        done[cell["name"]].update(prof)
        if cell["name"] == "am_iqauto_anf_64ch":
            kernel = scanops.anf_scan
            scanops.anf_scan = scanops.anf_plain
            try:
                st = [cell["state"]]

                def dispatch():
                    st[0], _ = cell["rx"].step_many(st[0], cell["params"],
                                                    cell["iq"],
                                                    spectra=False)

                ms = time_cuda(torch, dispatch, WINDOW_DISPATCHES)
            finally:
                scanops.anf_scan = kernel
            done["plain_loop_ms"] = ms
            log(f"phase42 am_iqauto_anf_64ch with anf_plain in K8's place "
                f"(one window of {WINDOW_DISPATCHES} dispatches, spectra "
                f"off): {ms:.4f} ms per dispatch, against "
                f"{prof['ms']:.4f} ms with K8")
        del cell
        torch.cuda.empty_cache()
    return done


def outputs_equal(torch, a, b, prefix: str = "") -> list:
    """The keys (dotted into dicts) where two outputs of step_many differ
    in any bit."""
    if isinstance(a, dict):
        return [bad for key in a for bad in outputs_equal(
            torch, a[key], b[key], f"{prefix}{key}.")]
    return [] if bits_equal(torch, a, b) else [prefix.rstrip(".")]


def bits_equal(torch, a, b) -> bool:
    """Two tensors equal bit for bit (NaNs too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def phase_checkpoint(torch, receiver, front, wfm_tail) -> dict:
    """Phase 43: checkpoint/resume on the card.  am_iqauto_anf_64ch's
    receiver (the staged front, K5, K8) runs six dispatches from its
    initial state; a second receiver runs three, saves its state with
    utils/checkpoint.py into a file, and a fresh Receiver loads it and
    runs dispatches 4-6 (K5 and K8 once each a dispatch): every output and
    the final state equal to the uninterrupted run's bit for bit.  The
    kernels on this path use no atomics; a difference names the outputs
    and state leaves that differ and fails."""
    import os

    from pebblesdr_tpu_torch.ops import scanops
    from pebblesdr_tpu_torch.utils import checkpoint
    cell = make_iqauto_anf_cell(torch, receiver, front)
    rx, params, iq = cell["rx"], cell["params"], cell["iq"]
    st = rx.init_state()
    ref = []
    for d in range(6):
        st, out = rx.step_many(st, params, iq)
        if d >= 3:
            ref.append(out)
    ref_state = convert_leaves(st)
    st = rx.init_state()
    for _ in range(3):
        st, _ = rx.step_many(st, params, iq)
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "am_iqauto_anf_64ch.npz")
    checkpoint.save_state(path, st, extra={"dispatches": 3})
    rx2 = receiver.Receiver(cell["cfg"], "cuda")
    st2, extra = checkpoint.load_state(path, rx2.init_state())
    reset_launches(front, wfm_tail)
    bad = []
    for d in range(3):
        st2, out = rx2.step_many(st2, params, iq)
        bad += [f"dispatch {4 + d} {key}"
                for key in outputs_equal(torch, ref[d], out)]
    torch.cuda.synchronize()
    launches = (scanops.auto_iq_balance.launches, scanops.anf_scan.launches,
                front.fused_front.launches)
    leaves = convert_leaves(st2)
    bad += [f"state leaf {i}" for i, (a, b) in enumerate(zip(ref_state,
                                                            leaves))
            if not bits_equal(torch, a, b)]
    log(f"phase43 checkpoint of am_iqauto_anf_64ch after dispatch 3 "
        f"({os.path.getsize(path) / 2 ** 20:.2f} MiB, {len(leaves)} leaves, "
        f"extra {extra}), resumed in a fresh Receiver: launches (K5, K8, K1) "
        f"{launches} for 3 dispatches; dispatches 4-6 and the final state "
        f"bit-equal to the uninterrupted run: {not bad}"
        + (f"; differ: {', '.join(bad[:12])}" if bad else ""))
    if launches != (3, 3, 0) or bad:
        raise RuntimeError("phase43: the resumed run is not the "
                           "uninterrupted run's bit for bit")
    del cell, ref, st, st2
    torch.cuda.empty_cache()
    return {"launches": launches, "leaves": len(leaves)}


def convert_leaves(state) -> list:
    from pebblesdr_tpu_torch.utils import convert
    return [leaf.clone() for leaf in convert.leaves(state)]


def phase_soak(torch, front, wfm_tail) -> dict:
    """Phase 44: the port's soak (pebblesdr_tpu_torch/tools/soak.py) on the
    card: WFM stereo + RDS, 64 channels, dispatches of 32 blocks, for
    SOAK["seconds"] of wall clock, the state carried, the host RDS decode
    running; K1 and K2 once per dispatch; it passes on no bad dispatch,
    RDS synced and the PS "PEBBLES "."""
    from pebblesdr_tpu_torch.tools import soak
    reset_launches(front, wfm_tail)
    res = soak.run(SOAK["seconds"], SOAK["channels"], SOAK["blocks"], False,
                   "cuda")
    torch.cuda.synchronize()
    launches = (front.fused_front.launches, wfm_tail.wfm_tail.launches)
    log(f"phase44 soak {json.dumps(res)}; launches (K1, K2) {launches} for "
        f"{res['dispatches'] + 1} dispatches")
    if not (res["bad_dispatches"] == 0 and res["rds_synced"]
            and res["rds_ps"] == "PEBBLES "
            and launches == (res["dispatches"] + 1,) * 2):
        raise RuntimeError("phase44: the soak failed")
    return res


def phase_cli_checkpoint(torch) -> dict:
    """Phase 45: the CLI on the card with --checkpoint and
    --checkpoint-every 4 (a 2 s synthetic AM run: the supervisor's
    snapshots every 4 blocks, "health" in the JSON), then a run that
    resumes from the file with --resume; the saved state loads into the
    configuration's Receiver."""
    import io
    import os

    from pebblesdr_tpu_torch.serve import cli
    from pebblesdr_tpu_torch.utils import checkpoint
    os.makedirs(CLI_DIR, exist_ok=True)
    ck = os.path.join(CLI_DIR, "state.npz")
    argv = ["--synthetic", "am", "--mode", "AM", "--tune", "250000",
            "--noise-db", "-60", "--json", "--device", "cuda"]
    runs = {}
    for name, extra in (("checkpoint", ["--seconds", "2.0", "--checkpoint",
                                        ck, "--checkpoint-every", "4"]),
                        ("resume", ["--seconds", "1.0", "--resume", ck])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv + extra)
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        runs[name] = m
        h = m.get("health")
        log(f"phase45 CLI {name}: rc {rc}, {m['blocks']} blocks, realtime "
            f"factor {m['realtime_factor']}, snr {m['snr_db']} dB"
            + (f", health {json.dumps({**h, 'events': len(h['events'])})} "
               f"(events: {', '.join(sorted({e['kind'] for e in h['events']}))}"
               f" at blocks {h['events'][0]['block']}.."
               f"{h['events'][-1]['block']})" if h else ""))
        if rc != 0:
            raise RuntimeError(f"phase45 CLI {name}: exit {rc}")
    health = runs["checkpoint"].get("health")
    kinds = [e["kind"] for e in (health or {}).get("events", [])]
    want = runs["checkpoint"]["blocks"] // 4
    rx = receiver_for_cli(torch)
    _, extra = checkpoint.load_state(ck, rx.init_state())
    if not (health and health["blocks"] == runs["checkpoint"]["blocks"]
            and kinds == ["checkpoint"] * want
            and extra == {"blocks": runs["checkpoint"]["blocks"]}
            and "health" not in runs["resume"]
            and runs["resume"]["squelch_open"]):
        raise RuntimeError("phase45: the CLI's checkpoint/resume failed")
    return runs


# ---- phases 46-50: the live receiver shell ----

LIVE_DIR = "build/chip_smoke_live"
LIVE_K = HEADLINE["blocks"] * HEADLINE["frames"]   # rows of one dispatch
LIVE_DISPATCH_MS = 1e3 * LIVE_K / FS               # 512 ms of signal
LIVE_PACED_DISPATCHES = 4      # phase 47's paced run (>= 3, the first builds)
LIVE_FREE_DISPATCHES = 8       # phase 47's unpaced run
SDR_IP_DISPATCHES = 4          # phase 49's SDR-IP run, paced, full width
HPSDR_RUN = dict(fs=192_000, channels=64, frames=8192, blocks=8,
                 seconds=0.5)                             # phase 49


def full_width_argv(dispatches: int) -> list:
    """The CLI's headline geometry: 64 channels, dispatches of 32 blocks of
    32768 frames, for exactly `dispatches` dispatches."""
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    return ["--channels", str(HEADLINE["channels"]), "--frames", str(n),
            "--blocks-per-dispatch", str(k),
            "--seconds", repr(dispatches * k * n / FS)]


def live_recording(wav, path: str, seconds: float, program: str) -> str:
    """An IQ WAV inside the u8 range (|x| <= 0.5): "am" the AM station at
    250 kHz (1 kHz, m = 0.8; a whole number of periods, so a loop is
    seamless), "rds" the FM stereo station with the PEBBLES RDS groups,
    "two" the AM station at 250 kHz beside a stronger one at -300 kHz
    (400 Hz), noise at -60 dB."""
    n = int(seconds * FS)
    if program == "rds":
        plane = wfm_plane(1, n, None, program="rds")
        iq = plane[:, 0] + 1j * plane[:, 1]
    else:
        t = np.arange(n) / FS
        iq = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
            2j * np.pi * 250_000.0 * t)
        if program == "two":
            iq = 0.5 * iq + 0.4 * (1 + 0.8 * np.cos(2 * np.pi * 400.0 * t)) \
                / 2 * np.exp(-2j * np.pi * 300_000.0 * t)
            rng = np.random.default_rng(5)
            iq = iq + 1e-3 * (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
    wav.write_iq_wav(path, iq.astype(np.complex64), FS, demod_mode="AM")
    return path


def run_cli(torch, cli, argv: list, profiled: bool = True):
    """cli.main(argv + --json --device cuda) in this process (under
    torch.profiler when profiled): (rc, its JSON, stdout lines, the CUDA
    kernel names, the JSON's per-dispatch split)."""
    import io

    from torch.profiler import ProfilerActivity, profile
    buf = io.StringIO()
    ctx = (profile(activities=[ProfilerActivity.CUDA]) if profiled
           else contextlib.nullcontext())
    with ctx as prof, contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--json", "--device", "cuda"])
        torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    names = kernel_names(prof) if profiled else set()
    m = json.loads(lines[-1])
    return rc, m, lines, names, m["split_ms"]


def split_text(split: dict) -> str:
    return ", ".join(f"{k} {v.get('avg')} ms (min {v.get('min')}, max "
                     f"{v.get('max')}, n {v.get('n')})"
                     for k, v in split.items())


def launch_counts(front, wfm_tail) -> dict:
    return {"fused_front": front.fused_front.launches,
            "front_means": front.chunk_means.launches,
            "front_dc_scan": front.dc_scan.launches,
            "wfm_tail": wfm_tail.wfm_tail.launches}


def phase_runtime(torch) -> dict:
    """Phase 46: the port's host runtime, built on the card's host from
    csrc/ring.cpp (g++, no -march=native) into build/kernels/: its path;
    a NativeRing
    round trip with an overrun counted; the native decode_iq_planes (u8,
    i8, i16, u16, f32) and deint_iq_planes_i16 (i16, i8, u8) bit-equal to
    numpy on 1M samples each; core.iqformat.decode_iq on a CUDA tensor
    bit-equal to decode_iq_host for every format, with and without the
    I/Q swap."""
    from pebblesdr_tpu_torch import runtime
    from pebblesdr_tpu_torch.core import iqformat
    from pebblesdr_tpu_torch.kernels import build
    t0 = time.perf_counter()
    runtime.load()
    log(f"phase46 runtime built and loaded from {runtime.library_path()} in "
        f"{time.perf_counter() - t0:.1f} s (g++ {' '.join(build.CXX_FLAGS)})")
    ring = runtime.NativeRing(2, 8)
    ok = all(ring.write(bytes([i]) * 8, timeout_ms=10) for i in range(3))
    got = [ring.read(timeout_ms=10) for _ in range(2)]
    ok = ok and got == [b"\x01" * 8, b"\x02" * 8] and ring.overruns == 1 \
        and ring.read(timeout_ms=10) is None
    log(f"phase46 NativeRing: 3 writes into 2 buffers, {ring.overruns} "
        f"overrun, reads {[g[:1] for g in got]}: {'ok' if ok else 'FAILED'}")
    rng = np.random.default_rng(46)
    n = 1 << 20
    raws = {"u8": rng.integers(0, 256, 2 * n, dtype=np.uint8),
            "i8": rng.integers(-128, 128, 2 * n, dtype=np.int8),
            "u16": rng.integers(0, 65536, 2 * n, dtype=np.uint16),
            "i16": rng.integers(-32768, 32768, 2 * n, dtype=np.int16),
            "f32": rng.uniform(-1.5, 1.5, 2 * n).astype(np.float32),
            "f64": rng.uniform(-1.5, 1.5, 2 * n)}
    bad = []
    for fmt, raw in raws.items():
        for swap in (False, True):
            ref = iqformat.decode_iq_host(raw.tobytes(), fmt, swap)
            if fmt != "f64":
                planes = runtime.decode_iq_planes(raw.tobytes(), fmt, swap)
                if not (np.array_equal(planes[0], ref.real)
                        and np.array_equal(planes[1], ref.imag)):
                    bad.append(f"decode_iq_planes {fmt} swap={swap}")
            if fmt in ("i16", "i8", "u8"):
                x = raw.astype(np.int16)
                x = x << 8 if fmt == "i8" else (x - 128) << 8 if fmt == "u8" \
                    else x
                want = np.stack([x[1::2], x[0::2]] if swap
                                else [x[0::2], x[1::2]])
                if not np.array_equal(runtime.deint_iq_planes_i16(
                        raw.tobytes(), fmt, swap), want):
                    bad.append(f"deint_iq_planes_i16 {fmt} swap={swap}")
            dev = iqformat.decode_iq(torch.from_numpy(raw).cuda(), fmt, swap)
            if not (dev.is_cuda and np.array_equal(dev.cpu().numpy(), ref)):
                bad.append(f"decode_iq on cuda {fmt} swap={swap}")
    log(f"phase46 native decode (5 formats), i16 deinterleave (3) and "
        f"decode_iq on cuda (6 formats), each with and without the swap, "
        f"on {n} samples: {len(bad)} mismatches {bad}")
    if not ok or bad:
        raise RuntimeError("phase46: the native runtime or the decode failed")
    return {"library": str(runtime.library_path())}


def start_server(path: str) -> tuple:
    """`python -m pebblesdr_tpu_torch.serve.server --source file --path
    path --port P` (it paces the file in real time), started as a user
    starts it; returns (process, port) once it listens."""
    import select
    import socket
    import os
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pebblesdr_tpu_torch.serve.server", "--source",
         "file", "--path", path, "--host", "127.0.0.1", "--port", str(port)],
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.getcwd()})
    deadline = time.monotonic() + 120
    line = ""
    while time.monotonic() < deadline and proc.poll() is None:
        if select.select([proc.stderr], [], [], 1.0)[0]:
            line = proc.stderr.readline()
            if "serving" in line:
                return proc, port
    proc.kill()
    raise RuntimeError(f"the rtl_tcp server did not start: {line!r}")


def stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def phase_rtl_tcp(torch, front, wfm_tail, wav) -> dict:
    """Phase 47: rtl_tcp at full width.  The port's server (python -m
    pebblesdr_tpu_torch.serve.server, a subprocess pacing an AM recording
    in real time) feeds the port's CLI in this process under
    torch.profiler: --source rtl_tcp, 64 channels, 32 blocks of 32768
    frames per dispatch, 4 dispatches, AM at 250 kHz, --audio-out pipe:dd.
    front_fir in the trace, K1 launched once per dispatch and once for the
    CLI's warm-up dispatch (counts set to 0 just before the run, read
    just after), the piped channel-0 PCM's 1 kHz
    tone SNR >= 40 dB, every dispatch after the first doing its work (the
    CLI's loop pass less its read, which waits for the server's clock) in
    under its 512 ms of signal, the paced sink's overruns 0.  Then an
    unpaced run (an in-process RtlTcpServer over FileSource(pace=False),
    8 dispatches): every pass after the first, read included, under 512
    ms; its realtime factor and the per-dispatch split (read: the socket
    read and u8 decode; plane: the [K N, 2C] plane's build; copy: host to
    device; step: copy, dispatch and the audio's fetch; dispatch: the
    whole pass; work: the pass less its read)."""
    import os

    from pebblesdr_tpu_torch.io import rtl_tcp, sources
    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(LIVE_DIR, exist_ok=True)
    rec = live_recording(wav, os.path.join(LIVE_DIR, "am.wav"), 1.0, "am")
    pcm = os.path.join(LIVE_DIR, "am_pcm.raw")
    proc, port = start_server(rec)
    try:
        reset_launches(front, wfm_tail)
        rc, m, _, names, split = run_cli(
            torch, cli, ["--source", "rtl_tcp", "--port", str(port),
                         "--mode", "AM", "--tune", "250000",
                         "--audio-out", f"pipe:dd of={pcm} status=none"]
            + full_width_argv(LIVE_PACED_DISPATCHES))
        counts = launch_counts(front, wfm_tail)
    finally:
        stop_server(proc)
    live = np.fromfile(pcm, "<f4")
    live = live[live != 0.0]          # the paced sink's underrun silence
    snr = tone_snr_db(live[-48_000:].astype(np.float64), 48_000.0)
    fir = any("front_fir" in nm for nm in names)
    sink = m.get("audio_sink", {})
    log(f"phase47 rtl_tcp paced (AM, 64 ch, K 32, N 32768): rc {rc}, "
        f"{m['blocks']} blocks, realtime factor {m['realtime_factor']}, "
        f"work ms {split.get('work')} (each < {LIVE_DISPATCH_MS:.0f}); "
        f"launches "
        f"{counts}; front_fir in the trace {fir}; audio sink {sink}; piped "
        f"PCM {len(live)} samples, 1 kHz tone SNR over its last second "
        f"{snr:.2f} dB (>= {TONE_SNR_DB})")
    log(f"phase47 paced split: {split_text(split)}")
    # one K1 per dispatch, and one for the CLI's warm-up dispatch of zeros
    # before it opens a network source
    want = m["blocks"] // HEADLINE["blocks"] + 1
    if not (rc == 0 and fir and m["blocks"] == LIVE_PACED_DISPATCHES
            * HEADLINE["blocks"] and counts["fused_front"] == want
            and counts["front_means"] == want
            and counts["front_dc_scan"] == want
            and split["work"]["max"] < LIVE_DISPATCH_MS
            and sink.get("overruns") == 0 and snr >= TONE_SNR_DB):
        raise RuntimeError("phase47: the paced rtl_tcp run failed")

    server = rtl_tcp.RtlTcpServer(sources.FileSource(rec, pace=False),
                                  port=0, block=16384)
    server.start()
    try:
        reset_launches(front, wfm_tail)
        rc, m, _, _, split = run_cli(
            torch, cli, ["--source", "rtl_tcp", "--port", str(server.port),
                         "--mode", "AM", "--tune", "250000", "--audio-out",
                         os.path.join(LIVE_DIR, "am_free.wav")]
            + full_width_argv(LIVE_FREE_DISPATCHES), profiled=False)
        counts = launch_counts(front, wfm_tail)
    finally:
        server.stop()
    a = read_audio_wav(os.path.join(LIVE_DIR, "am_free.wav"))[:, 0]
    snr = tone_snr_db(a[len(a) // 2:], m["audio_rate"])
    log(f"phase47 rtl_tcp unpaced: rc {rc}, {m['blocks']} blocks, realtime "
        f"factor {m['realtime_factor']}, wall {m['wall_s']} s, Msps "
        f"{m['msps']}, step ms {m['step_ms']}, dispatch ms "
        f"{split.get('dispatch')} (each < {LIVE_DISPATCH_MS:.0f}); launches "
        f"{counts}; tone SNR {snr:.2f} dB")
    log(f"phase47 unpaced split: {split_text(split)}")
    if not (rc == 0 and counts["fused_front"] == LIVE_FREE_DISPATCHES + 1
            and split["dispatch"]["max"] < LIVE_DISPATCH_MS
            and snr >= TONE_SNR_DB):
        raise RuntimeError("phase47: the unpaced rtl_tcp run failed")
    return {"realtime_factor": m["realtime_factor"], "split": split}


def phase_rtl_tcp_fms(torch, front, wfm_tail, wav) -> dict:
    """Phase 48: FM stereo with --rds over rtl_tcp at full width: an
    in-process RtlTcpServer serves the PEBBLES recording (inside the u8
    range) to the CLI (64 channels, 2 dispatches of 32 blocks of 32768
    frames) under torch.profiler: K1's WFM form and K2 launched once per
    dispatch and once for the warm-up, wfm_tail_march and front_disc in
    the trace, the PS decoded
    from the u8 wire as "PEBBLES "."""
    import os

    from pebblesdr_tpu_torch.io import rtl_tcp, sources
    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(LIVE_DIR, exist_ok=True)
    rec = live_recording(wav, os.path.join(LIVE_DIR, "fm_rds.wav"), 1.1,
                         "rds")
    server = rtl_tcp.RtlTcpServer(sources.FileSource(rec, pace=False),
                                  port=0, block=16384)
    server.start()
    try:
        reset_launches(front, wfm_tail)
        rc, m, _, names, split = run_cli(
            torch, cli, ["--source", "rtl_tcp", "--port", str(server.port),
                         "--mode", "FM-Stereo", "--tune", "250000", "--rds"]
            + full_width_argv(2))
        counts = launch_counts(front, wfm_tail)
    finally:
        server.stop()
    k2 = any("wfm_tail_march" in nm for nm in names)
    disc = any("front_disc" in nm for nm in names)
    log(f"phase48 rtl_tcp FMS + RDS (64 ch, K 32): rc {rc}, {m['blocks']} "
        f"blocks, realtime factor {m['realtime_factor']}, step ms "
        f"{m['step_ms']}; launches {counts}; wfm_tail_march {k2}, front_disc "
        f"{disc} in the trace; RDS {m.get('rds')}")
    if not (rc == 0 and k2 and disc and counts["wfm_tail"] == 3
            and counts["fused_front"] == 3
            and m.get("rds", {}).get("ps") == "PEBBLES "):
        raise RuntimeError("phase48: FM stereo over rtl_tcp failed")
    return {"realtime_factor": m["realtime_factor"]}


class DspServer:
    """A minimal ghpsdr3 dspserver on loopback: answers startaudiostream
    with four frames of a-law audio (a 440 Hz tone at 0.5)."""

    def __init__(self):
        import socket
        import threading
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(10.0)
        self.port = self.sock.getsockname()[1]
        self.commands = []
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    def run(self):
        import struct

        from pebblesdr_tpu_torch.io import ghpsdr3
        from pebblesdr_tpu_torch.ops.util_filters import alaw_compress
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        t = np.arange(2000) / ghpsdr3.AUDIO_RATE
        payload = alaw_compress((0.5 * np.sin(2 * np.pi * 440 * t)).astype(
            np.float32)).tobytes()
        try:
            while True:
                cmd = conn.recv(64)
                if not cmd:
                    return
                text = cmd.rstrip(b"\0").decode(errors="replace")
                self.commands.append(text)
                if text.startswith("startaudiostream"):
                    hdr = bytearray(ghpsdr3.HEADER_LEN)
                    hdr[0] = ghpsdr3.AUDIO_BUFFER
                    hdr[1:3] = struct.pack(">H", len(payload))
                    for _ in range(4):
                        conn.sendall(bytes(hdr) + payload)
        except OSError:
            pass
        finally:
            conn.close()
            self.sock.close()


def phase_net_sources(torch, receiver, front, wfm_tail, wav) -> dict:
    """Phase 49: SDR-IP, HPSDR, ghpsdr3 and the soundcard source.
    SDR-IP: the port's SdrIpServer (in a subprocess, pacing the AM
    recording in real time at 2.048 Msps: 8000 datagrams/s) feeds the CLI
    at full width (64 channels, dispatches of 32 blocks of 32768 frames,
    4 dispatches) through the native UDP pump, which must be the source's
    data plane: the pump received as many datagrams as the server says it
    sent, none dropped, restarted or overrun; every dispatch after the
    first did its work (the pass less its read) in under 512 ms; K1 once
    per dispatch and once for the warm-up; the tone SNR over the run's
    second half >= 40 dB.  HPSDR: the port's
    HpsdrServer (192 ksps, paced) feeds the CLI (64 channels, 8192
    frames, K 8) with --bandscope --display waterfall: bandscope_frames >
    0, the BS rows printed.  ghpsdr3: a loopback dspserver round trip (the
    440 Hz tone through a-law within 5 %).  AudioIqSource over a WavStream
    (an AM station in a 256 ksps stereo capture) feeds the port's Receiver
    on the card: the 1 kHz tone SNR >= 40 dB."""
    import os

    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.io import audio_iq, ghpsdr3, hpsdr, sources
    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(LIVE_DIR, exist_ok=True)
    rec = os.path.join(LIVE_DIR, "am.wav")
    out = {}

    # SDR-IP through the native pump, paced, at full width
    code = ("import sys, time\n"
            "from pebblesdr_tpu_torch.io import sdr_ip, sources\n"
            "srv = sdr_ip.SdrIpServer(sources.FileSource(sys.argv[1], "
            "pace=True), port=0)\n"
            "srv.start()\n"
            "print(srv.port, flush=True)\n"
            "sys.stdin.read()\n"
            "srv.stop()\n"
            "print(srv.datagrams_sent, flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code, rec],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True,
                            env={**os.environ, "PYTHONPATH": os.getcwd()})
    sent = None
    try:
        port = int(proc.stdout.readline())
        reset_launches(front, wfm_tail)
        rc, m, _, _, split = run_cli(
            torch, cli, ["--source", "sdr_ip", "--port", str(port), "--mode",
                         "AM", "--tune", "250000", "--audio-out",
                         os.path.join(LIVE_DIR, "sdr_ip.wav")]
            + full_width_argv(SDR_IP_DISPATCHES), profiled=False)
        counts = launch_counts(front, wfm_tail)
        proc.stdin.close()
        sent = int(proc.stdout.readline())
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    counters = m.get("source_counters", {})
    a = read_audio_wav(os.path.join(LIVE_DIR, "sdr_ip.wav"))[:, 0]
    snr = tone_snr_db(a[len(a) // 2:], m["audio_rate"])
    log(f"phase49 SDR-IP paced (AM, 64 ch, K 32, N 32768): rc {rc}, "
        f"{m['blocks']} blocks, realtime factor {m['realtime_factor']}, "
        f"server sent {sent} datagrams, native pump counters {counters}; "
        f"work ms {split.get('work')} (each < {LIVE_DISPATCH_MS:.0f}); "
        f"launches {counts}; tone SNR over the second half {snr:.2f} dB "
        f"(>= {TONE_SNR_DB})")
    log(f"phase49 SDR-IP split: {split_text(split)}")
    # received + counted = sent: the datagrams the pump took plus the
    # sequence gaps it counted; blocks that found no ring slot at the stop
    # are counted in 'discarded' (logged above), never dropped silently
    if not (rc == 0 and "resyncs" in counters and "overruns" in counters
            and "discarded" in counters
            and counters["datagrams"] + counters["dropped_datagrams"] == sent
            and counters["datagrams"] == sent
            and counters["dropped_datagrams"] == 0
            and counters["resyncs"] == 0 and counters["overruns"] == 0
            and m["blocks"] == SDR_IP_DISPATCHES * HEADLINE["blocks"]
            and counts["fused_front"] == SDR_IP_DISPATCHES + 1
            and split["work"]["max"] < LIVE_DISPATCH_MS
            and snr >= TONE_SNR_DB):
        raise RuntimeError("phase49: SDR-IP through the native pump failed")
    out["sdr_ip"] = {"sent": sent, "counters": counters, "snr_db": snr,
                     "split": split}

    # HPSDR with the bandscope waterfall
    h = HPSDR_RUN
    src = sources.SyntheticSource(h["fs"], tones=((20_000.0, 0.25),
                                                  (21_000.0, 0.1),
                                                  (19_000.0, 0.1)),
                                  noise_db=-60.0)
    server = hpsdr.HpsdrServer(src)
    server.start()
    try:
        rc, m, lines, names, _ = run_cli(
            torch, cli, ["--source", "hpsdr", "--port", str(server.port),
                         "--sample-rate", str(h["fs"]), "--mode", "AM",
                         "--tune", "20000", "--channels", str(h["channels"]),
                         "--frames", str(h["frames"]),
                         "--blocks-per-dispatch", str(h["blocks"]),
                         "--seconds", str(h["seconds"]), "--bandscope",
                         "--display", "waterfall"])
    finally:
        server.stop()
    bs_rows = sum(ln.startswith("BS ") for ln in lines)
    log(f"phase49 HPSDR (192 ksps, 64 ch, N 8192, K 8): rc {rc}, "
        f"{m['blocks']} blocks, realtime factor {m['realtime_factor']}, "
        f"snr {m['snr_db']} dB, bandscope_frames {m.get('bandscope_frames')}"
        f", {bs_rows} BS rows printed, front_fir in the trace "
        f"{any('front_fir' in nm for nm in names)}")
    if not (rc == 0 and m.get("bandscope_frames", 0) > 0
            and bs_rows == m["bandscope_frames"]):
        raise RuntimeError("phase49: HPSDR with the bandscope failed")
    out["hpsdr"] = {"bandscope_frames": m["bandscope_frames"]}

    # ghpsdr3 round trip
    dsp = DspServer()
    client = ghpsdr3.Ghpsdr3Client("127.0.0.1", dsp.port)
    client.set_frequency(7_100_000)
    client.start_audio()
    audio = client.read_audio(4000)
    client.close()
    amp = tone_amplitude(audio.astype(np.float64), ghpsdr3.AUDIO_RATE, 440.0)
    log(f"phase49 ghpsdr3 loopback: {len(audio)} samples, 440 Hz amplitude "
        f"{amp:.4f} (0.5 within 5 %), commands {dsp.commands}")
    if not (abs(amp - 0.5) <= 0.025
            and "setfrequency 7100000" in dsp.commands):
        raise RuntimeError("phase49: the ghpsdr3 round trip failed")

    # the soundcard IQ source into the Receiver on the card
    fs, n, c = 256_000, 16384, 4
    t = np.arange(fs) / fs
    iq = 0.5 * (1 + 0.8 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 40_000.0 * t)
    frames = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)
    src = audio_iq.AudioIqSource(
        sample_rate=fs, stream_factory=lambda: audio_iq.WavStream(frames))
    rx = Receiver(ReceiverConfig(sample_rate=fs, frames_per_buffer=n,
                                 channels=c, mode=DemodMode.AM,
                                 agc_mode="off"), "cuda")
    state, params = rx.init_state(), rx.default_params(40_000.0)
    reset_launches(front, wfm_tail)
    outs = []
    for blk in src.blocks(n, max_blocks=24):
        plane = np.concatenate([np.repeat(blk.real[:, None], c, 1),
                                np.repeat(blk.imag[:, None], c, 1)], axis=1)
        state, o = rx.step(state, params, torch.from_numpy(plane).cuda())
        outs.append(o["audio"][0].cpu().numpy())
    k1 = front.fused_front.launches
    a = np.concatenate(outs)
    snr = tone_snr_db(a[len(a) // 2:].astype(np.float64), rx.cfg.audio_rate)
    log(f"phase49 AudioIqSource (WavStream, 256 ksps AM) into the Receiver on "
        f"the card (4 ch, 24 blocks of 16384): K1 launches {k1}, tone SNR "
        f"{snr:.2f} dB (>= {TONE_SNR_DB})")
    if not (k1 == 24 and snr >= TONE_SNR_DB):
        raise RuntimeError("phase49: the soundcard source on the card failed")
    out["audio_iq_snr_db"] = snr
    return out


def phase_control(torch, front, wfm_tail, wav) -> dict:
    """Phase 50: the control surface on the card, through the CLI at 64
    channels with --display spectrum and --keys (one key per dispatch of
    32 blocks of 32768 frames).  (1) USB on a tone at tune + 1 kHz, keys
    "x", Left: the retune moves the demodulated tone from 1 kHz (dispatch
    1) to 2 kHz (dispatch 2).  (2) FM-Mono on a recording of an AM station
    at 250 kHz and a stronger one at -300 kHz, keys "x", "p", "m", "x",
    "q": 'p' snaps to the -300 kHz carrier within one bin of the 2048-bin
    display spectrum, 'm' rebuilds the chain in the next mode, FM stereo,
    on cuda (K1's WFM form and K2 launched once per dispatch after it,
    wfm_tail_march and front_disc in the trace), 'q' ends the run after 4
    dispatches; control_events printed."""
    import os

    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(LIVE_DIR, exist_ok=True)
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    path = os.path.join(LIVE_DIR, "usb_keys.wav")
    reset_launches(front, wfm_tail)
    rc, m, lines, _, _ = run_cli(
        torch, cli, ["--synthetic", "tone", "--mode", "USB", "--tune",
                     "400000", "--noise-db", "-60", "--display", "spectrum",
                     "--keys", "x\x1b[D", "--audio-out", path]
        + full_width_argv(2), profiled=False)
    a = read_audio_wav(path)[:, 0]
    half = len(a) // 2
    seg = half // 2
    amps = {(d, f): tone_amplitude(a[d * half + seg:(d + 1) * half],
                                   m["audio_rate"], f)
            for d in (0, 1) for f in (1000.0, 2000.0)}
    log(f"phase50 keys USB retune: rc {rc}, events {m['control_events']}, "
        f"tune {m['tune_hz']}; tone amplitude dispatch 1: 1 kHz "
        f"{amps[0, 1000.0]:.4f}, 2 kHz {amps[0, 2000.0]:.4f}; dispatch 2: "
        f"1 kHz {amps[1, 1000.0]:.4f}, 2 kHz {amps[1, 2000.0]:.4f}; "
        f"{len(lines)} display lines; K1 launches "
        f"{front.fused_front.launches}")
    if not (rc == 0 and m["tune_hz"] == 399_000.0
            and amps[0, 1000.0] > 10 * amps[0, 2000.0]
            and amps[1, 2000.0] > 10 * amps[1, 1000.0]):
        raise RuntimeError("phase50: the retune did not move the tone")

    rec = live_recording(wav, os.path.join(LIVE_DIR, "two.wav"), 1.0, "two")
    reset_launches(front, wfm_tail)
    rc, m, lines, names, _ = run_cli(
        torch, cli, ["--wav", rec, "--mode", "FM-Mono", "--tune", "250000",
                     "--display", "spectrum", "--keys", "xpmxq"]
        + full_width_argv(6))
    counts = launch_counts(front, wfm_tail)
    k2 = any("wfm_tail_march" in nm for nm in names)
    disc = any("front_disc" in nm for nm in names)
    bin_hz = FS / 2048
    log(f"phase50 keys FMM -> p -> m: rc {rc}, control_events "
        f"{m['control_events']}, tune {m['tune_hz']} Hz (the carrier at "
        f"-300000, one bin {bin_hz:.0f} Hz), final mode {m['final_mode']}, "
        f"{m['blocks']} blocks; launches {counts}; wfm_tail_march {k2}, "
        f"front_disc {disc} in the trace")
    if not (rc == 0 and abs(m["tune_hz"] + 300_000.0) <= bin_hz
            and m["final_mode"] == "FM-Stereo" and k2 and disc
            and counts["wfm_tail"] == 2 and counts["fused_front"] == 4
            and m["control_events"][1:] == ["MODE FM-Stereo", "QUIT"]
            and m["blocks"] == 4 * k):
        raise RuntimeError("phase50: the control surface on the card failed")
    return {"events": m["control_events"]}


# ---- phases 51-54: parallel/ (mode experts, --assign, the sharded receiver)

PAR_DIR = "build/chip_smoke_parallel"
EXPERT_TUNES = -945_000.0 + 30_000.0 * np.arange(64)   # 64 stations 30 kHz apart
EXPERT_MODES = tuple("AM" if i % 4 < 2 else "USB" if i % 4 == 2 else "FMN"
                     for i in range(64))              # 32 AM, 16 USB, 16 FMN
EXPERT_ATOL = 1e-5       # each expert vs its mode's single-mode Receiver
SHARD = dict(channel=2, time=2, dispatches=3)
SHARD_ATOL = 2e-3        # sharded vs unsharded audio (tests/test_parallel.py)
SHARD_TUNES = 250_000.0 + 40.0 * np.arange(64)
BANK_SHARD = dict(fs=1_024_000, frames=16384, m=32, blocks=3, stations=8)
FFT_SHARD = (256, 1024)  # N1 x N2 of phase 54's sharded FFT
PIPE_SHARD = dict(fs=512_000, n=8192, c=2, blocks=5)


def expert_capture(torch, rows: int):
    """[rows, 2] float32: one 2.048 Msps capture, made on the card in
    float64, of 64 stations at EXPERT_TUNES: AM (1 kHz, m = 0.8), USB (a
    1 kHz tone above its carrier frequency) and NFM (1 kHz at 3 kHz
    deviation), 0.01 each, by EXPERT_MODES."""
    t = torch.arange(rows, dtype=torch.float64, device="cuda") / FS
    tone = 2 * np.pi * 1000.0 * t
    z = torch.zeros(rows, dtype=torch.complex128, device="cuda")
    for f, mode in zip(EXPERT_TUNES, EXPERT_MODES):
        if mode == "AM":
            z += 0.01 * (1 + 0.8 * torch.cos(tone)) * torch.exp(
                2j * np.pi * f * t)
        elif mode == "USB":
            z += 0.01 * torch.exp(2j * np.pi * (f + 1000.0) * t)
        else:
            z += 0.01 * torch.exp(1j * (2 * np.pi * f * t
                                        + 3.0 * torch.sin(tone)))
    return torch.stack([z.real, z.imag], dim=1).float().contiguous()


def shared_lanes(torch, iq, c: int):
    """A shared [rows, 2] capture as a [rows, 2c] plane (an expert's
    gather)."""
    idx = torch.tensor([0] * c + [1] * c, device=iq.device)
    return iq.index_select(1, idx)


def phase_experts(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phase 51: the mode experts at full width: one 2.048 Msps capture,
    64 channels (32 AM, 16 USB, 16 FMN, 30 kHz apart), N 32768, K 32,
    through ModeExpertChannelizer.step_many on the card.  Warm-up then
    WINDOWS event windows of WINDOW_DISPATCHES dispatches, K1 counted by
    fused_front.launches (experts x dispatches); the warm-up's three
    dispatches held, expert by expert, to its mode's single-mode Receiver
    on the same rows within 1e-5; the tone SNR of every AM and USB
    channel's last dispatch >= 40 dB; the dispatches' profile (enqueue,
    busy, kernels by name); then K1 at the AM expert's [K*N, 64] against
    its plain version, both timed."""
    from pebblesdr_tpu_torch.parallel import expert
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    assign = [expert.ChannelAssignment(DemodMode[m], f)
              for m, f in zip(EXPERT_MODES, EXPERT_TUNES)]
    ch = expert.ModeExpertChannelizer(FS, n, assign, device="cuda",
                                      agc_stride=HEADLINE["agc_stride"])
    iq = expert_capture(torch, k * n)
    # each mode's single-mode Receiver over the same rows, first
    refs = []
    for g in ch.groups:
        c = len(g.channel_ids)
        rx = receiver.Receiver(receiver.ReceiverConfig(
            sample_rate=FS, frames_per_buffer=n, channels=c, mode=g.mode,
            agc_stride=HEADLINE["agc_stride"]), "cuda")
        p, s = rx.default_params(g.tunes), rx.init_state()
        for _ in range(WARMUP):
            s, o = rx.step_many(s, p, shared_lanes(torch, iq, c))
        refs.append(o["audio"])
    st = [ch.init_states()]
    outs = [None]

    def dispatch():
        st[0], outs[0] = ch.step_many(st[0], iq)

    reset_launches(front, wfm_tail)
    for _ in range(WARMUP):
        dispatch()
    torch.cuda.synchronize()
    errs = {g.mode.value: float((ref - out["audio"]).abs().max())
            for g, ref, out in zip(ch.groups, refs, outs[0])}
    windows = []
    for _ in range(WINDOWS):
        windows.append(time_cuda(torch, dispatch, WINDOW_DISPATCHES))
    torch.cuda.synchronize()
    n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
    launches = front.fused_front.launches
    audio = ch.audio_by_channel(outs[0], many=True)
    rate = ch.receivers[0][0].cfg.audio_rate
    snrs = {i: tone_snr_db(audio[i][len(audio[i]) // 2:], rate)
            for i, m in enumerate(EXPERT_MODES) if m != "FMN"}
    finite = all(bool(torch.isfinite(o["audio"]).all()) for o in outs[0])
    best = min(windows)
    log(f"phase51 mode experts (64 ch: 32 AM, 16 USB, 16 FMN) x {n} x {k}: "
        f"dispatch ms per window " + " ".join(f"{w:.4f}" for w in windows)
        + f"; {64 * n * k / (best / 1e3) / 1e6:.1f} Msps, "
        f"{n * k / (best / 1e3) / FS:.1f}x realtime per channel; K1 "
        f"launches {launches} for {n_dispatch} dispatches of "
        f"{ch.n_experts} experts; audio vs the single-mode Receivers "
        + ", ".join(f"{m} {v:.3g}" for m, v in errs.items())
        + f" (<= {EXPERT_ATOL}); tone SNR AM min "
        f"{min(v for i, v in snrs.items() if EXPERT_MODES[i] == 'AM'):.2f}"
        f" dB, USB min "
        f"{min(v for i, v in snrs.items() if EXPERT_MODES[i] == 'USB'):.2f}"
        f" dB (>= {TONE_SNR_DB})")
    prof = dispatch_profile(torch, {"name": "experts_64ch", "state": None},
                            "phase51", dispatch=dispatch)
    times = kernel_times(torch, dispatch, want=("front_fir",))
    log(f"phase51 experts' kernels per launch: {breakdown_text(times)}")
    if not (launches == ch.n_experts * n_dispatch and finite
            and max(errs.values()) <= EXPERT_ATOL
            and min(snrs.values()) >= TONE_SNR_DB):
        raise RuntimeError("phase51: the mode experts on the card failed")
    # K1 at the AM expert's shape, against its plain version, both timed
    rx_am = ch.receivers[0][0]
    c = rx_am.cfg.channels
    plan = rx_am.front
    x = shared_lanes(torch, iq, c).contiguous()
    p = ch.params[0][0]
    z = dict(dtype=torch.float32, device="cuda")
    args = (x, torch.zeros(1, 2 * c, **z) + 0.01, torch.zeros(c, **z),
            p.tune_hi, p.tune_lo, torch.randn(plan.d_rows, 2 * c, **z) * 0.01)
    got = front.fused_front(plan, *args, n_block=n)
    ref = front.fused_front_reference(plan, *args, n_block=n)
    err = max(rel_err(a, b) for a, b in zip(got[:4], ref[:4]))
    ms, plain_ms, _ = time_pair(
        torch, lambda: front.fused_front(plan, *args, n_block=n),
        lambda: front.fused_front_reference(plan, *args, n_block=n))
    k1_launch = kernel_times(torch, lambda: front.fused_front(
        plan, *args, n_block=n), want=("front_fir",))
    per_launch = sum(v[0] for v in k1_launch.values())
    log(f"phase51 K1 at the AM expert's [{k * n}, {2 * c}]: {ms:.4f} ms "
        f"(plain {plain_ms:.4f}), per launch {per_launch:.4f} ms "
        f"({breakdown_text(k1_launch)}), relative error {err:.3g} "
        f"(<= {FRONT_RTOL})")
    if not err <= FRONT_RTOL:
        raise RuntimeError("phase51: K1 at the AM expert's shape disagrees")
    return {"launches": launches, "max_abs_err": float(
        (got[0] - ref[0]).abs().max()), "ms": ms, "plain_ms": plain_ms,
        "per_launch_ms": per_launch, "shape": (k * n, 2 * c), "plan": plan,
        "errs": errs, "windows": windows, "profile": prof}


def phase_assign_cli(torch, front, wfm_tail) -> dict:
    """Phase 52: the CLI's --assign on the card (--device cuda --json):
    AM, USB, FMN and AM experts on the synthetic AM station at 250 kHz
    (noise at -60 dB), 3 dispatches of 32 blocks of 32768 frames; the
    channels' modes in order, K1 once per expert per dispatch, the
    per-channel WAVs written and the tone SNR of their last dispatch >= 40
    dB (AM and USB: the AM DC blocker and AGC settle over the first)."""
    import os

    from pebblesdr_tpu_torch.serve import cli
    os.makedirs(PAR_DIR, exist_ok=True)
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    path = os.path.join(PAR_DIR, "assign.wav")
    reset_launches(front, wfm_tail)
    rc, m, _, names, split = run_cli(
        torch, cli, ["--synthetic", "am", "--tune", "250000", "--noise-db",
                     "-60", "--assign", "AM@250000,USB@250000,FMN@250000,"
                     "AM@250000", "--frames", str(n), "--blocks-per-dispatch",
                     str(k), "--seconds", repr(3 * k * n / FS),
                     "--audio-out", path])
    counts = launch_counts(front, wfm_tail)
    snrs = {}
    for c in m["channels"]:
        a = read_audio_wav(os.path.join(PAR_DIR, f"assign.ch{c['channel']}"
                                                 f".wav"))[:, 0]
        snrs[c["channel"]] = tone_snr_db(a[2 * len(a) // 3:], 48000.0)
    log(f"phase52 --assign on the card: rc {rc}, {m['blocks']} blocks, "
        f"realtime factor {m['realtime_factor']}, channels "
        + ", ".join(f"{c['channel']} {c['mode']} S-meter SNR {c['snr_db']} "
                    f"dB, rms {c['audio_rms']}, WAV tone SNR "
                    f"{snrs[c['channel']]:.2f} dB" for c in m["channels"])
        + f"; launches {counts}; front_fir in the trace "
        f"{any('front_fir' in nm for nm in names)}; step ms {m['step_ms']}")
    if not (rc == 0 and [c["mode"] for c in m["channels"]]
            == ["AM", "USB", "FMN", "AM"] and m["blocks"] == 3 * k
            and counts["fused_front"] == 3 * 3
            and all(snrs[i] >= TONE_SNR_DB for i in (0, 1, 3))):
        raise RuntimeError("phase52: --assign on the card failed")
    return {"snrs": snrs, "realtime": m["realtime_factor"]}


def shard_plane(torch):
    """[K*N, 128] float32: am_64ch's dispatch plane on the card (the AM
    carrier at 250 kHz on every channel, one block repeated K times)."""
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    block = torch.from_numpy(am_plane(HEADLINE["channels"], n, None))
    return block.cuda().repeat(k, 1).contiguous()


def shard_receiver(torch, receiver, DemodMode):
    return receiver.Receiver(receiver.ReceiverConfig(
        sample_rate=FS, frames_per_buffer=HEADLINE["frames"],
        channels=HEADLINE["channels"], mode=DemodMode.AM,
        agc_stride=HEADLINE["agc_stride"]), "cuda")


def bank_shard_setup(torch, DemodMode, device):
    """The sharded bank's PfbBankReceiver and capture (phase 54)."""
    from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
    from pebblesdr_tpu_torch.ops import pfb
    b = BANK_SHARD
    plan = pfb.plan(b["fs"], b["m"])
    tunes = pfb.channel_freqs(plan)[1:4 * b["stations"]:4] + 300.0
    bank = PfbBankReceiver(b["fs"], b["frames"], tunes, mode=DemodMode.AM,
                           n_bank=b["m"], agc_mode="off", device=device)
    rng = np.random.default_rng(3)
    n = b["blocks"] * b["frames"]
    t = np.arange(n) / b["fs"]
    x = sum(0.05 * (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t))
            * np.exp(2j * np.pi * f * t) for f in tunes)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return bank, x.astype(np.complex64)


def shard_worker(argv: list) -> int:
    """One rank of phase 53-54's world: `python chip_smoke.py --shard-rank
    RANK WORLD PORT OUTDIR`.  Joins the world on the card (the backend from
    the layout: gloo, the ranks sharing one card), runs the sharded AM
    receiver at am_64ch's geometry on a (2, 2) mesh (K1 per time shard,
    counted; one K1 call's inputs held to its plain version), then
    pfb_shard on (2, 2), dist_fft on (1, 4) and the 4-stage pipeline, and
    writes its results to OUTDIR/RANK.npz."""
    import os

    import torch

    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.ops import front, wfm_tail
    from pebblesdr_tpu_torch.parallel import channelizer, comm, dist_fft
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    from pebblesdr_tpu_torch.parallel import pipeline, scaling
    from pebblesdr_tpu_torch.parallel.pfb_shard import build_sharded_bank_step
    DemodMode = receiver.DemodMode
    rank, world, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    out = {"backend": comm.init_world(world, rank, "cuda",
                                      f"tcp://127.0.0.1:{port}")}
    m = mesh_mod.make_mesh(SHARD["channel"], SHARD["time"], "cuda")
    out["host_hops_mode"] = m.host_hops
    rx = shard_receiver(torch, receiver, DemodMode)
    step = channelizer.build_sharded_step(rx, m)
    out["fused"] = step.fused
    params = rx.default_params(SHARD_TUNES)
    x = mesh_mod.local_plane(shard_plane(torch), m)
    st = step.init_state()
    st, _ = step.step_many(st, params, x)             # warm
    st = step.init_state()
    torch.cuda.synchronize()
    reset_launches(front, wfm_tail)
    comm.reset_counters()
    audio = []
    with captured(front, "fused_front") as calls:
        for _ in range(SHARD["dispatches"]):
            st, o = step.step_many(st, params, x)
            audio.append(o["audio"])
        torch.cuda.synchronize()
    out["launches"] = [front.fused_front.launches, front.chunk_means.launches,
                       front.dc_scan.launches]
    c = comm.counters
    out["hops"] = [c["hops"], c["hop_bytes"]]
    out["collectives"] = json.dumps({"calls": c["calls"],
                                     "bytes": c["bytes"]})
    out["audio"] = torch.cat(audio).cpu().numpy()
    out["c0"] = step.c0
    out["coord"] = [m.index("channel"), m.index("time")]
    # K1 on the inputs the step gave it: the seeded dc and received tail
    args, kw = calls[-1]
    got = front.fused_front(*args, **kw)
    ref = front.fused_front_reference(*args, **kw)
    torch.cuda.synchronize()
    out["k1_err"] = max(rel_err(a, b) for a, b in zip(got[:4], ref[:4]))
    out["k1_abs"] = float((got[0] - ref[0]).abs().max())
    plan = rx.front
    # fused_front(plan, x, dc, phase0, f_hi, f_lo, tail, ...)
    out["seed"] = float(args[2].abs().max())                 # dc seed
    out["tail_rows"] = float(args[6][plan.d_rows - step.d:].abs().max())
    out["ms"] = time_cuda(torch, lambda: step.step_many(st, params, x), 3)
    # the sharded bank on (2, 2)
    bank, cap = bank_shard_setup(torch, DemodMode, m.device)
    bstep = build_sharded_bank_step(bank, m)
    bst = bstep.init_state()
    b = BANK_SHARD
    t0, t1 = mesh_mod.time_range(m, b["frames"])
    baud = []
    for i in range(b["blocks"]):
        blk = torch.from_numpy(cap[i * b["frames"]:(i + 1) * b["frames"]]
                               [t0:t1].copy()).cuda()
        bst, o = bstep(bst, None, blk)
        baud.append(o["audio"][0])
    out["bank_audio"] = torch.cat(baud, -1).cpu().numpy()
    out["bank_s0"] = bstep.s0
    # the sharded FFT on (1, 4)
    fm = mesh_mod.make_mesh(1, 4, "cuda")
    n1, n2 = FFT_SHARD
    xf = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n1, n2, 2)).astype(np.float32)).cuda()
    out["fft"] = dist_fft.fft_sharded(torch.view_as_complex(xf), fm
                                      ).cpu().numpy()
    # the 4-stage pipeline
    prx = receiver.Receiver(receiver.ReceiverConfig(
        sample_rate=PIPE_SHARD["fs"], frames_per_buffer=PIPE_SHARD["n"],
        channels=PIPE_SHARD["c"], mode=DemodMode.AM, taps=True), "cuda")
    pp = prx.default_params(100_000.0)
    stages, init = pipeline.am_chain_stages(prx, pp)
    pipe = pipeline.RingPipeline(stages, pipeline.stage_mesh(4, "cuda"))
    xs = torch.from_numpy(pipe_planes()).cuda()
    _, ys = pipe.run(init, xs)
    pst, ref = prx.init_state(), []
    cc = PIPE_SHARD["c"]
    for xb in xs:
        pst, o = prx.step(pst, pp, torch.complex(xb[:cc], xb[cc:]),
                          spectra=False)
        ref.append(o["audio"])
    out["pipe_err"] = float((ys - torch.stack(ref)).abs().max())
    out["halo"] = json.dumps(scaling.halo_accounting(rx, rx.cfg.channels))
    np.savez(os.path.join(outdir, f"{rank}.npz"), **{
        key: np.asarray(v) for key, v in out.items()})
    comm.destroy_world()
    return 0


def pipe_planes() -> np.ndarray:
    """[T, 2C, N] float32 packed AM planes (tests/test_pipeline.py:30-43)."""
    c, n, fs, t_blocks = (PIPE_SHARD[key] for key in ("c", "n", "fs",
                                                      "blocks"))
    rng = np.random.default_rng(3)
    t = np.arange(t_blocks * n) / fs
    env = (1 + 0.5 * np.cos(2 * np.pi * 800.0 * t)) / 2
    iq = (env * np.exp(2j * np.pi * 100_000.0 * t)
          + 0.01 * (rng.normal(size=t_blocks * n)
                    + 1j * rng.normal(size=t_blocks * n))).astype(
        np.complex64)
    return np.stack([np.concatenate([np.broadcast_to(b.real, (c, n)),
                                     np.broadcast_to(b.imag, (c, n))], 0)
                     for b in iq.reshape(t_blocks, n)]).astype(np.float32)


def phase_sharded(torch, receiver, front, wfm_tail, DemodMode) -> dict:
    """Phases 53-54: the sharded receiver on the card.  A world of 4 ranks
    (subprocesses of this script, channel 2 x time 2) on the one H100:
    gloo, each payload hopping through the host (comm.py counts the hops
    and bytes); the AM receiver at am_64ch's geometry with the fused front,
    K1 per time shard (counted by each rank's wrapper counters: one per
    dispatch), its dc seeded from the closed form and its history from the
    left neighbour, one call held to its plain version on those inputs;
    the ranks' audio joined over channels within 2e-3 of the unsharded
    Receiver.step_many on the card, computed here meanwhile; the host hops
    and bytes per block beside scaling.halo_accounting.  Then, in the same
    world, pfb_shard (2e-4 of scale of the unsharded bank), dist_fft
    (2e-5 of scale of torch.fft) and the 4-stage pipeline (1e-5 of the
    staged Receiver).  Then a one-rank NCCL world in this process on the
    same step (2e-3).  Four ranks on one card measure correctness and host
    hops, not scaling."""
    import os
    import socket

    from pebblesdr_tpu_torch.parallel import channelizer, comm
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    world = SHARD["channel"] * SHARD["time"]
    outdir = os.path.join(PAR_DIR, "ranks")
    os.makedirs(outdir, exist_ok=True)
    for f in os.listdir(outdir):
        os.remove(os.path.join(outdir, f))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen([sys.executable, __file__, "--shard-rank",
                               str(r), str(world), port, outdir],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        # the unsharded references on the card, meanwhile
        rx = shard_receiver(torch, receiver, DemodMode)
        params = rx.default_params(SHARD_TUNES)
        plane = shard_plane(torch)
        st, ref = rx.init_state(), []
        for _ in range(SHARD["dispatches"]):
            st, o = rx.step_many(st, params, plane)
            ref.append(o["audio"])
        ref = torch.cat(ref).cpu().numpy()
        bank, cap = bank_shard_setup(torch, DemodMode, "cuda")
        bst, bref = bank.init_state(), []
        fr = BANK_SHARD["frames"]
        for i in range(BANK_SHARD["blocks"]):
            bst, o = bank.step(bst, torch.from_numpy(
                cap[i * fr:(i + 1) * fr]).cuda())
            bref.append(o["audio"])
        bref = torch.cat(bref, -1).cpu().numpy()
        n1, n2 = FFT_SHARD
        xf = np.random.default_rng(5).standard_normal((n1, n2, 2)).astype(
            np.float32)
        fref = torch.fft.fft(torch.view_as_complex(torch.from_numpy(xf)
                                                   .cuda()).reshape(-1))
        fref = fref.cpu().numpy()
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(text[-4000:])
            raise RuntimeError(f"phase53: rank {r} failed")
    res = []
    for r in range(world):
        with np.load(os.path.join(outdir, f"{r}.npz")) as z:
            res.append({key: z[key] for key in z.files})
    rows = {}
    for r in res:
        rows.setdefault(int(r["c0"]), r["audio"])
    got = np.concatenate([rows[c] for c in sorted(rows)], axis=1)
    err = float(np.abs(got - ref).max())
    halo = json.loads(str(res[0]["halo"]))
    k = HEADLINE["blocks"]
    per_block = [int(r["hops"][1]) / (SHARD["dispatches"] * k) for r in res]
    log(f"phase53 world: {world} ranks, backend {res[0]['backend']}, host "
        f"hops {bool(res[0]['host_hops_mode'])}; each rank's K1 launches "
        f"(fused_front, front_means, front_dc_scan) "
        + "; ".join(f"rank {i} {list(r['launches'])}"
                    for i, r in enumerate(res))
        + f" for {SHARD['dispatches']} dispatches")
    log(f"phase53 K1 per time shard vs its plain version on the inputs the "
        f"step gave it (dc seed max {[float(r['seed']) for r in res]}, "
        f"received history rows max {[float(r['tail_rows']) for r in res]}):"
        f" relative errors {[float(r['k1_err']) for r in res]} (<= "
        f"{FRONT_RTOL})")
    log(f"phase53 sharded (2 x 2, fused) vs unsharded step_many on the card:"
        f" max |audio| difference {err:.3g} (<= {SHARD_ATOL}) over "
        f"{SHARD['dispatches']} dispatches of {k} blocks x "
        f"{HEADLINE['channels']} ch; ms per dispatch per rank (4 ranks on "
        f"one card: not a scaling figure) {[float(r['ms']) for r in res]}")
    log(f"phase53 host hops per rank {[int(r['hops'][0]) for r in res]}, "
        f"bytes per block {per_block} (collectives "
        f"{str(res[0]['collectives'])}); halo_accounting {halo}")
    bank_rows = {int(r["bank_s0"]): r["bank_audio"] for r in res}
    bgot = np.concatenate([bank_rows[s] for s in sorted(bank_rows)], axis=0)
    bank_err = float(np.abs(bgot - bref).max() / max(np.abs(bref).max(),
                                                     1e-9))
    fgot = np.concatenate([r["fft"] for r in res], axis=0).reshape(-1)
    fft_err = float(np.abs(fgot - fref).max() / np.abs(fref).max())
    pipe_err = max(float(r["pipe_err"]) for r in res)
    log(f"phase54 pfb_shard (2 x 2, {BANK_SHARD['stations']} stations, M "
        f"{BANK_SHARD['m']}) vs the unsharded bank: {bank_err:.3g} of scale "
        f"(<= 2e-4); dist_fft ({FFT_SHARD[0]} x {FFT_SHARD[1]} over 4 ranks) "
        f"vs torch.fft: {fft_err:.3g} of scale (<= 2e-5); the 4-stage "
        f"pipeline vs the staged Receiver: {pipe_err:.3g} (<= 1e-5)")
    ok = (all(str(r["backend"]) == "gloo" and bool(r["host_hops_mode"])
              and bool(r["fused"])
              and list(r["launches"][:1]) == [SHARD["dispatches"]]
              and float(r["k1_err"]) <= FRONT_RTOL and int(r["hops"][0]) > 0
              for r in res)
          and all(float(r["tail_rows"]) > 0 for r in res
                  if int(r["coord"][1]) > 0)
          and err <= SHARD_ATOL and bank_err <= 2e-4 and fft_err <= 2e-5
          and pipe_err <= 1e-5)
    if not ok:
        raise RuntimeError("phase53-54: the sharded world on the card failed")
    # a one-rank NCCL world, in this process, on the same step
    be = comm.init_world(1, 0, "cuda")
    try:
        m = mesh_mod.make_mesh(1, 1, "cuda")
        step = channelizer.build_sharded_step(rx, m)
        st, one = step.init_state(), []
        reset_launches(front, wfm_tail)
        for _ in range(SHARD["dispatches"]):
            st, o = step.step_many(st, params, plane)
            one.append(o["audio"])
        torch.cuda.synchronize()
        k1 = front.fused_front.launches
        err1 = float(np.abs(torch.cat(one).cpu().numpy() - ref).max())
    finally:
        comm.destroy_world()
    log(f"phase53 one-rank world: backend {be}, K1 launches {k1}, audio vs "
        f"unsharded {err1:.3g} (<= {SHARD_ATOL})")
    if not (be == "nccl" and k1 == SHARD["dispatches"]
            and err1 <= SHARD_ATOL):
        raise RuntimeError("phase53: the one-rank NCCL world failed")
    launches = sum(int(r["launches"][0]) for r in res)
    return {"launches": launches, "err": err,
            "max_abs_err": max(float(r["k1_abs"]) for r in res),
            "hops": [int(r["hops"][0]) for r in res],
            "bytes_per_block": per_block,
            **phase_shard_k1_time(torch, front, rx)}


def phase_shard_k1_time(torch, front, rx) -> dict:
    """K1 at a time shard's shape ([K*N/2, 64]: 2 time x 2 channel shards
    of am_64ch), with a seeded dc and a received history, against its plain
    version, both timed (this process alone on the card)."""
    n, k = HEADLINE["frames"], HEADLINE["blocks"]
    c = HEADLINE["channels"] // SHARD["channel"]
    rows = k * n // SHARD["time"]
    plan = rx.front
    z = dict(dtype=torch.float32, device="cuda")
    x = torch.from_numpy(am_plane(c, n, None)).cuda().repeat(
        k // SHARD["time"], 1).contiguous()
    p = rx.default_params(SHARD_TUNES)
    args = (x, torch.zeros(1, 2 * c, **z) + 0.02,
            torch.rand(c, **z), p.tune_hi[:c].contiguous(),
            p.tune_lo[:c].contiguous(),
            torch.randn(plan.d_rows, 2 * c, **z) * 0.05)
    ms, plain_ms, _ = time_pair(
        torch, lambda: front.fused_front(plan, *args, n_block=rows),
        lambda: front.fused_front_reference(plan, *args, n_block=rows))
    times = kernel_times(torch, lambda: front.fused_front(
        plan, *args, n_block=rows), want=("front_fir",))
    per_launch = sum(v[0] for v in times.values())
    log(f"phase53 K1 at a time shard's [{rows}, {2 * c}]: {ms:.4f} ms "
        f"(plain {plain_ms:.4f}), per launch {per_launch:.4f} ms "
        f"({breakdown_text(times)})")
    return {"ms": ms, "plain_ms": plain_ms, "per_launch_ms": per_launch,
            "shape": (rows, 2 * c), "plan": plan}


PARITY = dict(channels=64, frames=32768, blocks=32, dispatches=2)
PARITY_CARRIERS = (-750_000.0, -250_000.0, 250_000.0, 750_000.0)
PARITY_MARGIN = 16384    # the goldens see half a block past the chain, as
#                          tests/test_parity.py's 1 s signal is 62.5 blocks:
#                          the analytic pilot's and resample_poly's edge
#                          lies past the chain's audio
PARITY_SPREAD = 1e-2     # chain / golden tone phasors, channel vs channel 0
PARITY_DIR = "build/chip_smoke_parity"
EXAMPLES_DIR = "build/chip_smoke_examples"


def phase_parity(torch, front, wfm_tail) -> dict:
    """Phase 55: the main path against the independent float64 golden at
    full width.  For each mode with a golden, one 2.048 Msps capture of two
    dispatches (and half a block for the goldens) holding
    tests/test_parity.py's signal at four carriers (tools/parity_harness.py
    parity_capture: carrier i's tones start at carrier_phase(i)), its 64
    channels tuned channel c to carrier c % 4, run on the card through
    Receiver.step_many (K = 32, the main path) and Receiver.step per block
    (tools/parity_harness.py run_chain, AGC off); every channel of both
    paths held to its carrier's golden with snr_db at the mode's threshold
    (parity_harness.MIN_SNR_DB) and its tone phasor to channel 0's (no
    channel reads another carrier); FM stereo's golden must demux
    (> 30 dB).  K1 launched once per dispatch and once per step, K2 as
    often for FMS and never otherwise, FMM on K1's F = 8 plan.  Then the
    harness's own command line on its fixture at full width, which must
    exit 0."""
    import os
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.tools import parity_harness as ph
    c, n, k, d = (PARITY[key] for key in ("channels", "frames", "blocks",
                                          "dispatches"))
    rows = n * k * d
    carrier_of = np.arange(c) % len(PARITY_CARRIERS)
    tunes = np.asarray(PARITY_CARRIERS)[carrier_of]
    t_phase = time.perf_counter()
    golden_s = 0.0
    res = {}
    for mode in ph.GOLDEN_MODES:
        iq = ph.parity_capture(mode, FS, rows + PARITY_MARGIN,
                               PARITY_CARRIERS)
        refs = None
        for path, batched, want_k1 in (("step_many", True, d),
                                       ("step", False, d * k)):
            reset_launches(front, wfm_tail)
            t0 = time.perf_counter()
            got, rx = ph.run_chain(iq, FS, mode, tunes, n, "cuda", blocks=k,
                                   batched=batched)
            chain_s = time.perf_counter() - t0
            k1 = front.fused_front.launches
            k2 = wfm_tail.wfm_tail.launches
            if refs is None:
                t0 = time.perf_counter()
                x_dc = ph.dc_removed64(iq)
                refs = [ph.golden(iq, FS, f, rx, x_dc=x_dc)
                        for f in PARITY_CARRIERS]
                golden_s += time.perf_counter() - t0
                if mode == DemodMode.FMS:
                    seps = [ph.separation_db(r[0], r[1], rx.cfg.audio_rate,
                                             ph.probe_tone(mode))
                            for r in refs]
                    log(f"phase55 FMS golden separation "
                        f"{', '.join(f'{v:.1f}' for v in seps)} dB (> "
                        f"{ph.GOLDEN_SEPARATION_DB})")
                    if min(seps) <= ph.GOLDEN_SEPARATION_DB:
                        raise RuntimeError("the FM stereo golden does not "
                                           "demux")
            snrs, spread = ph.hold_channels(got, refs, carrier_of, rx)
            floor = ph.MIN_SNR_DB[mode]
            want_k2 = want_k1 if mode == DemodMode.FMS else 0
            res[(mode.name, path)] = dict(
                min=float(snrs.min()), median=float(np.median(snrs)),
                max=float(snrs.max()), spread=spread, k1=k1, k2=k2,
                seconds=chain_s)
            log(f"phase55 {mode.name} {path}: SNR vs golden min "
                f"{snrs.min():.2f} median {np.median(snrs):.2f} max "
                f"{snrs.max():.2f} dB over {c} channels (>= {floor:.1f}), "
                f"phasor spread {spread:.2e}, K1 {k1} (want {want_k1}) K2 "
                f"{k2} (want {want_k2}), plan F = {rx.plan.factor}, "
                f"{got.shape[-1]} samples, {chain_s:.1f} s")
            if snrs.min() < floor:
                raise RuntimeError(f"{mode.name} {path}: channels "
                                   f"{np.flatnonzero(snrs < floor).tolist()} "
                                   f"below {floor} dB of the golden")
            if spread >= PARITY_SPREAD:
                raise RuntimeError(f"{mode.name} {path}: a channel reads "
                                   f"another carrier (spread {spread:.3g})")
            if (k1, k2) != (want_k1, want_k2):
                raise RuntimeError(f"{mode.name} {path}: K1 {k1} K2 {k2} "
                                   f"launches, want {want_k1} {want_k2}")
            if mode == DemodMode.FMM and rx.plan.factor != 8:
                raise RuntimeError(f"FMM plan factor {rx.plan.factor}")
    log(f"phase55 goldens took {golden_s:.1f} s on the host")
    os.makedirs(PARITY_DIR, exist_ok=True)
    fix = f"{PARITY_DIR}/fixture.wav"
    mod = [sys.executable, "-m", "pebblesdr_tpu_torch.tools.parity_harness"]
    subprocess.run(mod + ["--make-fixture", fix], check=True,
                   capture_output=True, text=True)
    t0 = time.perf_counter()
    proc = subprocess.run(mod + [fix, "--device", "cuda", "--channels",
                                 str(c), "--blocks", str(k), "--batched"],
                          capture_output=True, text=True, timeout=300)
    log(f"phase55 harness command line: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{' | '.join(proc.stdout.strip().splitlines())}")
    if proc.returncode != 0:
        raise RuntimeError(f"parity harness rc {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    log(f"phase55 took {time.perf_counter() - t_phase:.1f} s (goldens "
        f"{golden_s:.1f} s)")
    return dict(paths=res, golden_s=golden_s)


def phase_examples(torch) -> dict:
    """Phase 56: the port's examples 01-05 (pebblesdr_tpu_torch/examples/)
    on the card at the JAX examples' sizes, each outcome checked by the
    example's check(): the written audio and the S-meter (01), the channels
    on a station (02), pilot lock, separation and the PS name (03), the
    bank's stations (04), the DTMF digits "2468" and the CTCSS open
    (05)."""
    import importlib
    import io
    briefs = {
        "ex01_file_playback": lambda r: dict(
            samples=r["samples"], signal_db=round(r["signal_db"][-1], 2),
            snr_db=round(r["snr_db"][-1], 2)),
        "ex02_channelizer": lambda r: dict(hot=r["hot"]),
        "ex03_wfm_rds": lambda r: {key: r[key] for key in (
            "pilot_locked", "separation_db", "ps", "block_errors")},
        "ex04_station_bank": lambda r: dict(
            stations=len(r["stations"]), snr_db=round(r["snr_db"][0], 2),
            rms=round(r["rms"][0], 4)),
        "ex05_interactive_and_decoders": lambda r: {key: r[key] for key in (
            "digits", "ctcss_first_open", "events")}}
    res = {}
    for name, argv in (("ex01_file_playback", ["--out", EXAMPLES_DIR]),
                       ("ex02_channelizer", []), ("ex03_wfm_rds", []),
                       ("ex04_station_bank", []),
                       ("ex05_interactive_and_decoders", [])):
        mod = importlib.import_module(f"pebblesdr_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = mod.main(["--device", "cuda"] + argv)
        mod.check(out)
        brief = briefs[name](out)
        log(f"phase56 {name}: {brief} ({time.perf_counter() - t0:.1f} s)")
        res[name] = brief
    return res


QUALITY = dict(channels=64, frames=32768, blocks=32)   # am_64ch's geometry
QUALITY_RDS_SNRS = (12.0, 14.0, 16.0, 17.0, 20.0)      # channel c: c % 5
QUALITY_RDS_DISPATCHES = 2     # 64 blocks (bench_quality decodes 40)
MULTIPATH_SEPARATION_DB = 15.0  # tests/test_impairments.py:83
MULTIPATH_TONE = 0.5            # tests/test_impairments.py:84
AM_IMPAIR_DB = 1.0              # tests/test_impairments.py:103, :111
AM_WINDOWS = (12, 16, 32)       # blocks of the AM capture measured: the JAX
#                                 test's KB (its bound holds there),
#                                 bench_quality's, the whole dispatch
STATIONS = (-700_000.0, 0.0, 700_000.0)   # tests/test_robustness.py:21-22
STATION_TONES = (800.0, 1500.0, 2500.0)
LONG_RUN = dict(f0=123_456.0, step=7_919.0, dispatches=4)
AGC_HANG_DB = 3.0               # tests/test_ops_scans.py:200


def quality_capture(torch, front, wfm_tail, tag: str, planes, tunes,
                    cpu_chans, spectra: bool = False, **cfg) -> dict:
    """One capture of phase 57: a 64-channel Receiver on the card through
    step_many (tools/quality.py run_chain; every launch count set to 0 just
    before, K1 read after: once a dispatch, K2 likewise for FM stereo) and
    the same Receiver configuration on the CPU over the columns of
    cpu_chans, held to the card's channels there dispatch by dispatch with
    the slice bounds (audio 2e-4, spectra and S-meter SNR 0.1 dB, RDS soft
    symbols 1e-3 of their scale, pilot lock and symbol timing equal).
    planes: the dispatches' [K*N, 2C] float32 planes (an iterable).
    Returns the card's outputs on the host (one dict a dispatch), its
    final state and Receiver, and the CPU's outputs and final state."""
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.tools import quality as q
    c = QUALITY["channels"]
    tunes = np.asarray(tunes, np.float64)
    sel = list(cpu_chans)
    cols = sel + [c + i for i in sel]
    planes = list(planes)
    kw = dict(spectra=spectra, n=QUALITY["frames"], fs=FS, **cfg)
    reset_launches(front, wfm_tail)
    t0 = time.perf_counter()
    rx, st, outs = q.run_chain("cuda", planes, tunes, True, **kw)
    outs = [q.tree_map(lambda v: v.cpu(), o) for o in outs]
    card_s = time.perf_counter() - t0
    k1, k2 = front.fused_front.launches, wfm_tail.wfm_tail.launches
    _, stc, outs_c = q.run_chain(
        "cpu", (np.ascontiguousarray(x[:, cols]) for x in planes),
        tunes[sel], True, **kw)
    worst = {}
    for out, oc in zip(outs, outs_c):
        diffs = {"audio": float((out["audio"][:, sel] - oc["audio"])
                                .abs().max())}
        if spectra:
            diffs["spectrum"] = float((out["spectrum"][:, sel]
                                       - oc["spectrum"]).abs().max())
            diffs["snr"] = float((out["smeter"]["snr_db"][:, sel]
                                  - oc["smeter"]["snr_db"]).abs().max())
        if "rds_soft" in oc:
            scale = float(oc["rds_soft"].abs().max())
            diffs["rds_soft"] = float((out["rds_soft"][:, sel]
                                       - oc["rds_soft"]).abs().max()) / scale
        for key in ("pilot_locked", "rds_timing"):
            if key in oc and not bool((out[key][:, sel] == oc[key]).all()):
                raise RuntimeError(f"phase57 {tag}: {key} on the card "
                                   f"differs from the CPU's")
        for key, v in diffs.items():
            worst[key] = max(worst.get(key, 0.0), v)
    k = len(outs)
    want_k2 = k if cfg["mode"] == DemodMode.FMS else 0
    bounds = {"audio": 2e-4, "spectrum": 0.1, "snr": 0.1,
              "rds_soft": SOFT_RTOL}
    log(f"phase57 {tag}: card vs CPU on channels {sel}: "
        + ", ".join(f"{key} {v:.3g} (<= {bounds[key]})"
                    for key, v in worst.items())
        + f"; K1 {k1} K2 {k2} (want {k} {want_k2}), card {card_s:.2f} s")
    if any(v > bounds[key] for key, v in worst.items()):
        raise RuntimeError(f"phase57 {tag}: the card disagrees with the CPU")
    if (k1, k2) != (k, want_k2):
        raise RuntimeError(f"phase57 {tag}: K1 {k1} K2 {k2} launches, want "
                           f"{k} {want_k2}")
    return dict(outs=outs, state=st, rx=rx, outs_c=outs_c, state_c=stc)


def side_by_side(tag: str, card, cpu, sel, fmt: str = ".2f") -> None:
    """Logs card[ch] beside cpu[i] for the i-th channel ch of sel."""
    log(f"phase57 {tag} card / CPU: " + ", ".join(
        f"ch{ch} {card[ch]:{fmt}} / {cpu[i]:{fmt}}" for i, ch in
        enumerate(sel)))


def phase_quality(torch, front, wfm_tail) -> dict:
    """Phase 57: the port against the JAX suite's impairment and robustness
    bounds at full width (pebblesdr_tpu_torch/tools/quality.py, the port of
    bench.py bench_quality, and the fixtures of tests/test_impairments.py
    and tests/test_robustness.py).  Every capture at 2.048 Msps, N = 32768,
    64 channels, each channel on its own columns, through Receiver.step_many
    at K = 32 (quality_capture: launches counted, channels held to the CPU
    port), every channel checked: the L-only stereo program (even channels
    clean, >= 30 dB; odd through the 15 us / -10 dB two-ray channel, > 15
    dB and the L tone > 0.5), the same program at the hq geometry (>= 40
    dB), the RDS curve (channel c at QUALITY_RDS_SNRS[c % 5], noise from
    default_rng(11 + c); two dispatches; BLER 0 and "PEBBLES " on every
    20 dB channel, the pooled BLER weakly non-increasing over 12 -> 16 ->
    20 dB), AM with a -20 dB neighbour and a -50 dB CW spur (c % 3: clean,
    neighbour, spur; over the JAX test's 12 blocks, each impaired channel's
    SNR within 1 dB of the clean channels'; also printed over 16 and 32
    blocks, where the clean SNR leaves the DC blocker's transient and the
    spur costs more, in both packages), three FM stations in one capture
    on every column (channel c tuned to station c % 3: own tone > 0.25,
    ten times any other), 128
    AM blocks with channel c at 123 456 + 7 919 c Hz (finite audio on
    every block, mixer phase in [0, 1), the RMS over the last half steady
    to 1 %), the display offset (0 and 10 dB with spectra and a 1e-2
    noise floor: every peak +10.0 +- 0.1 dB, the S-meter SNR equal +- 0.2)
    and the AGC hang (64 rows of bench_quality's dropout, row c's noise
    from default_rng(5 + c): parallel vs scan < 3 dB on every row, K4's
    launches counted, row 0 held to the CPU).  Then the card's quality
    row (the tool's Receiver captures at 64 channels, with the AGC hangs
    above) and the seconds of each capture."""
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    from pebblesdr_tpu_torch.ops import agc
    from pebblesdr_tpu_torch.tools import quality as q
    c, n, k = (QUALITY[key] for key in ("channels", "frames", "blocks"))
    rows = n * k
    res, secs = {}, {}
    t_phase = time.perf_counter()

    def timed(name, t0):
        secs[name] = time.perf_counter() - t0

    # stereo: even channels clean, odd through the two-ray channel
    t0 = time.perf_counter()
    prog = q.stereo_program(rows)
    clean = prog.astype(np.complex64)
    echoed = q.two_ray(prog).astype(np.complex64)
    plane = q.build_plane(lambda ch: echoed if ch % 2 else clean, range(c),
                          rows)
    r = quality_capture(torch, front, wfm_tail, "stereo", [plane],
                        [q.STEREO_HZ] * c, [0, 1], mode=DemodMode.FMS,
                        agc_mode="off")
    rate = r["rx"].cfg.audio_rate
    aud, aud_c = q.audio_of(r["outs"]), q.audio_of(r["outs_c"])
    seps = np.array([q.separation_db(a, rate) for a in aud])
    tone_l = np.array([q.tone_amp(a[0, a.shape[-1] // 2:], 700.0, rate)
                       for a in aud])
    side_by_side("stereo separation dB (ch0 clean, ch1 two-ray)", seps,
                 [q.separation_db(a, rate) for a in aud_c], [0, 1])
    even, odd = seps[0::2], seps[1::2]
    log(f"phase57 stereo: clean separation min {even.min():.2f} max "
        f"{even.max():.2f} dB (>= {SEPARATION_DB}); two-ray min "
        f"{odd.min():.2f} max {odd.max():.2f} dB (> "
        f"{MULTIPATH_SEPARATION_DB}), L tone min {tone_l[1::2].min():.4f} "
        f"(> {MULTIPATH_TONE})")
    if not (even.min() >= SEPARATION_DB and odd.min() > MULTIPATH_SEPARATION_DB
            and tone_l[1::2].min() > MULTIPATH_TONE):
        raise RuntimeError("phase57 stereo: a channel misses its bound")
    res["stereo"] = dict(clean=float(even.min()), two_ray=float(odd.min()))
    timed("stereo", t0)

    # the same program at the hq geometry, every channel clean
    t0 = time.perf_counter()
    plane = q.build_plane(lambda _: clean, range(c), rows)
    r = quality_capture(torch, front, wfm_tail, "stereo hq", [plane],
                        [q.STEREO_HZ] * c, [0], mode=DemodMode.FMS,
                        agc_mode="off", wfm_hq=True)
    rate = r["rx"].cfg.audio_rate
    seps = np.array([q.separation_db(a, rate) for a in q.audio_of(r["outs"])])
    side_by_side("hq separation dB", seps,
                 [q.separation_db(q.audio_of(r["outs_c"])[0], rate)], [0])
    log(f"phase57 stereo hq: separation min {seps.min():.2f} max "
        f"{seps.max():.2f} dB (>= {HQ_SEPARATION_DB})")
    if not seps.min() >= HQ_SEPARATION_DB:
        raise RuntimeError("phase57 stereo hq: a channel below its bound")
    res["stereo_hq"] = float(seps.min())
    timed("stereo hq", t0)

    # the RDS curve: channel c at QUALITY_RDS_SNRS[c % 5]
    t0 = time.perf_counter()
    d = QUALITY_RDS_DISPATCHES
    carrier = q.rds_carrier(rows * d)
    snr_of = [QUALITY_RDS_SNRS[ch % len(QUALITY_RDS_SNRS)] for ch in range(c)]
    plane = q.build_plane(
        lambda ch: q.rds_noisy(carrier, snr_of[ch], q.RDS_SEED + ch),
        range(c), rows * d)
    top = snr_of.index(max(QUALITY_RDS_SNRS))
    r = quality_capture(torch, front, wfm_tail, "RDS",
                        [plane[i * rows:(i + 1) * rows] for i in range(d)],
                        [q.RDS_TUNE_HZ] * c, [top], mode=DemodMode.FMS,
                        rds=True)
    del plane
    decs = q.rds_decode(r["outs"], c)
    (dec_c, grp_c), = q.rds_decode(r["outs_c"], 1)
    log(f"phase57 RDS ch{top} ({snr_of[top]:g} dB) block errors / ok card / "
        f"CPU: {decs[top][0].block_errors}/{decs[top][0].blocks_ok} / "
        f"{dec_c.block_errors}/{dec_c.blocks_ok}")
    pooled = {}
    for snr in QUALITY_RDS_SNRS:
        chans = [ch for ch in range(c) if snr_of[ch] == snr]
        errs = sum(decs[ch][0].block_errors for ch in chans)
        tot = sum(decs[ch][0].block_errors + decs[ch][0].blocks_ok
                  for ch in chans)
        pooled[snr] = errs / max(1, tot)
    clean_ch = [ch for ch in range(c) if snr_of[ch] == max(QUALITY_RDS_SNRS)]
    bad = [ch for ch in clean_ch if decs[ch][0].block_errors
           or decs[ch][1].ps_name != q.PS]
    log(f"phase57 RDS: pooled BLER " + ", ".join(
        f"{snr:g} dB {v:.4f}" for snr, v in pooled.items())
        + f"; {len(clean_ch)} channels at {max(QUALITY_RDS_SNRS):g} dB, "
        f"failing (errors or PS): {bad}; CPU ch{top} PS {grp_c.ps_name!r}")
    if bad or not pooled[12.0] >= pooled[16.0] >= pooled[20.0]:
        raise RuntimeError("phase57 RDS: the BLER curve misses its bounds")
    res["rds"] = pooled
    timed("RDS", t0)

    # AM: clean, with the neighbour, with the CW spur (channel c: c % 3)
    t0 = time.perf_counter()
    base = q.am_station(rows)
    sigs = [base.astype(np.complex64),
            (base + q.am_neighbour(rows)).astype(np.complex64),
            (base + q.cw_spur(rows)).astype(np.complex64)]
    plane = q.build_plane(lambda ch: sigs[ch % 3], range(c), rows)
    r = quality_capture(torch, front, wfm_tail, "AM interference", [plane],
                        [q.AM_HZ] * c, [0, 1, 2], mode=DemodMode.AM,
                        agc_mode="off")
    rate, blk = r["rx"].cfg.audio_rate, r["rx"].audio_blk
    aud, aud_c = q.audio_of(r["outs"]), q.audio_of(r["outs_c"])
    losses = {}
    for kb in AM_WINDOWS:
        snrs = np.array([q.am_audio_snr(a[:kb * blk], rate) for a in aud])
        side_by_side(f"AM SNR dB over the first {kb} blocks (clean, "
                     f"neighbour, spur)", snrs,
                     [q.am_audio_snr(a[:kb * blk], rate) for a in aud_c],
                     [0, 1, 2])
        ref = snrs[0::3].max()
        losses[kb] = {name: float(ref - snrs[i::3].min())
                      for i, name in ((1, "neighbour"), (2, "spur"))}
        log(f"phase57 AM over the first {kb} blocks: clean SNR "
            f"{snrs[0::3].min():.2f}-{ref:.2f} dB; loss with the neighbour "
            f"{losses[kb]['neighbour']:.3f}, with the spur "
            f"{losses[kb]['spur']:.3f} dB"
            + (f" (< {AM_IMPAIR_DB})" if kb == AM_WINDOWS[0] else ""))
    if max(losses[AM_WINDOWS[0]].values()) >= AM_IMPAIR_DB:
        raise RuntimeError("phase57 AM: an impairment costs 1 dB or more")
    res["am"] = losses
    timed("AM interference", t0)

    # three stations in one capture, channel c tuned to station c % 3
    t0 = time.perf_counter()
    cap = q.three_stations(rows, STATIONS, STATION_TONES)
    plane = q.build_plane(lambda _: cap, range(c), rows)
    tunes = [STATIONS[ch % 3] for ch in range(c)]
    r = quality_capture(torch, front, wfm_tail, "three stations", [plane],
                        tunes, [0, 1, 2], mode=DemodMode.FMS)
    rate = r["rx"].cfg.audio_rate
    skip = 8 * r["rx"].audio_blk         # tests/test_robustness.py:43

    def own_other(a, ch):
        tone = STATION_TONES[ch % 3]
        own = q.station_amp(a[0, skip:], tone, rate)
        other = max(q.station_amp(a[0, skip:], f, rate)
                    for f in STATION_TONES if f != tone)
        return own, own / max(other, 1e-9)

    got = np.array([own_other(a, ch)
                    for ch, a in enumerate(q.audio_of(r["outs"]))])
    worst = (float(got[:, 0].min()), float(got[:, 1].min()))
    side_by_side("three stations own tone", got[:, 0],
                 [own_other(a, ch)[0]
                  for ch, a in enumerate(q.audio_of(r["outs_c"]))],
                 [0, 1, 2], fmt=".4f")
    log(f"phase57 three stations: least own tone {worst[0]:.4f} (> 0.25), "
        f"least own / other {worst[1]:.1f} (> 10)")
    if not (worst[0] > 0.25 and worst[1] > 10):
        raise RuntimeError("phase57 three stations: a channel lost its "
                           "station or hears another")
    res["three_stations"] = dict(own=worst[0], ratio=worst[1])
    timed("three stations", t0)

    # the long run: channel c's station at f0 + step * c, 128 blocks
    t0 = time.perf_counter()
    freqs = LONG_RUN["f0"] + LONG_RUN["step"] * np.arange(c)

    def long_planes():
        for i in range(LONG_RUN["dispatches"]):
            t = (i * rows + np.arange(rows)) / FS
            yield q.build_plane(lambda ch: q.am_long(t, freqs[ch]), range(c),
                                rows)

    r = quality_capture(torch, front, wfm_tail, "long run", long_planes(),
                        freqs, [0], mode=DemodMode.AM, agc_mode="off")
    audio = torch.cat([o["audio"] for o in r["outs"]])       # [B, C, M]
    finite = torch.isfinite(audio).flatten(1).all(dim=1)
    rms = audio.double().pow(2).mean(dim=-1).sqrt().numpy()  # [B, C]
    tail = rms[rms.shape[0] // 2:]
    steady = tail.std(axis=0) / tail.mean(axis=0)
    ph = r["state"].mixer.phase.cpu().double().numpy()
    d_ph = abs(ph[0] - float(r["state_c"].mixer.phase[0]))
    d_ph = min(d_ph, 1.0 - d_ph)
    log(f"phase57 long run: {int(finite.sum())} of {finite.numel()} blocks "
        f"finite on every channel; mixer phase in [{ph.min():.6f}, "
        f"{ph.max():.6f}], ch0 card vs CPU {d_ph:.2e} cycles (<= 1e-4); "
        f"RMS over the last {tail.shape[0]} blocks steady to "
        f"{steady.max():.2e} at worst (< 0.01)")
    if not (bool(finite.all()) and ph.min() >= 0.0 and ph.max() < 1.0
            and steady.max() < 0.01 and d_ph <= 1e-4):
        raise RuntimeError("phase57 long run: drift, NaN or an unbounded "
                           "phase")
    res["long_run"] = float(steady.max())
    timed("long run", t0)

    # the display offset: spectra at 0 and 10 dB, the S-meter unmoved
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tone = (0.5 * np.exp(2j * np.pi * 100_000.0 * np.arange(rows) / FS)
            + 1e-2 * (rng.standard_normal(rows)
                      + 1j * rng.standard_normal(rows))).astype(np.complex64)
    plane = q.build_plane(lambda _: tone, range(c), rows)
    offs = {}
    for off in (0.0, 10.0):
        r = quality_capture(torch, front, wfm_tail, f"db_offset {off:g}",
                            [plane], [100_000.0] * c, [0], spectra=True,
                            mode=DemodMode.AM, db_offset=off)
        o = r["outs"][0]
        offs[off] = (o["spectrum"].amax(dim=-1).double(),
                     o["smeter"]["snr_db"].double())
    d_peak = (offs[10.0][0] - offs[0.0][0] - 10.0).abs().max().item()
    d_snr = (offs[10.0][1] - offs[0.0][1]).abs().max().item()
    log(f"phase57 db_offset: every block and channel's spectrum peak moved "
        f"10 dB within {d_peak:.2e} (<= 0.1), S-meter SNR within "
        f"{d_snr:.2e} dB (<= 0.2); SNR {offs[0.0][1].min().item():.2f}-"
        f"{offs[0.0][1].max().item():.2f} dB")
    if not (d_peak <= 0.1 and d_snr <= 0.2):
        raise RuntimeError("phase57 db_offset: the offset moved the wrong "
                           "thing")
    res["db_offset"] = dict(peak=d_peak, snr=d_snr)
    timed("db_offset", t0)

    # the AGC hang: 64 rows, the scan AGC's smoother on K4
    t0 = time.perf_counter()
    reset_launches(front, wfm_tail)
    ys = q.agc_pair("cuda", range(c))
    k4 = agc.agc_scan.launches
    hangs = q.agc_hangs(ys)
    ys_c = q.agc_pair("cpu", [0])
    d_agc = max(float(np.abs(ys[a][0] - ys_c[a][0]).max()
                      / np.abs(ys_c[a][0]).max()) for a in ys)
    want_k4 = ys["scan"].shape[-1] // q.AGC_BLOCK
    side_by_side("AGC hang dB", hangs, q.agc_hangs(ys_c), [0], fmt=".4f")
    log(f"phase57 AGC hang over {c} rows: max {hangs.max():.4f} dB (< "
        f"{AGC_HANG_DB}); row 0 card vs CPU {d_agc:.3g} of scale (<= "
        f"{LOOP_ATOL}); K4 agc_scan launches {k4} (want {want_k4})")
    if not (hangs.max() < AGC_HANG_DB and d_agc <= LOOP_ATOL
            and k4 == want_k4):
        raise RuntimeError("phase57 AGC: hang, card vs CPU or K4 launches")
    res["agc"] = dict(hang=float(hangs.max()), k4_launches=k4)
    timed("AGC hang", t0)

    # the card's quality row at 64 channels: the tool's Receiver captures,
    # the AGC hangs above
    t0 = time.perf_counter()
    reset_launches(front, wfm_tail)
    row = q.row_of(dict(q.receiver_metrics("cuda", range(c)),
                        agc_hang_par_vs_scan_db=hangs))
    res["row_launches"] = dict(k1=front.fused_front.launches,
                               k2=wfm_tail.wfm_tail.launches)
    log(f"phase57 quality row (tools/quality.py, {c} channels, K = "
        f"{q.K}): {json.dumps(row)}; launches {res['row_launches']}")
    res["row"] = row
    timed("quality row", t0)
    log("phase57 seconds: " + ", ".join(f"{name} {v:.1f}"
                                        for name, v in secs.items())
        + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    res["seconds"] = secs
    return res


def receiver_for_cli(torch):
    """The Receiver the CLI builds for phase 45's arguments."""
    from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
    from pebblesdr_tpu_torch.demod.modes import DemodMode
    return Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=32768,
                                   mode=DemodMode.AM), "cuda")


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
    from pebblesdr_tpu_torch.core import siggen
    from pebblesdr_tpu_torch.ops import (agc, decimator, front, goertzel,
                                         kprobe, pll, scanops, wfm_tail)
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
                              DemodMode, loops["fed_ns"])
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
    phase_stereo_tail(torch, receiver, convert, front, wfm_tail, wfm_mod,
                      pll, DemodMode)
    clock("phase 35")
    from pebblesdr_tpu_torch.io import wav
    phase_cli(torch, wav)
    clock("phase 36")
    dk = phase_decode_kernels(torch)
    clock("phase 37")
    k7 = phase_testbench(torch, receiver, front, wfm_tail, DemodMode,
                         dk["steps_ns"])
    clock("phase 38")
    phase_cli_decode(torch, front, wfm_tail, wav)
    clock("phase 39")
    cw = phase_cw_cell(torch, receiver, front, wfm_tail, DemodMode,
                       dk["steps_ns"])
    clock("phase 40")
    k8 = phase_anf(torch, front, wfm_tail)
    clock("phase 41")
    acells = phase_anf_cells(torch, receiver, front, wfm_tail)
    clock("phase 42")
    phase_checkpoint(torch, receiver, front, wfm_tail)
    clock("phase 43")
    phase_soak(torch, front, wfm_tail)
    clock("phase 44")
    phase_cli_checkpoint(torch)
    clock("phase 45")
    phase_runtime(torch)
    clock("phase 46")
    phase_rtl_tcp(torch, front, wfm_tail, wav)
    clock("phase 47")
    phase_rtl_tcp_fms(torch, front, wfm_tail, wav)
    clock("phase 48")
    phase_net_sources(torch, receiver, front, wfm_tail, wav)
    clock("phase 49")
    phase_control(torch, front, wfm_tail, wav)
    clock("phase 50")
    ex = phase_experts(torch, receiver, front, wfm_tail, DemodMode)
    clock("phase 51")
    phase_assign_cli(torch, front, wfm_tail)
    clock("phase 52")
    sh = phase_sharded(torch, receiver, front, wfm_tail, DemodMode)
    clock("phases 53-54")
    phase_parity(torch, front, wfm_tail)
    clock("phase 55")
    phase_examples(torch)
    clock("phase 56")
    phase_quality(torch, front, wfm_tail)
    clock("phase 57")

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
        # (steps x the step latency of the chain probe fed from memory:
        # K3's and K3c's chain alone, K4's loop in one lane); no PyTorch
        # call computes a recurrence: library_ms null
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
        # K6 and K7 (csrc/recur.cu; each replaces a lax.scan): K6's
        # launches from the timed cw_taps_64ch run (phase 40), its times,
        # state error and bound at the inputs a dispatch gave it; K7's
        # launches from the TestBench's card run (phase 38), its times,
        # error and bound at the arguments the TestBench gave it; no
        # PyTorch call computes either recurrence: library_ms null
        {"name": f"ook_scan (the OOK detector, peak: cw_taps_64ch, "
                 f"{cw['k6']['shape']} frames)", "route": "cuda",
         "source": goertzel.SOURCE, "replaces": goertzel.REPLACES,
         "launches": cw["launches"][1],
         **{key: cw["k6"][key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by")},
         "library_ms": None},
        {"name": f"sweep_scan (the TestBench's pulsed sweep, n={k7['n']})",
         "route": "cuda", "source": siggen.SOURCE,
         "replaces": siggen.REPLACES, "launches": k7["launches"],
         **{key: k7[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
         "library_ms": None},
    ] + [
        # K8 (csrc/recur.cu; replaces anf's lax.scan): launches from the
        # timed cell that runs each form (phase 42), times, error and
        # bound at the cell's shape (phase 41); no PyTorch call computes
        # the LMS recurrence: library_ms null
        {"name": f"anf_scan (the ANF's block LMS, {k8[tag]['form']} form, "
                 f"U = {k8[tag]['u']}: {cell}, {k8[tag]['shape']})",
         "route": "cuda",
         "source": scanops.SOURCE, "replaces": scanops.ANF_REPLACES,
         "launches": acells[cell]["launches"][7],
         **{key: k8[tag][key] for key in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")},
         "library_ms": None}
        for tag, cell in (("staged", "am_iqauto_anf_64ch"),
                          ("batched", "am_anf_long_64ch"))
    ] + [
        # K1's callers in parallel/ (phases 51, 53): the mode experts
        # (launches: every expert's over the timed run; times and error at
        # the AM expert's [K*N, 64]) and the time shards of the 4-rank
        # sharded step (launches: every rank's; the error on the inputs
        # the step gave K1, its dc seeded and its history received; times
        # at a shard's [K*N/2, 64], this process alone on the card)
        {"name": f"fused_front ({what}, timed at {r['shape']})",
         "route": "cuda", "source": front.SOURCE,
         "replaces": front.REPLACES, "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"],
         **roofline.k1_bound(r["plan"], r["shape"][0], r["shape"][1] // 2,
                             4, r["shape"][0] if what.startswith("per time")
                             else n, 0), "library_ms": None}
        for what, r in (("mode experts: AM 32 ch, USB 16 ch, FMN 16 ch", ex),
                        ("per time shard of the 4-rank sharded step, dc "
                         "seeded and history received", sh))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_worker(sys.argv[2:]))
    sys.exit(main())
