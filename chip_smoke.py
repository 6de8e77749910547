#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  0. torch / CUDA versions and the card's name and power limit (nvidia-smi);
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
  5. K1 against its plain version, timed with CUDA events.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  No JAX is imported.
"""

from __future__ import annotations

import json
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
TONE_SNR_DB = 40.0       # AM 1 kHz tone, m = 0.8, band above 100 Hz


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))


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


def tone_snr_db(audio: np.ndarray, rate: float, f0: float = 1000.0) -> float:
    """Least-squares fit of a tone (cos, sin) at f0; SNR of the fit against
    the residual above 100 Hz."""
    t = np.arange(len(audio)) / rate
    basis = np.stack([np.cos(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * t),
                      np.ones_like(t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, audio, rcond=None)
    fit = basis[:, :2] @ coef[:2]
    res = audio - basis @ coef
    spec = np.fft.rfft(res)
    spec[np.fft.rfftfreq(len(res), 1 / rate) <= 100.0] = 0.0
    res_hp = np.fft.irfft(spec, n=len(res))
    return float(10 * np.log10(np.mean(fit ** 2) / max(np.mean(res_hp ** 2),
                                                        1e-30)))


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


def phase_slice(torch, receiver, convert) -> None:
    """Phase 3: the AM receiver on the card vs on the CPU."""
    c, n = SLICE["channels"], SLICE["frames"]
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=c, agc_stride=16)
    rx_cpu = receiver.Receiver(cfg, "cpu")
    rx_gpu = receiver.Receiver(cfg, "cuda")
    rng = np.random.default_rng(2)
    params_c = rx_cpu.default_params(250_000.0)
    params_g = rx_gpu.default_params(250_000.0)
    # a one-block warm-up on the CPU, carried to both, so no compared
    # dispatch starts from the zero state's filter leading edge
    st_c, _ = rx_cpu.step_many(rx_cpu.init_state(), params_c,
                               torch.from_numpy(am_plane(c, n, rng, 1e-2)))
    st_g = convert.state_from_numpy(rx_gpu, convert.state_to_numpy(st_c))
    for k in SLICE["dispatches"]:
        x = am_plane(c, k * n, rng, 1e-2)
        st_c, out_c = rx_cpu.step_many(st_c, params_c, torch.from_numpy(x))
        st_g, out_g = rx_gpu.step_many(st_g, params_g,
                                       torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        d_audio = float((out_g["audio"].cpu() - out_c["audio"]).abs().max())
        d_db = {key: float((out_g[key].cpu() - out_c[key]).abs().max())
                for key in ("spectrum", "zoomed")}
        d_db["snr"] = float((out_g["smeter"]["snr_db"].cpu()
                             - out_c["smeter"]["snr_db"]).abs().max())
        same_sq = bool((out_g["squelch_open"].cpu()
                        == out_c["squelch_open"]).all())
        d_state = max(float(np.abs(a.astype(np.complex128)
                                   - b.astype(np.complex128)).max())
                      for a, b in zip(convert.state_to_numpy(st_g),
                                      convert.state_to_numpy(st_c)))
        log(f"phase3 slice K={k}: audio {d_audio:.3g} (<= 2e-4), dB "
            + " ".join(f"{kk}={v:.3g}" for kk, v in d_db.items())
            + f" (<= 0.1), squelch equal {same_sq}, state {d_state:.3g} "
            f"(<= 1e-4)")
        if not (d_audio <= 2e-4 and max(d_db.values()) <= 0.1 and same_sq
                and d_state <= 1e-4):
            raise RuntimeError(f"card slice disagrees with the CPU slice at "
                               f"K={k}")
    log("phase3 ok: card slice == CPU slice")


def phase_headline(torch, receiver, front) -> dict:
    """Phase 4: the headline AM run, timed, with launch count and audio."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    cfg = receiver.ReceiverConfig(sample_rate=FS, frames_per_buffer=n,
                                  channels=c, agc_stride=HEADLINE["agc_stride"])
    rx = receiver.Receiver(cfg, "cuda")
    params = rx.default_params(250_000.0)
    block = torch.from_numpy(am_plane(c, n, None)).cuda()
    iq = block.repeat(k, 1).contiguous()                  # [K*N, 2C]
    state = rx.init_state()
    box = {"state": state, "out": None, "i": 0}

    def dispatch():
        i = box["i"]
        box["state"], box["out"] = rx.step_many(
            box["state"], params, iq, spectra=(i % SPECTRA_EVERY == 0))
        box["i"] = i + 1

    front.fused_front.launches = 0
    for _ in range(WARMUP):
        dispatch()
    torch.cuda.synchronize()
    windows = [time_cuda(torch, dispatch, WINDOW_DISPATCHES)
               for _ in range(WINDOWS)]
    torch.cuda.synchronize()
    launches = front.fused_front.launches
    n_dispatch = WARMUP + WINDOWS * WINDOW_DISPATCHES
    log(f"phase4 K1 launches {launches} for {n_dispatch} dispatches")
    if launches != n_dispatch:
        raise RuntimeError("the headline run did not go through K1 once per "
                           "dispatch")
    best = min(windows)                                   # ms per dispatch
    block_ms = best / k
    msps = c * n * k / (best / 1e3) / 1e6
    realtime = n * k / (best / 1e3) / FS
    spread = max(windows) / best
    log(f"phase4 headline AM {c}ch x {n} x {k}: dispatch ms per window "
        + " ".join(f"{w:.4f}" for w in windows)
        + f"; block {block_ms:.5f} ms, {msps:.1f} Msps per GPU, "
        f"{realtime:.1f}x realtime per channel, window spread {spread:.3f}")

    out = box["out"]
    audio = out["audio"]
    if not bool(torch.isfinite(audio).all()):
        raise RuntimeError("headline audio is not finite")
    if tuple(audio.shape) != (k, c, rx.audio_blk):
        raise RuntimeError(f"headline audio shape {tuple(audio.shape)}")
    if not bool(out["squelch_open"].all()):
        raise RuntimeError("squelch closed on the headline signal")
    snr = tone_snr_db(audio[:, 0, :].reshape(-1).double().cpu().numpy(),
                      cfg.audio_rate)
    log(f"phase4 tone SNR {snr:.2f} dB (>= {TONE_SNR_DB}), S-meter SNR "
        f"{float(out['smeter']['snr_db'][-1, 0]):.2f} dB")
    if not snr >= TONE_SNR_DB:
        raise RuntimeError("headline tone SNR below its bound")
    return {"launches": launches, "block_ms": block_ms, "msps": msps}


def phase_front_time(torch, front, fr) -> dict:
    """Phase 5: K1 vs its plain version at the headline shape."""
    c, n, k = HEADLINE["channels"], HEADLINE["frames"], HEADLINE["blocks"]
    plan = fr["plan"]
    x = torch.from_numpy(am_plane(c, n, None)).cuda().repeat(k, 1).contiguous()
    zeros = dict(dtype=torch.float32, device="cuda")
    args = (x, torch.zeros(1, 2 * c, **zeros), torch.zeros(c, **zeros),
            fr["f_hi"], fr["f_lo"], torch.zeros(plan.d_rows, 2 * c, **zeros))

    def kernel():
        front.fused_front(plan, *args, n_block=n, raw_rows=2048)

    def plain():
        front.fused_front_reference(plan, *args, n_block=n, raw_rows=2048)

    kernel(), plain()
    torch.cuda.synchronize()
    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t[name].append(time_cuda(torch, kernel if name == "kernel" else plain,
                                 10))
    ms, plain_ms = float(np.mean(t["kernel"])), float(np.mean(t["plain"]))
    log(f"phase5 K1 {ms:.4f} ms vs plain {plain_ms:.4f} ms per headline "
        f"dispatch (runs kernel {t['kernel']}, plain {t['plain']})")
    return {"ms": ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pebblesdr_tpu_torch.chain import receiver
    from pebblesdr_tpu_torch.kernels import build
    from pebblesdr_tpu_torch.ops import decimator, front
    from pebblesdr_tpu_torch.utils import convert

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

    # phase 1
    t0 = time.perf_counter()
    build.build("front")
    log(f"phase1 built front kernel in {time.perf_counter() - t0:.1f} s")

    fr = phase_front(torch, front, decimator)
    phase_slice(torch, receiver, convert)
    head = phase_headline(torch, receiver, front)
    times = phase_front_time(torch, front, fr)

    log(json.dumps({"kernels": [{
        "name": "fused_front", "route": "cuda", "source": front.SOURCE,
        "replaces": front.REPLACES, "launches": head["launches"],
        "max_abs_err": fr["max_abs_err"], "ms": times["ms"],
        "plain_ms": times["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
