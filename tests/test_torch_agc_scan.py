"""The port's scan AGC (algorithm="scan": the sample-exact CuteSDR attack /
decay / hang recurrence, csrc/recur.cu agc_scan on the card, its plain
version here) against the JAX package, on the CPU.

  * agc_apply in the modes "long" (the hang timer), "med" and "fast" at
    strides 1 and 16, call for call over three calls of 4096 samples of a
    keyed carrier (the levels of a strided call are resized to the call
    within it, so the two packages are compared with the same call
    lengths), with every state leaf;
  * the linear resize against jax.image.resize(..., "linear");
  * the configuration and state layout of the scan (its hang is a timer:
    no held-max window; its peak window's tail stays at the full rate);
  * tests/test_ops_scans.py:170-200 on the port: the parallel AGC's hang
    held to the scan's within 3 dB on a steady carrier with a dropout.

Bounds: output 1e-6 absolute (|y| <= ~0.7; float32 log10 / power
rounding), state leaves 1e-6 (log-domain levels near -1..-8), the hang
counter exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu_torch.ops import agc as tagc
from pebblesdr_tpu_torch.utils import convert

C, N, FS = 3, 4096, 32000.0


def keyed(call: int, seed: int) -> np.ndarray:
    """[C, N] complex64: a 1 kHz carrier keyed on and off every 75 ms (the
    last call ends 39 ms into a dropout), channel i at level 0.5 / (i + 1),
    plus noise."""
    rng = np.random.default_rng(seed)
    t = (call * N + np.arange(N)) / FS
    on = np.where(((t + 0.03) % 0.15) < 0.075, 1.0, 0.01)
    lvl = 0.5 / (np.arange(C)[:, None] + 1.0)
    x = (lvl * on * np.exp(2j * np.pi * 1000.0 * t)
         + 1e-3 * (rng.standard_normal((C, N))
                   + 1j * rng.standard_normal((C, N))))
    return x.astype(np.complex64)


@pytest.mark.parametrize("stride", [1, 16])
@pytest.mark.parametrize("mode", ["long", "med", "fast"])
def test_scan_agc_matches_jax_call_for_call(mode, stride):
    cj = jagc.AGCConfig.make(FS, mode, stride=stride, algorithm="scan")
    ct = tagc.AGCConfig.make(FS, mode, stride=stride, algorithm="scan")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    sj, st = jagc.agc_init(cj, C), tagc.agc_init(ct, C, "cpu")
    # both averages start at the carrier's level (the 600 ms decay rise
    # would not reach it within the fixture), so the dropouts run the hang
    level = np.log10(0.5 / (np.arange(C) + 1.0)).astype(np.float32)
    sj = dataclasses.replace(sj, attack_avg=jnp.asarray(level),
                             decay_avg=jnp.asarray(level))
    st = dataclasses.replace(st, attack_avg=torch.from_numpy(level),
                             decay_avg=torch.from_numpy(level))
    before = tagc.agc_scan.launches
    for call in range(3):
        x = keyed(call, 7 * call + stride)
        sj, yj = jagc.agc_apply(cj, sj, jnp.asarray(x))
        st, yt = tagc.agc_apply(ct, st, torch.from_numpy(x))
        assert yt.shape == (C, N) and yt.dtype == torch.complex64
        assert np.abs(np.asarray(yj) - yt.numpy()).max() < 1e-6
        jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(sj)]
        tl = convert.state_to_numpy(st)
        assert len(jl) == len(tl) == 6
        for a, b in zip(jl, tl):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.abs(a.astype(np.complex128)
                          - b.astype(np.complex128)).max(initial=0.0) < 1e-6
        assert np.array_equal(np.asarray(sj.hang_count),
                              st.hang_count.numpy())
    assert tagc.agc_scan.launches == before
    if mode == "long":                 # the hang timer ran in the dropout
        assert int(st.hang_count.min()) > 0


@pytest.mark.parametrize("m,n", [(256, 4096), (3, 48), (2048, 32768)])
def test_resize_linear_matches_jax_image_resize(m, n):
    rng = np.random.default_rng(m)
    v = rng.standard_normal((2, m)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(v), (2, n), "linear"))
    got = tagc.resize_linear(torch.from_numpy(v), n).numpy()
    assert got.shape == (2, n)
    assert np.abs(want - got).max() < 1e-6


def test_scan_config_and_state_layout():
    """The scan keeps its peak window's tail at the full rate and has no
    held-max window (its hang is the timer in hang_count); the parallel
    form at stride 16 keeps both on the coarse grid."""
    for alg in ("scan", "parallel"):
        cj = jagc.AGCConfig.make(FS, "long", stride=16, algorithm=alg)
        ct = tagc.AGCConfig.make(FS, "long", stride=16, algorithm=alg)
        assert tagc.hang_window(ct) == jagc.hang_window(cj)
        jl = jax.tree_util.tree_leaves(jagc.agc_init(cj, C))
        tl = convert.leaves(tagc.agc_init(ct, C, "cpu"))
        assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert tagc.hang_window(ct) > 1
    scan = tagc.agc_init(tagc.AGCConfig.make(FS, "long", stride=16,
                                             algorithm="scan"), C, "cpu")
    assert scan.window_tail.shape == (C, int(0.018 * FS) - 1)
    assert scan.hang_tail is None
    k = tagc.scan_coefs(tagc.AGCConfig.make(FS, "long", stride=16,
                                            algorithm="scan"))
    assert k["hang"] and k["hang_samples"] == int(2.0 * FS / 16)
    with pytest.raises(ValueError, match="algorithm"):
        tagc.AGCConfig.make(FS, "long", algorithm="loop")


def test_port_parallel_hang_matches_scan():
    """tests/test_ops_scans.py:170-200 on the port's two AGCs: a steady
    carrier with a 0.5 s dropout (shorter than the 2 s hang) after a 3.5 s
    warm-up; the 25 ms RMS envelopes within 3 dB after the first 8."""
    fs = 8000.0
    n = int(fs * 4.5)
    t = np.arange(n) / fs
    env = np.ones(n)
    env[int(3.5 * fs):int(4.0 * fs)] = 0.01
    rng = np.random.default_rng(5)
    x = ((env * np.exp(2j * np.pi * 500.0 * t)
          + 2e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
         .astype(np.complex64))[None]
    x = x[:, :(n // 2048) * 2048]
    outs = {}
    for alg in ("parallel", "scan"):
        cfg = tagc.AGCConfig.make(fs, mode="long", threshold_db=-40.0,
                                  algorithm=alg)
        st = tagc.agc_init(cfg, 1, "cpu")
        blk = 2048
        ys = []
        for k in range(x.shape[-1] // blk):
            st, y = tagc.agc_apply(cfg, st, torch.from_numpy(
                x[:, k * blk:(k + 1) * blk]))
            ys.append(y.numpy()[0])
        outs[alg] = np.concatenate(ys)
    seg = int(0.025 * fs)
    n_seg = len(outs["scan"]) // seg
    rms = {a: np.sqrt(np.mean(np.abs(v[:n_seg * seg].reshape(n_seg, seg))
                              ** 2, axis=1)) for a, v in outs.items()}
    d_db = 20 * np.log10((rms["parallel"] + 1e-9) / (rms["scan"] + 1e-9))
    assert np.max(np.abs(d_db[8:])) < 3.0, np.max(np.abs(d_db[8:]))
