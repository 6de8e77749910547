"""pebblesdr_tpu_torch/tools/quality.py, the port's counterpart of bench.py
bench_quality, on the CPU.

  * each fixture equals, bit for bit, the array bench.py (bench_quality's
    lines, copied here) or the JAX tests (tests/test_impairments.py,
    tests/test_robustness.py, tests/test_rds.py) build;
  * the row's keys are bench_quality's (its row in BENCH_r05.json), in its
    order, and with more channels each numeric key's range beside it;
  * four channels, each its own capture, through Receiver.step_many at
    K = 4 equal one channel at a time through Receiver.step, channel by
    channel, on short captures;
  * the command line at --device cpu, and without a CUDA device and
    without --device a non-zero exit;
  * the AGC hang within 0.02 dB of JAX's agc_apply pair on the fixture.
"""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_impairments as jimp
from test_rds import differential_encode, make_ps_groups

from pebblesdr_tpu.demod import rds as jrds
from pebblesdr_tpu.ops import agc as jagc
from pebblesdr_tpu_torch.tools import quality as q
from pebblesdr_tpu_torch.tools import soak

FS, N = q.FS, q.N
SHORT = dict(blocks=8, k=4)      # the step / step_many comparison's captures
#                                  and blocks a dispatch
DB_ATOL = 1e-3                   # step_many vs step: dB metrics
BENCH_R05 = Path(__file__).resolve().parent.parent / "BENCH_r05.json"


def bench_row_keys() -> list:
    """The keys of bench_quality's row as BENCH_r05.json recorded it."""
    with open(BENCH_R05) as f:
        tail = json.load(f)["tail"]
    m = re.search(r'\{"config": "quality"[^{}]*\}', tail)
    return list(json.loads(m.group(0)))


# ------------------------------------------------------------------ fixtures
# bench.py:300-485 and the JAX tests' lines, copied; each function returns
# (the reference array, the tool's array)

def fix_stereo():
    kb, frames = 20, N                                       # bench.py:302
    t = np.arange(kb * frames) / FS
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = (0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
          ).astype(np.complex64)
    return iq, q.stereo_program(kb * N).astype(np.complex64)


def fix_two_ray():
    kb = jimp.KB                                 # tests/test_impairments.py
    t = np.arange(kb * jimp.FRAMES) / jimp.FS
    lt = np.sin(2 * np.pi * 700.0 * t)
    th = 2 * np.pi * 19000.0 * t
    comp = 0.45 * lt + 0.1 * np.sin(th) + 0.45 * lt * np.sin(2 * th)
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    iq = 0.5 * np.exp(1j * (2 * np.pi * 250_000.0 * t + ph))
    d = int(15e-6 * FS)
    echo = (np.concatenate([np.zeros(d, complex), iq[:-d]])
            * 10 ** (-10 / 20) * np.exp(1j * 2.1))
    return ((iq + echo).astype(np.complex64),
            q.two_ray(q.stereo_program(kb * N)).astype(np.complex64))


def fix_am():
    base, adj, cw = jimp.TestAmInterference()._fixtures()
    n = jimp.KB * jimp.FRAMES
    return (np.stack([base, adj, cw]),
            np.stack([q.am_station(n), q.am_neighbour(n), q.cw_spur(n)]))


def fix_rds_bench():
    frames, nb2 = N, 40                                  # bench.py:344-361
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    t2 = np.arange(nb2 * frames) / FS
    sym_idx = np.minimum((t2 * jrds.RDS_BAUD).astype(np.int64),
                         len(sym) - 1)
    frac = t2 * jrds.RDS_BAUD - sym_idx
    biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
    comp2 = (0.3 * np.sin(2 * np.pi * 1000.0 * t2)
             + 0.1 * np.sin(2 * np.pi * 19000.0 * t2)
             + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t2))
    ph2 = 2 * np.pi * np.cumsum(75000.0 * comp2) / FS
    carrier = 0.5 * np.exp(1j * (2 * np.pi * 300_004.0 * t2 + ph2))
    rng = np.random.default_rng(11)
    sigma = np.sqrt(0.25 / 10 ** (20.0 / 10) / 2)
    iq2 = (carrier + sigma * (rng.normal(size=len(t2))
                              + 1j * rng.normal(size=len(t2)))
           ).astype(np.complex64)
    return iq2, q.rds_noisy(q.rds_carrier(nb2 * N), 20.0, q.RDS_SEED)


def fix_rds_curve():
    nb = 20                            # tests/test_impairments.py:127-148
    t = np.arange(nb * jimp.FRAMES) / jimp.FS
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=12)
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    sym_idx = np.minimum((t * jrds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    frac = t * jrds.RDS_BAUD - sym_idx
    biphase = sym[sym_idx] * np.where(frac < 0.5, 1.0, -1.0)
    comp = (0.3 * np.sin(2 * np.pi * 1000.0 * t)
            + 0.1 * np.sin(2 * np.pi * 19000.0 * t)
            + 0.06 * biphase * np.cos(2 * np.pi * 57000.0 * t))
    ph = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
    carrier = 0.5 * np.exp(1j * (2 * np.pi * 300_004.0 * t + ph))
    rng = np.random.default_rng(11)
    noise = rng.normal(size=len(t)) + 1j * rng.normal(size=len(t))
    sigma = np.sqrt(0.25 / 10 ** (12.0 / 10) / 2)
    iq = (carrier + sigma * noise).astype(np.complex64)
    return iq, q.rds_noisy(q.rds_carrier(nb * N), 12.0, q.RDS_SEED)


def fix_agc():
    fs_a = 8000.0                                        # bench.py:469-485
    n_a = int(fs_a * 4.5)
    ta = np.arange(n_a) / fs_a
    env = np.ones(n_a)
    env[int(3.5 * fs_a):int(4.0 * fs_a)] = 0.01
    rng_a = np.random.default_rng(5)
    xa = ((env * np.exp(2j * np.pi * 500.0 * ta)
           + 2e-3 * (rng_a.standard_normal(n_a)
                     + 1j * rng_a.standard_normal(n_a)))
          .astype(np.complex64))[None]
    xa = xa[:, :(n_a // 2048) * 2048]
    return xa, q.agc_dropout(q.AGC_SEED)[None]


def fix_three_stations():
    nb = 16                              # tests/test_robustness.py:19-30
    t = np.arange(nb * N) / FS
    stations = [-700_000.0, 0.0, 700_000.0]
    tones = [800.0, 1500.0, 2500.0]
    capture = np.zeros(nb * N, np.complex64)
    for f0, tone in zip(stations, tones):
        comp = (0.45 * np.sin(2 * np.pi * tone * t)
                + 0.1 * np.sin(2 * np.pi * 19000.0 * t))
        phase = 2 * np.pi * np.cumsum(75000.0 * comp) / FS
        capture += (0.4 * np.exp(1j * (2 * np.pi * f0 * t + phase))
                    ).astype(np.complex64)
    return capture, q.three_stations(nb * N, stations, tones)


def fix_long_run():
    t0 = np.arange(8192) / 512_000           # tests/test_robustness.py:66-70
    ref, got = [], []
    for i in (0, 57, 99):
        t = t0 + i * 8192 / 512_000
        env = (1 + 0.5 * np.cos(2 * np.pi * 700.0 * t)) / 2
        ref.append((0.5 * env * np.exp(2j * np.pi * 123_456.0 * t)
                    ).astype(np.complex64))
        got.append(q.am_long(t, 123_456.0))
    return np.stack(ref), np.stack(got)


FIXTURES = {"stereo": fix_stereo, "two_ray": fix_two_ray, "am": fix_am,
            "rds_bench": fix_rds_bench, "rds_curve": fix_rds_curve,
            "agc": fix_agc, "three_stations": fix_three_stations,
            "long_run": fix_long_run}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_equals_the_references(name):
    ref, got = FIXTURES[name]()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.float64 if got.dtype == np.complex128
                                   else np.float32),
                          ref.view(np.float64 if ref.dtype == np.complex128
                                   else np.float32)), name


def test_rds_bits_and_biphase_equal_test_rds():
    """The tool's RDS stream (tools/soak.py ps_group_bits / rds_biphase) is
    tests/test_rds.py's make_ps_groups(0x54A8, "PEBBLES ", repeats=24),
    differentially encoded from 0 and sent as biphase (bench.py:344-351)."""
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
    assert soak.ps_group_bits() == bits
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    assert np.array_equal(np.cumsum(bits) % 2 * 2.0 - 1.0, sym)
    t = np.arange(40 * N) / FS
    idx = np.minimum((t * jrds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    biphase = sym[idx] * np.where(t * jrds.RDS_BAUD - idx < 0.5, 1.0, -1.0)
    assert np.array_equal(soak.rds_biphase(t), biphase)


# ----------------------------------------------------------------------- row

@pytest.fixture(scope="module")
def four_channels():
    """Four channels through step_many (K = 4) and each channel alone
    through step, on 8-block captures (the AGC rows are not Receiver
    captures: the last row alone stands for them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(q, "K", SHORT["k"])
        many = q.channel_metrics("cpu", range(4), SHORT["blocks"])
    one = [q.receiver_metrics("cpu", [c], SHORT["blocks"]) for c in range(4)]
    one[3]["agc_hang_par_vs_scan_db"] = q.agc_hangs(q.agc_pair("cpu", [3]))
    return many, one


def test_row_keys_equal_bench_quality():
    keys = bench_row_keys()
    assert list(q.ROW_KEYS) == keys
    row = q.quality_row("cpu", channels=1, blocks=2)
    assert list(row) == keys
    assert row["config"] == "quality" and row["rds_snr_db"] == 20.0


@pytest.mark.parametrize("c", range(4))
def test_step_many_channels_equal_step(four_channels, c):
    """Channel c's capture on its own columns of a 4-channel plane through
    step_many gives the values it gives alone through step: dB metrics
    within 1e-3, BLER and the PS decision equal (the AGC hang: row 3
    alone against the four rows' row 3)."""
    many, one = four_channels
    for key, v in many.items():
        if key not in one[c]:
            continue
        if key.startswith("rds_"):
            assert v[c] == one[c][key][0], (key, v[c], one[c][key][0])
        else:
            assert abs(v[c] - one[c][key][0]) < DB_ATOL, (key, v[c],
                                                          one[c][key][0])


def test_row_is_the_worst_over_channels(four_channels):
    many, _ = four_channels
    row = q.row_of(many)
    want = set(q.ROW_KEYS) | {f"{k}_range" for k in q.WORST}
    assert set(row) == want
    for key, (worst, digits) in q.WORST.items():
        assert row[key] == round(float(worst(many[key])), digits)
        lo, hi = row[f"{key}_range"]
        assert lo <= row[key] <= hi
    assert row["rds_ps_decoded"] == bool(np.all(many["rds_ps_decoded"]))


def test_command_line_on_the_cpu(capsys):
    assert q.main(["--device", "cpu", "--channels", "2", "--blocks", "2",
                   "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(row)[:len(q.ROW_KEYS)] == list(q.ROW_KEYS)
    assert row["agc_hang_par_vs_scan_db_range"][1] < 3.0


def test_command_line_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        q.main([])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_agc_hang_equals_jax():
    """The parallel-vs-scan AGC hang on bench_quality's dropout within 0.02
    dB of JAX's agc_apply pair (bench.py:486-500) on the same fixture."""
    x = q.agc_dropout()[None]
    outs = {}
    for alg in ("parallel", "scan"):
        cfg = jagc.AGCConfig.make(q.AGC_FS, mode="long", threshold_db=-40.0,
                                  algorithm=alg)
        st = jagc.agc_init(cfg, 1)
        ys = []
        for k in range(x.shape[-1] // 2048):
            st, y = jagc.agc_apply(cfg, st, jnp.asarray(
                x[:, k * 2048:(k + 1) * 2048]))
            ys.append(np.asarray(y)[0])
        outs[alg] = np.concatenate(ys)
    jhang = q.hang_db(outs["parallel"], outs["scan"])
    hang, = q.agc_hangs(q.agc_pair("cpu", [0]))
    assert hang < 3.0
    assert abs(hang - jhang) < 0.02, (hang, jhang)
