"""The port's soak (pebblesdr_tpu_torch/tools/soak.py) on the CPU at a
small size, and its RDS fixture against the JAX package's.

  * one dispatch of 2 channels x 2 blocks of 32768 frames (SOAK_SECONDS 0:
    the soak checks one dispatch whatever the clock says), run as
    ``main`` with its environment variables: the JAX soak's JSON keys
    (tools/soak.py:97-111) plus the device, no bad dispatch, finite audio
    within full scale;
  * the PS group bits and their biphase waveform equal the JAX tests'
    (tests/test_rds.py make_ps_groups, differential_encode; the biphase
    of tools/soak.py:51-60) sample for sample.
"""

import json

import numpy as np

from pebblesdr_tpu.demod import rds as jrds
from pebblesdr_tpu_torch.tools import soak
from test_rds import differential_encode, make_ps_groups

JAX_KEYS = {"seconds", "dispatches", "blocks", "msps_sustained",
            "bad_dispatches", "audio_peak", "rds_blocks_ok",
            "rds_block_errors", "rds_bler", "rds_ps", "rds_synced"}


def test_soak_one_dispatch_on_the_cpu(monkeypatch, capsys):
    for key, value in (("SOAK_SECONDS", "0"), ("SOAK_CHANNELS", "2"),
                       ("SOAK_BLOCKS", "2"), ("SOAK_HQ", "0")):
        monkeypatch.setenv(key, value)
    assert soak.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == JAX_KEYS | {"device"}
    assert res["device"] == "cpu"
    assert res["dispatches"] == 1 and res["blocks"] == 2
    assert res["bad_dispatches"] == 0
    assert 0.1 < res["audio_peak"] < 1.5
    assert res["msps_sustained"] > 0


def test_rds_fixture_matches_the_jax_tests():
    bits = make_ps_groups(0x54A8, "PEBBLES ", repeats=24)
    assert soak.ps_group_bits() == bits
    t = np.arange(200_000) / soak.FS
    sym = np.asarray(differential_encode(bits), np.float64) * 2 - 1
    idx = np.minimum((t * jrds.RDS_BAUD).astype(np.int64), len(sym) - 1)
    want = sym[idx] * np.where(t * jrds.RDS_BAUD - idx < 0.5, 1.0, -1.0)
    np.testing.assert_array_equal(soak.rds_biphase(t), want)
