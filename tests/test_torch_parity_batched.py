"""The port's chain on the CPU through Receiver.step_many, the main path,
held to the port's float64 scipy golden (pebblesdr_tpu_torch/tools/
parity_harness.py, equal to the JAX harness's: tests/test_torch_parity.py):
two channels on two carriers of one capture, tests/test_parity.py's
signal at each (the second carrier's tones started half a radian later),
K = 31 so that the 1 s signal fills two dispatches, each channel within
its mode's threshold of its own carrier's golden, and no channel reading
the other's carrier."""

import pytest
import torch

from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.tools import parity_harness as ph

FS = 2_048_000
CARRIERS = (-250_000.0, 250_000.0)
K = 31   # 62 whole blocks of 32768 in the 1 s capture: two dispatches


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the chain's ops are small, and the suite runs
    several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [m.name for m in ph.GOLDEN_MODES])
def test_chain_step_many_matches_golden(name):
    mode = DemodMode[name]
    iq = ph.parity_capture(mode, FS, FS, CARRIERS)
    got, rx = ph.run_chain(iq, FS, mode, CARRIERS, 32768, "cpu", blocks=K,
                           batched=True)
    assert got.shape[0] == 2 and got.shape[-1] == 2 * K * rx.audio_blk
    x_dc = ph.dc_removed64(iq)
    refs = [ph.golden(iq, FS, c, rx, x_dc=x_dc) for c in CARRIERS]
    if mode == DemodMode.FMS:
        for ref in refs:
            sep = ph.separation_db(ref[0], ref[1], rx.cfg.audio_rate,
                                   ph.probe_tone(mode))
            assert sep > ph.GOLDEN_SEPARATION_DB, sep
    snrs, spread = ph.hold_channels(got, refs, [0, 1], rx)
    assert snrs.min() > ph.MIN_SNR_DB[mode], f"{name} parity SNR {snrs} dB"
    assert spread < 1e-2, spread
    # the same audio with the channels swapped: each reads the other's
    # carrier, which the tone phasors show
    _, swapped = ph.hold_channels(got[::-1], refs, [0, 1], rx)
    assert swapped > 0.5, swapped
