"""The port's sharded filterbank bank (pebblesdr_tpu_torch/parallel/
pfb_shard.py) in one 8-rank gloo world on the CPU, a (2, 4) mesh: the
filterbank time-sharded with its state_len halo, one all-to-all over
'time' re-laying the stations' channel streams, the tail Receiver on each
rank's station; three blocks of 16384 samples at 1.024 Msps through a
32-channel bank, mirroring tests/test_pfb_bank.py:148-185 with eight
stations (one per rank) where it has four.  Bound: 2e-4 of scale against
the port's unsharded PfbBankReceiver and the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from pebblesdr_tpu.chain.pfb_bank import PfbBankReceiver as JaxBank
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.ops import pfb

B = td.BANK


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("pfb", 8, tmp_path_factory.mktemp("pfb"))


def tunes():
    plan = pfb.plan(B["fs"], B["m"])
    return pfb.channel_freqs(plan)[list(B["channels"])] + np.array(
        B["offsets"])


def sharded(world) -> np.ndarray:
    res = world.results()
    rows = {int(r["s0"]): r["audio"] for r in res}
    assert sorted(rows) == list(range(8))   # one station per rank
    return np.concatenate([rows[s] for s in sorted(rows)], axis=0)


def test_sharded_matches_port_bank(world):
    bank = PfbBankReceiver(B["fs"], B["frames"], tunes(), mode=DemodMode.AM,
                           n_bank=B["m"], agc_mode="off", device="cpu")
    x = td.bank_capture()
    st = bank.init_state()
    ref = []
    for b in range(B["blocks"]):
        st, out = bank.step(st, torch.from_numpy(
            x[b * B["frames"]:(b + 1) * B["frames"]]))
        ref.append(out["audio"].numpy())
    ref = np.concatenate(ref, -1)
    got = sharded(world)
    scale = max(np.abs(ref).max(), 1e-9)
    assert np.abs(got - ref).max() / scale < 2e-4


def test_sharded_matches_jax_bank(world):
    bank = JaxBank(B["fs"], B["frames"], tunes(), mode=JaxMode.AM,
                   n_bank=B["m"], agc_mode="off")
    x = td.bank_capture()
    st = bank.init_state()
    ref = []
    for b in range(B["blocks"]):
        st, out = bank.step(st, jnp.asarray(
            x[b * B["frames"]:(b + 1) * B["frames"]]))
        ref.append(np.asarray(out["audio"]))
    ref = np.concatenate(ref, -1)
    got = sharded(world)
    scale = max(np.abs(ref).max(), 1e-9)
    assert np.abs(got - ref).max() / scale < 2e-4
