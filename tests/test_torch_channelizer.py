"""The port's sharded receiver (pebblesdr_tpu_torch/parallel/channelizer.py)
in one 8-rank gloo world on the CPU, mirroring tests/test_parallel.py:147-
326 at its sizes (512 ksps, N = 8192; WFM 2.048 Msps, N = 32768, C = 4) and
meshes (8, 1), (4, 2), (2, 4) and (2, 2) (the last on ranks 0-3).  Each
rank's audio is joined over the channel groups (every time replica must
hold the same audio) and held, with each JAX test's bound, to the port's
unsharded Receiver and to the JAX package's:

  * the channel-parallel step (8, 1): 1e-5 of the port's unsharded step
    (tests/test_parallel.py:147-171), 2e-4 of the JAX Receiver's (the
    port's Receiver parity bound, tests/test_chain_batched.py:58);
  * the staged front (4, 2), two blocks: 2e-3;
  * the fused front (2, 4), K1's plain version per shard, three blocks
    with a DC offset (the seeded cross-shard DC recurrence): 2e-3;
  * fused against staged on (2, 2): 1e-4, and both against the unsharded
    Receivers, 2e-3;
  * WFM stereo (4, 2), staged and fused fronts, four blocks: 3e-3;
  * the port's dispatch contract: K = 4 blocks per dispatch split into T =
    2 pieces on (4, 2), two dispatches, against the port's unsharded
    step_many: audio 2e-4 (the port's Receiver parity bound), the
    S-meter's SNR 0.1 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from pebblesdr_tpu.chain.receiver import Receiver as JaxReceiver
from pebblesdr_tpu.chain.receiver import ReceiverConfig as JaxConfig
from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.parallel import channelizer

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 devices")

FS, N = td.CH["fs"], td.CH["n"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return td.World("channelizer", 8, tmp_path_factory.mktemp("channelizer"))


def am_kw(c):
    return dict(sample_rate=FS, frames_per_buffer=N, channels=c,
                agc_mode="off")


def references(mode: str, kw: dict, blocks, tunes):
    """(the port's unsharded Receiver audio, the JAX Receiver's) over the
    [C, n] complex blocks, joined in time."""
    trx = Receiver(ReceiverConfig(mode=DemodMode[mode], **kw), "cpu")
    jrx = JaxReceiver(JaxConfig(mode=JaxMode[mode], **kw))
    tp, jp = trx.default_params(tunes), jrx.default_params(tunes)
    ts, js = trx.init_state(), jrx.init_state()
    t_out, j_out = [], []
    for b in blocks:
        ts, o = trx.step(ts, tp, torch.from_numpy(b))
        t_out.append(o["audio"].numpy())
        js, o = jrx.step(js, jp, jnp.asarray(b))
        j_out.append(np.asarray(o["audio"]))
    return np.concatenate(t_out, -1), np.concatenate(j_out, -1)


def test_channel_parallel_step(world):
    iq = td.am_broadcast(8, N, FS)
    port, jx = references("AM", am_kw(8), [iq], 100_000.0)
    got = td.by_channel(world.results(), "cp")
    np.testing.assert_allclose(got, port, atol=1e-5)
    np.testing.assert_allclose(got, jx, atol=2e-4)


def test_staged_sharded_step_matches_unsharded(world):
    iq = td.am_tones(8, 2 * N, FS)
    port, jx = references("AM", am_kw(8), [iq[:, :N], iq[:, N:]],
                          np.linspace(-150_000, 150_000, 8))
    got = td.by_channel(world.results(), "staged42")
    np.testing.assert_allclose(got, port, atol=2e-3)
    np.testing.assert_allclose(got, jx, atol=2e-3)


def test_fused_sharded_step_matches_unsharded(world):
    """K1 (its plain version on the CPU) per time shard, seeded from
    outside: the DC estimate from the closed form, the history from the
    left neighbour."""
    iq = td.am_tones(4, 3 * N, FS, dc=0.03)
    port, jx = references("AM", am_kw(4),
                          [iq[:, i * N:(i + 1) * N] for i in range(3)],
                          np.linspace(-150_000, 150_000, 4))
    got = td.by_channel(world.results(), "fused24")
    np.testing.assert_allclose(got, port, atol=2e-3)
    np.testing.assert_allclose(got, jx, atol=2e-3)


def test_fused_matches_staged_sharded(world):
    """Fused against staged on the same (2, 2) mesh (1e-4), and both
    against the unsharded Receivers (2e-3).  Not against the JAX package's
    own sharded step: on this input (noise at 0.1 plus a 0.05 DC offset,
    tests/test_parallel.py:267-271) its staged sharded step is 0.033 off its
    unsharded Receiver (scale 0.046), which tests/test_parallel.py does not
    check; the port's is within 1e-7 of both unsharded Receivers."""
    res = world.results()
    staged = td.by_channel(res, "pair22_0")
    fused = td.by_channel(res, "pair22_1")
    np.testing.assert_allclose(fused, staged, atol=1e-4)
    iq = td.noisy_dc(2, 2 * N)
    port, jx = references("AM", am_kw(2), [iq[:, :N], iq[:, N:]],
                          np.array([50_000.0, -75_000.0]))
    for got in (staged, fused):
        np.testing.assert_allclose(got, port, atol=2e-3)
        np.testing.assert_allclose(got, jx, atol=2e-3)


@functools.lru_cache(maxsize=1)
def wfm_references():
    w = td.WFM
    kw = dict(sample_rate=w["fs"], frames_per_buffer=w["n"],
              channels=w["c"])
    iq = td.fm_stereo(w["c"], w["blocks"] * w["n"], w["fs"])
    return references("FMS", kw, [iq[:, i * w["n"]:(i + 1) * w["n"]]
                                  for i in range(w["blocks"])], 300_000.0)


@pytest.mark.parametrize("fused", [0, 1])
def test_wfm_sharded_matches_unsharded(world, fused):
    port, jx = wfm_references()
    got = td.by_channel(world.results(), f"wfm42_{fused}")
    assert got.shape == port.shape and got.shape[1] == 2   # L and R
    np.testing.assert_allclose(got, port, atol=3e-3)
    np.testing.assert_allclose(got, jx, atol=3e-3)


def test_dispatch_contract_matches_step_many(world):
    """The port's dispatch: [K*N, 2C] planes split into T contiguous pieces
    per channel group, two dispatches carrying the state, against the
    unsharded step_many on the whole planes."""
    c, k = td.MANY["c"], td.MANY["k"]
    iq = td.am_tones(c, td.MANY["dispatches"] * k * N, FS, dc=0.02)
    rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **am_kw(c)), "cpu")
    params = rx.default_params(np.linspace(-150_000, 150_000, c))
    st = rx.init_state()
    audio, snr = [], []
    for i in range(td.MANY["dispatches"]):
        st, o = rx.step_many(st, params, torch.from_numpy(
            td.packed(iq[:, i * k * N:(i + 1) * k * N])))
        audio.append(o["audio"].numpy())
        snr.append(o["smeter"]["snr_db"].numpy())
    res = world.results()
    got = td.by_channel(res, "many42", axis=1)
    assert got.shape == (td.MANY["dispatches"] * k, c, rx.audio_blk)
    np.testing.assert_allclose(got, np.concatenate(audio), atol=2e-4)
    np.testing.assert_allclose(td.by_channel(res, "many42_snr", axis=1),
                               np.concatenate(snr), atol=0.1)


def test_refuses_options_it_does_not_shard():
    """The sharded front is the base front: the blanker, IQ balance and
    the staged-front options raise rather than being dropped."""
    from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
    from pebblesdr_tpu_torch.parallel import comm
    if comm.is_initialized():
        pytest.skip("a world is up in this process")
    try:
        m = mesh_mod.make_mesh(1, 1, "cpu")
        for opts in (dict(enable_noise_blanker=True),
                     dict(enable_iq_balance=True),
                     dict(enable_iq_balance="auto"), dict(taps=True)):
            rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **am_kw(2),
                                         **opts), "cpu")
            with pytest.raises(ValueError, match="base front"):
                channelizer.build_sharded_step(rx, m)
        rx = Receiver(ReceiverConfig(mode=DemodMode.AM, **am_kw(2)), "cpu")
        step = channelizer.build_sharded_step(rx, m, fused=True)
        with pytest.raises(ValueError, match="sub-blocks"):
            step.step_many(step.init_state(), rx.default_params(0.0),
                           torch.zeros(N + 512, 4))
    finally:
        comm.destroy_world()
