"""The port's mode experts (pebblesdr_tpu_torch/parallel/expert.py) on the
CPU, mirroring tests/test_expert.py: the routing table and every
partition_devices case, exact; the experts against single-mode port
Receivers on the same rows, 1e-5 (the JAX test's bound), over two blocks
carrying the state; audio_by_channel and retune; experts split over a
device list (sub-Receivers) against the unsplit experts; step_many (the
port's K-block dispatch, a shared [K*N, 2] capture) against K steps; and
the port's experts against the JAX package's ModeExpertChannelizer on the
same capture (its Receivers with use_pallas=True, the fused front in
interpret mode), within the port's Receiver parity bound 2e-4
(tests/test_chain_batched.py:58)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.demod.modes import DemodMode as JaxMode
from pebblesdr_tpu.parallel import expert as jexpert
from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode
from pebblesdr_tpu_torch.parallel import expert

FS = 512_000
N = 8192


def capture():
    """tests/test_expert.py:18-28: AM at +100 kHz, NFM at -50 kHz."""
    rng = np.random.default_rng(7)
    t = np.arange(N) / FS
    am = (1 + 0.6 * np.cos(2 * np.pi * 1000.0 * t)) / 2 * np.exp(
        2j * np.pi * 100_000.0 * t)
    dev = 3000.0
    ph = 2 * np.pi * np.cumsum(dev * np.sin(2 * np.pi * 700.0 * t)) / FS
    fm = 0.5 * np.exp(1j * (2 * np.pi * -50_000.0 * t + ph))
    noise = 0.001 * (rng.normal(size=N) + 1j * rng.normal(size=N))
    return (am + fm + noise).astype(np.complex64)


def a(mode, hz):
    return expert.ChannelAssignment(mode, hz)


class TestRouting:
    def test_groups_preserve_order(self):
        groups = expert.route_channels(
            [a(DemodMode.AM, 1.0), a(DemodMode.FMN, 2.0), a(DemodMode.AM, 3.0),
             a(DemodMode.FMN, 4.0), a(DemodMode.AM, 5.0)])
        assert [g.mode for g in groups] == [DemodMode.AM, DemodMode.FMN]
        assert groups[0].channel_ids == (0, 2, 4)
        assert groups[1].channel_ids == (1, 3)
        np.testing.assert_allclose(groups[0].tunes, [1.0, 3.0, 5.0])

    def test_partition_devices_proportional(self):
        groups = expert.route_channels([a(DemodMode.AM, 0.0)] * 6
                                       + [a(DemodMode.FMN, 0.0)] * 2)
        parts = expert.partition_devices(list(range(8)), groups)
        assert [len(p) for p in parts] == [6, 2]
        assert sorted(sum(parts, [])) == list(range(8))

    def test_partition_devices_min_one(self):
        groups = expert.route_channels([a(DemodMode.AM, 0.0)] * 15
                                       + [a(DemodMode.FMN, 0.0)])
        parts = expert.partition_devices(list(range(4)), groups)
        assert all(len(p) >= 1 for p in parts)
        assert sum(len(p) for p in parts) == 4

    def test_partition_devices_skewed_overshoot(self):
        groups = expert.route_channels([a(DemodMode.AM, 0.0)] * 10
                                       + [a(DemodMode.FMN, 0.0)]
                                       + [a(DemodMode.USB, 0.0)])
        parts = expert.partition_devices(list(range(4)), groups)
        assert [len(p) for p in parts] == [2, 1, 1]
        assert sorted(sum(parts, [])) == list(range(4))

    @pytest.mark.parametrize("n_dev", [3, 4, 5, 6, 7, 8])
    @pytest.mark.parametrize("sizes", [(10, 1, 1), (1, 1, 1), (5, 4, 3),
                                       (100, 1, 2)])
    def test_partition_devices_matches_jax(self, n_dev, sizes):
        """Every case of tests/test_expert.py:66-80, each partition equal
        to the JAX package's, over torch devices."""
        modes = [(DemodMode.AM, JaxMode.AM), (DemodMode.FMN, JaxMode.FMN),
                 (DemodMode.USB, JaxMode.USB)]
        groups = expert.route_channels(
            [a(m, 0.0) for (m, _), s in zip(modes, sizes) for _ in range(s)])
        jgroups = jexpert.route_channels(
            [jexpert.ChannelAssignment(j, 0.0)
             for (_, j), s in zip(modes, sizes) for _ in range(s)])
        devs = [torch.device("cpu", i) for i in range(n_dev)]
        parts = expert.partition_devices(devs, groups)
        jparts = jexpert.partition_devices(list(range(n_dev)), jgroups)
        assert [[d.index for d in p] for p in parts] == jparts
        assert all(len(p) >= 1 for p in parts)
        flat = [d.index for d in sum(parts, [])]
        assert len(set(flat)) == len(flat) <= n_dev

    def test_too_few_devices_raises(self):
        groups = expert.route_channels([a(DemodMode.AM, 0.0),
                                        a(DemodMode.FMN, 0.0)])
        with pytest.raises(ValueError, match="need >= 2"):
            expert.partition_devices([torch.device("cpu")], groups)


ASSIGN = [(DemodMode.AM, 100_000.0), (DemodMode.FMN, -50_000.0),
          (DemodMode.AM, 101_000.0)]


def experts(**kw):
    return expert.ModeExpertChannelizer(
        FS, N, [a(m, hz) for m, hz in ASSIGN], device="cpu", **kw)


def single(mode, tunes, rows, blocks=2):
    rx = Receiver(ReceiverConfig(sample_rate=FS, frames_per_buffer=N,
                                 channels=len(tunes), mode=mode), "cpu")
    p = rx.default_params(np.asarray(tunes))
    st = rx.init_state()
    for _ in range(blocks):
        st, out = rx.step(st, p, torch.from_numpy(rows), spectra=False)
    return out["audio"].numpy()


class TestMixedModeStep:
    def test_matches_single_mode_receivers(self):
        cap = capture()
        ch = experts()
        assert ch.n_experts == 2
        states = ch.init_states()
        iq = torch.from_numpy(np.broadcast_to(cap, (3, N)).copy())
        for _ in range(2):
            states, outs = ch.step(states, iq)
        ref_am = single(DemodMode.AM, [100_000.0, 101_000.0],
                        np.broadcast_to(cap, (2, N)).copy())
        ref_fm = single(DemodMode.FMN, [-50_000.0], cap[None].copy())
        np.testing.assert_allclose(outs[0]["audio"].numpy(), ref_am,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(outs[1]["audio"].numpy(), ref_fm,
                                   rtol=0, atol=1e-5)

    def test_audio_by_channel_mapping(self):
        ch = expert.ModeExpertChannelizer(
            FS, N, [a(DemodMode.AM, 100_000.0), a(DemodMode.FMN, -50_000.0),
                    a(DemodMode.AM, 100_000.0)], device="cpu")
        _, outs = ch.step(ch.init_states(),
                          torch.from_numpy(capture()[None]))  # shared row
        audio = ch.audio_by_channel(outs)
        assert set(audio) == {0, 1, 2}
        np.testing.assert_array_equal(audio[0], audio[2])
        assert not np.allclose(audio[0], audio[1])

    def test_retune_keeps_the_receivers(self):
        ch = expert.ModeExpertChannelizer(
            FS, N, [a(DemodMode.AM, 100_000.0), a(DemodMode.AM, 90_000.0)],
            device="cpu")
        rx = ch.receivers[0][0]
        iq = torch.from_numpy(np.broadcast_to(capture(), (2, N)).copy())
        states, _ = ch.step(ch.init_states(), iq)
        ch.retune(1, 100_000.0)
        assert ch.receivers[0][0] is rx
        np.testing.assert_allclose(ch.groups[0].tunes, [100_000.0, 90_000.0])
        states, outs = ch.step(states, iq)
        a1 = outs[0]["audio"].numpy()
        assert np.std(a1[1]) > 0
        with pytest.raises(KeyError):
            ch.retune(7, 0.0)

    def test_experts_split_over_devices(self):
        """Eight channels on a list of 8 devices: [4, 4] devices, each
        expert's channels one per sub-Receiver, audio equal to the unsplit
        experts'."""
        cap = capture()
        assign = ([a(DemodMode.AM, 100_000.0)] * 4
                  + [a(DemodMode.FMN, -50_000.0)] * 4)
        split = expert.ModeExpertChannelizer(
            FS, N, assign, devices=[torch.device("cpu")] * 8)
        whole = expert.ModeExpertChannelizer(FS, N, assign, device="cpu")
        assert [len(d) for d in split.device_groups] == [4, 4]
        assert [len(r) for r in split.receivers] == [4, 4]
        iq = torch.from_numpy(np.broadcast_to(cap, (8, N)).copy())
        s1, s2 = split.init_states(), whole.init_states()
        for _ in range(2):
            s1, o1 = split.step(s1, iq)
            s2, o2 = whole.step(s2, iq)
        for x, y in zip(o1, o2):
            assert np.all(np.isfinite(x["audio"].numpy()))
            np.testing.assert_allclose(x["audio"].numpy(),
                                       y["audio"].numpy(), atol=1e-6)

    def test_step_many_matches_steps(self):
        """K = 3 blocks of one shared [K*N, 2] capture plane in one dispatch
        against three steps."""
        t = np.arange(3 * N) / FS
        cap = (0.3 * (1 + 0.6 * np.cos(2 * np.pi * 1000.0 * t))
               * np.exp(2j * np.pi * 100_000.0 * t)).astype(np.complex64)
        plane = np.stack([cap.real, cap.imag], axis=1).astype(np.float32)
        ch = experts()
        states, outs = ch.step_many(ch.init_states(),
                                    torch.from_numpy(plane))
        many = ch.audio_by_channel(outs, many=True)
        st = ch.init_states()
        steps = {i: [] for i in range(3)}
        for b in range(3):
            st, o = ch.step(st, torch.from_numpy(plane[b * N:(b + 1) * N]))
            for i, x in ch.audio_by_channel(o).items():
                steps[i].append(x)
        for i in range(3):
            np.testing.assert_allclose(many[i], np.concatenate(steps[i]),
                                       atol=1e-5)
        two = ch.audio_by_channel(outs, many=True, blocks=2)
        np.testing.assert_array_equal(two[0], many[0][:2 * len(steps[0][0])])

    def test_matches_jax_experts(self):
        """The same capture through the JAX package's ModeExpertChannelizer
        (use_pallas=True: the fused front in interpret mode) and the
        port's, two blocks of the packed [N, 2] shared plane.  As in the
        port's FMN parity tests (tests/test_torch_nfm.py), the FMN expert's
        first block is not compared (from a zero state it discriminates
        the front FIR's fill, whose angles are rounding noise in either
        package): the JAX expert's state after it is carried into the
        port's."""
        import jax

        from pebblesdr_tpu_torch.utils import convert
        cap = capture()
        plane = np.stack([cap.real, cap.imag], axis=1).astype(np.float32)
        jch = jexpert.ModeExpertChannelizer(
            FS, N, [jexpert.ChannelAssignment(JaxMode[m.name], hz)
                    for m, hz in ASSIGN], use_pallas=True)
        ch = experts()
        js, ts = jch.init_states(), ch.init_states()
        for b in range(2):
            js, jo = jch.step(js, jnp.asarray(plane))
            ts, to = ch.step(ts, torch.from_numpy(plane))
            ja, ta = jch.audio_by_channel(jo), ch.audio_by_channel(to)
            assert set(ja) == set(ta) == {0, 1, 2}
            for i in (0, 2, 1) if b else (0, 2):
                np.testing.assert_allclose(ta[i], ja[i], atol=2e-4)
            np.testing.assert_allclose(
                to[0]["smeter"]["snr_db"].numpy(),
                np.asarray(jo[0]["smeter"]["snr_db"]), atol=0.1)
            leaves = [np.asarray(x)
                      for x in jax.tree_util.tree_leaves(js[1])]
            ts[1] = (convert.state_from_numpy(ch.receivers[1][0], leaves),)
