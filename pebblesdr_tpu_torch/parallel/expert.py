"""Mode-expert parallelism: route channels to per-demod-mode expert chains.

Port of pebblesdr_tpu/parallel/expert.py.  The reference runs one demod
mode at a time, chosen from its static ``demodInfo[]`` table
(application/demod.cpp:25-40); here every channel of a wideband capture
carries a demod-mode assignment made at build time, the channels are
grouped by mode, and each group runs its own expert: a Receiver built for
that mode's decimation plan, bandpass, AGC profile and demod — on the card
its own K1 form, and K2 or the recurrence kernels where its mode runs
them.  Routing is static, so no device spends work on an inactive expert.

With a device list, each expert gets a disjoint slice of the devices
(proportional to its channel count) and splits its channels evenly over
them, one sub-Receiver per device (JAX trims the slice to even shards the
same way).  The experts are enqueued back to back, so experts on different
cards overlap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverConfig
from pebblesdr_tpu_torch.demod.modes import DemodMode


@dataclasses.dataclass(frozen=True)
class ChannelAssignment:
    """One channel of the routing table: demod mode + tune offset (Hz from
    the capture centre)."""
    mode: DemodMode
    tune_hz: float


@dataclasses.dataclass(frozen=True)
class ExpertGroup:
    """One expert: a demod mode plus the (original) channel indices routed
    to it, in routing-table order."""
    mode: DemodMode
    channel_ids: tuple  # original channel indices
    tunes: np.ndarray   # [c_e] Hz


def route_channels(assignments) -> list[ExpertGroup]:
    """The static routing table: channels grouped by mode, first-seen mode
    order and per-mode channel order kept (the demodInfo[] analog)."""
    order: list[DemodMode] = []
    by_mode: dict[DemodMode, list[int]] = {}
    for i, a in enumerate(assignments):
        if a.mode not in by_mode:
            by_mode[a.mode] = []
            order.append(a.mode)
        by_mode[a.mode].append(i)
    return [
        ExpertGroup(mode=m, channel_ids=tuple(by_mode[m]),
                    tunes=np.asarray(
                        [assignments[i].tune_hz for i in by_mode[m]],
                        np.float64))
        for m in order
    ]


def partition_devices(devices, groups) -> list[list]:
    """Split a flat device list (torch.device) into per-expert groups,
    proportional to channel count (largest remainder; every expert gets at
    least 1 device and at most its channel count)."""
    n_dev = len(devices)
    total = sum(len(g.channel_ids) for g in groups)
    if n_dev < len(groups):
        raise ValueError(f"{len(groups)} experts need >= {len(groups)} "
                         f"devices, have {n_dev}")
    quota = [len(g.channel_ids) * n_dev / total for g in groups]
    counts = [max(1, min(len(g.channel_ids), int(q)))
              for q, g in zip(quota, groups)]
    # the max(1, ...) lift can overshoot the device count (channels
    # [10, 1, 1] on 4 devices): shrink the largest groups first, never
    # below 1 device
    while sum(counts) > n_dev:
        i = max(range(len(counts)), key=lambda j: (counts[j], quota[j]))
        if counts[i] <= 1:  # unreachable given n_dev >= len(groups)
            raise ValueError("cannot give every expert a device")
        counts[i] -= 1
    # distribute any remainder by largest fractional part
    rem = n_dev - sum(counts)
    frac = sorted(range(len(groups)), key=lambda i: quota[i] - int(quota[i]),
                  reverse=True)
    k = 0
    while rem > 0 and k < len(frac):
        i = frac[k % len(frac)]
        if counts[i] < len(groups[i].channel_ids):
            counts[i] += 1
            rem -= 1
        k += 1
    out, pos = [], 0
    for c in counts:
        out.append(list(devices[pos:pos + c]))
        pos += c
    return out


def _cat(outs: list, dim: int, device: torch.device):
    """The sub-Receivers' outputs joined along the channel axis on one
    device (dicts of tensors, nested)."""
    if len(outs) == 1:
        return outs[0]
    first = outs[0]
    if isinstance(first, dict):
        return {key: _cat([o[key] for o in outs], dim, device)
                for key in first}
    return torch.cat([o.to(device) for o in outs], dim=dim)


class ModeExpertChannelizer:
    """One wideband capture -> N channels routed to per-mode expert chains.

    assignments: ChannelAssignment per channel of the capture (original
    channel order); each distinct mode becomes an expert built for it.
    devices: an optional flat list of torch devices, partitioned into
    per-expert groups (partition_devices); an expert splits its channels
    evenly over its group, one sub-Receiver per device.  Without devices,
    every expert runs on `device` (the card unless the caller passes
    "cpu").  rx_kwargs go to every expert's ReceiverConfig.

    step(states, iq) -> (states', outs): JAX's per-block contract, iq [C,
    N] complex64 in original channel order, [1, N] one shared capture, or
    the packed [N, 2C] float32 plane ([N, 2]: one shared capture).
    step_many(states, iq): K blocks per dispatch, [K*N, 2C] or [K*N, 2].
    outs is one dict per expert in routing order (a Receiver's outputs for
    the expert's channels); groups[e].channel_ids maps rows back to the
    original channel numbering.  A state is a tuple with one sub-Receiver
    state per device of its expert.
    """

    def __init__(self, sample_rate: int, frames_per_buffer: int,
                 assignments, devices=None, spectra: bool = False,
                 device: str | torch.device = "cuda", **rx_kwargs):
        self.groups = route_channels(assignments)
        self._tunes = [np.array(g.tunes, np.float64) for g in self.groups]
        self.spectra = spectra
        dev_groups = (partition_devices(list(devices), self.groups)
                      if devices is not None
                      else [[torch.device(device)]] * len(self.groups))
        self.device_groups = []
        self.receivers: list[list[Receiver]] = []
        self.params = []
        for g, devs in zip(self.groups, dev_groups):
            c = len(g.channel_ids)
            while c % len(devs):               # even channel shards only
                devs = devs[:-1]
            self.device_groups.append(devs)
            per = c // len(devs)
            rxs = [Receiver(ReceiverConfig(
                sample_rate=sample_rate, frames_per_buffer=frames_per_buffer,
                channels=per, mode=g.mode, **rx_kwargs), d) for d in devs]
            self.receivers.append(rxs)
            self.params.append([rx.default_params(g.tunes[i * per:
                                                          (i + 1) * per])
                                for i, rx in enumerate(rxs)])

    @property
    def n_experts(self) -> int:
        return len(self.groups)

    def init_states(self) -> list[tuple]:
        return [tuple(rx.init_state() for rx in rxs)
                for rxs in self.receivers]

    def retune(self, channel_id: int, tune_hz: float) -> None:
        """Retune one original channel (a params change, nothing rebuilt)."""
        for e, g in enumerate(self.groups):
            if channel_id in g.channel_ids:
                slot = g.channel_ids.index(channel_id)
                self._tunes[e][slot] = tune_hz
                per = len(g.channel_ids) // len(self.receivers[e])
                i = slot // per
                self.params[e][i] = self.receivers[e][i].retune(
                    self.params[e][i], self._tunes[e][i * per:(i + 1) * per])
                return
        raise KeyError(channel_id)

    def set_params(self, e: int, fn) -> None:
        """Replace expert e's params by fn(receiver, params) on each of its
        sub-Receivers (the CLI's --bandpass, --squelch, --gain)."""
        self.params[e] = [fn(rx, p) for rx, p in
                          zip(self.receivers[e], self.params[e])]

    def _rows(self, iq: torch.Tensor, e: int, i: int, packed: bool):
        """Sub-Receiver i of expert e's input: its channels' rows (or
        lanes) of iq, on its device."""
        rxs = self.receivers[e]
        g = self.groups[e]
        per = len(g.channel_ids) // len(rxs)
        ctot = iq.shape[1] // 2 if packed else iq.shape[0]
        ids = (np.zeros(per, np.int64) if ctot == 1
               else np.asarray(g.channel_ids[i * per:(i + 1) * per]))
        dev = rxs[i].device
        if packed:
            idx = torch.from_numpy(np.concatenate([ids, ctot + ids]))
            return iq.index_select(1, idx.to(iq.device)).to(dev)
        return iq.index_select(0, torch.from_numpy(ids).to(iq.device)).to(
            dev)

    def _run(self, states, iq: torch.Tensor, many: bool):
        packed = not iq.is_complex()
        outs, new_states = [], []
        for e, rxs in enumerate(self.receivers):
            sts, sub = [], []
            for i, rx in enumerate(rxs):
                x = self._rows(iq, e, i, packed)
                fn = rx.step_many if many else rx.step
                st, out = fn(states[e][i], self.params[e][i], x,
                             spectra=self.spectra)
                sts.append(st)
                sub.append(out)
            new_states.append(tuple(sts))
            outs.append(_cat(sub, 1 if many else 0, rxs[0].device))
        return new_states, outs

    def step(self, states, iq: torch.Tensor):
        """One block (JAX's contract, class docstring)."""
        return self._run(states, iq, False)

    def step_many(self, states, iq: torch.Tensor):
        """K blocks in one dispatch: [K*N, 2C] or [K*N, 2] float32."""
        return self._run(states, iq, True)

    def audio_by_channel(self, outs, many: bool = False,
                         blocks: int | None = None) -> dict[int, np.ndarray]:
        """Per-expert audio as {original channel id: audio} (numpy): [M]
        (or [2, M] for stereo) from step's outs; with many, step_many's
        first `blocks` blocks (all K by default) joined in time, [K*M] (or
        [2, K*M])."""
        result = {}
        for g, out in zip(self.groups, outs):
            a = out["audio"][:blocks].cpu().numpy() if many \
                else out["audio"].cpu().numpy()
            for slot, cid in enumerate(g.channel_ids):
                result[cid] = (np.concatenate(list(a[:, slot]), axis=-1)
                               if many else a[slot])
        return result
