"""The sharded PFB dense-bank step: one wideband capture -> many stations
over a (channel x time) mesh of ranks.

Port of pebblesdr_tpu/parallel/pfb_shard.py.  The polyphase filterbank
(ops/pfb.py) is a strided FIR + transform over one full-rate stream, so it
shards over TIME with one halo of state_len = T M - hop input samples (its
carry, the left-neighbour protocol of parallel/time_shard.py).  Each rank
then holds every station's channel for its time span; the per-station tail
Receiver wants whole time streams per station, so one all-to-all over
'time' re-lays the (hop-times smaller) channel-rate streams: the stations
of the rank's channel group split over its time ranks, each rank receiving
its stations' pieces from every time rank.  The tail then runs on the
rank's stations (chain/pfb_bank.py's tail Receiver, C / (channel x time)
stations).
"""

from __future__ import annotations

import dataclasses

import torch

from pebblesdr_tpu_torch.chain.pfb_bank import PfbBankReceiver
from pebblesdr_tpu_torch.chain.receiver import Receiver
from pebblesdr_tpu_torch.ops import pfb
from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
from pebblesdr_tpu_torch.parallel import time_shard
from pebblesdr_tpu_torch.utils.precision import ieee_float32

AXES = ("channel", "time")   # the stations split over both, channel major


class ShardedBankStep:
    """The bank's step on a mesh (module docstring).  step(state, params,
    iq): iq the rank's contiguous [N_l] (or [1, N_l]) complex64 piece of
    the capture's [K*N] samples (mesh.time_range); params the bank's
    (bank.params, every station) or None.  Returns (state', the tail
    Receiver's outputs for the rank's stations, [K, C_r, ...])."""

    def __init__(self, bank: PfbBankReceiver, mesh):
        self.bank, self.mesh = bank, mesh
        plan = bank.pfb_plan
        n_time = mesh.size("time")
        n_local = bank.frames_per_buffer // n_time
        if n_local % (plan.hop * plan.os):
            # os=2: whole frame pairs per shard keep the per-frame
            # twiddle's parity globally consistent (ops/pfb.py apply)
            raise ValueError(f"per-shard chunk {n_local} not divisible by "
                             f"hop*os = {plan.hop * plan.os}")
        c = len(bank.chan_idx)
        self.s0, self.s1 = mesh_mod.channel_range(mesh, c, AXES)
        g0, _ = mesh_mod.channel_range(mesh, c)        # the channel group's
        self.rx = Receiver(dataclasses.replace(
            bank.rx.cfg, channels=self.s1 - self.s0), mesh.device)
        self.chan_idx = torch.as_tensor(
            bank.chan_idx[g0:g0 + c // mesh.size("channel")],
            device=mesh.device)

    def init_state(self):
        """(the filterbank's carry [1, T M - hop], the rank's tail state)."""
        return (pfb.init_state(self.bank.pfb_plan, 1, self.mesh.device),
                self.rx.init_state())

    def _params(self, params):
        dev = self.mesh.device
        kw = {f.name: getattr(params, f.name).to(dev)
              for f in dataclasses.fields(params)}
        for key in ("tune_hi", "tune_lo"):
            kw[key] = kw[key][self.s0:self.s1].contiguous()
        return dataclasses.replace(params, **kw)

    @ieee_float32()
    def __call__(self, state, params, iq: torch.Tensor, spectra: bool = True):
        mesh, plan = self.mesh, self.bank.pfb_plan
        pfb_state, rx_state = state
        xl = iq.reshape(1, -1).to(torch.complex64)
        halo = time_shard.left_halo(xl, plan.state_len, mesh, "time")
        lead = pfb_state if mesh.index("time") == 0 else halo
        _, y = pfb.apply(plan, lead, xl)                  # [1, M, N_l/hop]
        pfb_state = time_shard._last_shard_tail(xl, plan.state_len, mesh,
                                                "time")
        ch = y[0].index_select(0, self.chan_idx)          # [C_g, K_l]
        # the channel group's stations over its time ranks: one all-to-all
        ch = comm.all_to_all(ch, mesh, "time", 0, 1)      # [C_r, K]
        p = self._params(self.bank.params if params is None else params)
        rx_state, out = self.rx.step_many(
            rx_state, p, ch.contiguous(), spectra=spectra,
            rds_per_call=self.bank.rds_per_call)
        return (pfb_state, rx_state), out


def build_sharded_bank_step(bank: PfbBankReceiver, mesh) -> ShardedBankStep:
    """The bank's sharded step (ShardedBankStep); its state from the step's
    init_state()."""
    return ShardedBankStep(bank, mesh)
