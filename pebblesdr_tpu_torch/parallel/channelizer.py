"""The sharded whole-chain step: one wideband capture -> many demodulated
channels over a (channel x time) mesh of ranks.

Port of pebblesdr_tpu/parallel/channelizer.py.  Channels split over the
'channel' axis as a pure map; the wideband front end (DC blocker + NCO mix
+ the whole decimator cascade as one composed FIR) runs time-sharded over
the 'time' axis with one halo of D post-mix samples; the decimated stream
is then gathered over 'time' within the channel group and the batched tail
(chain/receiver.py ``_tail_many``: FastFIR -> AGC -> demod -> resample, or
the WFM tail) runs on the rank's channels.

Two front ends, both streaming-exact against the unsharded Receiver:

  * fused (the default on a card): ops.front.fused_front — K1 on the card,
    its plain version on the CPU — on each shard's own [N_l, 2C_l] plane,
    seeded from outside (JAX's protocol, channelizer.py:182-193):
      1. DC seed: the shard's chunk means join the cross-shard EWMA in
         closed form (one all-gather of [2C_l] affine maps,
         time_shard.dc_seed), giving the estimate entering the shard;
      2. post-mix tail: the shard DC-removes and mixes its own last D rows
         (a few hundred) and sends them right; shard 0 takes the carried
         tail;
      3. K1 runs on the shard's plane with dc = that estimate (packed [1,
         2C_l]) and tail = the received rows in its [d_rows, 2C_l] history.
  * staged (the default on the CPU): time_shard.sharded_dc_removal +
    sharded_composed_front.

Two input contracts.  ``step(state, params, iq)``: JAX's, one block [C, N]
split over 'time' (the rank passes its [C_l, N_l] piece, mesh.local_block);
returns (state', audio [C_l, ...]).  ``step_many(state, params, x)``: the
port's dispatch, K blocks [K*N, 2C] split into T contiguous pieces (the
rank passes its [K*N/T, 2C_l] plane, mesh.local_plane; or [C_l, K*N/T]
complex64); returns (state', the batched tail's outputs for the rank's
channels, [K, C_l, ...]).  Either way the shard's rows must be a whole
number of 2048-row sub-blocks (fused) or 512-sample DC chunks (staged) and
of the decimation factor, and at least D.

The sharded front takes the Receiver's base front only: the noise blanker,
IQ balance, the staged-front options and the WFM hq geometry raise.  FM
stereo discriminates the gathered stream (the front's FM discriminator, in
torch) and runs the stereo tail K2 behind it.  Spectra are not computed
(JAX's sharded step has none); the zoom window's S-meter and squelch are.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pebblesdr_tpu_torch.chain.receiver import Receiver, ReceiverState
from pebblesdr_tpu_torch.demod.modes import is_wfm
from pebblesdr_tpu_torch.ops import decimator, front
from pebblesdr_tpu_torch.ops.mixer import MixerState
from pebblesdr_tpu_torch.parallel import comm
from pebblesdr_tpu_torch.parallel import mesh as mesh_mod
from pebblesdr_tpu_torch.parallel import time_shard
from pebblesdr_tpu_torch.utils.precision import ieee_float32

DC_ALPHA = 0.9999  # the Receiver front end's (demod_am.cpp:44 alpha)


def init_state(rx: Receiver) -> ReceiverState:
    """rx.init_state() in the sharded step's layout: the decimator carry is
    the composed front's — the last D post-mix samples [C, D] complex64 (D
    the composed group delay) — and the DC estimate [C] complex64; both
    split over 'channel' (mesh.shard_state) where the unsharded fused front
    keeps them lane-packed."""
    d = len(decimator.compose_response(rx.plan)) - 1
    c = rx.cfg.channels
    return dataclasses.replace(
        rx.init_state(),
        decim=torch.zeros(c, d, dtype=torch.complex64, device=rx.device),
        dc=torch.zeros(c, dtype=torch.complex64, device=rx.device))


def _packed(z: torch.Tensor) -> torch.Tensor:
    """[C, n] complex -> [n, 2C] float32 lanes (re | im), contiguous."""
    return torch.cat([z.real.T, z.imag.T], dim=1).contiguous()


def _complex(p: torch.Tensor) -> torch.Tensor:
    """[n, 2C] lanes -> [C, n] complex64, contiguous."""
    c = p.shape[1] // 2
    return torch.complex(p[:, :c].T, p[:, c:].T).contiguous()


class ShardedStep:
    """The sharded step of one Receiver configuration on one mesh (module
    docstring).  rx: the unsharded Receiver (its configuration and plan);
    the rank runs a Receiver of the same configuration for its C_l
    channels on the mesh's device (``self.rx``)."""

    def __init__(self, rx: Receiver, mesh, fused: bool | None = None):
        cfg = rx.cfg
        if (rx.staged or cfg.enable_noise_blanker or cfg.enable_iq_balance
                or (is_wfm(cfg.mode) and cfg.wfm_hq)):
            raise ValueError(
                "the sharded step runs the base front only: no noise "
                "blanker, IQ balance, staged-front option or WFM hq "
                "geometry")
        self.mesh = mesh
        self.fused = (mesh.device.type == "cuda") if fused is None \
            else bool(fused)
        self.c0, self.c1 = mesh_mod.channel_range(mesh, cfg.channels)
        self.rx = Receiver(dataclasses.replace(
            cfg, channels=self.c1 - self.c0), mesh.device)
        self.h = decimator.compose_response(rx.plan)
        self.d = len(self.h) - 1
        self.factor = rx.plan.factor
        self.n = cfg.frames_per_buffer

    def init_state(self) -> ReceiverState:
        """The rank's state for its channels (init_state of its Receiver),
        on the mesh's device."""
        return init_state(self.rx)

    # ---------------------------------------------------------------- checks
    def _rows(self, rows: int) -> int:
        """Checks a shard's row count; returns the dispatch's blocks K."""
        t = self.mesh.size("time")
        unit = front.SUB_BLOCK if self.fused else front.DC_CHUNK
        if rows % unit or rows % self.factor or rows < self.d:
            raise ValueError(
                f"per-shard chunk {rows} must divide into whole "
                f"{unit}-row {'sub-blocks' if self.fused else 'DC chunks'} "
                f"and the decimation factor {self.factor}, and hold the "
                f"{self.d}-sample halo")
        if (rows * t) % self.n:
            raise ValueError(f"{t} shards of {rows} rows are not a whole "
                             f"number of {self.n}-frame blocks")
        return rows * t // self.n

    def _params(self, params):
        dev = self.mesh.device
        kw = {f.name: getattr(params, f.name).to(dev)
              for f in dataclasses.fields(params)}
        for key in ("tune_hi", "tune_lo"):
            kw[key] = kw[key][self.c0:self.c1].contiguous()
        return dataclasses.replace(params, **kw)

    # ----------------------------------------------------------------- front
    def _fused_front(self, state, p, x: torch.Tensor):
        """K1 on the shard's [rows, 2C_l] plane, seeded from outside.
        Returns (y [rows/F, 2C_l], dc' [C_l], decim' [C_l, D], phase')."""
        mesh, d = self.mesh, self.d
        i, tt = mesh.index("time"), mesh.size("time")
        rows, c2 = x.shape
        c = c2 // 2
        nch = rows // front.DC_CHUNK
        means = x.view(nch, front.DC_CHUNK, c2).mean(dim=1).T   # [2C, nch]
        dc0 = torch.cat([state.dc.real, state.dc.imag])
        # (1) the DC seed entering this shard, and the global end estimate
        m_start, new_dc = time_shard.dc_seed(means, dc0, DC_ALPHA, mesh,
                                             "time", front.DC_CHUNK)
        # (2) this shard's last D rows DC-removed and mixed -> right
        first = (rows - d) // front.DC_CHUNK
        m_tail = time_shard.chunk_estimates(means, m_start, DC_ALPHA,
                                            range(first, nch),
                                            front.DC_CHUNK)
        pick = torch.from_numpy(np.arange(rows - d, rows) // front.DC_CHUNK
                                - first).to(x.device)
        z_tail = x[rows - d:] - m_tail[:, pick].T.float()        # [D, 2C]
        hi, lo, phase0 = p.tune_hi, p.tune_lo, state.mixer.phase
        k0 = float(i * rows)
        shard_phase = torch.remainder(
            phase0 + torch.remainder(k0 * hi, 1.0)
            + torch.remainder(k0 * lo, 1.0), 1.0)
        # the rows mixed as K1 mixes them: the phase of the shard's row t
        # from its sub-block's start (t = 2048 s + 128 q + r), so that
        # (t - D) hi is never rounded (at K*N/T rows a rounded product
        # misses the phase by 0.01 cycle)
        u_tail = front.mix_reference(z_tail, shard_phase, hi, lo,
                                     first=rows - d)              # [D, 2C]
        halo = comm.ring_shift_right(u_tail, mesh, "time")
        lead = _packed(state.decim) if i == 0 else halo
        plan = self.rx.front
        tail = torch.cat([torch.zeros(plan.d_rows - d, c2, device=x.device),
                          lead]).contiguous()
        # (3) K1 on the shard's own plane
        y = front.fused_front(plan, x, m_start.float()[None].contiguous(),
                              shard_phase, hi, lo, tail, n_block=rows)[0]
        carry = comm.broadcast_from(u_tail, mesh, "time", tt - 1)
        ntot = float(tt * rows)
        phase2 = torch.remainder(phase0 + torch.remainder(ntot * hi, 1.0)
                                 + ntot * lo, 1.0)
        dc = torch.complex(new_dc[:c], new_dc[c:]).to(torch.complex64)
        return y, dc, _complex(carry), phase2

    def _staged_front(self, state, p, x: torch.Tensor):
        """The staged front on the shard's [C_l, rows] stream.  Returns (y
        [C_l, rows/F] complex64, dc', decim', phase')."""
        new_dc, z = time_shard.sharded_dc_removal(
            x, state.dc, DC_ALPHA, self.mesh, "time", front.DC_CHUNK)
        phase2, carry, y = time_shard.sharded_composed_front(
            z, state.mixer.phase, p.tune_hi, p.tune_lo, state.decim, self.h,
            self.factor, self.mesh, "time")
        return y, new_dc, carry, phase2

    # ------------------------------------------------------------------ step
    def _run(self, state, params, x: torch.Tensor):
        mesh, rx = self.mesh, self.rx
        if x.device != mesh.device:
            raise ValueError(f"the shard is on {x.device} but the mesh runs "
                             f"on {mesh.device}")
        p = self._params(params)
        if self.fused:
            x = _packed(x) if x.is_complex() else x.contiguous()
            k = self._rows(x.shape[0])
            y, dc, carry, phase = self._fused_front(state, p, x)
            y_pk = comm.gather_axis(y, mesh, "time", 0)   # [K blk, 2C_l]
            x_cat = _complex(y_pk)
        else:
            x = x if x.is_complex() else _complex(x)
            k = self._rows(x.shape[1])
            y, dc, carry, phase = self._staged_front(state, p, x)
            x_cat = comm.gather_axis(y, mesh, "time", 1).contiguous()
            y_pk = None
        c, blk = rx.cfg.channels, rx.blk
        xz = x_cat.reshape(c, k, blk)[:, :, blk - rx.zoom_bins:]
        if rx.wfm_tail is not None:
            # stereo: the front's FM discriminator on the gathered stream,
            # then the stereo tail (K2)
            last = state.demod.last
            disc, dlast = front.discriminate(
                _packed(x_cat) if y_pk is None else y_pk,
                torch.cat([last.real, last.imag])[None], rx.disc_gain)
            demod = functools.partial(rx._demod_wfm, disc_t=disc,
                                      dlast=dlast, comp_tail=None)
        elif rx.wfm_cfg is not None:
            demod = functools.partial(rx._demod_cm, x_cat=x_cat,
                                      rds_per_block=False)
        else:
            demod = functools.partial(rx._demod_narrow, x_cat=x_cat)
        tail_st, out = rx._tail_many(state, p, k, None, xz, False, demod)
        new_state = ReceiverState(mixer=MixerState(phase=phase), decim=carry,
                                  dc=dc, nb=state.nb, iqbal=state.iqbal,
                                  **tail_st)
        return new_state, out

    @ieee_float32()
    def __call__(self, state, params, iq: torch.Tensor):
        """JAX's contract: the rank's [C_l, N_l] complex64 piece of one [C,
        N] block.  Returns (state', audio [C_l, ...])."""
        t = self.mesh.size("time")
        if iq.shape[-1] * t != self.n:
            raise ValueError(f"{t} shards of {iq.shape[-1]} samples are not "
                             f"one {self.n}-frame block")
        state, out = self._run(state, params, iq)
        return state, out["audio"][0]

    @ieee_float32()
    def step_many(self, state, params, x: torch.Tensor):
        """The port's dispatch: the rank's [K*N/T, 2C_l] float32 plane (or
        [C_l, K*N/T] complex64).  Returns (state', outputs [K, C_l, ...])."""
        return self._run(state, params, x)


def build_sharded_step(rx: Receiver, mesh, fused: bool | None = None
                       ) -> ShardedStep:
    """The sharded step of rx's configuration on mesh (ShardedStep); the
    rank's state from its init_state() (or mesh.shard_state(init_state(rx),
    mesh, rx.cfg.channels)).  fused=None
    runs the fused front (K1) on a card and the staged front on the CPU;
    fused=True on a CPU mesh runs K1's plain version per shard."""
    return ShardedStep(rx, mesh, fused)
