"""RDS (Radio Data System): the 57 kHz BPSK subcarrier -> soft symbols on the
device, then block sync, FEC and group decoding on the host.

Port of pebblesdr_tpu/demod/rds.py.  Device half (rds_process): the real
tail-rate composite is decimated to 16 kHz with the -57 kHz mix folded into
the decimation taps (premix, the path the Receiver runs: one paired banded
matmul, ops/fir.fir_apply_real_signal_pair, and a 16 kHz twiddle), or, with
premix=False or a complex pre-mixed baseband, decimated by the composed
response on the stacked [re; im] rows (composed, ops/fir.
fir_apply_real_signal) or by the halfband cascade (staged, ops/decimator.
apply); then resampled
to 19 kHz (exactly 16 samples per 1187.5-baud symbol), carrier-recovered by
the scan-free squaring loop (alg="open", ops/pll.costas_open_run) or the
per-sample Costas loop (alg="scan", ops/pll.pll_run: on a CUDA tensor the
recurrence kernel csrc/recur.cu pll_scan), matched-filtered and sampled at
the symbol phase with the largest smoothed |mf|.  Host half (numpy and
plain Python, copied): the 26-bit syndrome check with burst FEC, the
4-state block sync machine and the group decoder (PI, PTY, PS, RadioText).

"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from pebblesdr_tpu_torch.ops import decimator, fir, iir, pll, resampler

RDS_CARRIER_HZ = 57000.0
RDS_BAUD = 1187.5
SPS = 16  # samples per symbol at 19 kHz


@dataclasses.dataclass(frozen=True, eq=False)
class RdsConfig:
    composite_rate: float
    plan: decimator.DecimatorPlan    # composite -> 16 kHz
    rs_plan: resampler.ResamplePlan  # 16 kHz -> 19 kHz
    pll: pll.PLLConfig               # the per-sample Costas ("scan" only)
    mf_taps: np.ndarray              # biphase matched filter at 19 kHz
    n_sym: int                       # symbols per block
    alg: str = "open"                # "open": the squaring loop; "scan":
    #                                  the per-sample Costas loop
    costas_open: pll.CostasOpenConfig | None = None
    chunk19: int = 16                # open-loop chunk at 19 kHz
    h_composed: np.ndarray | None = None   # composite -> 16 kHz response
    composed: bool = True
    premix: bool = True              # the -57 kHz mix folded into the taps:
    #   y[m] = e^{-j2pi f mD/fs} sum_j (h[j] e^{+j2pi f j/fs}) x[mD-j]
    h_mix_re: np.ndarray | None = None
    h_mix_im: np.ndarray | None = None
    mix_adv16: float = 0.0           # twiddle advance per 16 kHz sample

    @staticmethod
    def make(composite_rate: float, block: int,
             alg: str = "open") -> "RdsConfig":
        plan = decimator.build_plan(composite_rate, 4800.0,
                                    sample_rate_out=16000)
        if plan.rate_out != 16000.0:
            raise ValueError(f"RDS needs a composite rate that halves to "
                             f"16 kHz, got {composite_rate}")
        n16 = block // plan.factor
        rs = resampler.plan(16000, 19000, n16, taps=16)
        n19 = rs.n_out
        if n19 % SPS:
            raise ValueError(
                f"RDS needs whole symbols per block: a {block}-sample "
                f"composite block yields {n19} samples at 19 kHz, not a "
                f"multiple of {SPS} (use a block length whose 16 kHz "
                f"stream is a multiple of {SPS * 16})")
        half = SPS // 2
        mf = np.concatenate([np.ones(half), -np.ones(half)]) / SPS
        cfg_pll = pll.make_pll_config(19000.0, bw_hz=30.0, zeta=0.707,
                                      center_hz=0.0, range_hz=100.0,
                                      detector="costas")
        # open-loop chunk: a multiple of SPS (chunk sums then null the baud
        # harmonics of the squared signal) that divides one block's stream
        ell = 64
        while ell > SPS and n19 % ell:
            ell //= 2
        h = decimator.compose_response(plan)
        jj = np.arange(len(h), dtype=np.float64)
        th = 2.0 * np.pi * (RDS_CARRIER_HZ / composite_rate) * jj
        return RdsConfig(composite_rate=composite_rate, plan=plan, rs_plan=rs,
                         pll=cfg_pll, mf_taps=mf, n_sym=n19 // SPS, alg=alg,
                         costas_open=pll.make_costas_open_config(19000.0),
                         chunk19=ell, h_composed=h,
                         h_mix_re=(h * np.cos(th)).astype(np.float32),
                         h_mix_im=(h * np.sin(th)).astype(np.float32),
                         mix_adv16=float(np.mod(RDS_CARRIER_HZ / 16000.0,
                                                1.0)))


ALGORITHMS = ("open", "scan")


def check_ported(cfg: RdsConfig) -> None:
    """Raise a ValueError naming the first option this port does not run."""
    if cfg.alg not in ALGORITHMS:
        raise ValueError(f"RDS: unknown carrier algorithm {cfg.alg!r} "
                         f"(algorithms: {', '.join(ALGORITHMS)})")


@dataclasses.dataclass(frozen=True)
class RdsState:
    decim: Any               # [C, len(h) - 1] premix decimator history;
    #                          composed [2C, len(h) - 1]; staged one [C, T-1]
    #                          complex64 tail per halfband stage
    resamp: torch.Tensor     # [C, 16] complex64 resampler history
    pll: pll.CostasOpenState | pll.PLLState   # "open" | "scan"
    mf_tail: torch.Tensor    # [C, SPS - 1] matched-filter history
    phase_acc: torch.Tensor  # [C, SPS] EWMA of |mf| per symbol phase (timing)
    mix_phase: torch.Tensor  # [C] premix twiddle phase at the 16 kHz grid


def rds_init(cfg: RdsConfig, channels: int, device) -> RdsState:
    check_ported(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.premix:
        decim = zeros(channels, len(cfg.h_composed) - 1)
    elif cfg.composed:
        decim = zeros(2 * channels, len(cfg.h_composed) - 1)
    else:
        decim = decimator.state_init(cfg.plan, channels, device)
    return RdsState(
        decim=decim,
        resamp=resampler.state_init(cfg.rs_plan, channels, device,
                                    torch.complex64),
        pll=(pll.costas_open_init(channels, device) if cfg.alg == "open"
             else pll.pll_init(cfg.pll, channels, device)),
        mf_tail=zeros(channels, len(cfg.mf_taps) - 1),
        phase_acc=zeros(channels, SPS),
        mix_phase=zeros(channels))


def rds_process(cfg: RdsConfig, state: RdsState, rds_baseband: torch.Tensor,
                blocks: int = 0):
    """rds_baseband: the real tail-rate composite [C, N] float32 (the WFM
    discriminator output), or a complex pre-mixed baseband [C, N] complex64
    (the composed input, whose state comes from rds_init of a premix=False
    configuration).  N may span K concatenated blocks: every stage
    is streaming-exact on the concatenated stream, except the symbol-timing
    EWMA, which updates once per call (a K-block dispatch smooths the same
    statistic at another rate), or with blocks = K once per block, as K
    calls would (the closed form of the per-block EWMA, then an argmax per
    block).

    Returns (state', soft [C, n_sym_total] float32 soft symbols, timing
    [C] int32 symbol phase, or [C, K] with blocks); sign(soft) are the
    biphase symbols for RdsBlockDecoder."""
    check_ported(cfg)
    mix_phase = state.mix_phase
    c_in = rds_baseband.shape[0]
    if cfg.premix and not rds_baseband.is_complex():
        ya, yb, st_d = fir.fir_apply_real_signal_pair(
            rds_baseband, state.decim, cfg.h_mix_re, cfg.h_mix_im,
            decim=cfg.plan.factor)
        n16 = ya.shape[-1]
        adv = float(np.float32(cfg.mix_adv16))
        m = torch.arange(n16, dtype=torch.float32, device=ya.device)[None, :]
        ph = torch.remainder(state.mix_phase[:, None] + m * adv, 1.0)
        tw_c = torch.cos(2.0 * np.pi * ph)
        tw_s = torch.sin(2.0 * np.pi * ph)
        x = torch.complex(ya * tw_c + yb * tw_s, yb * tw_c - ya * tw_s)
        mix_phase = torch.remainder(state.mix_phase + n16 * adv, 1.0)
    elif cfg.composed:
        # the composed response on the stacked [re; im] rows; a complex
        # baseband takes this input even with premix, whose [C, ...]
        # history does not fit it
        if not isinstance(state.decim, torch.Tensor) or \
                state.decim.shape[0] != 2 * c_in:
            raise ValueError(
                f"RDS: a complex baseband takes the composed input, whose "
                f"decimator history is [2C, ...] (rds_init of a premix="
                f"False configuration); this state's is "
                f"{getattr(state.decim, 'shape', None)}")
        xb = rds_baseband.to(torch.complex64)
        xr = torch.cat([xb.real, xb.imag], dim=0)
        y, st_d = fir.fir_apply_real_signal(
            xr, state.decim, np.asarray(cfg.h_composed, np.float32),
            decim=cfg.plan.factor)
        x = torch.complex(y[:c_in], y[c_in:])
    else:
        st_d, x = decimator.apply(cfg.plan, state.decim,
                                  rds_baseband.to(torch.complex64))
    st_r, x = resampler.apply_many(cfg.rs_plan, state.resamp, x)      # 19 kHz
    if cfg.alg == "open":
        st_p, phases, _ = pll.costas_open_run(cfg.costas_open, state.pll, x,
                                              chunk=cfg.chunk19)
    else:
        st_p, phases, _ = pll.pll_run(cfg.pll, state.pll, x)          # Costas
    coherent = (x * torch.exp(-1j * phases.to(torch.complex64))).real
    mf, mf_tail = fir.fir_apply_real_signal(coherent, state.mf_tail,
                                            cfg.mf_taps)
    c, n19 = mf.shape
    k = blocks or 1
    sym = mf.reshape(c, k, n19 // SPS // k, SPS)
    # symbol timing: EWMA of the mean |mf| per intra-symbol phase, sampled
    # at its largest
    p = sym.abs().mean(dim=2)                                   # [C, K, SPS]
    if blocks:
        lmat, seed = iir.ewma_tables(k, 0.9, p.device)
        acc_k = (torch.matmul(lmat, p.transpose(0, 1).reshape(k, -1))
                 .reshape(k, c, SPS)
                 + seed[:, None, None] * state.phase_acc[None])   # [K, C, SPS]
        acc = acc_k[-1]
        best = torch.argmax(acc_k, dim=-1).T                      # [C, K]
    else:
        acc = 0.9 * state.phase_acc + 0.1 * p[:, 0]
        best = torch.argmax(acc, dim=-1)[:, None]                 # [C, 1]
    soft = torch.gather(sym, 3, best[:, :, None, None].expand(
        c, k, sym.shape[2], 1)).reshape(c, n19 // SPS)
    timing = (best if blocks else best[:, 0]).to(torch.int32)
    return (RdsState(decim=st_d, resamp=st_r, pll=st_p, mf_tail=mf_tail,
                     phase_acc=acc, mix_phase=mix_phase), soft, timing)


# ---------------------------------------------------------------- host side

# parity-check generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 (CENELEC EN 50067)
_G = 0b10110111001
_OFFSETS = {
    "A": 0b0011111100,
    "B": 0b0110011000,
    "C": 0b0101101000,
    "Cp": 0b1101010000,
    "D": 0b0110110100,
}
_BLOCK_SEQ = ["A", "B", "C", "D"]  # C may be C' in B-version groups


def _syndrome(block26: int) -> int:
    """10-bit syndrome of a 26-bit block (information*2^10 + checkword)."""
    reg = block26
    for i in range(25, 9, -1):
        if reg & (1 << i):
            reg ^= _G << (i - 10)
    return reg & 0x3FF


def _expected_offset(name: str) -> int:
    return _OFFSETS[name]


def _build_burst_table(max_burst: int = 5) -> dict:
    """syndrome(error) -> 26-bit error mask, for every burst error of width
    <= max_burst (errors confined to `max_burst` consecutive bit positions).
    The (26,16) shortened cyclic code maps such bursts to unique syndromes,
    so FEC is one dict lookup per errored block."""
    table: dict[int, int] = {}
    for start in range(26):  # msb position of the burst (bit index from lsb)
        for width in range(1, max_burst + 1):
            if start - width + 1 < 0:
                continue
            # first and last bit of the burst are set; interior bits free
            if width <= 2:
                interiors = [0]
            else:
                interiors = range(1 << (width - 2))
            for inner in interiors:
                e = 1 << start
                if width > 1:
                    e |= 1 << (start - width + 1)
                    e |= inner << (start - width + 2)
                syn = _syndrome(e)
                prev = table.get(syn)
                if prev is None or bin(e).count("1") < bin(prev).count("1"):
                    table[syn] = e
    return table


_BURST_TABLE = _build_burst_table()


def check_block(block26: int, offset: int, use_fec: bool):
    """Syndrome-check one 26-bit block against its offset word; with FEC,
    correct any <=5-bit burst error.  Returns (ok, corrected_block26,
    n_corrected_bits)."""
    syn = _syndrome(block26) ^ offset
    if syn == 0:
        return True, block26, 0
    if use_fec:
        e = _BURST_TABLE.get(syn)
        if e is not None:
            return True, block26 ^ e, bin(e).count("1")
    return False, block26, 0


# decoder states
_BITSYNC = 0      # sliding bit-by-bit, looking for a clean block A
_BLOCKSYNC = 1    # need B, C, D clean in sequence before trusting position
_GROUPDECODE = 2  # locked: decode groups, FEC enabled
_GROUPRESYNC = 3  # skip to the next group boundary after a block error

BLOCK_ERROR_LIMIT = 5  # bad blocks before falling back to bit-level sync


@dataclasses.dataclass
class RdsBlockDecoder:
    """Bits -> synced 26-bit blocks -> 4-block groups.

    BITSYNC slides bit-by-bit until a block-A checkword passes without FEC;
    BLOCKSYNC then requires B, C, D clean in sequence; GROUPDECODE runs with
    burst FEC (<=5 bits) and falls back to BITSYNC after BLOCK_ERROR_LIMIT
    consecutive bad blocks; GROUPRESYNC skips the rest of a damaged group.
    Differential decode included."""

    _state: int = _BITSYNC
    _bits: int = 0
    _nbits: int = 0
    _last_raw: int = 0
    _block_idx: int = 0
    _version_b: bool = False
    _group: list = dataclasses.field(default_factory=list)
    groups: list = dataclasses.field(default_factory=list)
    block_errors: int = 0        # cumulative bad blocks (stat)
    _consec_errors: int = 0      # consecutive bad blocks (resync trigger)
    blocks_ok: int = 0
    bits_corrected: int = 0      # FEC-corrected bit count (stat)

    @property
    def synced(self) -> bool:
        return self._state != _BITSYNC

    def feed_symbols(self, symbols: np.ndarray) -> None:
        """symbols: [n] biphase symbol signs (+-1 or bool).  RDS data is
        differentially encoded: bit = sym[k] XOR sym[k-1]."""
        raw = (np.asarray(symbols) > 0).astype(np.uint8)
        for s in raw:
            bit = int(s ^ self._last_raw)
            self._last_raw = int(s)
            self._push_bit(bit)

    def _offset_name(self) -> str:
        name = _BLOCK_SEQ[self._block_idx]
        if name == "C" and self._version_b:
            name = "Cp"
        return name

    def _push_bit(self, bit: int) -> None:
        self._bits = ((self._bits << 1) | bit) & ((1 << 26) - 1)
        self._nbits += 1
        if self._state == _BITSYNC:
            if self._nbits < 26:
                return
            ok, _, _ = check_block(self._bits, _OFFSETS["A"], use_fec=False)
            if ok:  # candidate bit position; BLOCKSYNC must confirm it
                self._group = [self._bits >> 10]
                self._block_idx = 1
                self._version_b = False
                self._nbits = 0
                self._state = _BLOCKSYNC
            return
        if self._nbits < 26:
            return
        self._nbits = 0
        if self._state == _BLOCKSYNC:
            ok, _, _ = check_block(self._bits, _OFFSETS[self._offset_name()],
                                   use_fec=False)
            if not ok:  # false bit sync: start over at the bit level
                self._state = _BITSYNC
                self._nbits = 26  # keep sliding bit-by-bit immediately
                self._group = []
                return
            self._take_block(self._bits)
            if self._block_idx == 0:  # D landed: bit position confirmed
                self._consec_errors = 0
                self._state = _GROUPDECODE
            return
        if self._state == _GROUPRESYNC:
            self._block_idx = (self._block_idx + 1) % 4
            if self._block_idx == 0:
                self._state = _GROUPDECODE
            return
        # GROUPDECODE
        ok, corrected, nbits = check_block(
            self._bits, _OFFSETS[self._offset_name()], use_fec=True)
        if not ok:
            self.block_errors += 1
            self._consec_errors += 1
            self._group = []
            if self._consec_errors > BLOCK_ERROR_LIMIT:
                self._state = _BITSYNC
                self._nbits = 26
                return
            self._block_idx = (self._block_idx + 1) % 4
            if self._block_idx != 0:  # skip the rest of this damaged group
                self._state = _GROUPRESYNC
            return
        self._consec_errors = 0
        self.bits_corrected += nbits
        self._take_block(corrected)

    def _take_block(self, block26: int) -> None:
        info = block26 >> 10
        self.blocks_ok += 1
        name = _BLOCK_SEQ[self._block_idx]
        if name == "A":
            self._group = [info]
        else:
            self._group.append(info)
        if name == "B":
            self._version_b = bool((info >> 11) & 1)
        if name == "D" and len(self._group) == 4:
            self.groups.append(tuple(self._group))
            self._group = []
        self._block_idx = (self._block_idx + 1) % 4


_PTY_NAMES_RBDS = [
    "None", "News", "Information", "Sports", "Talk", "Rock", "Classic Rock",
    "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies", "Soft",
    "Nostalgia", "Jazz", "Classical", "R&B", "Soft R&B", "Language",
    "Religious Music", "Religious Talk", "Personality", "Public", "College",
    "Spanish Talk", "Spanish Music", "Hip-Hop", "", "", "Weather",
    "Emergency Test", "Emergency",
]


@dataclasses.dataclass
class RdsGroupDecoder:
    """Groups -> station data: PI, PTY, PS name, RadioText, the RBDS
    callsign from PI, and group 1A's Extended Country Code / PIN."""

    pi: int = 0
    pty: int = 0
    ecc: int = 0      # Extended Country Code (group 1A variant 0)
    pin: int = 0      # Programme Item Number (group 1 block D)
    ps: list = dataclasses.field(default_factory=lambda: [" "] * 8)
    rt: list = dataclasses.field(default_factory=lambda: [" "] * 64)

    def reset(self) -> None:
        """Station changed (new PI): clear the per-station text."""
        self.ps = [" "] * 8
        self.rt = [" "] * 64
        self.ecc = 0
        self.pin = 0

    def decode(self, group: tuple[int, int, int, int]) -> None:
        a, b, c, d = group
        if a and a != self.pi and self.pi:
            self.reset()
        self.pi = a
        gtype = (b >> 12) & 0xF
        version_b = (b >> 11) & 1
        self.pty = (b >> 5) & 0x1F
        if gtype == 0:  # PS name
            seg = b & 0x3
            self.ps[2 * seg] = chr((d >> 8) & 0xFF)
            self.ps[2 * seg + 1] = chr(d & 0xFF)
        elif gtype == 1:  # slow labelling codes / programme item number
            self.pin = d
            if not version_b:
                variant = (c >> 12) & 0x7
                if variant == 0:
                    self.ecc = c & 0xFF
        elif gtype == 2:  # RadioText
            seg = b & 0xF
            if version_b:
                self.rt[2 * seg] = chr((d >> 8) & 0xFF)
                self.rt[2 * seg + 1] = chr(d & 0xFF)
            else:
                self.rt[4 * seg] = chr((c >> 8) & 0xFF)
                self.rt[4 * seg + 1] = chr(c & 0xFF)
                self.rt[4 * seg + 2] = chr((d >> 8) & 0xFF)
                self.rt[4 * seg + 3] = chr(d & 0xFF)

    @property
    def ps_name(self) -> str:
        return "".join(self.ps)

    @property
    def radiotext(self) -> str:
        return "".join(self.rt).rstrip()

    @property
    def pty_name(self) -> str:
        return _PTY_NAMES_RBDS[self.pty] if self.pty < 32 else ""

    @property
    def callsign(self) -> str:
        """RBDS PI -> US callsign (K/W stations)."""
        pi = self.pi
        if 0x1000 <= pi <= 0x994F:
            if pi < 0x54A8:
                first, n = "K", pi - 0x1000
            else:
                first, n = "W", pi - 0x54A8
            c1, rem = divmod(n, 26 * 26)
            c2, c3 = divmod(rem, 26)
            return first + chr(65 + c1) + chr(65 + c2) + chr(65 + c3)
        return ""


def encode_group(a: int, b: int, c: int, d: int, version_b=False) -> list[int]:
    """Build the 104-bit block bitstream of one group (information +
    checkwords + offsets), ready for differential encoding."""
    out_bits = []
    names = ["A", "B", "Cp" if version_b else "C", "D"]
    for info, name in zip((a, b, c, d), names):
        block = info << 10
        check = _syndrome(block) ^ _expected_offset(name)
        block |= check
        assert _syndrome(block) == _expected_offset(name)
        out_bits.extend((block >> i) & 1 for i in range(25, -1, -1))
    return out_bits
