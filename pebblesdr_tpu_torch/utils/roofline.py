"""The H100's peak rates and the least time a kernel's work could take on
it, from the bytes it must move and the operations it must do.

One place for the rates and for the bounds of K1, its passes (front_means,
which also bounds front_nb_means, front_dc_scan, front_fir, K1's carried
history, front_disc, front_comp), K2 and the recurrences (pll_scan,
pll_chunk_scan, agc_scan, iq_lms_scan, ook_scan, sweep_scan, anf_scan),
read by chip_smoke.py, ops/kprobe.py and the tools.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 peak, whichever is larger."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def means_bound(t: int, lanes: int, x_bytes: int, blocks: int = 1,
                raw_rows: int = 0) -> dict:
    """front_means' bound: the [t, lanes] plane read once (x_bytes per
    element), the chunk means [t/512, lanes] and the raw tails [blocks,
    raw_rows, lanes] written once, in float32; its ~1 add per element is
    far below the float32 peak."""
    nbytes = (t * lanes * x_bytes + (t // 512) * lanes * 4
              + blocks * raw_rows * lanes * 4)
    return {"bytes": nbytes, **bound(nbytes, t * lanes)}


def k1_ops(taps: int, t: int, c: int, factor: int) -> int:
    """K1's base-form operations over t rows of c channels: the FIR's 2
    taps per decimated lane, DC 2 per lane and the mix 6 per channel per
    row."""
    return 2 * taps * (t // factor) * 2 * c + 2 * t * 2 * c + 6 * t * c


def k1_bound(plan, t: int, c: int, x_bytes: int, n_block: int,
             raw_rows: int, disc: bool = False, y_tail_rows: int = 0,
             nb: bool = False, iq: bool = False, comp_taps: int = 0) -> dict:
    """K1's bound from its shapes: the plane read once, every output
    written once, the carried state read and written; k1_ops plus the
    per-row work of the options (IQ 3 and blanker 6 per channel;
    discriminator ~26 per output; with comp_taps the half-rate plane
    written instead of the full-rate one, its 32-row history read and
    written, and 2 tc operations per half-rate output)."""
    c2, k, m = 2 * c, t // n_block, t // plan.factor
    disc_rows = m // 2 if comp_taps else m
    nbytes = (t * c2 * x_bytes + 2 * plan.d_rows * c2 * 4
              + k * raw_rows * c2 * 4
              + (k * y_tail_rows if y_tail_rows else m) * c2 * 4
              + (disc_rows * c * 4 if disc else 0)
              + (2 * 32 * c * 4 if comp_taps else 0)
              + (2 * (1 + 16) * c2 * 4 if nb else 0))
    ops = (k1_ops(plan.h.numel(), t, c, plan.factor)
           + (3 * t * c if iq else 0) + (6 * t * c if nb else 0)
           + (26 * m * c if disc else 0) + 2 * comp_taps * (m // 2) * c)
    return bound(nbytes, ops)


def fir_bound(plan, t: int, c: int, x_bytes: int) -> dict:
    """front_fir's bound (K1's FIR pass, with its DC removal and mix): the
    [t, 2c] plane read once (x_bytes per element), its chunk DC estimates
    and the carried tail read, y [t/F, 2c] written once in float32; 2 taps
    operations per decimated lane."""
    c2, m = 2 * c, t // plan.factor
    nbytes = (t * c2 * x_bytes + (t // 512) * c2 * 4 + plan.d_rows * c2 * 4
              + m * c2 * 4)
    return bound(nbytes, 2 * plan.h.numel() * m * c2)


def k2_bound(tplan, n: int, c: int) -> dict:
    """K2's bound: raw [n, C] and the pilot parameters read, the audio
    [n/F, 2C] written, the history read and written; 2 (D+1) operations per
    decimated lane plus ~24 per row and channel for the demux."""
    nbytes = (n * c * 4 + 2 * (n // tplan.ell) * c * 4
              + (n // tplan.factor) * 2 * c * 4 + 2 * tplan.d_rows * 2 * c * 4)
    ops = 2 * tplan.h.numel() * (n // tplan.factor) * 2 * c + 24 * n * c
    return bound(nbytes, ops)


def scan_bound(nchunk: int, lanes: int) -> dict:
    """front_dc_scan's bound: the chunk means [nchunk, lanes] and the
    carried estimate read, the estimates [nchunk, lanes] and the next
    carried one written; 2 operations per chunk and lane."""
    nbytes = 2 * (nchunk + 1) * lanes * 4
    return bound(nbytes, 2 * nchunk * lanes)


def front_tail_bound(d_rows: int, c: int, x_bytes: int) -> dict:
    """The bound of K1's carried history (front_fir's march writes it; a
    launch of its own, front_tail, before): the last d_rows rows of the
    [T, 2c] plane, their
    chunk DC estimates and the carried tail read, tail' [d_rows, 2c]
    written; two phasors (~40 operations) and the mix per row and
    channel."""
    nbytes = d_rows * 2 * c * (x_bytes + 4 + 4 + 4)
    return bound(nbytes, 46 * d_rows * c)


def disc_bound(m: int, c: int, blocks: int, y_tail_rows: int,
               hist_rows: int = 0) -> dict:
    """front_disc's bound (K1d + K1f): y [m, 2c] read once, the carried
    sample read and the next written, the y-tails [blocks, y_tail_rows, 2c]
    written, and the discriminator [m, c] (in the hq form, hist_rows > 0,
    only its last hist_rows rows) written; ~26 operations per decimated row
    and channel (the conjugate product 6, atan2 ~20)."""
    nbytes = (m * 2 * c * 4 + 2 * 2 * c * 4 + blocks * y_tail_rows * 2 * c * 4
              + (hist_rows if hist_rows else m) * c * 4)
    return bound(nbytes, 26 * m * c)


def comp_bound(m: int, c: int, tc: int, hist_rows: int, blocks: int = 0,
               y_tail_rows: int = 0) -> dict:
    """front_comp's bound (K1e, the hq form's one pass over y): y [m, 2c]
    read once, the carried sample and comp_hist [hist_rows, c] read, the
    half-rate composite [m/2, c], comp_hist' [hist_rows, c], the next
    carried sample [1, 2c] and the y-tails [blocks, y_tail_rows, 2c]
    written; the discriminator of each decimated row (~26 operations) and
    2 tc per half-rate output."""
    nbytes = (m * 2 * c * 4 + 2 * 2 * c * 4 + 2 * hist_rows * c * 4
              + (m // 2) * c * 4 + blocks * y_tail_rows * 2 * c * 4)
    return bound(nbytes, 26 * m * c + 2 * tc * (m // 2) * c)


def recur_bound(steps: int, c: int, in_bytes: int, outs: int,
                step_ns: float) -> dict:
    """A recurrence's bound (csrc/recur.cu): the larger of two floors.  The
    bytes: the input [c, steps] (in_bytes per element) read once, `outs`
    float32 outputs [c, steps] written once, three 4-byte state words per
    channel read and written, over the HBM rate.  The serial floor: each
    channel's next step needs its previous state, so the steps run one
    after another whatever the channel count (c <= 32 x 132 x 64 threads
    is far from filling the card) and the work takes at least steps x the
    latency of one step's dependent chain.  step_ns is that latency as a
    chain probe measures it (ops/pll.py chain_probe, timed over many steps
    on the card; the callers say which probe): it is the latency of this
    implementation's chain (IEEE sincosf, atan2f, hypotf, divisions), not a
    property of the card alone.  bound_by "operations" names the serial
    floor."""
    nbytes = c * steps * (in_bytes + 4 * outs) + 2 * 3 * 4 * c
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_s = steps * step_ns * 1e-6
    return {"bytes": nbytes, "serial_ms": t_s, "bound_ms": max(t_b, t_s),
            "bound_by": "bytes" if t_b >= t_s else "operations"}


def pll_scan_bound(c: int, n: int, step_ns: float) -> dict:
    """pll_scan's (K3) bound: x [c, n] complex64 in, phases and freqs [c, n]
    float32 out, n steps of the loop (recur_bound).  step_ns is the
    chain-only probe's step fed from memory (chain_probe(detector,
    fed=True)): one lane runs the state-dependent part of the loop kernel's
    step (sincosf and the derotation, or the pilot's cosf and product; the
    detector, the clip, the add and the wrap) op for op on a pattern that
    the compiler cannot fold, |x|, amp' and the denominators precomputed;
    no bit-equal design runs a step below it.  The register-only probe,
    its constant input folding |x| out of the loop, is no floor (K3c's
    kernels read 101-122 % of it on the H100)."""
    return recur_bound(n, c, 8, 2, step_ns)


def pll_chunk_bound(c: int, f: int, step_ns: float) -> dict:
    """pll_chunk_scan's (K3c) bound: the chunk phasors [c, f] complex64
    in, offs and fdevs [c, f] float32 out, f steps of the loop
    (recur_bound); step_ns from the chain-only probe fed from memory
    (chain_probe("chunk" or "chunk pilot", fed=True)), as pll_scan_bound."""
    return recur_bound(f, c, 8, 2, step_ns)


def agc_scan_bound(c: int, m: int, step_ns: float) -> dict:
    """agc_scan's bound: the envelope [c, m] float32 in, the levels [c, m]
    out, m steps of the smoother (recur_bound)."""
    return recur_bound(m, c, 4, 1, step_ns)


def iq_lms_bound(c: int, n: int, step_ns: float, group: int = 64) -> dict:
    """iq_lms_scan's (K5) bound: x [c, n] complex64 read once, y [c, n]
    complex64 written once, the weight [c] complex64 read and written, over
    the HBM rate; the serial floor n / group steps of the LMS chain (its
    step latency from the chain probe "iq lms"); the ~10 operations per
    sample of the sums and the output are far below the float32 peak."""
    nbytes = 2 * c * n * 8 + 2 * c * 8
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_s = (n // group) * step_ns * 1e-6
    return {"bytes": nbytes, "serial_ms": t_s, "bound_ms": max(t_b, t_s),
            "bound_by": "bytes" if t_b >= t_s else "operations"}


def ook_scan_bound(c: int, f: int, step_ns: float,
                   compare: bool = False) -> dict:
    """ook_scan's (K6) bound: the frame powers the mode reads, once (the
    main power, 4 bytes a frame; in compare mode the low and high ones
    too, 12), the marks [c, f] written once as bool (1 byte), the state
    (five 4-byte words and the 1-byte decision per channel) read and
    written; the serial floor f steps of the detector's chain
    (recur_bound's; step_ns from the chain probe fed from memory, which
    folds no step on constant inputs)."""
    nbytes = c * f * ((12 if compare else 4) + 1) + 2 * (5 * 4 + 1) * c
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_s = f * step_ns * 1e-6
    return {"bytes": nbytes, "serial_ms": t_s, "bound_ms": max(t_b, t_s),
            "bound_by": "bytes" if t_b >= t_s else "operations"}


def sweep_scan_bound(n: int, step_ns: float) -> dict:
    """sweep_scan's (K7) bound: the samples [n] complex64 written once and
    the four-word state read and written; the serial floor n steps of the
    sweep's chain (one sequence: nothing runs beside it)."""
    nbytes = 8 * n + 2 * 4 * 4
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_s = n * step_ns * 1e-6
    return {"bytes": nbytes, "serial_ms": t_s, "bound_ms": max(t_b, t_s),
            "bound_by": "bytes" if t_b >= t_s else "operations"}


def anf_scan_bound(rows: int, n: int, u: int, step_ns: float,
                   taps: int = 45, hist: int = 108) -> dict:
    """anf_scan's (K8) bound: x [rows, n] float32 read once, the
    predictions y [rows, n] written once, the weights [rows, taps] and the
    history [rows, hist] read and written, over the HBM rate; the
    operations (2 taps per sample for the prediction, 1 for the error, 2
    taps for the gradient, 3 taps per update for the leaky step) over the
    float32 peak; and the serial floor: the n / u updates run one after
    another, each at least the chain probe's time per update ("anf <u>").
    bound_by "operations" names the larger of the last two."""
    nbytes = 2 * rows * n * 4 + 2 * rows * (taps + hist) * 4
    ops = rows * (n * (4 * taps + 1) + (n // u) * 3 * taps)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOPS * 1e3
    t_s = (n // u) * step_ns * 1e-6
    return {"bytes": nbytes, "ops": ops, "serial_ms": t_s,
            "bound_ms": max(t_b, t_o, t_s),
            "bound_by": "bytes" if t_b >= max(t_o, t_s) else "operations"}
