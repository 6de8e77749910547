"""The summation order of the ANF kernel K8 (csrc/recur.cu anf_scan) on the
CPU: ops/scanops.py anf_emulate repeats each form's order (the chain
form's butterfly over the lanes and split gradient accumulators, the wide
form's split accumulators over the taps, the warps and the pieces) in
float32, and is held to the JAX package's lax.scan (pebblesdr_tpu/ops/
scanops.py anf) and to the plain version anf_plain:

  * at the staged front's U = 16 over 2048 updates and the batched graph's
    U = 1024, on a few rows: y and w' within 1e-5 of their scale of JAX's,
    hist' equal (the bound the kernel is held to on the card against
    anf_plain);
  * each form at the crossover's boundary (U = 32 in both forms, U = 33),
    an update of two pieces (U = 2048), U = 1 and U = 3 (a chain form
    with outputs past U), 33 taps, and N = 0: within 1e-5 of scale of
    anf_plain over two calls carrying the state;
  * the form and the threads per block that the launcher picks.

The kernel itself runs only on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.ops import scanops as jscan
from pebblesdr_tpu_torch.ops import scanops

RTOL = 1e-5          # y and w' of their scale, as K8 against anf_plain


def rows(r: int, n: int, seed: int) -> np.ndarray:
    """[r, n] float32 at 64 kHz: an 800 Hz tone (a phase per row), 2100 Hz
    and noise at 0.1, as tools/cells.py anf_signal's rows."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 64_000.0 + rng.random()
    x = (0.3 * np.cos(2 * np.pi * 800.0 * t + np.arange(r)[:, None])
         + 0.2 * np.cos(2 * np.pi * 2100.0 * t)
         + 0.1 * rng.standard_normal((r, n)))
    return x.astype(np.float32)


def close(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    if not want.size:
        return got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-3)
    return got.shape == want.shape and float(
        np.abs(got - want).max()) <= RTOL * scale


@pytest.mark.parametrize("u", [16, 1024])
def test_emulate_matches_jax(u):
    """One call of 32768 samples from zero weights (2048 updates at U =
    16, 32 at U = 1024) on 4 rows, the form the launcher picks."""
    r, n = 4, 32768
    x = rows(r, n, u)
    js, jy = jscan.anf(jscan.anf_init(r), jnp.asarray(x), update_every=u)
    st = scanops.anf_init(r, "cpu")
    y, w, h = scanops.anf_emulate(torch.from_numpy(x), st.weights, st.delay,
                                  update_every=u)
    assert close(y, jy)
    assert close(w, js.weights)
    assert np.array_equal(h.numpy(), np.asarray(js.delay))
    assert float(w.abs().max()) > 1e-3                   # it adapted


@pytest.mark.parametrize("form,u,n,taps", [
    ("chain", 32, 4096, 45), ("wide", 32, 4096, 45), ("wide", 33, 3300, 45),
    ("wide", 2048, 8192, 45), ("chain", 1, 512, 45), ("chain", 3, 999, 45),
    ("chain", 16, 2048, 33), ("wide", 64, 2048, 33), ("chain", 16, 0, 45)])
def test_emulate_matches_plain(form, u, n, taps):
    """Two calls carrying the state, each form against anf_plain."""
    r = 3
    w_e = w_p = torch.zeros(r, taps)
    h_e = h_p = torch.zeros(r, scanops.ANF_DELAY + taps - 1)
    for call in range(2):
        x = torch.from_numpy(rows(r, n, 7 * call + u))
        y_e, w_e, h_e = scanops.anf_emulate(x, w_e, h_e, update_every=u,
                                            form=form)
        y_p, w_p, h_p = scanops.anf_plain(x, w_p, h_p, update_every=u)
        assert close(y_e, y_p) and close(w_e, w_p)
        assert torch.equal(h_e, h_p)
    if n:
        assert float(w_e.abs().max()) > 1e-3


def test_forms_and_threads():
    """The chain form up to U = 32 on a chain warp and a copy warp; the
    wide form above it on U rounded up to a warp, 64 to 1024 threads."""
    assert [scanops.anf_form(u) for u in (1, 16, 32, 33, 1024)] == [
        "chain", "chain", "chain", "wide", "wide"]
    assert scanops.anf_threads("chain", 16) == 64
    assert [scanops.anf_threads("wide", u) for u in (1, 33, 64, 100, 1024,
                                                     3072)] == [
        64, 64, 64, 128, 1024, 1024]
