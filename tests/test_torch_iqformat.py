"""The port's wire-format decode (pebblesdr_tpu_torch/core/iqformat.py)
against the JAX package's (pebblesdr_tpu/core/iqformat.py) on the CPU:
decode_iq bit-equal for every format with and without the I/Q swap, the
host decoder and the u8 encoder byte- and bit-equal; then the cases of
tests/test_core.py's TestIQFormat on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pebblesdr_tpu.core import iqformat as jiq
from pebblesdr_tpu_torch.core import iqformat

FORMATS = ("u8", "i8", "u16", "i16", "f32", "f64")


def raw_samples(fmt: str, n: int = 4096, seed: int = 0) -> np.ndarray:
    """n interleaved samples of fmt over its whole range (the floats in
    [-1.5, 1.5], past full scale too), from a numpy seed."""
    rng = np.random.default_rng(seed)
    if fmt in ("f32", "f64"):
        return rng.uniform(-1.5, 1.5, 2 * n).astype(
            np.float32 if fmt == "f32" else np.float64)
    info = np.iinfo({"u8": np.uint8, "i8": np.int8, "u16": np.uint16,
                     "i16": np.int16}[fmt])
    return rng.integers(info.min, info.max, 2 * n, endpoint=True,
                        dtype=info.dtype)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_iq_bit_equal_to_jax(fmt, swap):
    raw = raw_samples(fmt)
    want = np.asarray(jiq.decode_iq(jnp.asarray(raw), fmt, swap_iq=swap))
    got = iqformat.decode_iq(torch.from_numpy(raw), fmt, swap_iq=swap)
    assert got.dtype == torch.complex64 and got.shape == (raw.size // 2,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_iq_batched_rows(fmt):
    """[..., 2n] rows decode row by row, as the JAX package's does."""
    raw = raw_samples(fmt, 512, seed=1).reshape(4, 256)
    want = np.asarray(jiq.decode_iq(jnp.asarray(raw), fmt))
    np.testing.assert_array_equal(
        iqformat.decode_iq(torch.from_numpy(raw), fmt).numpy(), want)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_iq_host_bit_equal_to_jax(fmt, swap):
    raw = raw_samples(fmt, seed=2).tobytes()
    np.testing.assert_array_equal(iqformat.decode_iq_host(raw, fmt, swap),
                                  jiq.decode_iq_host(raw, fmt, swap))


def test_encode_iq_u8_byte_equal_to_jax():
    rng = np.random.default_rng(3)
    x = (rng.uniform(-1.2, 1.2, 4096)
         + 1j * rng.uniform(-1.2, 1.2, 4096)).astype(np.complex64)
    assert iqformat.encode_iq_u8(x) == jiq.encode_iq_u8(x)


# ---- tests/test_core.py TestIQFormat on the port --------------------------

def test_u8_decode():
    raw = np.array([128, 128, 255, 0], dtype=np.uint8)
    x = iqformat.decode_iq(torch.from_numpy(raw), "u8")
    np.testing.assert_allclose(x.numpy(), [0 + 0j, 0.9921875 - 1j], atol=1e-6)


def test_i16_decode_swap():
    raw = np.array([16384, -16384], dtype=np.int16)
    x = iqformat.decode_iq(torch.from_numpy(raw), "i16", swap_iq=True)
    np.testing.assert_allclose(x.numpy(), [-0.5 + 0.5j], atol=1e-6)


def test_host_matches_device():
    rng = np.random.default_rng(0)
    raw = rng.integers(-32768, 32767, 64, dtype=np.int16)
    a = iqformat.decode_iq_host(raw.tobytes(), "i16")
    b = iqformat.decode_iq(torch.from_numpy(raw), "i16").numpy()
    np.testing.assert_array_equal(a, b)


def test_u8_encode_roundtrip():
    x = (np.linspace(-0.9, 0.9, 32)
         + 1j * np.linspace(0.9, -0.9, 32)).astype(np.complex64)
    back = iqformat.decode_iq_host(iqformat.encode_iq_u8(x), "u8")
    np.testing.assert_allclose(back, x, atol=1 / 64)
