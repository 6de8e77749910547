"""IEEE float32 products for the port's entry points.

Every matmul and convolution of the port must run in IEEE float32: a
reduced-precision product (TF32 on the card, a one-pass bf16 product on the
CPU under ``torch.set_float32_matmul_precision("medium")``) moves the
S-meter by about a dB and the spectra by tens of dB.  The JAX package pins
``precision=`` on each dot; the port pins the process-wide settings for the
duration of each entry point (``Receiver.step`` / ``step_many``,
``PfbBankReceiver.step_many``, ``spectrum.shifted_power``,
``fir.fir_apply_real_signal``, ``fir.fir_apply``) and gives the caller's
settings back afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_float32():
    """For the duration: ``torch.set_float32_matmul_precision("highest")``
    (cuBLAS TF32 off, so ``torch.backends.cuda.matmul.allow_tf32`` reads
    False, and no bf16 products on the CPU) and cuDNN's TF32 off.  The
    caller's precision, and with it its ``allow_tf32``, and its cuDNN flag
    are restored on exit.  Also a decorator."""
    prec = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)
