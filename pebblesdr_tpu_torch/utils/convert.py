"""Carry receiver state and params across from the JAX package, and back.

The JAX ``ReceiverState`` / ``RxParams`` are pytree dataclasses whose leaves
flatten in field order with ``None`` fields skipped.  The port's dataclasses
keep the same fields and shapes, so a list of numpy leaves flattened on the
JAX side maps onto the port's structure in that same order (with the noise
blanker on, the JAX state's ``nb`` leaves (avg [1, 2C], spike tail [16, 2C])
land on the port's ``ReceiverState.nb`` tuple).  The structure is the
port's ``init_state()`` for the same configuration, so the carry follows
each configuration's leaves: ``RdsState.pll`` is the squaring loop's
CostasOpenState (5 leaves) with rds_alg "open" and the Costas loop's
PLLState (3) with "scan"; the scan AGC's state keeps its peak window's
tail at the full rate and has no hang_tail.  A Receiver on the staged
front carries the JAX package's staged layout (``dc`` [C] complex64,
``decim`` one [C, T-1] complex64 tail per halfband stage, ``nb`` the
NoiseBlankerChunkedState (mag_avg [C], spike_tail [C, 6]), ``iqbal.w`` [C]
complex64), and RDS ``decim`` its premix=False forms; a PfbBankReceiver's
state is the pair (filterbank carry [1, T M - hop] complex64, the tail
Receiver's state), flattened in that order.  The OOK detector's state
(ops/goertzel.py OOKState) and the generators' (core/siggen.py ToneState,
SweepState) carry across the same way.  Nothing here
imports jax: the caller flattens (``jax.tree_util.tree_leaves``) and passes
numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from pebblesdr_tpu_torch.core import siggen
from pebblesdr_tpu_torch.ops import goertzel


def leaves(tree: Any) -> list:
    """Tensor leaves of a (nested) port state dataclass in field order,
    skipping None fields — the JAX pytree flatten order."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in leaves(item)]
    return [tree]


def _rebuild(template: Any, it: Iterator, device) -> Any:
    if template is None:
        return None
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), it, device)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(item, it, device) for item in template)
    arr = np.asarray(next(it))
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"leaf has shape {arr.shape}, expected "
                         f"{tuple(template.shape)}")
    return torch.as_tensor(np.array(arr, copy=True, order="C"), device=device)


def from_numpy(template: Any, arrays: list, device) -> Any:
    """A copy of `template`'s structure with its leaves taken, in order, from
    `arrays` (numpy), placed on `device`."""
    it = iter(arrays)
    out = _rebuild(template, it, device)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def state_from_numpy(rx, arrays: list):
    """Port the state of `rx` (a Receiver or a PfbBankReceiver) from the JAX
    state's leaves."""
    return from_numpy(rx.init_state(), arrays, rx.device)


def params_from_numpy(rx, arrays: list):
    """Port RxParams for Receiver `rx` from the JAX params' leaves."""
    return from_numpy(rx.default_params(), arrays, rx.device)


def ook_state_from_numpy(arrays: list, device) -> goertzel.OOKState:
    """An OOKState from the JAX OOKState's leaves (peak, floor, avg, state,
    attack, decay; each [C])."""
    return from_numpy(goertzel.ook_init(len(arrays[0]), device), arrays,
                      device)


def tone_state_from_numpy(arrays: list, device) -> siggen.ToneState:
    """A ToneState from the JAX ToneState's leaf (phase)."""
    return from_numpy(siggen.tone_init(device), arrays, device)


def sweep_state_from_numpy(arrays: list, device) -> siggen.SweepState:
    """A SweepState from the JAX SweepState's leaves (phase, freq,
    direction, pulse_count)."""
    return from_numpy(siggen.sweep_init(0.0, device), arrays, device)


def state_to_numpy(state: Any) -> list[np.ndarray]:
    """The state's leaves as numpy arrays, in the JAX flatten order."""
    return [leaf.detach().cpu().numpy() for leaf in leaves(state)]
