"""Receiver state checkpoint/resume: save and restore the carry state.

Port of pebblesdr_tpu/utils/checkpoint.py, in its file format.  The whole
carry of a Receiver (or a PfbBankReceiver, or any of the port's state
dataclasses) is a tree of tensors whose leaves flatten in the JAX pytree
order (utils/convert.py ``leaves``), so mid-stream suspend/resume is exact:
save after block k, restore into a fresh receiver's ``init_state()``,
continue with block k+1, and the outputs are bit for bit those of the
uninterrupted run.

Storage: one ``.npz``.  Leaf i is ``leaf<i>`` (complex leaves split into
``leaf<i>_re`` / ``leaf<i>_im`` float planes), and ``__meta__`` is the JSON
``{"n_leaves": ..., "extra": {...}}`` as bytes.  A file written by the JAX
package's ``save_state`` loads here into the port's state of the same
configuration, and one written here loads there.
"""

from __future__ import annotations

import json

import numpy as np

from pebblesdr_tpu_torch.utils import convert


def save_state(path: str, state, extra: dict | None = None) -> None:
    """Write `state`'s leaves (fetched to the host) and `extra` (a JSON
    object) to `path`."""
    leaves = convert.state_to_numpy(state)
    arrays = {}
    for i, a in enumerate(leaves):
        if np.iscomplexobj(a):
            arrays[f"leaf{i}_re"] = a.real
            arrays[f"leaf{i}_im"] = a.imag
        else:
            arrays[f"leaf{i}"] = a
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves), "extra": extra or {}}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, template):
    """Restore into the structure of `template` (e.g. ``rx.init_state()``),
    on the template's device.  Returns (state, extra).  Raises ValueError
    when the leaf count or a leaf's shape differs (another configuration
    wrote the file)."""
    tmpl = convert.leaves(template)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["n_leaves"] != len(tmpl):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template has "
                f"{len(tmpl)} — chain config mismatch")
        arrays = []
        for i, t in enumerate(tmpl):
            if f"leaf{i}_re" in data:
                a = (data[f"leaf{i}_re"] + 1j * data[f"leaf{i}_im"]
                     ).astype(np.complex64)
            else:
                a = data[f"leaf{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"leaf {i}: shape {a.shape} != "
                                 f"{tuple(t.shape)}")
            arrays.append(a)
    device = tmpl[0].device if tmpl else "cpu"
    return (convert.from_numpy(template, arrays, device),
            meta.get("extra", {}))
