"""The JAX package's examples 01-05 on the port (run with ``python -m``):
file playback, the 64-channel channelizer, WFM stereo + RDS, the station
bank and the decoders with the control surface.  Each is ``main(argv)``,
runs on the card unless ``--device`` says otherwise (no fallback: without a
CUDA device ``--device cuda`` is an error) and returns what it printed as a
dict.  Nothing runs at import."""

from __future__ import annotations

import argparse


def parse_args(doc: str, argv, add_args=None) -> argparse.Namespace:
    """The example's flags: --device (resolved to a torch.device) and those
    add_args(parser) adds."""
    from pebblesdr_tpu_torch.serve.cli import resolve_device

    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the default; an error "
                        "without a CUDA device), 'cuda:N' or 'cpu'")
    if add_args is not None:
        add_args(p)
    args = p.parse_args(argv)
    args.device = resolve_device(p, args.device)
    return args
