"""Source (device-plugin) registry and discovery.

Capability parity with the reference's plugin discovery (application/
plugins.cpp:77-129: QPluginLoader scan + qobject_cast): sources register by
name — built-ins here, third-party packages via the port's own
`pebblesdr_tpu_torch.sources` entry-point group — and the app shell
instantiates by name + kwargs.  Port of pebblesdr_tpu/io/registry.py.
"""

from __future__ import annotations

import importlib.metadata
from typing import Callable

from pebblesdr_tpu_torch.io import sources as _src
from pebblesdr_tpu_torch.io import rtl_tcp as _rtl
from pebblesdr_tpu_torch.io import sdr_ip as _sdrip
from pebblesdr_tpu_torch.io import hpsdr as _hpsdr

_REGISTRY: dict[str, Callable] = {}


def register(name: str, factory: Callable) -> None:
    _REGISTRY[name.lower()] = factory


def available() -> list[str]:
    _load_entry_points()
    return sorted(_REGISTRY)


def create(name: str, **kwargs) -> _src.Source:
    _load_entry_points()
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown source {name!r}; available: {', '.join(available())}")


_eps_loaded = False


def _load_entry_points() -> None:
    global _eps_loaded
    if _eps_loaded:
        return
    _eps_loaded = True
    try:
        for ep in importlib.metadata.entry_points(
                group="pebblesdr_tpu_torch.sources"):
            try:
                register(ep.name, ep.load())
            except Exception:  # a broken third-party plugin must not kill us
                pass
    except Exception:
        pass


# built-ins (the in-tree "plugins")
register("file", _src.FileSource)
register("synthetic", _src.SyntheticSource)
register("morsegen", _src.MorseGenSource)
register("rtl_tcp", _rtl.RtlTcpSource)
register("sdr_ip", _sdrip.SdrIpSource)
register("hpsdr", _hpsdr.HpsdrSource)


def _audio_factory(**kwargs):
    # imported lazily: the audio-IQ source only needs libportaudio when a
    # real stream is opened (tests inject stream_factory)
    from pebblesdr_tpu_torch.io.audio_iq import AudioIqSource

    return AudioIqSource(**kwargs)


register("audio", _audio_factory)
