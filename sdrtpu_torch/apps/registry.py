"""Component registry — ``ModuleManager`` capability (PyTorch
counterpart of ``sdrtpu/apps/registry.py``; host code).

The reference dlopens plugin .so files exposing a C ABI
(``core/src/module.cpp:5-84``).  Plugins are Python: register
sources, sinks, demodulators, and decoders by name (directly or via
``importlib.metadata`` entry points in the ``sdrtpu_torch.plugins``
group, so a plugin of the JAX package is not loaded here), then
construct them from configs.  Max-instances and enable/disable state are
tracked like ``ModuleManager::Instance``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Registration:
    factory: Callable[..., Any]
    kind: str
    max_instances: int = -1
    instances: int = 0


class Registry:
    def __init__(self):
        self._entries: dict[str, Registration] = {}

    def register(self, name: str, kind: str, factory: Callable[..., Any],
                 max_instances: int = -1) -> None:
        if name in self._entries:
            raise ValueError(f"{name!r} already registered")
        self._entries[name] = Registration(factory, kind, max_instances)

    def names(self, kind: str | None = None) -> list[str]:
        return [n for n, r in self._entries.items()
                if kind is None or r.kind == kind]

    def create(self, name: str, *args, **kwargs):
        reg = self._entries[name]
        if 0 <= reg.max_instances <= reg.instances:
            raise RuntimeError(f"{name}: max instances reached")
        reg.instances += 1
        return reg.factory(*args, **kwargs)

    def release(self, name: str) -> None:
        reg = self._entries.get(name)
        if reg and reg.instances > 0:
            reg.instances -= 1

    def load_entry_points(self, group: str = "sdrtpu_torch.plugins") -> int:
        """Discover installed plugins; each entry point is a callable
        ``register(registry)``. Returns the number loaded."""
        import importlib.metadata as md

        n = 0
        try:
            eps = md.entry_points(group=group)
        except TypeError:  # older API
            eps = md.entry_points().get(group, [])
        for ep in eps:
            ep.load()(self)
            n += 1
        return n


def default_registry() -> Registry:
    """Registry pre-populated with the port's built-in components."""
    from ..io.net import IqExporter, NetworkSource
    from ..io.rtl_tcp import RtlTcpClient
    from ..io.spyserver import SpyServerClient
    from ..io.hermes import HermesClient
    from ..io.server_protocol import SdrppClient
    from .radio import RadioChain
    from .recorder import Recorder
    from .scanner import Scanner

    r = Registry()
    r.register("network_source", "source", NetworkSource)
    r.register("rtl_tcp_source", "source", RtlTcpClient)
    r.register("spyserver_source", "source", SpyServerClient)
    r.register("hermes_source", "source", HermesClient)
    r.register("sdrpp_server_source", "source", SdrppClient)
    r.register("iq_exporter", "sink", IqExporter)
    r.register("radio", "decoder", RadioChain)
    r.register("recorder", "misc", Recorder)
    r.register("scanner", "misc", Scanner)
    return r
