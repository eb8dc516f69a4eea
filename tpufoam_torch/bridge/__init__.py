"""The serving process for external CFD solvers (the counterpart of
tpufoam/bridge): the C client library in the repo's `bridge/` talks to
`server.BridgeServer` over a Unix socket and a shared-memory arena;
`client` builds that library and binds it with ctypes."""

from .server import BridgeServer, serve

__all__ = ["BridgeServer", "serve"]
