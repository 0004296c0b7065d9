"""Mesh spec, collectives, the data-parallel step and the other parallel
strategies (sp, tp, pp, ep) of the port. ``ring_attention`` and
``ulysses_attention`` are exported here as in the reference; they load on
first use (PEP 562), since ``common/basics.py`` imports ``parallel.mesh``
and the strategies import ``common/basics.py``."""

_EXPORTS = {"ring_attention": "sp", "ulysses_attention": "sp"}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    import importlib
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
