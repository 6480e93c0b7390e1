"""Mirror tracer spans into ``torch.profiler.record_function``.

Port of ``src/repro/telemetry/jaxbridge.py``.  While a
``torch.profiler.profile`` capture runs, ``record_function`` rows put
the planning stack's host-side phases (CSSE stages, plan compiles, serve
ticks) on the profiler timeline next to the kernels they launched.  The
bridge is opt-in (``configure(profiler_bridge=True)`` or
``REPRO_TRACE_JAX=1``) and imports torch only on the first bridged span,
so the telemetry package stays importable without torch.
"""

from __future__ import annotations


def annotation(name: str):
    """A ``record_function`` context manager for ``name``."""
    from torch.profiler import record_function
    return record_function(name)
