"""Runtime discipline checks for the port.

``trace_guard`` fails a block in which a guarded control plane moved to
another table layout (the port's counterpart of a JAX recompile), and
``race_guard`` wraps the port's ``HostLog`` / ``CamBroker`` locks in
lockset-checking proxies.  The AST lint (``repro.analysis.mezlint``) lints
this package's source from the JAX package's side.
"""

from repro_torch.analysis.trace_guard import (TraceGuardError,
                                              assert_compiled_once,
                                              trace_guard)

__all__ = ["trace_guard", "assert_compiled_once", "TraceGuardError"]
