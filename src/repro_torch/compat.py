"""Deprecated v1 compatibility surface.

The v1 iterator API (paper Fig. 7: one blocking ``subscribe`` call per
camera) predates the v2 session machinery.  ``EdgeBroker.subscribe`` warns
``DeprecationWarning`` on every call; v1 callers that cannot migrate yet
import :func:`subscribe_v1` from here instead -- same behavior, no per-call
warning, one explicit opt-in import.

Migration:

    # v1                                     # v2
    for f in edge.subscribe(spec): ...       with client.open_session(app) as s:
                                                 sub = s.subscribe([cam], t0, t1,
                                                                   qos=QosBounds(l, a))
                                                 for f in sub.frames(): ...

This module is the last v1 surface and goes with it.
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.core.api import DeliveredFrame, SubscribeSpec

__all__ = ["subscribe_v1"]


def subscribe_v1(edge, spec: SubscribeSpec, *,
                 controlled: bool = True,
                 feedback_window: int = 8,
                 fetch_window: int = 2) -> Iterator[DeliveredFrame]:
    """v1 streaming subscription over the v2 session machinery, without the
    per-call ``DeprecationWarning`` (importing this module is the opt-in).

    ``edge`` is an ``EdgeBroker`` or anything with an ``edge`` attribute
    that is one (pass a ``MezSystem`` as it is)."""
    edge = getattr(edge, "edge", edge)
    return edge._subscribe_v1(spec, controlled=controlled,
                              feedback_window=feedback_window,
                              fetch_window=fetch_window)
