"""Dispatch attribution, so far its composition classes.

Port of `walkai_nos_tpu/obs/attrib.py:classify_dispatch`: the engine tags
every dispatch's trace event with what the step program carried.
`DispatchAttribution` and its roofline gauges are not ported yet.
"""

from __future__ import annotations

__all__ = ["DISPATCH_KINDS", "classify_dispatch"]

# Every value the `kind` label can take, in documentation order.
DISPATCH_KINDS = ("decode", "prefill", "mixed", "spec", "spec_prefill")


def classify_dispatch(
    busy_slots: int, lane_rows: int, spec: bool
) -> str:
    """Composition class of one dispatch: what the step program
    actually carried. `busy_slots` = slots holding a live request,
    `lane_rows` = prefill-lane rows carrying a real admission, `spec`
    = the dispatch was a speculative draft+verify round."""
    if spec:
        return "spec_prefill" if lane_rows else "spec"
    if lane_rows and busy_slots:
        return "mixed"
    if lane_rows:
        return "prefill"
    return "decode"
