"""``k1_roofline_pct`` in the cells that report ``frame_ms_p90`` and not
``frame_ms`` (``exajet256.zoom``): the same reading, moving the tail."""

from portbench.metric_alias import alias

_m = alias(__file__)
TAP, record, read = _m.TAP, _m.record, _m.read
