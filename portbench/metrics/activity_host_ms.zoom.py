"""``activity_host_ms`` in the cells that report ``frame_ms_p90`` and not
``frame_ms`` (``exajet256.zoom``): the same reading, moving the tail."""

from portbench.metric_alias import alias

read = alias(__file__).read
