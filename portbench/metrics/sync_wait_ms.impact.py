"""``sync_wait_ms`` in ``impact1024.tev_drag``, the multi-field cell, where
it moves ``frame_ms``: the same reading under a name of its own."""

from portbench.metric_alias import alias

read = alias(__file__).read
