"""The megakernel lane's early exit on the CPU: the device flags that K1's
plain twin reads (a set flag leaves the chunk an exact no-op) and the
host's polls of them, every chunk or every few, give the frame of the
loop that read the saturation at every chunk's top and broke there, bit
for bit, with and without a carried composite; ``exit.flagged`` counts
the frame and ``exit.late_chunks`` the chunks run flagged.  Nothing here
imports JAX."""

import dataclasses

import numpy as np
import pytest

from owlexabrick_tpu_torch.render import slabs
from owlexabrick_tpu_torch.utils import profiling

from torch_sweep_inputs import EXIT_H, EXIT_W, exit_scene
from torch_threads import one_torch_thread  # noqa: F401


class _NoExit:
    """A loop that never exits early: K1 runs unflagged to the end."""

    def done(self, alpha):
        return False

    def flag(self, alpha, ci):
        return None


def _frame(grids, fs, cfg, cam, carry, exit_kind, poll):
    mp = pytest.MonkeyPatch()
    mp.setattr(slabs._FlagExit, "POLL", poll)
    if exit_kind == "sync":
        mp.setattr(slabs, "_FlagExit", lambda dev, n: slabs._SyncExit())
    elif exit_kind == "never":
        mp.setattr(slabs, "_FlagExit", lambda dev, n: _NoExit())
    c0 = dict(profiling.counts)
    try:
        rgba = slabs.render_slabs_camera(grids, fs, cfg, cam, EXIT_W, EXIT_H,
                                         carry=carry)
    finally:
        mp.undo()
    diff = {k: v - c0.get(k, 0) for k, v in profiling.counts.items()
            if v != c0.get(k, 0)}
    return rgba.numpy(), diff


# (carry, saturate_collapse, the flags' poll every so many chunks): the
# fresh and partly carried frames flag chunk 3 of 8 first, the saturated
# carry chunk 0
CASES = [(carry, False, poll) for carry in (None, "partial", "saturated")
         for poll in (1, 2, 8)] + [(None, True, 1), ("saturated", True, 8)]


@pytest.mark.parametrize(
    "carry,collapse,poll", CASES,
    ids=[f"{c or 'fresh'}-{'collapsed' if k else 'composite'}-poll{p}"
         for c, k, p in CASES])
def test_flag_exit_matches_synchronous_exit(carry, collapse, poll):
    grids, fs, cfg, cam, rgba0 = exit_scene("cpu", carry)
    cfg = dataclasses.replace(cfg, saturate_collapse=collapse)
    got, n_got = _frame(grids, fs, cfg, cam, rgba0, "flag", poll)
    ref, n_ref = _frame(grids, fs, cfg, cam, rgba0, "sync", poll)
    np.testing.assert_array_equal(got, ref)
    assert "exit.flagged" not in n_ref
    # the first poll at or after the first flagged chunk stops the loop at
    # the next chunk's top, if there is one; every chunk launched from
    # the flagged one on is late
    n_chunks = -(-cfg.nslabs // cfg.chunk)
    first = 0 if carry == "saturated" else 3
    polled = -(-first // poll) * poll
    if polled < n_chunks - 1:
        assert n_got.get("exit.flagged") == 1
        assert n_got.get("exit.late_chunks") == polled - first + 1
        assert n_got["cache.none"] == polled + 1
    else:
        assert "exit.flagged" not in n_got
        assert n_got["cache.none"] == n_chunks
    if not collapse:
        # a pixel short of K1's own saturation skip (alpha 0.995) would
        # have changed past the flagged chunk
        never, _ = _frame(grids, fs, cfg, cam, rgba0, "never", poll)
        assert not np.array_equal(got, never)
        assert (got[:, 3] >= 0.98).all() and (got[:, 3] < 0.995).any()
