"""``update_dt``: the sampling step (``dt``, in finest cells; one slab of
the sweep), which restarts accumulation."""

import numpy as np


def program(sess, args):
    sess.r.update_dt(float(args["dt"]))


def reference(sess, state, args):
    state["dt"] = np.float32(args["dt"])
