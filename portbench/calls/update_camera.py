"""``update_camera``: a new pose (accumulation restarts; the camera
products are rebuilt).  Arguments: ``eye`` and ``at`` in fractions of the
lattice edge n, ``up``, ``fovy_deg``.  The camera vectors come from the
benchmark's own ``look_at`` and are handed to both sides."""

import numpy as np


def camera(sess, args):
    """The frozen ``look_at`` camera of the call's arguments."""
    from portbench.reference.camera import Camera

    n = float(sess.n)
    return Camera.look_at(np.multiply(args["eye"], n).tolist(),
                          np.multiply(args["at"], n).tolist(),
                          args.get("up", [0.0, 1.0, 0.0]),
                          float(args["fovy_deg"]), sess.width, sess.height)


def program(sess, args):
    from owlexabrick_tpu_torch.render.camera import Camera

    c = camera(sess, args)
    sess.r.update_camera(Camera(pos=c.pos, dir00=c.dir00, dir_du=c.dir_du,
                                dir_dv=c.dir_dv))


def reference(sess, state, args):
    c = camera(sess, args)
    state.update(cam_pos=np.asarray(c.pos, np.float32),
                 cam_dir00=np.asarray(c.dir00, np.float32),
                 cam_du=np.asarray(c.dir_du, np.float32),
                 cam_dv=np.asarray(c.dir_dv, np.float32))
