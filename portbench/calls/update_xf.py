"""``update_xf``: a transfer-function edit (accumulation restarts; the
camera products of an unchanged pose are reused).  Arguments:
``channel``; ``colormap``, a file ``portbench/inputs/<name>.json``;
``lower``, the opacity ramp's lower knot in fractions of the value
domain (the ramp rises linearly from 0 there to 1 at the top of the
domain, over 128 texels); ``opacity_scale``.  The domain is [0, the
scene's largest value].  A colormap or opacity scale left out keeps the
one set before."""

import json
import pathlib

import numpy as np

NUM_XF_VALUES = 128
INPUTS = pathlib.Path(__file__).resolve().parent.parent / "inputs"


def opacities(lower: float) -> np.ndarray:
    """The (128,) opacity ramp whose lower knot is at ``lower``."""
    x = np.arange(NUM_XF_VALUES, dtype=np.float64) / (NUM_XF_VALUES - 1)
    lo = float(lower)
    return np.clip((x - lo) / (1.0 - lo), 0.0, 1.0).astype(np.float32)


def colors(name: str) -> np.ndarray:
    with open(INPUTS / f"{name}.json") as f:
        return np.asarray(json.load(f)["colors"], np.float32)


def program(sess, args):
    ch = int(args.get("channel", 0))
    fs = sess.r.fs
    rgb = (colors(args["colormap"]) if "colormap" in args
           else np.asarray(fs.xf_lut)[ch, :, :3])
    scale = float(args.get("opacity_scale", fs.xf_opacity_scale))
    sess.r.update_xf(ch, rgb, opacities(args["lower"]), sess.domain, scale)


def reference(sess, state, args):
    if int(args.get("channel", 0)) != 0:
        raise ValueError("the reference holds one channel's transfer "
                         "function")
    rgb = (colors(args["colormap"]) if "colormap" in args
           else state["xf_lut"][0, :, :3])
    lut = np.concatenate([rgb, opacities(args["lower"])[:, None]], 1)[None]
    state.update(xf_lut=lut.astype(np.float32),
                 xf_domain=np.asarray([sess.domain], np.float32),
                 xf_opacity_scale=np.float32(args.get(
                     "opacity_scale", state.get("xf_opacity_scale"))))
