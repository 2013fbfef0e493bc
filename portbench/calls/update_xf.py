"""``update_xf``: a transfer-function edit (accumulation restarts; the
camera products of an unchanged pose are reused).  Arguments:
``channel`` (0 by default; below the scene's number of fields);
``colormap``, a file ``portbench/inputs/<name>.json``; ``lower``, the
opacity ramp's lower knot in fractions of the value domain (the ramp
rises linearly from 0 there to 1 at the top of the domain, over 128
texels); ``opacity_scale``.  The domain is the channel's field's
(``Session.domains``).  A colormap or opacity scale left out keeps the
one set before.

On the reference's side the state holds ``xf_lut`` (C, 128, 4) and
``xf_domain`` (C, 2) for the scene's C fields, each call setting its
channel's row, and ``xf_channels``, the channels set so far, which
``Session.reference_state`` checks and takes out."""

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


def channel(sess, args) -> int:
    """The call's channel, refused unless the scene has its field."""
    ch = int(args.get("channel", 0))
    if not 0 <= ch < len(sess.domains):
        raise ValueError(f"update_xf channel {ch}: the scene has "
                         f"{len(sess.domains)} field(s)")
    return ch


def program(sess, args):
    ch = channel(sess, args)
    fs = sess.r.fs
    rgb = (colors(args["colormap"]) if "colormap" in args
           else np.asarray(fs.xf_lut)[ch, :, :3])
    scale = float(args.get("opacity_scale", fs.xf_opacity_scale))
    sess.r.update_xf(ch, rgb, opacities(args["lower"]), sess.domains[ch],
                     scale)


def reference(sess, state, args):
    ch = channel(sess, args)
    done = set(state.get("xf_channels", ()))
    if "xf_lut" in state:
        lut, dom = state["xf_lut"].copy(), state["xf_domain"].copy()
    else:
        fields = len(sess.domains)
        lut = np.zeros((fields, NUM_XF_VALUES, 4), np.float32)
        dom = np.zeros((fields, 2), np.float32)
    if "colormap" in args:
        lut[ch, :, :3] = colors(args["colormap"])
    elif ch not in done:
        raise ValueError(f"update_xf channel {ch}: no colormap given and "
                         f"none set before")
    lut[ch, :, 3] = opacities(args["lower"])
    dom[ch] = sess.domains[ch]
    state.update(xf_lut=lut, xf_domain=dom, xf_channels=done | {ch},
                 xf_opacity_scale=np.float32(args.get(
                     "opacity_scale", state.get("xf_opacity_scale"))))
