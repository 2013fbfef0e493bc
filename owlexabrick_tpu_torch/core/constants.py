"""Global constants of the exa-brick data model (the values of
``owlexabrick_tpu/core/constants.py``, which mirror the reference's
exa/common.h:40-44, programs/FrameState.h:27, programs/exabrick.cu:49)."""

# number of entries in a transfer-function lookup table
NUM_XF_VALUES = 128

# maximum number of scalar channels a scene may carry
MAX_CHANNELS = 10

# maximum number of simultaneously enabled iso surfaces
MAX_ISO_SURFACES = 2

# maximum number of simultaneously enabled contour planes
MAX_CONTOUR_PLANES = 3

# early-ray-termination threshold on accumulated opacity
TERMINATION_THRESHOLD = 0.98

# primitive-ID code of a streamline hit (programs/exabrick.cu:31-38)
PRIMID_STREAMLINE = -25
