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

# poison value marking an empty cell (only used in ALLOW_EMPTY_CELLS mode)
EMPTY_CELL_POISON_VALUE = -1e20

# multiplicative epsilon used to advance past a region's exit distance
REGION_ADVANCE_EPS = 1.0000001

# sentinel position marking a dead particle trace
TRACE_DEAD = 2e10

# primitive-ID codes of contour-plane and iso-surface hits
PRIMID_PLANE = -24
PRIMID_ISOSURFACE = -23
