"""The exa file formats and the ``.exa`` scene config (the port of
``owlexabrick_tpu/io``: host numpy, no torch)."""

from . import formats
from .config import Config, parse_config
from .expression import evaluate_postfix
