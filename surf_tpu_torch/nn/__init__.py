"""Networks of the SuRF cascade and renderer (torch counterparts of
surf_tpu/nn/*)."""

from . import core, feature_net, reg_net, volume, matching_field
from . import sdf_net, blending_net, rendering_net, variance, implicit_surface, surf
