"""Networks of the SuRF cascade and renderer (torch counterparts of
surf_tpu/nn/*)."""
