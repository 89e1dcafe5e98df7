"""Training losses (torch counterpart of surf_tpu/losses)."""

from .loss import compute_loss, make_loss_config
from .ncc import compute_lncc
from .photometric import compute_ptloss, ssim_loss_map
from .consistency import compute_consistency_loss

__all__ = ["compute_loss", "make_loss_config", "compute_lncc",
           "compute_ptloss", "ssim_loss_map", "compute_consistency_loss"]
