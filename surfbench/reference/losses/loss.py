"""Aggregate training loss (torch counterpart of surf_tpu/losses/loss.py):
masked L1 colour, eikonal, annealed exp-sparseness, second-order
smoothness, masked top-2 NCC over surface patches (mfc), per-stage
photometric warping and pseudo-depth L1 on the matching-field depths
(train mode), |SDF| at the pseudo points, pseudo/GT depth L1 on the
rendered depth."""

from __future__ import annotations

import torch

from .ncc import compute_lncc
from .photometric import compute_ptloss

_WEIGHTS = ("color_weight", "sparse_scale_factor", "sparse_weight", "igr_weight",
            "mfc_weight", "smooth_weight", "depth_weight", "ptloss_weight",
            "pseudo_auxi_depth_weight", "pseudo_sdf_weight", "pseudo_depth_weight")


def make_loss_config(conf):
    cfg = {k: conf.get_float(k) for k in _WEIGHTS}
    cfg["stage_weights"] = conf.get_list("stage_weights")
    return cfg


def _masked_l1(pred, target, mask):
    return ((pred - target).abs() * mask).sum() / (mask.sum() + 1e-8)


def compute_loss(cfg, preds, targets, step, mode="train"):
    """The loss terms as a dict of scalars (0-d tensors or 0.0); "loss" is
    their weighted sum."""
    valid_mask = preds["valid_mask"].float()
    if "mask" in targets:
        valid_mask = valid_mask * targets["mask"].reshape(-1, 1)
    color_err = (preds["color_fine"] - targets["color"]).abs()
    color_loss = (color_err * valid_mask).sum() / (valid_mask.sum() + 1e-5)
    eikonal_loss = preds["gradient_error"].mean()
    anneal = min(1.0, float(step) / 2.0)
    sparse_loss = torch.exp(-preds["sparse_sdf"].abs()
                            * cfg["sparse_scale_factor"]).mean() * anneal
    smooth_loss = preds["smooth_error"].mean()
    ncc = compute_lncc(preds["ref_gray_val"], preds["sampled_gray_val"])
    ncc_mask = valid_mask * preds["mid_inside_sphere"]
    mfc_loss = 0.5 * ((ncc * ncc_mask).sum(0) / (ncc_mask.sum(0) + 1e-8)).squeeze()

    photo_loss = pseudo_auxi_depth_loss = auxi_depth_loss = 0.0
    auxi_depth_loss0 = src_auxi_depth_loss = 0.0
    if mode == "train":
        n_stages = len(cfg["stage_weights"])
        for i in range(n_stages):
            d_ref = preds[f"depth_stage{i}"]
            d_src = preds[f"depth_src_stage{i}"]
            ref_photo = compute_ptloss(d_ref, targets["imgs"], targets["mask_ref"],
                                       targets["intrs"], targets["c2ws"])
            src_photo = compute_ptloss(d_src, targets["imgs"], targets["mask_src"],
                                       targets["intrs"], targets["c2ws"],
                                       ref_idx=targets["src_idx"], topk=1)
            photo_loss = photo_loss + (ref_photo + src_photo) * cfg["stage_weights"][i]
            pm_ref = (targets["pseudo_depth_ref"] > 0).float()
            pm_src = (targets["pseudo_depth_src"] > 0).float()
            pa = _masked_l1(d_ref, targets["pseudo_depth_ref"], pm_ref)
            pa_src = _masked_l1(d_src, targets["pseudo_depth_src"], pm_src)
            pseudo_auxi_depth_loss = pseudo_auxi_depth_loss + \
                (pa + pa_src) * cfg["stage_weights"][i]
        last = n_stages - 1
        auxi_depth_loss = _masked_l1(preds[f"depth_stage{last}"], targets["depth_ref"],
                                     targets["mask_ref"])
        src_auxi_depth_loss = _masked_l1(preds[f"depth_src_stage{last}"],
                                         targets["depth_src"], targets["mask_src"])
        auxi_depth_loss0 = _masked_l1(preds["depth_stage0"], targets["depth_ref"],
                                      targets["mask_ref"])

    pseudo_sdf_loss = preds["pseudo_sdf"].abs().mean() if "pseudo_sdf" in preds else 0.0
    pseudo_depth_loss = 0.0
    if "pseudo_depth" in targets:
        pm = (targets["pseudo_depth"] > 0).float()
        pseudo_depth_loss = _masked_l1(preds["render_depth"], targets["pseudo_depth"], pm)
    depth_loss = 0.0
    if "depth" in targets:
        dm = (targets["depth"] > 0).float()
        depth_loss = _masked_l1(preds["render_depth"], targets["depth"], dm)

    loss = (color_loss * cfg["color_weight"]
            + eikonal_loss * cfg["igr_weight"]
            + sparse_loss * cfg["sparse_weight"]
            + mfc_loss * cfg["mfc_weight"]
            + smooth_loss * cfg["smooth_weight"]
            + depth_loss * cfg["depth_weight"]
            + photo_loss * cfg["ptloss_weight"]
            + pseudo_auxi_depth_loss * cfg["pseudo_auxi_depth_weight"]
            + pseudo_sdf_loss * cfg["pseudo_sdf_weight"]
            + pseudo_depth_loss * cfg["pseudo_depth_weight"])
    return {"loss": loss, "color_loss": color_loss, "eikonal_loss": eikonal_loss,
            "sparse_loss": sparse_loss, "mfc_loss": mfc_loss,
            "smooth_loss": smooth_loss, "depth_loss": depth_loss,
            "photo_loss": photo_loss, "auxi_depth_loss": auxi_depth_loss,
            "pseudo_auxi_depth_loss": pseudo_auxi_depth_loss,
            "src_auxi_depth_loss": src_auxi_depth_loss,
            "pseudo_sdf_loss": pseudo_sdf_loss, "auxi_depth_loss0": auxi_depth_loss0,
            "pseudo_depth_loss": pseudo_depth_loss}
