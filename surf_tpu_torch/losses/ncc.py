"""Patch NCC for multi-view feature consistency (torch counterpart of
surf_tpu/losses/ncc.py, the reference's ``compute_LNCC2``): the box-filter
sums at the patch centre are sums over the patch axis."""

from __future__ import annotations

import torch


def compute_lncc(ref_gray, src_grays):
    """ref_gray (n, p*p, c) reference patches; src_grays (s, n, p*p, c)
    source-view patches.  Returns (n, 1): the mean of the two lowest
    (1 - NCC^2) across sources, clamped to [0, 2]."""
    npatch = ref_gray.shape[1]
    ref = ref_gray.permute(0, 2, 1)[:, None]                 # (n, 1, c, pp)
    src = src_grays.permute(1, 0, 3, 2)                      # (n, s, c, pp)
    ref_sum, src_sum = ref.sum(-1), src.sum(-1)
    ref_sq_sum, src_sq_sum = (ref ** 2).sum(-1), (src ** 2).sum(-1)
    ref_src_sum = (ref * src).sum(-1)
    u_ref, u_src = ref_sum / npatch, src_sum / npatch
    cross = ref_src_sum - u_src * ref_sum - u_ref * src_sum + u_ref * u_src * npatch
    ref_var = ref_sq_sum - 2 * u_ref * ref_sum + u_ref * u_ref * npatch
    src_var = src_sq_sum - 2 * u_src * src_sum + u_src * u_src * npatch
    cc = cross * cross / (ref_var * src_var + 1e-5)          # (n, s, c)
    ncc = (1.0 - cc).clamp(0.0, 2.0).mean(2)                 # (n, s)
    k = min(2, ncc.shape[1])
    return torch.sort(ncc, dim=1).values[:, :k].mean(1, keepdim=True)
