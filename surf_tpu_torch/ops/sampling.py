"""Ray sample placement (torch counterpart of surf_tpu/ops/sampling.py):
the NeRF inverse-CDF importance sampler the reference keeps available
(implicit_surface.py:14-48; its call site is commented out there)."""

from __future__ import annotations

import torch


def _cdf(weights):
    """The reference's CDF: cumsum(w) / (sum(w) + 1e-6), no zero prepended
    (implicit_surface.py:23)."""
    return torch.cumsum(weights, 1) / (weights.sum(1, keepdim=True) + 1e-6)


def _invert_cdf(cdf, bins, u):
    """Samples at the CDF levels ``u`` (n, s): right-side search, linear
    interpolation within the located bin, a bin narrower than 1e-5 in the
    CDF taken as width 1."""
    b = cdf.shape[1]
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=b - 1)
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def sample_pdf(bins, weights, n_samples, det=False, generator=None):
    """bins (n, b), weights (n, b) -> samples (n, n_samples): ``_cdf``
    inverted at evenly spaced levels (``det``) or at uniform ones drawn
    from ``generator``."""
    n = weights.shape[0]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=weights.dtype, device=weights.device).expand(n, n_samples)
    else:
        u = torch.rand((n, n_samples), generator=generator, dtype=weights.dtype,
                       device=weights.device)
    return _invert_cdf(_cdf(weights), bins, u)
