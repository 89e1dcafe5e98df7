"""NeuS single-parameter variance network: inv_s = exp(10 * variance)."""

import torch


def init(conf, device=None):
    return {"variance": torch.tensor(conf.get_float("init_val"), device=device)}


def inv_s(params):
    return torch.exp(params["variance"] * 10.0)
