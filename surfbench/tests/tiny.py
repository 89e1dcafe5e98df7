"""A cell at a size the CPU runs in seconds: two stages (16^3 -> 32^3, the
finer through the sparse convolutions), 64x80 images, a 32^3 mesh."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

MODEL = {
    "range_ratios": [1.0, 0.4],
    "feature_network": {"d_in": 3, "d_base": 8, "d_out": [4, 4]},
    "volume": {"base_volume_dim": [16, 16, 16], "stage_parent_capacity": [512, 1024]},
    "reg_network": {"d_in": [8, 16], "d_base": [8, 8], "d_out": [8, 8]},
    "matching_field": {"n_samples_depths": [16, 8], "depth_res_levels": [4, 2]},
    "implicit_surface": {
        "sdf_network": {"d_out": 129, "d_in": 3, "d_hidden": 128, "n_layers": 6,
                        "skip_in": [3], "multires": 4, "bias": 0.5, "scale": 1.0,
                        "geometric_init": True, "weight_norm": True, "feat_channels": 14,
                        "feat_multires": 0},
        "color_network": {"d_feature": 8}, "variance_network": {"init_val": 0.3},
        "render": {"n_samples": [16, 8], "sample_ranges": [1.0, 0.4], "n_depth": 32,
                   "perturb": 1.0}},
    "dense_unet_max_res": 16}

TRAIN = {
    "lr_conf": {"feat_lr": 0.001, "mlp_lr": 0.0005}, "epochs": 2, "anneal_end": 1,
    "warmup": 1, "alpha": 0.02, "save_freq": 1, "val_freq": 10,
    "loss": {"color_weight": 1.0, "sparse_weight": 0.02, "igr_weight": 0.1,
             "sparse_scale_factor": 100, "mfc_weight": 1.0, "smooth_weight": 0.0001,
             "depth_weight": 0.0, "ptloss_weight": 1.0, "pseudo_auxi_depth_weight": 1.0,
             "pseudo_sdf_weight": 1.0, "stage_weights": [0.5, 1.0],
             "pseudo_depth_weight": 1.0}}

INPUTS = {
    "validate": {"img_hw": [64, 80], "num_src_view": 2, "val_res_level": 4, "n_views": 6,
                 "mesh_resolution": 32, "val_ray_chunk": 4096},
    "train_step": {"img_hw": [64, 80], "num_src_view": 2, "n_rays": 64, "n_views": 6}}


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(name):
    """Cell ``name`` of BENCHMARK.json with the tiny configuration in place
    of its own, and its workload file's traffic parameters."""
    from surfbench import manifest
    cell = manifest.cell(benchmark(), name)
    cfg = dict(cell["config"], model=MODEL, train=TRAIN, inputs=INPUTS)
    return dict(cell, config=cfg)
