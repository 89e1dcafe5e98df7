"""The ``dtu_finetune`` cell at a size the CPU runs in seconds: the tiny
model of ``tiny.py``, the finetune conf's ``train`` section with two
stage weights, and a 96x128 scan with 64 rays a step."""

from __future__ import annotations

from surfbench.tests.tiny import MODEL, benchmark

TRAIN = {
    "lr_conf": {"mlp_lr": 5e-4, "vol_lr": [1e-1, 1e-2, 1e-2, 1e-3]}, "epochs": 5000,
    "anneal_end": 0, "warmup": 0, "alpha": 0.02, "save_freq": 2500, "log_freq": 100,
    "val_freq": 2500,
    "loss": {"color_weight": 1.0, "sparse_weight": 0.01, "igr_weight": 0.1,
             "sparse_scale_factor": 100, "mfc_weight": 1.0, "smooth_weight": 0.0001,
             "tv_weight": 0.0, "depth_weight": 0.0, "ptloss_weight": 1.0,
             "pseudo_auxi_depth_weight": 1.0, "pseudo_sdf_weight": 1.0,
             "stage_weights": [0.5, 1.0], "pseudo_depth_weight": 1.0}}


def tiny_finetune_cell():
    """``dtu_finetune`` of BENCHMARK.json with the tiny model, the tiny
    scan and the cell's own workload file."""
    from surfbench import manifest
    cell = manifest.cell(benchmark(), "dtu_finetune")
    cfg = cell["config"]
    ft = dict(cfg["finetune_dataset"], img_hw=[96, 128], n_rays=64)
    return dict(cell, config=dict(cfg, model=MODEL, train=TRAIN, finetune_dataset=ft))
