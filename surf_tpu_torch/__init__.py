"""surf_tpu_torch: the PyTorch/CUDA port of surf_tpu's SuRF validation
and training paths.

Layout mirrors ``surf_tpu``: ``ops/`` (sampling, projection, sparse voxel
sets, homography patch warp and the hand-written CUDA kernels' wrappers),
``nn/`` (the networks and the cascade), ``losses/``, ``utils/`` (LR
schedule, npz checkpoints), ``geometry/`` (mesh extraction), ``data/``,
``config/`` and ``io/`` (host-side copies).  ``validate.py`` is the
counterpart of ``Runner.validate`` and ``train.py`` of ``Runner.train``;
``python -m surf_tpu_torch.main [--mode train|val|finetune]`` runs them
(``train`` by default, as the JAX CLI); ``train_synthetic.py`` is the
training demo on the synthetic scene and ``summarize_run.py`` summarises
its per-step log (tools/train_synthetic.py, tools/summarize_run.py);
``val_after_train.py`` splits a trained conf's validated views at the
scene's mask.

The package imports ``torch`` and never ``jax`` nor ``surf_tpu``.
"""
