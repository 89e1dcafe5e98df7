"""surf_tpu_torch: the PyTorch/CUDA port of surf_tpu's SuRF validation
and training paths.

Layout mirrors ``surf_tpu``: ``ops/`` (sampling, projection, sparse voxel
sets, homography patch warp and the hand-written CUDA kernels' wrappers),
``nn/`` (the networks and the cascade), ``losses/``, ``utils/`` (LR
schedule, npz checkpoints), ``geometry/`` (mesh extraction), ``data/``,
``config/`` and ``io/`` (host-side copies).  ``validate.py`` is the
counterpart of ``Runner.validate`` and ``train.py`` of ``Runner.train``;
``python -m surf_tpu_torch.main --mode val|train`` runs them.

The package imports ``torch`` and never ``jax`` nor ``surf_tpu``.
"""
