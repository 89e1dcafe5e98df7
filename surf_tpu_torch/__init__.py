"""surf_tpu_torch: the PyTorch/CUDA port of surf_tpu's SuRF validation path.

Layout mirrors ``surf_tpu``: ``ops/`` (sampling, projection, sparse voxel
sets and the hand-written CUDA kernels' wrappers), ``nn/`` (the networks
and the cascade), ``geometry/`` (mesh extraction), ``data/``, ``config/``
and ``io/`` (host-side copies).  ``validate.py`` is the counterpart of
``Runner.validate``; ``python -m surf_tpu_torch.main --mode val`` runs it.

The package imports ``torch`` and never ``jax`` nor ``surf_tpu``.
"""
