"""The benchmark's plain reference: SuRF's validate and training step in
plain PyTorch, with no hand-written kernel.

``nn/``, ``ops/`` and ``losses/`` are frozen copies of the same files of
surf_tpu_torch (commit 5b1d451) in which every kernel wrapper (K1-K4,
K1b-K3b, K4w and the second-order K1g, K1s, K2g, K2s) calls the plain
PyTorch version that the program keeps beside its kernel; nothing else
was changed.  ``pipeline.py`` is the validate (cascade, lattice, render)
and the training step (loss, backward, Adam) of the program's
``validate.py`` and ``train.py`` written over those copies, and
``mesh.py`` reads a lattice as the program's marching cubes would.
Nothing here imports the program.
"""
