"""The offline evaluation, on the port's own modules (numpy and scipy on
the host; no kernel):

* ``clean_mesh``: the official DTU mask cleaning of validation meshes
  against the ``DTU_TEST`` masks and cameras
  (``python -m surf_tpu_torch.evaluation.clean_mesh``);
* ``dtu_eval``: the DTU Chamfer of the cleaned meshes against the
  ``ObsMask`` / ``Plane`` / STL ground truth
  (``python -m surf_tpu_torch.evaluation.dtu_eval``);
* ``synthetic``: the Chamfer of finetune meshes against the procedural
  scene's analytic sphere (``python -m surf_tpu_torch.evaluation.synthetic``).

The submodules are not imported here, so that each runs with ``-m``."""
