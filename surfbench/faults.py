"""Faults planted in the program underneath a run, each of which the
cell's check must catch (``python -m surfbench.calibrate --fault <name>``
reads them at the cell's own size; surfbench/tests/test_surfbench_faults.py
at the tiny one).  Each is a context manager that patches the program and
restores it.  One card: there is no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

# the ray-indexed keys of a training batch
RAY_KEYS = ("pixels_x", "pixels_y", "rays_o", "rays_d", "color", "depth", "pseudo_depth",
            "mask")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _image(change):
    import surf_tpu_torch.validate as pv
    orig = pv.render_full_image
    return _patched(pv, "render_full_image", lambda *a, **k: change(*orig(*a, **k)))


def colour_altered():
    """One rendered pixel's colour moved by 0.25 where the render makes it."""
    def change(color, normal, sdf_depth, render_depth):
        color = color.copy()
        color[0, 0] += 0.25
        return color, normal, sdf_depth, render_depth
    return _image(change)


def half_the_rays():
    """The second half of the image's rays left out, the mean of the first
    half in their place."""
    def change(*outs):
        res = []
        for o in outs:
            o = o.copy()
            half = o.shape[0] // 2
            o[half:] = o[:half].mean(axis=(0, 1))
            res.append(o)
        return tuple(res)
    return _image(change)


def vertices_shifted():
    """Every vertex of marching cubes moved by a quarter of a lattice cell
    along x."""
    import surf_tpu_torch.geometry.extract as ex
    orig = ex.marching_cubes

    def broken(grid, iso):
        v, t = orig(grid, iso)
        v = v.copy()
        v[:, 0] += 0.25
        return v, t
    return _patched(ex, "marching_cubes", broken)


def storage_altered():
    """Every cascade stage's sparse U-Net output scaled by 1.01."""
    import surf_tpu_torch.nn.surf as ps
    orig = ps.reg_net.apply

    def broken(*a, **k):
        out, mid, st = orig(*a, **k)
        return out * 1.01, mid, st
    return _patched(ps.reg_net, "apply", broken)


def state_unchanged():
    """A training step whose update leaves the parameters as they were."""
    from surf_tpu_torch.train import Trainer
    return _patched(Trainer, "update", lambda self: None)


def half_the_batch():
    """A training step's loss over the first half of its rays only (the
    mean over the rest)."""
    from surf_tpu_torch.train import Trainer
    orig = Trainer.loss

    def half(self, batch, *a, **k):
        n = batch["rays_o"].shape[0] // 2
        return orig(self, {key: (v[:n] if key in RAY_KEYS else v) for key, v in batch.items()},
                    *a, **k)
    return _patched(Trainer, "loss", half)


def loss_altered():
    """A training step's loss scaled by 1.01 where it is computed."""
    import surf_tpu_torch.train as pt
    orig = pt.compute_loss

    def broken(*a, **k):
        res = orig(*a, **k)
        res["loss"] = res["loss"] * 1.01
        return res
    return _patched(pt, "compute_loss", broken)


def loss_not_finite():
    """A training step whose loss reads NaN."""
    from surf_tpu_torch.train import Trainer
    orig = Trainer.step

    def broken(self, *a, **k):
        return {**orig(self, *a, **k), "loss": float("nan")}
    return _patched(Trainer, "step", broken)


FAULTS = {"validate": {"colour_altered": colour_altered, "half_the_rays": half_the_rays,
                       "vertices_shifted": vertices_shifted,
                       "storage_altered": storage_altered},
          "train_step": {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
                         "loss_altered": loss_altered, "loss_not_finite": loss_not_finite}}
