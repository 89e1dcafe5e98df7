"""The window's rendered rays over its render seconds, from each
validate's ``render_rays_per_s`` (host clock ending in the image's copy
to the host) and its ray count."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows:
        return None
    rays = ctx.info["val_rays"]
    return rays * len(rows) / sum(rays / r["render_rays_per_s"] for r in rows)
