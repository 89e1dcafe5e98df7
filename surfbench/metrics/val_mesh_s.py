"""Mean ``mesh_s`` (the SDF lattice on the card and host marching cubes;
``Validator.validate``'s own timing) of the window's validates."""


def read(ctx):
    rows = ctx.info.get("val_results")
    return sum(r["mesh_s"] for r in rows) / len(rows) if rows else None
