"""Mean ``mesh_cubes_s`` (host marching cubes over the lattice and the
vertices' rescale; the ``mesh.cubes`` span inside ``mesh``) of the
window's validates; nothing where the program keeps no such span."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows or any("mesh_cubes_s" not in r for r in rows):
        return None
    return sum(r["mesh_cubes_s"] for r in rows) / len(rows)
