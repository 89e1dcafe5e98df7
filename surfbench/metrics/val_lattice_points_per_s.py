"""The SDF lattice's rate, in points a second: the window's
``lattice_points`` (occupied blocks x block^3, counted where the lattice
is evaluated) over its ``mesh_lattice_s`` (the ``mesh.lattice`` span: the
occupied blocks, their SDF on the card and its host copy); nothing where
the program keeps no such span."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows or any("lattice_points" not in r or "mesh_lattice_s" not in r for r in rows):
        return None
    seconds = sum(r["mesh_lattice_s"] for r in rows)
    return sum(r["lattice_points"] for r in rows) / seconds if seconds > 0 else None
