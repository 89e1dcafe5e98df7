"""Mean ``mesh_fill_s`` (the host filling the lattice array from the
occupied blocks' values; the ``mesh.fill`` span inside ``mesh``) of the
window's validates; nothing where the program keeps no such span."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows or any("mesh_fill_s" not in r for r in rows):
        return None
    return sum(r["mesh_fill_s"] for r in rows) / len(rows)
