"""Mean ``write_s`` (the mesh's ``.ply``, the PNG and ``.npy`` artifacts
and the metrics on the host; ``Validator.validate``'s ``write`` span) of
the window's validates; nothing where the program keeps no such span."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows or any("write_s" not in r for r in rows):
        return None
    return sum(r["write_s"] for r in rows) / len(rows)
