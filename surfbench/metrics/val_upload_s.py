"""Mean ``upload_s`` (the item's arrays to the card, ending in a
synchronise; ``Validator.validate``'s ``upload`` span) of the window's
validates; nothing where the program keeps no such span."""


def read(ctx):
    rows = ctx.info.get("val_results")
    if not rows or any("upload_s" not in r for r in rows):
        return None
    return sum(r["upload_s"] for r in rows) / len(rows)
