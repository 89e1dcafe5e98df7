"""Mean ``build_s`` (FPN features and the cascade, host clock ending in a
synchronise; ``Validator.validate``'s own timing) of the window's validates."""


def read(ctx):
    rows = ctx.info.get("val_results")
    return sum(r["build_s"] for r in rows) / len(rows) if rows else None
