"""Client operations (the `:invoke` records) of every check whose
verdict landed in the window, over the seconds from the first check's
start to the last verdict (host clock)."""


def read(ctx: dict):
    w = ctx["window"]
    return w["client_ops"] / w["seconds"] if w["checks"] else None
