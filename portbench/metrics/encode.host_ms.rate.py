"""Host milliseconds a request spends in ``DTMEngine.encode``, timed by a
wrapper that a traced run puts on the engine instance."""


def read(ctx):
    enc = ctx["counters"].get("encode") or {}
    if not enc.get("calls"):
        return None
    return 1e3 * enc["s"] / enc["calls"]
