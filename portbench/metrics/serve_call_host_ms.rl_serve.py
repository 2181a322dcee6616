"""Mean host time of a served call before its synchronize: padding, the
copy into the graph's inputs, the replay's launch and the clones out
(a host-clock span around the call, over the untraced window)."""

UNIT, SOURCE = "ms", "host_clock"
LAYER = "serve.py servers over utils/graphs.py CapturedCalls"
MOVES = "rl_serve_requests_per_s"


def read(ctx):
    spans = ctx.driver.host_s[-len(ctx.window["latencies"]):] \
        if ctx.window["latencies"] else []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
