"""dispatch.queries_per_call: queries answered in the window over the
device calls the Searcher made in it (its `calls` counter): how many
requests the dispatcher merges into one call."""


def read(ctx):
    if not ctx.get("calls"):
        return None
    return ctx["units"] / ctx["calls"]
