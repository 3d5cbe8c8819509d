"""batch_fill.open (%, program counter; serving layer: serve.py BatchServer
behind EsrganServer): the useful share of the batch slots the card computed
in the window, ServerStats.batched_items / (batches x batch_size), the
counters' growth from the window's open to its close. Partial buckets are
padded to the batch size, so the rest is padding."""


def read(ctx):
    batches = ctx.stats_close.get("batches", 0) - ctx.stats_open.get("batches", 0)
    items = ctx.stats_close.get("batched_items", 0) - ctx.stats_open.get("batched_items", 0)
    if batches <= 0:
        return None
    return 100.0 * items / (batches * ctx.batch_size)
