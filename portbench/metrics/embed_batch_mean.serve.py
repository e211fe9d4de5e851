"""Images per embedding dispatch over the window (``EmbedBatcher.images /
.dispatches``): how far concurrent queries coalesce into one body call."""


def read(run):
    n = run.record.get('dispatches')
    return run.record['images'] / n if n else None
