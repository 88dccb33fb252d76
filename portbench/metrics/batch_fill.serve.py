"""batch_fill.serve: the micro-batcher's mean fill, requests a batch run
in the window (`MicroBatcher.fills`)."""


def read(run):
    fills = run.counters.get("fills")
    if not fills:
        return None
    return sum(n for n, _ in fills) / len(fills)
