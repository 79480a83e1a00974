"""Mean host milliseconds a pair of the span around the refiner's compute,
closed by the stage's synchronise."""


def read(run):
    seconds = run.spans.get("icgn.compute")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
