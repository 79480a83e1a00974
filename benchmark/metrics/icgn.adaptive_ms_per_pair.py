"""Mean host milliseconds a pair of the span around the self-adaptive
refiner's set_images, prepare and compute, closed by the stage's
synchronise."""


def read(run):
    seconds = run.spans.get("icgn.adaptive")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
