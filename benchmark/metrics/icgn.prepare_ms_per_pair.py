"""Mean host milliseconds a pair of the span around the refiner's
set_images and prepare (gradients, B-spline coefficients), closed by the
stage's synchronise."""


def read(run):
    seconds = run.spans.get("icgn.prepare")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
