"""Mean host milliseconds a pair of the span around FFTCC's compute, closed
by the stage's synchronise."""


def read(run):
    seconds = run.spans.get("fftcc")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
