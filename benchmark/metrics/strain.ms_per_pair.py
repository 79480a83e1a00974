"""Mean host milliseconds a pair of the span around Strain's prepare and
compute, closed by the stage's synchronise."""


def read(run):
    seconds = run.spans.get("strain")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
