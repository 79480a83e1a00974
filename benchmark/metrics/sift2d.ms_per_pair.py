"""Mean host milliseconds a pair of the span around SIFT2D's set_images
and compute (detection of both frames, matching, the matches read back),
closed by the stage's synchronise."""


def read(run):
    seconds = run.spans.get("sift2d")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
