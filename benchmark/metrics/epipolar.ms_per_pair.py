"""Host milliseconds a pair of the spans around the two epipolar searches
(ref1 -> ref2 and tar1 -> tar2: set_images, prepare and compute, the
phase-3 read of the rounded points), closed by each stage's synchronise:
their sum over the window's pairs over the pairs."""


def read(run):
    seconds = run.spans.get("epipolar")
    return 1e3 * sum(seconds) / run.pairs if seconds else None
