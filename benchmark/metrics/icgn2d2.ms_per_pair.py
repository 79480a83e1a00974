"""Host milliseconds a pair of the spans around the two second-order
refinements (ref1 -> ref2 and ref1 -> tar2: set_images, prepare and
compute), closed by each stage's synchronise: their sum over the window's
pairs over the pairs."""


def read(run):
    seconds = run.spans.get("icgn2d2")
    return 1e3 * sum(seconds) / run.pairs if seconds else None
