"""Mean host milliseconds a pair of the span around FeatureAffine2D's
compute (the self-adaptive subsets from the host k-d tree, then RANSAC),
closed by the stage's synchronise."""


def read(run):
    seconds = run.spans.get("feature_affine")
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
