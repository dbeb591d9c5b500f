"""recall_at_k: the mean recall@k of the seeded sample of the window's
answers against the reference's exact filtered top-k (``check.judge``)."""


def read(ctx):
    return ctx["numbers"]["recall_at_k"]
