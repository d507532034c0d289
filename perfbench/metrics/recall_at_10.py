"""recall_at_10: mean recall@10 of a seed-drawn sample of the window's answers
against the reference's exact top-10."""


def read(rec):
    return rec.recall
