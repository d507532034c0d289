"""setup_s: from the process's start to the end of the warm-up (host clock)."""


def read(rec):
    return rec.setup_s
