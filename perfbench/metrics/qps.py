"""qps: queries answered in the window over the window's length (host clock)."""


def read(rec):
    w = rec.window
    return w.answered_in_window / w.window_s if w.window_s > 0 and w.answered_in_window else None
