"""Model-side users of the port's kernels. Port of ``repro/models``: so far
only the retrieval scorers of ``recsys.py`` (the recsys models themselves
wait for the model zoo)."""
