"""Model families: each module here sets up one kind of system under
test for the harness (``families/<family>.py``, named by the
configuration file's ``family``)."""
