"""Serving: the slot scheduler, the multi-stream streaming engine and the
sharded fleet (``serve.fleet``)."""
