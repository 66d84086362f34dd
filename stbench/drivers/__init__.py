"""One driver a kind of configuration, named by the configuration
file's ``driver``: ``run(ctx) -> harness.Record``."""
