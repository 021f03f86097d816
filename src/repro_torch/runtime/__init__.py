"""Train/serve steps and fault tolerance (port of `repro.runtime`)."""
