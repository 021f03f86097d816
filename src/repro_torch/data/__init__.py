"""Training data: the seeded synthetic LM stream and memmap token shards
(port of `repro.data`)."""
