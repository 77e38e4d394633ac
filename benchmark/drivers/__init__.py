"""One module per driver kind, named by a traffic file's ``driver``; each
exposes ``Session(spec, seed, device, program=None)``."""
