"""One configuration a pair of files: <name>.json (sizes, source, assumptions) and <name>.py (its generator)."""
