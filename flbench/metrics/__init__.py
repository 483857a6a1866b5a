"""One reader a metric: `read(record) -> number or None`, the record being
what run.py kept of one run (see run.Record). None leaves the metric out of
the result line."""
