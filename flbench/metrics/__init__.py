"""One reader a metric: `read(record) -> number or None`, the record being
what run.py kept of one run (see run.Record). None leaves the metric out of
the result line.

A reader that takes a program counter names it in its own module:
`COUNTERS = ("<module>.<attribute>", ...)`, dotted paths into
fastlanes_tpu_torch (a dict counter's values are summed). The run reads
every counter that the cell's readers name before and after the window and
keeps each one's change in `record.counters` under its path; a counter the
program lacks is not there, and its reader returns None."""
