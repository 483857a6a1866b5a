"""Everything before the window: kernel and host-codec builds (a checkout's
first run), the data generated, written and flushed, the warm-up query."""


def read(record):
    return record.setup_s
