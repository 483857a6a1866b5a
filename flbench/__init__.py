"""flbench: the end-to-end benchmark of fastlanes_tpu_torch on NVIDIA GPUs.

One command runs one cell of `BENCHMARK.json` once:

    python3 -m flbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, timed entry or
metric is a file of its own, found by its name:

  configs/<config>.json     the configuration's sizes, source and assumptions
  configs/<config>.py       its generator: data from the seed, written with the
                            program's own writer; and its test size, SMALL, the
                            overrides that the CPU tests (flbench/tests) run
  traffic/<traffic>.json    a traffic mix, read by the one generator in
                            traffic.py
  entries/<entry>.py        what a call of a timed entry covers: values, bytes
  reference/<entry>.py      the plain NumPy answer of a call, the comparison
                            that decides `correct`, and the control
  metrics/<metric>.py       a reader that takes one metric from a run's record;
                            it may name the program counters it reads
                            (COUNTERS, dotted paths into fastlanes_tpu_torch),
                            which the run reads over the window

The program's spans need no list here: a span `fl.<name>` is the root span
of a public entry where `name` is a function that the program's
`utils.trace.entry` made, and a stage otherwise (spans.entry_names).

A cell of more than one card runs one process a card (ranks.py): the
command's process is rank 0 and starts the others; every call gets the
program's `mesh=`.

The harness (run.py) imports the program under test, `fastlanes_tpu_torch`,
and nothing of the JAX package beside it.
"""
