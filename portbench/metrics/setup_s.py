"""Seconds from the start of the program's set-up (reading the inputs)
to the end of the warm-up: statistics, Gram cache, state, outputs, the
warm-up iterations with the CUDA-graph capture and a record, and in a
checkout's first run the kernels' build.  Making the inputs is apart."""


def read(run):
    return run["setup_s"]
