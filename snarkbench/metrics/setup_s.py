"""Process start to the first timed request, less the benchmark's input
making: imports, CUDA start, kernel load (nvcc on a checkout's first run),
the zkey cache, the warm-up proves."""


def read(run):
    return run.setup_s
