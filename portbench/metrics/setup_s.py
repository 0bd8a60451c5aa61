"""setup_s: from the harness's first line to the window's start: CUDA's
start, the weights from the seed, the engine, the primers' prefills, the
eager tick and the decode graph's capture (and, in a checkout's first
run, the kernels' build)."""


def read(run):
    return run.setup_s
