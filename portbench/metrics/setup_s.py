"""Set-up seconds: process start to the first measured request (loading,
making the inputs, building and warming; the nvcc build on a first run)."""


def read(run):
    return run.setup_s
