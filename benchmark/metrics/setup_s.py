"""setup_s: seconds from process start to the first timed solve or call:
imports, the CUDA context, the kernel library (built by nvcc on a
checkout's first run, loaded from ``build/`` after), the instance and the
warm-up."""


def read(run):
    return run["setup_s"]
