"""Set-up seconds: from the process's start (imports, the CUDA context,
the inputs made from the seed, the program built, the kernels built or
loaded) through the warm-up, up to the window's start."""


def read(w):
    return w.setup_s
