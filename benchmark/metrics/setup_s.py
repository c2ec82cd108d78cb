"""End to end: seconds from the process's start to the first timed group:
torch and CUDA, the index and the tables (loaded, or built by a checkout's
first run), the reads made and packed, and the warm-up groups."""


def read(ctx):
    return ctx.setup_s
