"""Process start to the first timed scan: interpreter, imports, the kernel
build or load, CUDA start, inputs, warm-up, and any set-up laps."""


def read(records):
    return records.get("setup_s")
